"""The metric arithmetic: rates over the whole window, a tail over every
request, the readers' silence where they find nothing, the trace's
interval arithmetic and the kernel-table formulas."""

import numpy as np
import pytest

from khi_bench import cost, manifest as mf, trace


def window(lat, burst=256, seconds=None):
    lat = np.asarray(lat, float)
    return {"latencies": lat, "burst": burst, "answered": burst * len(lat),
            "seconds": float(lat.sum()) if seconds is None else seconds}


def test_qps_is_every_answer_over_the_whole_window():
    ctx = {"window": window([0.2, 0.3, 0.5], seconds=1.25)}
    assert mf.reader("qps")(ctx) == pytest.approx(3 * 256 / 1.25)


def test_p95_is_over_every_request():
    # 19 bursts of 0.1 s and one of 1.0 s: the slow burst holds 5% of the
    # requests, so the 95th percentile of requests sits at its edge
    lat = [0.1] * 19 + [1.0]
    got = mf.reader("p95_ms")({"window": window(lat, burst=4)})
    per_request = np.repeat(lat, 4)
    assert got == pytest.approx(1e3 * np.percentile(per_request, 95))
    assert 100.0 <= got <= 1000.0


def test_per_layer_readers_stay_silent_without_a_trace():
    ctx = {"trace": False, "snapshot": {"device_seconds": 1.0,
                                        "device_queries": 0,
                                        "scan_lanes": 0},
           "window": window([1.0]), "build_s": 10.0, "l2dist_s": None}
    for m in mf.load()["per_layer"]:
        assert mf.reader(m["name"])(ctx) is None, m["name"]


def test_service_and_planner_counters():
    ctx = {"trace": True, "window": window([0.5, 0.5]),
           "snapshot": {"device_seconds": 0.8, "device_queries": 512,
                        "scan_lanes": 16}}
    assert mf.reader("service.outside_device_pct")(ctx) == pytest.approx(20)
    assert mf.reader("planner.scan_lane_pct")(ctx) == pytest.approx(3.125)


def test_spans_totals_and_readers():
    s = trace.Spans()
    s.records += [("planner.plan", 0, 2_000_000, 256),
                  ("planner.plan", 5, 4_000_005, 256),
                  ("graph.program", 0, 512_000_000, 256)]
    ctx = {"spans": s}
    assert mf.reader("planner.ms_per_batch")(ctx) == pytest.approx(3.0)
    assert mf.reader("graph.ms_per_lane")(ctx) == pytest.approx(2.0)


def test_spans_wrap_and_restore():
    class Owner:
        def f(self, x):
            return x + 1
    s = trace.Spans()
    s.wrap(Owner, "f", "owner.f", lambda self, x: x)
    assert Owner().f(3) == 4
    s.restore()
    assert Owner.f.__name__ == "f"
    seconds, calls, lanes = s.total("owner.f")
    assert calls == 1 and lanes == 3 and seconds >= 0


def test_merge_intervals_and_idle_by_span():
    busy = trace.merge_intervals([(10, 20), (15, 30), (50, 60), (40, 45)])
    assert busy == [(10, 30), (40, 45), (50, 60)]
    spans = [("service.search", 0, 100, 0), ("graph.program", 35, 70, 0)]
    idle = trace.idle_by_span(busy, 0, 120, spans)
    # gaps: [0,10) service, [30,40) graph (mid 35), [45,50) graph,
    # [60,120) mid 90: service (ends 100)
    assert idle["service.search"] == pytest.approx((10 + 60) / 1e9)
    assert idle["graph.program"] == pytest.approx((10 + 5) / 1e9)
    assert sum(idle.values()) == pytest.approx((120 - 35) / 1e9)
    assert trace.idle_by_span([], 0, 10, []) == {"client": 10 / 1e9}


def test_gather_cost_and_roofline_reader():
    nb, ops = cost.gather_l2_filter_cost(B=2, C=3, d=4, m=2, idx_itemsize=8,
                                         row_bytes=16, n_valid=5, n_pass=4)
    assert nb == 2 * 3 * 8 + 2 * 3 * 4 + 2 * 4 * 4 + 2 * 2 * 2 * 4 \
        + 5 * 2 * 4 + 4 * 16
    assert ops == 3 * 4 * 4
    t, by = cost.bound_s(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"

    class Rec:
        def kernel(self, pattern):
            assert "gather_l2_filter" in pattern
            return 2.0, 50          # seconds, records
    g = {"calls": 100, "bytes": 3.35e12, "ops": 0.0}
    got = mf.reader("gather_l2_filter_roofline")({"gather": g,
                                                  "device_record": Rec()})
    # half of the calls recorded: the bound of half of them, over 2 s
    assert got == pytest.approx(100 * 0.5 / 2.0)
    assert mf.reader("gather_l2_filter_roofline")(
        {"gather": {"calls": 0}, "device_record": Rec()}) is None


def test_device_record_by_name_and_busy():
    rec = trace.DeviceRecord([(0, 10, "a"), (5, 20, "b"), (30, 40, "a")],
                             offset=0, side_ops=0)
    assert rec.busy() == [(0, 20), (30, 40)]
    assert rec.kernel("^a$") == (pytest.approx(20 / 1e9), 2)
    ctx = {"device_record": rec, "busy_s": 0.25, "window_s": 1.0}
    assert mf.reader("device.idle_pct")(ctx) == pytest.approx(75.0)
    assert mf.reader("build.l2dist_qn_pct")(
        {"l2dist_s": 30.0, "build_s": 120.0}) == pytest.approx(25.0)


def test_plan_log_tells_each_request_its_plan():
    from khi_bench.run import PlanLog

    rng = np.random.default_rng(3)
    lo = rng.random((8, 4)).astype(np.float32)
    hi = lo + 1
    use = rng.random(8) < 0.5
    log = PlanLog()
    log.calls += [(lo[:5], hi[:5], use[:5]), (lo[5:], hi[5:], use[5:])]
    order = np.array([6, 0, 3, 7])
    assert (log.scan_lanes(lo[order], hi[order]) == use[order]).all()
    with pytest.raises(RuntimeError):
        log.scan_lanes(lo[:2] + 5, hi[:2])
