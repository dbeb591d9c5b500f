"""The port's KHIService against the reference's on mixed-size batches:
the same answers, bucket pad lanes, cache hits, epoch swaps and
snapshot keys."""

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.serve import KHIService as JService, ServeConfig as JServeConfig
from repro.data import make_queries

from repro_torch.configs import khi_serve
from repro_torch.core import engine as teng
from repro_torch.core.predicate import Range
from repro_torch.serve import KHIService, Request, ServeConfig

BUCKETS = (1, 8, 32)


@pytest.fixture(scope="module")
def reqs(tiny_data):
    vecs, attrs = tiny_data
    q1, p1 = make_queries(vecs, attrs, n_queries=20, sigma=1 / 2, seed=31)
    q2, p2 = make_queries(vecs, attrs, n_queries=20, sigma=1 / 64, seed=32)
    Q = np.concatenate([q1, q2])
    lo = np.stack([p.lo for p in p1 + p2]).astype(np.float32)
    hi = np.stack([p.hi for p in p1 + p2]).astype(np.float32)
    perm = np.random.default_rng(0).permutation(len(Q))
    return Q[perm], lo[perm], hi[perm]


def _services(tiny_index, strategy="auto", cache_size=64):
    kw = dict(k=10, ef=32, c_n=16, expand_width=4, strategy=strategy,
              scan_threshold=120)
    js = JService(tiny_index, jeng.SearchParams(backend="jnp", **kw),
                  config=JServeConfig(buckets=BUCKETS,
                                      cache_size=cache_size))
    ts = KHIService(tiny_index,
                    teng.SearchParams(backend="pallas_gather_l2_filter",
                                      **kw),
                    config=ServeConfig(buckets=BUCKETS,
                                       cache_size=cache_size),
                    device="cpu")
    return js, ts


@pytest.mark.parametrize("strategy", ["auto", "graph"])
def test_mixed_batches_match_reference(tiny_index, reqs, strategy):
    Q, lo, hi = reqs
    js, ts = _services(tiny_index, strategy)
    s = 0
    for b in (5, 1, 13, 40, 3):                     # 40 > top bucket
        b = min(b, len(Q) - s)
        wi, wd = js.search(Q[s:s + b], lo[s:s + b], hi[s:s + b])
        gi, gd = ts.search(Q[s:s + b], lo[s:s + b], hi[s:s + b])
        np.testing.assert_array_equal(gi, wi)
        fin = np.isfinite(wd)
        np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)
        s += b
    # repeat some requests: cache hits on both sides
    ts.search(Q[:6], lo[:6], hi[:6])
    js.search(Q[:6], lo[:6], hi[:6])
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    assert set(tsnap) == set(jsnap)
    for key in ("requests", "cache_hits", "batches", "pad_lanes",
                "device_queries", "traced_buckets", "scan_lanes",
                "cache_entries", "epoch", "tier_lanes"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["cache_hits"] == 6 and tsnap["pad_lanes"] > 0
    if strategy == "auto":
        assert 0 < tsnap["scan_lanes"] < tsnap["requests"]


def test_submit_flush_stream_and_swap(tiny_index, reqs):
    Q, lo, hi = reqs
    js, ts = _services(tiny_index)
    tickets = [ts.submit(Request(Q[i], lo[i], hi[i])) for i in range(9)]
    out = ts.flush()
    assert sorted(out) == tickets
    want_i, _ = js.search(Q[:9], lo[:9], hi[:9])
    for j, t in enumerate(tickets):
        np.testing.assert_array_equal(out[t].ids, want_i[j])
    stream = list(ts.serve_stream(Request(Q[i], lo[i], hi[i])
                                  for i in range(len(Q))))
    assert len(stream) == len(Q)
    assert all(r.cached for r in stream[:9])
    ts.submit(Request(Q[0], lo[0], hi[0]))
    drained = ts.swap_index(tiny_index)
    assert len(drained) == 1 and ts.epoch == 1
    assert ts.snapshot()["cache_entries"] == 0
    again = ts.search(Q[:9], lo[:9], hi[:9])[0]
    np.testing.assert_array_equal(again, want_i)
    # 9 stream hits + the drained request's hit; none after the swap
    assert ts.snapshot()["cache_hits"] == 9 + 1


def test_pad_lanes_are_empty_boxes(tiny_index, reqs):
    Q, lo, hi = reqs
    _, ts = _services(tiny_index, cache_size=0)
    ts.search(Q[:3], lo[:3], hi[:3])
    snap = ts.snapshot()
    assert snap["pad_lanes"] == 5 and snap["traced_buckets"] == [8]
    m = lo.shape[1]
    plan = ts._planner.plan(np.full((1, m), np.inf, np.float32),
                            np.full((1, m), -np.inf, np.float32))
    assert plan.card[0] == 0 and not plan.use_scan[0]


def test_khi_serve_config_and_rejections(tiny_index):
    cfg = khi_serve.config()
    p = cfg.search_params()
    assert (p.k, p.ef, p.c_e, p.c_n, p.expand_width, p.strategy,
            p.backend) == (10, 128, 10, 32, 4, "auto",
                           "pallas_gather_l2_filter")
    assert cfg.serve_config().buckets == (1, 8, 32, 128, 256)
    assert khi_serve.smoke_config().search_params().backend == "jnp"
    with pytest.raises(ValueError):
        ServeConfig(buckets=(8, 1))
    with pytest.raises(ValueError, match="needs a ShardedKHI"):
        KHIService(tiny_index, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="exactly one filter form"):
        Request(np.zeros(3), lo=np.zeros(3), hi=np.ones(3),
                expr=Range(0, 0.0, 1.0))
    assert cfg.delta_capacity == 131_072
    svc = KHIService(tiny_index, device="cpu")
    with pytest.raises(RuntimeError, match="enable_streaming"):
        svc.delete([0])
    svc.enable_streaming(capacity=8)
    with pytest.raises(RuntimeError, match="already enabled"):
        svc.enable_streaming()


def test_khi_serve_configs_equal_reference():
    """The port's khi-serve configs, field for field, are the reference's
    (the full cell and the smoke one), and so is the scheduler policy they
    build."""
    import dataclasses

    from repro.configs import khi_serve as jkhi_serve

    for name in ("config", "smoke_config"):
        got, want = getattr(khi_serve, name)(), getattr(jkhi_serve, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        gs, ws = got.scheduler_config(), want.scheduler_config()
        assert [dataclasses.asdict(s) for s in gs.ladder] == \
            [dataclasses.asdict(s) for s in ws.ladder]
        assert (gs.qdepth, gs.slo_ms, gs.batch_timeout_ms,
                gs.resolved_thresholds()) == (ws.qdepth, ws.slo_ms,
                                              ws.batch_timeout_ms,
                                              ws.resolved_thresholds())
    cfg = khi_serve.config().scheduler_config()
    assert (cfg.qdepth, cfg.slo_ms, len(cfg.ladder)) == (1024, 100.0, 2)


@pytest.mark.parametrize("inject", ["device_error@2"])
def test_serve_launcher_load_smoke(inject, capsys):
    """``repro_torch.launch.serve --load-smoke`` on the CPU at the
    launcher's default policy (slo 250 ms, qdepth 64, the smoke ladder):
    its accounting checks pass and the injected fault was retried. The
    smoke runs on one intra-op thread: its tensors are tiny, and with the
    test run's other processes on the same cores the thread pool's
    oversubscription alone stalls a batch past the 250 ms deadline."""
    import torch

    from repro_torch.launch.serve import main

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main(["--mode", "khi", "--n", "1500", "--d", "32", "--batch", "16",
              "--device", "cpu", "--load-smoke", "--inject", inject])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "[serve] load-smoke: 49 submitted" in out
    assert "(0 dropped)" in out and "retries=1" in out
    assert "slo=250.0ms" in out
