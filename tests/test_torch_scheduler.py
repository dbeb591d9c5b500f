"""The port's SLO scheduler (``repro_torch.serve.scheduler``) over the
port's KHIService: the reference's contracts (admission, tenant-fair
deadline-ordered batching, the degradation ladder, fault recovery,
drain), one scripted run held record for record to the JAX scheduler
over the JAX service under the same fake clock and faults, and the
ladder, policy and ``--inject`` grammars parsed by both packages."""

import dataclasses
import threading
import time

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.data import make_queries
from repro.serve import (FaultInjector as JFaultInjector,
                         KHIService as JService, Rejected as JRejected,
                         Request as JRequest,
                         SchedulerConfig as JSchedulerConfig,
                         Served as JServed, ServeConfig as JServeConfig,
                         SLOScheduler as JSLOScheduler, TierSpec as JTierSpec)

from repro_torch.core import engine as teng
from repro_torch.serve import (FaultInjector, InjectedFault, KHIService,
                               Rejected, Request, SchedulerConfig, Served,
                               ServeConfig, SLOScheduler, TierSpec,
                               replay_open_loop)
from repro_torch.serve.scheduler import REJECT_REASONS

PARAMS = teng.SearchParams(k=10, ef=48, c_n=16,
                           backend="pallas_gather_l2_filter")
LADDER = (TierSpec(ef=24), TierSpec(ef=12, expand_width=1))


@pytest.fixture(scope="module")
def workload(tiny_data):
    vecs, attrs = tiny_data
    Q, preds = make_queries(vecs, attrs, n_queries=32, sigma=1 / 16, seed=5)
    lo = np.stack([p.lo for p in preds]).astype(np.float32)
    hi = np.stack([p.hi for p in preds]).astype(np.float32)
    return [Request(Q[i], lo[i], hi[i]) for i in range(len(Q))]


def _service(tiny_index, cache=0):
    return KHIService(tiny_index, PARAMS, device="cpu",
                      config=ServeConfig(buckets=(1, 4, 8),
                                         cache_size=cache))


def make_sched(tiny_index, *, ladder=LADDER, injector=None, **cfg_kw):
    cfg_kw.setdefault("qdepth", 64)
    cfg_kw.setdefault("slo_ms", 10_000.0)   # no deadline unless a test
    svc = _service(tiny_index)              # sets one per request
    sched = SLOScheduler(svc, SchedulerConfig(ladder=ladder, **cfg_kw),
                         autostart=False, injector=injector)
    return svc, sched


def drain(sched):
    while sched.pump():
        pass


# ------------------------------------------------------------- admission
def test_queue_full_rejects_typed(tiny_index, workload):
    _, sched = make_sched(tiny_index, qdepth=3)
    tickets = [sched.submit(workload[i]) for i in range(5)]
    for t in tickets[3:]:
        rec = sched.result(t, timeout=0)
        assert isinstance(rec, Rejected) and rec.reason == "queue_full"
    drain(sched)
    snap = sched.shutdown()
    assert snap["submitted"] == 5 and snap["served"] == 3
    assert snap["rejected"] == {"queue_full": 2}
    assert snap["dropped"] == 0


def test_dead_on_arrival_and_expired_in_queue(tiny_index, workload):
    """A request dead on arrival is rejected at once; one whose deadline
    passes while queued is shed at batch formation, not served."""
    _, sched = make_sched(tiny_index)
    t_doa = sched.submit(workload[0], deadline_ms=0)
    rec = sched.result(t_doa, timeout=0)
    assert isinstance(rec, Rejected) and rec.reason == "expired"
    assert rec.detail == "dead on arrival"
    t_live = sched.submit(workload[1], deadline_ms=60_000)
    t_dead = sched.submit(workload[2], deadline_ms=0.001)
    time.sleep(0.01)
    drain(sched)
    assert isinstance(sched.result(t_live), Served)
    rec = sched.result(t_dead)
    assert isinstance(rec, Rejected) and rec.reason == "expired"
    snap = sched.shutdown()
    assert snap["expired_in_queue"] == 1 and snap["dropped"] == 0
    assert snap["rejected"] == {"expired": 2}


def test_submit_after_shutdown_rejected(tiny_index, workload):
    _, sched = make_sched(tiny_index)
    sched.shutdown()
    rec = sched.result(sched.submit(workload[0]), timeout=0)
    assert isinstance(rec, Rejected) and rec.reason == "shutdown"
    with pytest.raises(ValueError, match="unknown reject reason"):
        Rejected(0, "bogus", "t")
    assert REJECT_REASONS == ("queue_full", "expired", "fault", "shutdown")


# ------------------------------------------------------ batch formation
def test_tenant_round_robin_and_deadline_order(tiny_index, workload):
    _, sched = make_sched(tiny_index)
    ta = [sched.submit(workload[i], deadline_ms=1000 * (3 - i), tenant="a")
          for i in range(3)]
    tb = sched.submit(workload[3], tenant="b")
    with sched._cond:
        batch, _ = sched._form_batch(now=sched._clock())
    order = [it.ticket for it in batch]
    assert tb in order[:2]                  # fair: b is not last
    assert [t for t in order if t in ta] == sorted(ta, key=lambda t: -t)


def test_batch_respects_max_batch(tiny_index, workload):
    svc, sched = make_sched(tiny_index)
    for r in workload[:12]:
        sched.submit(r)
    assert sched.pump() == svc.config.max_batch == 8
    assert sched.snapshot()["queued"] == 4


# --------------------------------------------------------- degradation
def test_backlog_degrades_tier_and_records_it(tiny_index, workload):
    svc, sched = make_sched(tiny_index, qdepth=32, tier_thresholds=(8, 16))
    tickets = [sched.submit(r) for r in workload[:28]]
    drain(sched)
    recs = [sched.result(t) for t in tickets]
    assert {rec.tier for rec in recs} == {0, 1, 2}
    snap = sched.shutdown()
    assert sum(snap["tier_served"].values()) == snap["served"] == 28
    assert snap["tier_served"]["2"] > 0
    assert all(rec.result.ids.shape == (PARAMS.k,) for rec in recs)
    # a Served record is its tier's direct answer
    for t, rec in zip(tickets, recs):
        r = workload[t]
        ids, _ = svc.search(r.query[None], r.lo[None], r.hi[None],
                            tier=rec.tier)
        np.testing.assert_array_equal(rec.result.ids, ids[0])


def test_tier0_when_idle_and_slack_escalates(tiny_index, workload):
    """An idle queue serves at tier 0; a batch whose tightest slack cannot
    fit tier 0's latency average steps down the ladder."""
    _, sched = make_sched(tiny_index)
    t0 = sched.submit(workload[0])
    sched.pump()
    assert sched.result(t0).tier == 0
    sched._ema_ms[0] = 5_000.0              # pretend tier 0 is very slow
    t1 = sched.submit(workload[1], deadline_ms=50)
    sched.pump()
    assert sched.result(t1).tier >= 1


def test_timeout_pressure_escalates_next_batch(tiny_index, workload):
    inj = FaultInjector.parse("stall:30ms@0")
    _, sched = make_sched(tiny_index, injector=inj, batch_timeout_ms=5.0)
    t0 = sched.submit(workload[0])
    sched.pump()                            # stalled past the budget
    assert sched.result(t0).tier == 0       # the answer still arrives
    assert sched.snapshot()["timeouts"] == 1
    t1 = sched.submit(workload[1])
    sched.pump()
    assert sched.result(t1).tier >= 1
    assert inj.counts()["stall"] == 1


# ------------------------------------------------------- fault recovery
def test_ordinal_fault_recovers_all_lanes(tiny_index, workload):
    inj = FaultInjector.parse("device_error@0")
    _, sched = make_sched(tiny_index, ladder=(), injector=inj)
    tickets = [sched.submit(r) for r in workload[:4]]
    drain(sched)
    assert all(isinstance(r, Served) and r.retries == 1
               for r in map(sched.result, tickets))
    snap = sched.snapshot()
    assert snap["batch_failures"] == snap["retries"] == 1
    assert snap["lane_failures"] == 0 and snap["device_errors"] == 0
    assert snap["injected_faults"] == inj.counts()["device_error"] == 1
    assert snap["dropped"] == 0


def test_poison_lane_fails_alone_after_resplit(tiny_index, workload):
    _, sched = make_sched(tiny_index, ladder=())
    tickets = [sched.submit(r) for r in workload[:4]]
    poisoned = tickets[2]
    sched._injector = FaultInjector.parse(f"device_error%{poisoned}")
    drain(sched)
    for t in tickets:
        rec = sched.result(t)
        if t == poisoned:
            assert isinstance(rec, Rejected) and rec.reason == "fault"
            assert "poisoned" in rec.detail
        else:
            assert isinstance(rec, Served) and rec.retries == 1
    snap = sched.snapshot()
    assert snap["batch_failures"] == 1 and snap["retries"] == 1
    assert snap["lane_failures"] == 1
    assert snap["served"] == 3 and snap["rejected"] == {"fault": 1}
    assert snap["dropped"] == 0


def test_real_exception_counted_separately(tiny_index, workload):
    """A failure that was not injected takes the same recovery path but
    counts as ``device_errors``: the counter a caller reads to tell a
    failing kernel from a drill."""
    _, sched = make_sched(tiny_index, ladder=())
    orig = sched._run
    calls = {"n": 0}

    def flaky(batch, tier):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("CUDA error: an illegal memory access")
        return orig(batch, tier)

    sched._run = flaky
    t = sched.submit(workload[0])
    drain(sched)
    assert isinstance(sched.result(t), Served)
    snap = sched.snapshot()
    assert snap["device_errors"] == 1 and snap["injected_faults"] == 0


def test_max_retries_zero_fails_batch_typed(tiny_index, workload):
    inj = FaultInjector.parse("device_error@0")
    _, sched = make_sched(tiny_index, ladder=(), injector=inj,
                          max_retries=0)
    tickets = [sched.submit(r) for r in workload[:3]]
    drain(sched)
    for t in tickets:
        rec = sched.result(t)
        assert isinstance(rec, Rejected) and rec.reason == "fault"
    snap = sched.snapshot()
    assert snap["dropped"] == 0 and snap["retries"] == 0


# ------------------------------------------------------------- shutdown
def test_drain_shutdown_serves_everything(tiny_index, workload):
    _, sched = make_sched(tiny_index)
    tickets = [sched.submit(r) for r in workload[:11]]
    snap = sched.shutdown(drain=True)
    assert snap["served"] == 11 and snap["dropped"] == 0
    assert all(isinstance(sched.result(t), Served) for t in tickets)


def test_no_drain_shutdown_rejects_queue_typed(tiny_index, workload):
    _, sched = make_sched(tiny_index)
    tickets = [sched.submit(r) for r in workload[:5]]
    snap = sched.shutdown(drain=False)
    assert snap["rejected"] == {"shutdown": 5} and snap["dropped"] == 0
    assert all(sched.result(t).reason == "shutdown" for t in tickets)


def test_worker_thread_end_to_end(tiny_index, workload):
    """The worker thread serves submissions from two feeder threads; a
    drain shutdown leaves nothing in flight and the worker stopped."""
    svc = _service(tiny_index)
    sched = SLOScheduler(svc, SchedulerConfig(slo_ms=60_000.0, qdepth=64,
                                              ladder=LADDER),
                         autostart=True)
    with pytest.raises(RuntimeError, match="autostart=False"):
        sched.pump()
    tickets, lock = [], threading.Lock()

    def feed(a, b, tenant):
        for i in range(a, b):
            t = sched.submit(workload[i], tenant=tenant)
            with lock:
                tickets.append(t)

    threads = [threading.Thread(target=feed, args=(0, 16, "a")),
               threading.Thread(target=feed, args=(16, 32, "b"))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    sched.wait_all(timeout=120)
    worker = sched._thread
    snap = sched.shutdown(drain=True)
    assert not worker.is_alive()
    assert snap["submitted"] == 32 and snap["dropped"] == 0
    assert snap["served"] + sum(snap["rejected"].values()) == 32
    assert all(isinstance(sched.result(t, timeout=0), Served)
               for t in tickets)


def test_replay_open_loop_paces_submissions():
    now, slept = [0.0], []

    def sleep(s):
        slept.append(s)
        now[0] += s

    seen = []
    out = replay_open_loop(lambda x: seen.append(x) or x,
                           [0.0, 0.1, 0.15], ["a", "b", "c"],
                           clock=lambda: now[0], sleep=sleep)
    assert out == seen == ["a", "b", "c"]
    assert slept == pytest.approx([0.1, 0.05])


def test_fault_injector_fires_and_disarms():
    inj = FaultInjector.parse(
        "device_error@1,latency:5ms@0,device_error%7+9", sleep=lambda s: None)
    inj.before_batch(0, [1, 2])             # latency fires
    with pytest.raises(InjectedFault):
        inj.before_batch(1, [3])            # the ordinal error fires
    inj.before_batch(1, [3])                # ...and has disarmed
    with pytest.raises(InjectedFault, match="poisoned"):
        inj.before_batch(2, [7])            # poison fires
    with pytest.raises(InjectedFault):
        inj.before_batch(3, [9])            # ...and re-fires
    assert inj.counts() == {"device_error": 3, "latency": 1, "stall": 0}


# ----------------------------------------------- parity with the reference
class FakeClock:
    """A clock that advances a fixed step per reading; ``sleep`` advances
    it by the time asked. Two schedulers that read it in the same order
    see the same times, so their latency averages agree."""

    def __init__(self, step_s: float = 0.004):
        self.t, self.step = 0.0, step_s

    def __call__(self) -> float:
        self.t += self.step
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


FAULTS = "device_error@1,device_error%5,stall:30ms@3"


def _scripted_run(mods, index, Q, lo, hi):
    """One script through ``mods``' scheduler over its service: two
    tenants, a 28-request backlog that reaches every tier, a few tight
    deadlines (which the slack rule and expiry act on), one request dead
    on arrival, and ``FAULTS``. Returns (records by ticket, snapshot,
    the injector's counts, the service's snapshot)."""
    (svc_cls, cfg_cls, serve_cls, sched_cls, inj_cls, spec_cls, req_cls,
     params) = mods
    clock = FakeClock()
    svc = svc_cls(index, params, config=serve_cls(buckets=(1, 4, 8),
                                                  cache_size=0),
                  **({} if svc_cls is JService else {"device": "cpu"}))
    cfg = cfg_cls(qdepth=40, slo_ms=10_000.0, tier_thresholds=(8, 16),
                  ladder=spec_cls.parse_ladder("ef=24,ef=12+expand_width=1"))
    inj = inj_cls.parse(FAULTS, sleep=clock.sleep)
    sched = sched_cls(svc, cfg, injector=inj, autostart=False, clock=clock,
                      sleep=clock.sleep)
    tickets = []
    for i in range(28):
        tight = i in (9, 17, 26)
        tickets.append(sched.submit(req_cls(Q[i], lo[i], hi[i]),
                                    tenant=f"t{i % 2}",
                                    deadline_ms=60.0 if tight else None))
    tickets.append(sched.submit(req_cls(Q[0], lo[0], hi[0]), deadline_ms=0,
                                tenant="t0"))
    while sched.pump():
        pass
    snap = sched.shutdown(drain=True)
    recs = {t: sched.result(t, timeout=0) for t in tickets}
    return recs, snap, inj.counts(), svc.snapshot()


def test_scheduler_parity_with_reference(tiny_index, workload):
    Q = np.stack([r.query for r in workload])
    lo = np.stack([r.lo for r in workload])
    hi = np.stack([r.hi for r in workload])
    kw = dict(k=10, ef=48, c_n=16, expand_width=4, strategy="auto",
              scan_threshold=120)
    jmods = (JService, JSchedulerConfig, JServeConfig, JSLOScheduler,
             JFaultInjector, JTierSpec, JRequest,
             jeng.SearchParams(backend="jnp", **kw))
    tmods = (KHIService, SchedulerConfig, ServeConfig, SLOScheduler,
             FaultInjector, TierSpec, Request,
             teng.SearchParams(backend="pallas_gather_l2_filter", **kw))
    wrecs, wsnap, wfired, wsvc = _scripted_run(jmods, tiny_index, Q, lo, hi)
    grecs, gsnap, gfired, gsvc = _scripted_run(tmods, tiny_index, Q, lo, hi)
    assert gsnap == wsnap
    assert gfired == wfired
    for key in ("tier_lanes", "scan_lanes", "batches", "pad_lanes",
                "requests"):
        assert gsvc[key] == wsvc[key], key
    assert sorted(grecs) == sorted(wrecs)
    for t in wrecs:
        w, g = wrecs[t], grecs[t]
        assert type(g).__name__ == type(w).__name__, t
        if isinstance(w, JRejected):
            assert (g.reason, g.tenant, g.detail) == (w.reason, w.tenant,
                                                      w.detail), t
            continue
        assert isinstance(w, JServed)
        assert (g.tier, g.retries, g.tenant, g.deadline_met,
                g.result.cached) == (w.tier, w.retries, w.tenant,
                                     w.deadline_met, w.result.cached), t
        assert g.latency_ms == w.latency_ms, t
        np.testing.assert_array_equal(g.result.ids, w.result.ids)
        fin = np.isfinite(w.result.dists)
        np.testing.assert_allclose(g.result.dists[fin], w.result.dists[fin],
                                   rtol=1e-5, atol=1e-5)
    # the script reached what it is for
    assert set(gsnap["tier_served"]) == {"0", "1", "2"}
    assert gsnap["rejected"]["expired"] >= 2       # the DOA and a tight one
    assert gsnap["rejected"]["fault"] == 1         # ticket 5 alone
    assert isinstance(grecs[5], Rejected) and grecs[5].reason == "fault"
    assert gsnap["batch_failures"] == gsnap["retries"] >= 1
    assert gsnap["lane_failures"] == 1
    assert gsnap["injected_faults"] == gfired["device_error"]
    assert gfired["stall"] == 1 and gsnap["dropped"] == 0


# ----------------------------------------------------------- grammars
LADDERS = ["ef=24", "ef=24,ef=12+expand_width=1+quant=int8", "",
           " ef=64 , ef=32+expand_width=1 ", "c_e=4+c_n=8+strategy=scan",
           "scan_threshold=10+node_scan_threshold=5+rerank_mult=2",
           "bogus=3", "ef=", ",,", "ef=24,+", "ef=x"]
INJECTS = ["", "device_error@2", "device_error%7", "device_error%7+9",
           "latency:50ms@3", "stall:200ms@5",
           "device_error@1,latency:30ms@2,device_error%5",
           "device_error", "latency:5s@0", "oom@0", "latency:0ms@1",
           "latency:5ms%3", "device_error@x"]
POLICIES = [dict(), dict(qdepth=90, ladder="ef=24,ef=12"),
            dict(qdepth=0), dict(slo_ms=0), dict(max_retries=-1),
            dict(ladder="ef=24,ef=12", tier_thresholds=(4,)),
            dict(ladder="ef=24,ef=12", tier_thresholds=(16, 4)),
            dict(ladder="ef=24,ef=12", tier_thresholds=(0, 4)),
            dict(qdepth=5, ladder="ef=1,ef=2,ef=3,ef=4"),
            dict(qdepth=64, slo_ms=250.0, batch_timeout_ms=-1.0)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


def _spec_fields(specs):
    return [dataclasses.asdict(s) for s in specs]


@pytest.mark.parametrize("text", LADDERS)
def test_ladder_grammar_matches_reference(text):
    got = _outcome(lambda: _spec_fields(TierSpec.parse_ladder(text)))
    want = _outcome(lambda: _spec_fields(JTierSpec.parse_ladder(text)))
    assert got == want
    if got[0] == "ok" and got[1]:
        base_t = teng.SearchParams(ef=48, c_e=40, expand_width=32)
        base_j = jeng.SearchParams(ef=48, c_e=40, expand_width=32)
        for gs, ws in zip(TierSpec.parse_ladder(text),
                          JTierSpec.parse_ladder(text)):
            g = _outcome(lambda: dataclasses.asdict(gs.apply(base_t)))
            w = _outcome(lambda: dataclasses.asdict(ws.apply(base_j)))
            assert g == w


@pytest.mark.parametrize("text", INJECTS)
def test_inject_grammar_matches_reference(text):
    got = _outcome(lambda: [dataclasses.asdict(s) for s in
                            FaultInjector.parse(text).specs])
    want = _outcome(lambda: [dataclasses.asdict(s) for s in
                             JFaultInjector.parse(text).specs])
    assert got == want


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_scheduler_config_matches_reference(policy):
    def build(cfg_cls, spec_cls):
        kw = dict(policy)
        kw["ladder"] = spec_cls.parse_ladder(kw.pop("ladder", ""))
        cfg = cfg_cls(**kw)
        d = dataclasses.asdict(cfg)
        d["ladder"] = [dataclasses.asdict(s) for s in cfg.ladder]
        return d, cfg.resolved_thresholds()

    assert _outcome(lambda: build(SchedulerConfig, TierSpec)) == \
        _outcome(lambda: build(JSchedulerConfig, JTierSpec))
