"""Degradation tiers of the port's KHIService against the reference's:
the same index, queries and ladder go to the JAX service (``backend=
"jnp"``) and to the port's (``device="cpu"``), and every tier's answers,
lane counters, cache keys and ladder rules must agree. Ids are equal;
distances agree within rtol 1e-5, atol 1e-5 (the JAX plain path and the
port's kernel's plain version sum in other orders), and exactly on the
1/32-grid corpus of the streaming case."""

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.predicate import parse_expr as jparse
from repro.data import make_queries
from repro.serve import (KHIService as JService, ServeConfig as JServeConfig,
                         TierSpec as JTierSpec)

from repro_torch.core import engine as teng
from repro_torch.core.khi import KHIConfig, KHIIndex
from repro_torch.core.predicate import parse_expr as tparse
from repro_torch.serve import KHIService, ServeConfig, TierSpec

BUCKETS = (1, 8, 32)
KW = dict(k=10, ef=48, c_n=16, expand_width=4, scan_threshold=120)
LADDER = "ef=24,ef=12+expand_width=1"
E_BOXES = "a0 in [2019, 2021, 2023] and a1 <= 50"          # 3 boxes
E_MASK = ("a0 in [2009, 2011, 2013, 2015, 2017, 2019, 2021, 2023, 2024] "
          "and a2 > 0.2")                                   # 9 > box_budget


@pytest.fixture(scope="module")
def reqs(tiny_data):
    vecs, attrs = tiny_data
    q1, p1 = make_queries(vecs, attrs, n_queries=12, sigma=1 / 2, seed=51)
    q2, p2 = make_queries(vecs, attrs, n_queries=12, sigma=1 / 64, seed=52)
    Q = np.concatenate([q1, q2])
    lo = np.stack([p.lo for p in p1 + p2]).astype(np.float32)
    hi = np.stack([p.hi for p in p1 + p2]).astype(np.float32)
    perm = np.random.default_rng(5).permutation(len(Q))
    return Q[perm], lo[perm], hi[perm]


def _params(mod, backend, strategy, **kw):
    base = dict(KW, strategy=strategy, backend=backend, **kw)
    if strategy == "hybrid":
        base["node_scan_threshold"] = 64
    return mod.SearchParams(**base)


def _services(index, strategy="auto", ladder=LADDER):
    """The JAX and the port's service over ``index``, each carrying
    ``ladder`` applied by its own package's TierSpec."""
    jp = _params(jeng, "jnp", strategy)
    tp = _params(teng, "pallas_gather_l2_filter", strategy)
    js = JService(index, jp, config=JServeConfig(buckets=BUCKETS,
                                                 cache_size=64),
                  tiers=[s.apply(jp) for s in JTierSpec.parse_ladder(ladder)])
    ts = KHIService(index, tp,
                    config=ServeConfig(buckets=BUCKETS, cache_size=64),
                    device="cpu",
                    tiers=[s.apply(tp) for s in TierSpec.parse_ladder(ladder)])
    return js, ts


def _same(got, want, exact=False):
    gi, gd = got
    wi, wd = want
    np.testing.assert_array_equal(gi, wi)
    if exact:
        np.testing.assert_array_equal(gd, wd)
        return
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strategy,ladder", [
    ("auto", LADDER),
    ("graph", LADDER),
    ("hybrid", LADDER),
    ("auto", LADDER + "+quant=int8"),
])
def test_every_tier_matches_reference(tiny_index, reqs, strategy, ladder):
    Q, lo, hi = reqs
    js, ts = _services(tiny_index, strategy, ladder)
    assert ts.n_tiers == js.n_tiers == 3
    answers = []
    for t in range(3):
        for s, b in ((0, 5), (5, 19)):           # two bucket shapes
            got = ts.search(Q[s:s + b], lo[s:s + b], hi[s:s + b], tier=t)
            want = js.search(Q[s:s + b], lo[s:s + b], hi[s:s + b], tier=t)
            _same(got, want)
        answers.append(ts.search(Q, lo, hi, tier=t)[0])   # cache hits
        js.search(Q, lo, hi, tier=t)
    assert [ts._get_planner(t).params.ef for t in range(3)] == [48, 24, 12]
    if strategy != "hybrid":
        # the ladder degrades: the bottom tier answers some lane otherwise
        # (hybrid's window lanes, most of these, are exact at any ef)
        assert not np.array_equal(answers[0], answers[2])
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    for key in ("tier_lanes", "requests", "cache_hits", "batches",
                "pad_lanes", "device_queries", "scan_lanes",
                "cache_entries"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["tier_lanes"] == {"0": 24, "1": 24, "2": 24}
    assert tsnap["cache_hits"] == 3 * 24
    if strategy in ("auto", "hybrid"):
        assert 0 < tsnap["scan_lanes"]
    if ladder.endswith("int8"):
        # one replica, attached once, read by every tier's planner
        assert ts.index.qvecs is not None
        assert all(ts._get_planner(t).index.qvecs is ts.index.qvecs
                   for t in range(3))
        assert ts._get_planner(2).params.quant == "int8"
        assert ts._get_planner(0).params.quant == "none"


def test_tiers_built_lazily_share_one_plan_cache(tiny_index, reqs):
    Q, lo, hi = reqs
    _, ts = _services(tiny_index)
    assert sorted(ts._planners) == [0]
    ts.search(Q[:4], lo[:4], hi[:4])
    n_plans = len(ts._plan_cache)
    ts.search(Q[:4], lo[:4], hi[:4], tier=2)
    assert sorted(ts._planners) == [0, 2]
    assert ts._planners[2]._plan_cache is ts._planners[0]._plan_cache
    assert len(ts._plan_cache) == n_plans          # the bounds were cached
    assert ts._planner is ts._planners[0]


@pytest.mark.parametrize("text,mode", [(E_BOXES, "boxes"),
                                       (E_MASK, "bitmask")])
def test_search_expr_tiers_match_reference(tiny_index, reqs, text, mode):
    from repro_torch.core.predicate import compile_expr

    Q = reqs[0][:6]
    js, ts = _services(tiny_index)
    m = tiny_index.attrs.shape[1]
    assert compile_expr(tparse(text, m), m, box_budget=8).mode == mode
    for t in range(3):
        _same(ts.search_expr(Q, tparse(text, m), tier=t),
              js.search_expr(Q, jparse(text, m), tier=t))
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    assert tsnap["predicate_lanes"] == jsnap["predicate_lanes"]
    assert tsnap["tier_lanes"] == jsnap["tier_lanes"]
    with pytest.raises(ValueError) as te:
        ts.search_expr(Q, tparse(text, m), tier=3)
    with pytest.raises(ValueError) as je:
        js.search_expr(Q, jparse(text, m), tier=3)
    assert str(te.value) == str(je.value)


def test_result_cache_separates_tiers(tiny_index, reqs):
    """A degraded answer is never served from the cache as a tier-0 answer
    (nor the other way): the key carries the tier, even where two tiers'
    params are equal."""
    Q, lo, hi = reqs
    p = _params(teng, "pallas_gather_l2_filter", "auto")
    svc = KHIService(tiny_index, p, device="cpu",
                     config=ServeConfig(buckets=(1, 4, 8), cache_size=64),
                     tiers=[TierSpec(ef=12, expand_width=1).apply(p), p])
    q = Q[:1]
    svc.search(q, lo[:1], hi[:1], tier=0)
    before = svc.snapshot()["cache_hits"]
    svc.search(q, lo[:1], hi[:1], tier=1)          # distinct key
    assert svc.snapshot()["cache_hits"] == before
    svc.search(q, lo[:1], hi[:1], tier=2)          # tier 0's params, apart
    assert svc.snapshot()["cache_hits"] == before
    svc.search(q, lo[:1], hi[:1], tier=1)          # same-tier repeat
    assert svc.snapshot()["cache_hits"] == before + 1


@pytest.mark.parametrize("change", ["k", "quants", "tier"])
def test_ladder_rules_raise_the_references_errors(tiny_index, reqs, change):
    def build(mod, svc_cls, backend, **extra):
        p = _params(mod, backend, "auto")
        if change == "k":
            tiers = [mod.SearchParams(**dict(KW, k=5, backend=backend))]
        elif change == "quants":
            tiers = [_params(mod, backend, "auto", quant="int8"),
                     _params(mod, backend, "auto", quant="bf16")]
        else:
            svc = svc_cls(tiny_index, p, **extra)
            Q, lo, hi = reqs
            return lambda: svc.search(Q[:1], lo[:1], hi[:1], tier=1)
        return lambda: svc_cls(tiny_index, p, tiers=tiers, **extra)

    with pytest.raises(ValueError) as te:
        build(teng, KHIService, "pallas_gather_l2_filter", device="cpu")()
    with pytest.raises(ValueError) as je:
        build(jeng, JService, "jnp")()
    assert str(te.value) == str(je.value)


def test_set_tiers_and_swap_index_keep_the_ladder(tiny_index, reqs):
    Q, lo, hi = reqs
    js, ts = _services(tiny_index)
    jp0, tp0 = js._tier_user[0], ts._tier_user[0]
    ts.set_tiers([TierSpec(ef=16).apply(tp0)])
    js.set_tiers([JTierSpec(ef=16).apply(jp0)])
    assert ts.n_tiers == js.n_tiers == 2
    _same(ts.search(Q, lo, hi, tier=1), js.search(Q, lo, hi, tier=1))
    ladder = ts._tier_user[1:]
    tp = _params(teng, "pallas_gather_l2_filter", "auto", ef=40)
    jp = _params(jeng, "jnp", "auto", ef=40)
    ts.swap_index(tiny_index, params=tp)
    js.swap_index(tiny_index, params=jp)
    assert ts._tier_user[1:] == ladder and ts._tier_user[0] == tp
    assert ts.params.ef == 40 and ts._tier_params[1].ef == 16
    assert ts.epoch == js.epoch == 1
    for t in range(2):
        _same(ts.search(Q, lo, hi, tier=t), js.search(Q, lo, hi, tier=t))
    with pytest.raises(ValueError, match="changes k"):
        ts.swap_index(tiny_index, params=teng.SearchParams(k=3))


# ------------------------------------------------------------ streaming

D_G, M_G = 16, 2


def _grid(rng, shape):
    return (rng.integers(-64, 64, size=shape) / 32).astype(np.float32)


def _jax_compact(js):
    """The reference's ``compact``, its new epoch's planners refreshed with
    no tombstones (ROADMAP F5: the reference hands them the old epoch's)."""
    stream = js._stream
    stream.deleted_locals = lambda: [np.zeros(0, np.int64)] * stream.S
    try:
        js.compact()
    finally:
        del stream.deleted_locals


def test_streaming_tiers_match_reference():
    """Inserts and deletes, then tier 1 first used (its planner built
    after the deletes must count live rows only), then a compaction and
    tier 2 first used on the new epoch: ids, distances and routing bounds
    equal to the reference's on the grid corpus, where both builders
    agree bit for bit."""
    rng = np.random.default_rng(0x7E)
    n0 = 160
    vecs = _grid(rng, (n0, D_G))
    attrs = rng.integers(0, 16, size=(n0, M_G)).astype(np.float32)
    kw = dict(k=8, ef=32, c_n=16, expand_width=4, strategy="auto",
              scan_threshold=40)
    jp = jeng.SearchParams(backend="jnp", **kw)
    tp = teng.SearchParams(backend="pallas_gather_l2_filter", **kw)
    jcfg, tcfg = JConfig(M=8, builder="device"), KHIConfig(M=8,
                                                           builder="device")
    js = JService(JIndex.build(vecs, attrs, jcfg), jp,
                  config=JServeConfig(buckets=(4, 8), cache_size=64),
                  tiers=[s.apply(jp) for s in JTierSpec.parse_ladder(
                      "ef=16,ef=8+expand_width=1")])
    ts = KHIService(KHIIndex.build(vecs, attrs, tcfg, device="cpu"), tp,
                    config=ServeConfig(buckets=(4, 8), cache_size=64),
                    device="cpu",
                    tiers=[s.apply(tp) for s in TierSpec.parse_ladder(
                        "ef=16,ef=8+expand_width=1")])
    js.enable_streaming(capacity=64, build_config=jcfg)
    ts.enable_streaming(capacity=64, build_config=tcfg)
    Q = _grid(rng, (6, D_G))
    lo = rng.integers(0, 8, size=(6, M_G)).astype(np.float32)
    hi = lo + rng.integers(2, 9, size=(6, M_G)).astype(np.float32)

    def check(t):
        _same(ts.search(Q, lo, hi, tier=t), js.search(Q, lo, hi, tier=t),
              exact=True)
        np.testing.assert_array_equal(
            ts._get_planner(t).plan(lo, hi).card,
            js._planners[t].plan(lo, hi).card)

    check(0)
    nv, na = _grid(rng, (24, D_G)), rng.integers(0, 16, (24, M_G)).astype(
        np.float32)
    np.testing.assert_array_equal(ts.insert(nv, na), js.insert(nv, na))
    dead = np.concatenate([np.arange(0, n0, 5), [n0 + 1, n0 + 3]])
    assert ts.delete(dead) == js.delete(dead) > 0
    assert 1 not in ts._planners
    check(1)                    # first built after the deletes
    check(0)
    _jax_compact(js)
    ts.compact()
    assert 2 not in ts._planners and ts.epoch == js.epoch == 1
    check(2)                    # first built on the compacted epoch
    check(1)
    assert ts.snapshot()["tier_lanes"] == js.snapshot()["tier_lanes"]
