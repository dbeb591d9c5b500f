"""The port's host Algorithms 1-3 (``repro_torch.core.query_ref``) against
the reference's (``repro.core.query_ref``): the same entry lists, ids and
``return_stats`` fields over every pool, router, frontier width and
strategy, the same ``ValueError``s, and the numpy pool twins equal on
random pools. Both run on the reference's ``tiny_index`` and on an index
whose tree has leaves at several levels, the second read through the
port's ``KHIIndex.load`` with its graph as a tensor (as the port's
builders leave it). Last, the port's batched ``Planner`` on the CPU
equals the port's ``query(pool="beam", router="level")`` in ids and hops,
as ``tests/test_wide_frontier.py`` pins the JAX engine to the
reference's."""

import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core import query_ref as jqr
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.data import make_queries

from repro_torch.core import beam as tbeam
from repro_torch.core import engine as teng
from repro_torch.core import query_ref as tqr
from repro_torch.core.khi import KHIIndex as TIndex

K, EF, CN = 10, 32, 16


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    """A grid corpus whose heavy attribute value puts leaves at several
    tree levels; the reference builds it, the port loads it and holds its
    graph as a tensor."""
    rng = np.random.default_rng(11)
    n, d, m = 700, 16, 3
    vecs = (rng.integers(-64, 64, size=(n, d)) / 32).astype(np.float32)
    attrs = rng.integers(0, 16, size=(n, m)).astype(np.float32)
    attrs[: n // 3, 0] = 3.0
    jidx = JIndex.build(vecs, attrs, JConfig(M=8, builder="device"))
    leaf_levels = np.unique(jidx.tree.level[jidx.tree.left < 0])
    assert len(leaf_levels) >= 3, "the tree should have uneven levels"
    path = tmp_path_factory.mktemp("uneven") / "index.npz"
    jidx.save(str(path))
    tidx = TIndex.load(str(path))
    tidx.nbrs = torch.as_tensor(tidx.nbrs)
    q, preds = make_queries(vecs, attrs, n_queries=12, sigma=1 / 8, seed=3)
    return jidx, tidx, q, preds


@pytest.fixture(scope="module")
def cases(tiny_index, tiny_queries, uneven):
    Q, preds = tiny_queries
    jidx, tidx, uq, upreds = uneven
    return {"tiny": (tiny_index, tiny_index, Q, preds),
            "uneven": (jidx, tidx, uq, upreds)}


def _tpred(p):
    return tqr.Predicate(p.lo, p.hi)


def _assert_same(got, want, ctx):
    gi, gs = got
    wi, ws = want
    assert gi.dtype == wi.dtype == np.int64, ctx
    np.testing.assert_array_equal(gi, wi, err_msg=ctx)
    assert gs == ws, ctx


# pool x router x expand_width (beam only) x strategy
GRID = ([("heap", r, 1, s) for r in ("dfs", "level")
         for s in ("graph", "scan", "auto")]
        + [("beam", r, e, s) for r in ("dfs", "level") for e in (1, 4)
           for s in ("graph", "scan", "auto")])


@pytest.mark.parametrize("case", ["tiny", "uneven"])
@pytest.mark.parametrize("pool,router,E,strategy", GRID)
def test_query_equal(cases, case, pool, router, E, strategy):
    jidx, tidx, Q, preds = cases[case]
    kw = dict(ef=EF, c_n=CN, pool=pool, router=router, expand_width=E,
              strategy=strategy, return_stats=True)
    if strategy == "auto":
        kw["scan_threshold"] = jidx.n // 8
    for i, (q, p) in enumerate(zip(Q, preds)):
        want = jqr.query(jidx, q, p, K, **kw)
        got = tqr.query(tidx, q, _tpred(p), K, **kw)
        _assert_same(got, want, f"{case} query {i}")


@pytest.mark.parametrize("case", ["tiny", "uneven"])
@pytest.mark.parametrize("scan_budget", [None, 2, 16])
def test_query_scan_budget_and_default_threshold(cases, case, scan_budget):
    """``scan_budget`` through both routers, and ``strategy="auto"`` with
    the default threshold (``engine.DEFAULT_SCAN_FRAC`` of n)."""
    jidx, tidx, Q, preds = cases[case]
    assert teng.DEFAULT_SCAN_FRAC == 0.1
    for router in ("dfs", "level"):
        for strategy in ("graph", "auto"):
            kw = dict(ef=EF, scan_budget=scan_budget, router=router,
                      strategy=strategy, return_stats=True)
            for i, (q, p) in enumerate(zip(Q, preds)):
                _assert_same(tqr.query(tidx, q, _tpred(p), K, **kw),
                             jqr.query(jidx, q, p, K, **kw),
                             f"{case} {router} {strategy} query {i}")


@pytest.mark.parametrize("case", ["tiny", "uneven"])
@pytest.mark.parametrize("faithful_budget", [False, True])
@pytest.mark.parametrize("c_e", [1, 10, 40])
def test_range_filter_and_cardinality_equal(cases, case, faithful_budget,
                                            c_e):
    jidx, tidx, _, preds = cases[case]
    for i, p in enumerate(preds):
        tp = _tpred(p)
        for sb in (None, 3):
            ctx = f"{case} pred {i} scan_budget {sb}"
            assert tqr.range_filter(
                tidx, tp, c_e, scan_budget=sb,
                faithful_budget=faithful_budget) == jqr.range_filter(
                jidx, p, c_e, scan_budget=sb,
                faithful_budget=faithful_budget), ctx
            assert tqr.range_filter_level(tidx, tp, c_e, scan_budget=sb) \
                == jqr.range_filter_level(jidx, p, c_e, scan_budget=sb), ctx
        for exact in (False, True):
            got = tqr.estimate_cardinality(tidx, tp, exact=exact)
            assert type(got) is int
            assert got == jqr.estimate_cardinality(jidx, p, exact=exact)
        assert tqr.estimate_cardinality(tidx, tp) >= \
            tqr.estimate_cardinality(tidx, tp, exact=True)


@pytest.mark.parametrize("case", ["tiny", "uneven"])
def test_recons_nbr_equal(cases, case):
    """Algorithm 2 from many objects with a shared visited set: the same
    lists and the same marks, step by step."""
    jidx, tidx, _, preds = cases[case]
    rng = np.random.default_rng(5)
    for p in preds[:6]:
        vj = np.zeros(jidx.n, bool)
        vt = np.zeros(jidx.n, bool)
        for o in rng.integers(0, jidx.n, 20):
            for c_n in (1, 8):
                assert tqr.recons_nbr(tidx, int(o), _tpred(p), c_n, vt) == \
                    jqr.recons_nbr(jidx, int(o), p, c_n, vj)
                np.testing.assert_array_equal(vt, vj)


def test_value_errors_equal(tiny_index, tiny_queries):
    Q, preds = tiny_queries
    q, p = Q[0], preds[0]
    bad = [dict(strategy="nope"), dict(pool="beam", expand_width=0),
           dict(pool="beam", expand_width=EF + 1, ef=EF),
           dict(router="bfs"), dict(pool="stack"),
           dict(pool="heap", expand_width=2)]
    for kw in bad:
        with pytest.raises(ValueError) as je:
            jqr.query(tiny_index, q, p, K, **kw)
        with pytest.raises(ValueError) as te:
            tqr.query(tiny_index, q, _tpred(p), K, **kw)
        assert str(te.value) == str(je.value), kw


def test_empty_and_unconstrained(tiny_index):
    """The reference's own edge cases: an empty box answers nothing, an
    open box is plain ANN whose ids sit in the brute force's top-k."""
    m = tiny_index.m
    p = tqr.Predicate.from_bounds(m, {0: (1e9, 2e9)})
    assert tqr.query(tiny_index, tiny_index.vecs[0], p, 10).size == 0
    p = tqr.Predicate.from_bounds(m, {})
    q = tiny_index.vecs[7] + 0.05
    got = tqr.query(tiny_index, q, p, 5, ef=64)
    gt = tqr.brute_force(tiny_index.vecs, tiny_index.attrs, q, p, 5)
    assert len(set(got.tolist()) & set(gt.tolist())) >= 4


def _random_pool(rng, B, size, fill):
    ids, dists, expanded = jbeam.np_pool_alloc(B, size)
    k = fill
    seed_i = rng.integers(0, 50, size=(B, k)).astype(np.int64)
    seed_d = rng.integers(0, 8, size=(B, k)).astype(np.float32)
    seed_d[rng.random((B, k)) < 0.2] = np.inf
    return ids, dists, expanded, seed_i, seed_d


@pytest.mark.parametrize("seed", range(4))
def test_np_pool_twins_equal(seed):
    """Every twin, in place, on random pools with duplicate distances
    (the stable-sort ties) and sealed slots."""
    rng = np.random.default_rng(seed)
    B, ef, width, tail = 5, 12, 3, 6
    size = ef + tail
    pools = []
    for mod in (jbeam, tbeam):
        a = mod.np_pool_alloc(B, size)
        b = jbeam.np_pool_alloc(B, size)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    ids, dists, expanded, seed_i, seed_d = _random_pool(rng, B, size, 9)
    for _ in range(2):
        pools.append([ids.copy(), dists.copy(), expanded.copy()])
    (ji, jd, je), (ti, td, tex) = pools
    jbeam.np_pool_seed(ji, jd, je, seed_i, seed_d)
    tbeam.np_pool_seed(ti, td, tex, seed_i, seed_d)
    rows = np.array([0, 2, 3])
    for step in range(4):
        js, jv = jbeam.np_pool_top_unexpanded(ji, jd, je, ef, width)
        ts, tv = tbeam.np_pool_top_unexpanded(ti, td, tex, ef, width)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tv, jv)
        jbeam.np_pool_mark_expanded_many(je, np.arange(B), js, jv)
        tbeam.np_pool_mark_expanded_many(tex, np.arange(B), ts, tv)
        new_i = rng.integers(0, 50, size=(len(rows), tail)).astype(np.int64)
        new_d = rng.integers(0, 8, size=(len(rows), tail)).astype(np.float32)
        new_v = rng.random((len(rows), tail)) < 0.7
        jbeam.np_pool_merge_tail(ji, jd, je, rows, new_i, new_d, new_v, ef)
        tbeam.np_pool_merge_tail(ti, td, tex, rows, new_i, new_d, new_v, ef)
        for x, y in ((ti, ji), (td, jd), (tex, je)):
            np.testing.assert_array_equal(x, y, err_msg=f"step {step}")


@pytest.mark.parametrize("E", [1, 2, 4])
def test_planner_equals_host_beam_query(tiny_index, tiny_queries, E):
    """The batched engine against its host oracle: same result sets and
    hop counts for every lane."""
    Q, preds = tiny_queries
    lo = np.stack([p.lo for p in preds]).astype(np.float32)
    hi = np.stack([p.hi for p in preds]).astype(np.float32)
    p = teng.SearchParams(k=K, ef=48, c_e=10, c_n=CN, expand_width=E,
                          backend="pallas_gather_l2_filter")
    ids, _, hops, _ = teng.Planner(tiny_index, p, device="cpu").search(
        Q, lo, hi)
    for i, (q, pr) in enumerate(zip(Q, preds)):
        ref, st = tqr.query(tiny_index, q, _tpred(pr), K, ef=48, c_n=CN,
                            pool="beam", router="level", expand_width=E,
                            return_stats=True)
        got = sorted(x for x in ids[i].tolist() if x >= 0)
        assert got == sorted(ref.tolist()), f"query {i}"
        assert int(hops[i]) == st["hops"], f"query {i}"
