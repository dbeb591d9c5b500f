"""The port's batched search and planner against the reference's
``search_batch`` / ``Planner`` with ``backend="jnp"`` (whose ids the
reference's own tests pin to its fused kernel). The port runs its
production backend, ``pallas_gather_l2_filter``, which on the CPU is the
kernel's plain version.

Ids and hops are equal; distances are within rtol = atol = 1e-5 on the
float fixture (reduce order differs) and bit-equal on a 1/32-grid corpus.
Queries come at two selectivities (σ=1/2 and σ=1/64 at the fixture's 10%
threshold), so one ``auto`` batch holds both lane kinds."""

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.data import make_queries

from repro_torch.core import engine as teng
from repro_torch.core.query_ref import Predicate

K, EF, CN = 10, 32, 16


@pytest.fixture(scope="module")
def workload(tiny_data):
    vecs, attrs = tiny_data
    q1, p1 = make_queries(vecs, attrs, n_queries=10, sigma=1 / 2, seed=21)
    q2, p2 = make_queries(vecs, attrs, n_queries=10, sigma=1 / 64, seed=22)
    preds = [Predicate(p.lo, p.hi) for p in p1 + p2]
    return np.concatenate([q1, q2]), p1 + p2, preds


def _params(mod, **kw):
    base = dict(k=K, ef=EF, c_n=CN)
    base.update(kw)
    return mod.SearchParams(**base)


def _compare(got, want, exact):
    gi, gd, gh = got
    wi, wd, wh = want
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gh, wh)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    if exact:
        np.testing.assert_array_equal(gd[fin], wd[fin])
    else:
        np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strategy,E", [("graph", 1), ("graph", 4),
                                        ("scan", 1), ("auto", 4)])
def test_search_batch_matches_reference(tiny_index, workload, strategy, E):
    Q, jpreds, tpreds = workload
    kw = dict(expand_width=E, strategy=strategy, scan_threshold=120)
    want = jeng.search_batch(tiny_index, Q, jpreds,
                             _params(jeng, backend="jnp", **kw))
    got = teng.search_batch(
        teng.device_put_index(tiny_index, device="cpu"), Q, tpreds,
        _params(teng, backend="pallas_gather_l2_filter", **kw))
    _compare(got, want, exact=False)
    assert (got[0] >= 0).any()


def test_auto_dispatch_masks_equal(tiny_index, workload):
    Q, jpreds, _ = workload
    lo = np.stack([p.lo for p in jpreds]).astype(np.float32)
    hi = np.stack([p.hi for p in jpreds]).astype(np.float32)
    kw = dict(strategy="auto", expand_width=4, scan_threshold=120)
    jp = jeng.Planner(tiny_index, _params(jeng, **kw))
    tp = teng.Planner(tiny_index, _params(teng, **kw), device="cpu")
    jplan, tplan = jp.plan(lo, hi), tp.plan(lo, hi)
    np.testing.assert_array_equal(tplan.card, jplan.card)
    np.testing.assert_array_equal(tplan.use_scan, jplan.use_scan)
    assert tplan.use_scan.any() and not tplan.use_scan.all()
    assert tplan.threshold == jplan.threshold
    wi, wd, wh, _ = jp.search(Q, lo, hi)
    gi, gd, gh, _ = tp.search(Q, lo, hi)
    _compare((gi, gd, gh), (wi, wd, wh), exact=False)
    assert (gh[tplan.use_scan] == 0).all()
    # the plan cache answers repeated boxes without re-estimating
    filled = len(tp._plan_cache)
    np.testing.assert_array_equal(tp.plan(lo, hi).card, tplan.card)
    assert len(tp._plan_cache) == filled


@pytest.fixture(scope="module")
def grid_index():
    rng = np.random.default_rng(0x5EED)
    n, d, m = 800, 16, 3
    vecs = (rng.integers(-64, 64, size=(n, d)) / 32).astype(np.float32)
    attrs = rng.integers(0, 16, size=(n, m)).astype(np.float32)
    index = JIndex.build(vecs, attrs, JConfig(M=8, builder="device"))
    q = (rng.integers(-64, 64, size=(16, d)) / 32).astype(np.float32)
    lo = rng.integers(0, 8, size=(16, m)).astype(np.float32)
    hi = lo + rng.integers(2, 12, size=(16, m)).astype(np.float32)
    return index, q, lo, hi


@pytest.mark.parametrize("strategy,E,backend",
                         [("graph", 4, "pallas_gather_l2_filter"),
                          ("graph", 1, "jnp"),
                          ("scan", 1, "pallas_gather_l2_filter"),
                          ("auto", 4, "jnp")])
def test_grid_corpus_bit_equal(grid_index, strategy, E, backend):
    index, q, lo, hi = grid_index
    kw = dict(expand_width=E, strategy=strategy, scan_threshold=150)
    jp = jeng.Planner(index, _params(jeng, backend="jnp", **kw))
    tp = teng.Planner(index, _params(teng, backend=backend, **kw),
                      device="cpu")
    wi, wd, wh, _ = jp.search(q, lo, hi)
    gi, gd, gh, _ = tp.search(q, lo, hi)
    _compare((gi, gd, gh), (wi, wd, wh), exact=True)


def test_make_search_fn_and_unported_options(tiny_index):
    di = teng.device_put_index(tiny_index, device="cpu")
    with pytest.raises(ValueError, match="graph program only"):
        teng.make_search_fn(_params(teng, strategy="auto"))
    # the DFS router (item 3) and the unfused backends (item 8) run:
    # tests/test_torch_backends.py holds them to the reference
    q = np.zeros((2, di.vecs.shape[1]), np.float32)
    lo = np.full((2, di.attrs.shape[1]), -np.inf, np.float32)
    hi = np.full((2, di.attrs.shape[1]), np.inf, np.float32)
    ids, _, hops, _ = teng.Planner(
        di, _params(teng, router="dfs", backend="pallas_gather_l2")) \
        .search(q, lo, hi)
    assert (ids >= 0).all() and (hops > 0).all()
    for backend in ("pallas_l2", "pallas_gather_l2"):
        assert teng.resolve_scorer(backend).name == backend
    # a sharded index (item 13) is served: one shard answers as the index
    # itself does (tests/test_torch_sharded.py holds S > 1 to the reference)
    from repro_torch.core.sharded import stack_shards
    one = stack_shards([tiny_index], device="cpu")
    got = teng.Planner(one, _params(teng)).search(q, lo, hi)
    want = teng.Planner(di, _params(teng)).search(q, lo, hi)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    # hybrid and predicate expressions are ported (tests/test_torch_hybrid.py,
    # tests/test_torch_predicate.py): an empty expression answers nothing
    from repro_torch.core.predicate import Range
    ids, _, _, pplan = teng.Planner(di, _params(teng, strategy="hybrid")) \
        .search_expr(np.zeros((2, di.vecs.shape[1]), np.float32),
                     Range(0, 1.0, 0.0))
    assert (ids == -1).all() and pplan.mode == "boxes"
