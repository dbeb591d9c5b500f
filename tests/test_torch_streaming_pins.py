"""Targeted pins of the port's streaming write path against the
reference's, on the grid corpus and with the side-by-side ``Pair`` of
``tests/test_torch_streaming.py`` (whose docstring gives the contract):
the interleavings under auto, the int8 and bf16 deltas with their rerank,
the delta scan of a graph-only backend, auto-compaction past capacity, the refused epoch swap, the planner's
tombstone-adjusted bound, fresh ids on re-insert, hybrid on a tombstoned
base, compiled predicates under streaming and a no-op compaction."""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                    # pragma: no cover
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import engine as jeng
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.predicate import Or, Range
from repro.core.query_ref import Predicate
from repro.serve import KHIService as JService, ServeConfig as JServeConfig

from repro_torch.core import engine as teng
from repro_torch.core.khi import KHIConfig, KHIIndex
from repro_torch.core.predicate import Or as TOr, Range as TRange
from repro_torch.serve import KHIService, ServeConfig

from test_torch_streaming import (KW, Pair, _boxes, _grid_attrs,
                                  _grid_vecs, _run_interleaving)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_interleaving_auto_matches_reference(seed):
    _run_interleaving(seed, "auto", scan_threshold=12)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("backend", ["jnp", "pallas_gather_l2_filter"])
def test_quantized_delta_reranks_like_reference(quant, backend):
    """The int8 and bf16 deltas through the quantized scan and its f32
    rerank: ``rerank_mult=64`` over-fetches every candidate at this size,
    so the answers must equal the oracle's as well as the reference's."""
    pair = _run_interleaving(1234, "scan", backend=backend, quant=quant,
                             rerank_mult=64)
    seg = pair.ts._stream.delta
    assert seg.qvecs.dtype == {"bf16": torch.bfloat16,
                               "int8": torch.int8}[quant]
    assert (seg.qscale is None) == (quant == "bf16")


@pytest.mark.parametrize("backend", ["pallas_gather_l2", "pallas_l2", "jnp"])
def test_graph_service_scans_delta_through_kernel_wrapper(backend,
                                                          monkeypatch):
    """A graph service whose scorer has no scan form scans its delta
    through the box-scan kernel's wrapper (the kernel on the card, its
    plain version here), with the reference's answers; only the plain
    backend calls the plain version directly."""
    from repro_torch.kernels import ops

    calls = []
    scan_topk = ops.scan_topk

    def counted(*a, **kw):
        calls.append(1)
        return scan_topk(*a, **kw)

    monkeypatch.setattr(ops, "scan_topk", counted)
    _run_interleaving(77, "graph", backend=backend, n_ops=8)
    assert bool(calls) == (backend != "jnp")


def test_insert_past_capacity_auto_compacts():
    rng = np.random.default_rng(11)
    vecs, attrs = _grid_vecs(rng, 64), _grid_attrs(rng, 64)
    pair = Pair(vecs, attrs, 16)
    for _ in range(5):
        pair.insert(_grid_vecs(rng, 8), _grid_attrs(rng, 8))
    assert pair.ts.snapshot()["compactions"] >= 2
    pair.check(np.random.default_rng(12))
    for svc in (pair.ts, pair.js):
        with pytest.raises(ValueError, match="capacity"):
            svc.insert(_grid_vecs(rng, 17), _grid_attrs(rng, 17))


def test_swap_index_refused_while_streaming():
    rng = np.random.default_rng(3)
    vecs, attrs = _grid_vecs(rng, 64), _grid_attrs(rng, 64)
    ts = KHIService(KHIIndex.build(vecs, attrs, KHIConfig(M=8,
                                                          builder="device"),
                                   device="cpu"),
                    teng.SearchParams(**KW, strategy="scan"), device="cpu")
    with pytest.raises(RuntimeError, match="enable_streaming"):
        ts.insert(_grid_vecs(rng, 1), _grid_attrs(rng, 1))
    ts.enable_streaming(capacity=8)
    ts.insert(_grid_vecs(rng, 2), _grid_attrs(rng, 2))
    with pytest.raises(RuntimeError, match="compact"):
        ts.swap_index(KHIIndex.build(vecs, attrs,
                                     KHIConfig(M=8, builder="device"),
                                     device="cpu"))
    with pytest.raises(RuntimeError, match="already enabled"):
        ts.enable_streaming()
    ts.compact()                      # the sanctioned publisher still works
    assert ts.epoch == 1 and ts.snapshot()["n_live"] == 66


def test_auto_card_excludes_tombstones():
    """strategy="auto": deleting every row of a box lowers its routing
    bound as the reference's does, and the answer is all -1."""
    rng = np.random.default_rng(5)
    vecs, attrs = _grid_vecs(rng, 200), _grid_attrs(rng, 200)
    pair = Pair(vecs, attrs, 32, strategy="auto", scan_threshold=64,
                buckets=(4,), cache_size=0)
    lo = np.array([[0.0, 0.0]], np.float32)
    hi = np.array([[3.0, 3.0]], np.float32)
    in_box = ((attrs >= lo[0]) & (attrs <= hi[0])).all(axis=1)
    assert in_box.sum() > 0
    card0 = pair.ts._planner.plan(lo, hi).card[0]
    assert card0 == pair.js._planner.plan(lo, hi).card[0] >= in_box.sum()
    pair.delete(np.nonzero(in_box)[0])
    card1 = pair.ts._planner.plan(lo, hi).card[0]
    assert card1 == pair.js._planner.plan(lo, hi).card[0]
    assert card1 <= card0 - in_box.sum()
    for svc in (pair.ts, pair.js):
        ids, dists = svc.search(vecs[:1], lo, hi)
        assert np.all(ids == -1) and np.all(np.isinf(dists))


def test_delete_then_reinsert_gets_fresh_ext():
    rng = np.random.default_rng(9)
    vecs, attrs = _grid_vecs(rng, 64), _grid_attrs(rng, 64)
    pair = Pair(vecs, attrs, 16)
    pair.delete([7])
    pair.insert(vecs[7:8], attrs[7:8])
    assert pair.oracle.next_ext == 65
    pair.compact()
    for svc in (pair.ts, pair.js):
        assert svc.delete([7]) == 0       # still dead after the fold
        assert svc.delete([64]) == 1      # the re-insert dies apart
    pair.oracle.delete([64])
    pair.check(np.random.default_rng(10))


def test_hybrid_on_tombstoned_base_matches_reference():
    """strategy="hybrid" after base and delta deletes and inserts: the
    tombstoned windows, the refreshed position-ordered attrs and the
    adjusted estimator give the reference's ids, distances and hops."""
    rng = np.random.default_rng(21)
    vecs, attrs = _grid_vecs(rng, 300), _grid_attrs(rng, 300)
    pair = Pair(vecs, attrs, 64, strategy="hybrid", node_scan_threshold=12,
                buckets=(8,))
    pos_vecs = pair.ts._planner._pos_vecs
    pair.delete(rng.choice(300, size=60, replace=False))
    assert pair.ts._planner._pos_vecs is pos_vecs   # the vectors kept
    assert torch.isnan(pair.ts._planner._pos_attrs).any()
    pair.insert(_grid_vecs(rng, 20), _grid_attrs(rng, 20))
    pair.delete(np.arange(300, 305))
    for s in range(3):
        pair.check(np.random.default_rng(100 + s), nq=8)
    plan = pair.ts._planner.plan(*_boxes(np.random.default_rng(7), 8))
    assert plan.mode is not None


def test_search_expr_under_streaming():
    """Box-mode expressions serve each disjoint box through the merged
    path and answer int64 ext ids equal to the reference's; a bitmask
    program raises the reference's ValueError on both."""
    rng = np.random.default_rng(13)
    vecs, attrs = _grid_vecs(rng, 150), _grid_attrs(rng, 150)
    pair = Pair(vecs, attrs, 32, box_budget=4)
    pair.insert(_grid_vecs(rng, 10), _grid_attrs(rng, 10))
    pair.delete([3, 5, 151])
    Q = _grid_vecs(rng, 5)
    jexpr = Or((Range(0, 0.0, 4.0), Range(0, 9.0, 15.0)))
    texpr = TOr((TRange(0, 0.0, 4.0), TRange(0, 9.0, 15.0)))
    wi, wd = pair.js.search_expr(Q, jexpr)
    gi, gd = pair.ts.search_expr(Q, texpr)
    assert gi.dtype == np.int64
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    for i in range(len(Q)):
        np.testing.assert_array_equal(gi[i][gi[i] >= 0],
                                      pair.oracle.query_expr(Q[i], jexpr, 8))
    wide = [(float(v), float(v)) for v in range(0, 16, 2)]
    jb = Or(tuple(Range(0, a, b) for a, b in wide))
    tb = TOr(tuple(TRange(0, a, b) for a, b in wide))
    with pytest.raises(ValueError, match="bitmask"):
        pair.js.search_expr(Q, jb)
    with pytest.raises(ValueError, match="bitmask"):
        pair.ts.search_expr(Q, tb)


@pytest.mark.parametrize("strategy", ["graph", "auto"])
def test_noop_compact_keeps_answers(strategy):
    """Compacting an empty delta with no tombstones publishes an epoch
    whose ids, distances and hops equal the live reference service's (not
    the golden file, whose distances drift under this jax)."""
    rng = np.random.default_rng(17)
    vecs, attrs = _grid_vecs(rng, 200), _grid_attrs(rng, 200)
    p = dict(k=10, ef=32, c_e=10, c_n=16, strategy=strategy,
             scan_threshold=16)
    js = JService(JIndex.build(vecs, attrs, JConfig(M=8, builder="device")),
                  jeng.SearchParams(backend="jnp", **p),
                  config=JServeConfig(buckets=(8,), cache_size=0))
    ts = KHIService(KHIIndex.build(vecs, attrs,
                                   KHIConfig(M=8, builder="device"),
                                   device="cpu"),
                    teng.SearchParams(backend="pallas_gather_l2_filter", **p),
                    config=ServeConfig(buckets=(8,), cache_size=0),
                    device="cpu")
    ts.enable_streaming(capacity=16,
                        build_config=KHIConfig(M=8, builder="device"))
    ts.compact()
    snap = ts.snapshot()
    assert ts.epoch == 1 and snap["tombstones"] == 0 \
        and snap["delta_fill"] == [0] and snap["n_live"] == 200
    Q = _grid_vecs(rng, 8)
    lo, hi = _boxes(rng, 8)
    wi, wd = js.search(Q, lo, hi)
    gi, gd = ts.search(Q, lo, hi)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    preds = [Predicate(lo[i], hi[i]) for i in range(8)]
    want_h = (jeng.search_batch(js.index, Q, preds, js.params)[2]
              if strategy == "graph" else js._planner.search(Q, lo, hi)[2])
    np.testing.assert_array_equal(ts._planner.search(Q, lo, hi)[2], want_h)
