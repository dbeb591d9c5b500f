"""The port's baselines (iRangeGraph, Prefiltering, Postfiltering), its
index sizes, and the incremental builder reached through ``build_sharded``
and a streaming compaction, against the JAX package.

Graphs are built on a 1/32-grid corpus (exact squared distances in f32 in
any order), so the port's and the reference's agree bit for bit. Every
comparison runs the reference with its visited mark repaired (ROADMAP
Queue 3, F6; ``tests/test_torch_hnsw.py``). A baseline's fields, taken as
numpy arrays from the JAX-built baseline, build the port's directly: that
checks each query apart from its build."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core import engine as jeng
from repro.core.baselines import (IRangeGraph as JIRange,
                                  Postfiltering as JPost,
                                  Prefiltering as JPre)
from repro.core.baselines.irange import _build_segment_tree as jseg
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.query_ref import Predicate as JPred
from repro.core.sharded import build_sharded as jbuild_sharded
from repro.serve import KHIService as JService, ServeConfig as JServeConfig

from repro_torch.core import engine as teng
from repro_torch.core.baselines import IRangeGraph, Postfiltering, \
    Prefiltering
from repro_torch.core.baselines.irange import _build_segment_tree
from repro_torch.core.khi import KHIConfig, KHIIndex
from repro_torch.core.query_ref import Predicate
from repro_torch.core.sharded import build_sharded
from repro_torch.serve import KHIService, ServeConfig

from test_torch_hnsw import _marked_visited_fresh

TREE_FIELDS = ("left", "right", "parent", "dim", "split", "bl", "level",
               "lo", "hi", "order", "start", "count", "path")


@pytest.fixture(autouse=True)
def _repaired_reference(monkeypatch):
    monkeypatch.setattr(jbeam, "np_visited_fresh_mark", _marked_visited_fresh)


def _grid(seed, n, d=16, m=3):
    rng = np.random.default_rng(seed)
    vecs = (rng.integers(-64, 64, size=(n, d)) / 32).astype(np.float32)
    attrs = rng.integers(0, 16, size=(n, m)).astype(np.float32)
    return vecs, attrs


def _boxes(seed, b, m=3):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 10, size=(b, m)).astype(np.float32)
    hi = lo + rng.integers(2, 12, size=(b, m)).astype(np.float32)
    return lo, hi


@pytest.fixture(scope="module")
def grid_case():
    vecs, attrs = _grid(21, 500)
    rng = np.random.default_rng(22)
    Q = (rng.integers(-64, 64, size=(12, 16)) / 32).astype(np.float32)
    lo, hi = _boxes(23, 12)
    return vecs, attrs, Q, lo, hi


@pytest.mark.parametrize("leaf", [1, 7, 32])
def test_segment_tree_equal(leaf):
    vals = np.random.default_rng(leaf).integers(0, 40, 300).astype(
        np.float32)
    a, b = jseg(vals, leaf), _build_segment_tree(vals, leaf)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f)
    assert (a.tau, a.leaf_capacity, a.m) == (b.tau, b.leaf_capacity, b.m)
    b.validate()


@pytest.mark.parametrize("decay", [0.9, 0.5])
def test_irange_equal(grid_case, decay):
    vecs, attrs, Q, lo, hi = grid_case
    kw = dict(index_attr=1, M=8, leaf_size=16, merge_chunk=16)
    want = JIRange.build(vecs, attrs, **kw)
    got = IRangeGraph.build(vecs, attrs, device="cpu", **kw)
    np.testing.assert_array_equal(got.nbrs, want.nbrs)
    np.testing.assert_array_equal(got.sorted_vals, want.sorted_vals)
    assert got.graph_size_bytes() == want.graph_size_bytes()
    carried = IRangeGraph(**{f.name: getattr(want, f.name)
                             for f in dataclasses.fields(JIRange)})
    for i in range(len(Q)):
        w = want.query(Q[i], JPred(lo[i], hi[i]), 5, ef=24, decay=decay,
                       seed=i)
        for idx in (got, carried):
            ids, st = idx.query(Q[i], Predicate(lo[i], hi[i]), 5, ef=24,
                                decay=decay, seed=i, return_stats=True)
            np.testing.assert_array_equal(ids, w)
            assert st["hops"] > 0
            assert Predicate(lo[i], hi[i]).matches(attrs[ids]).all()


def test_irange_bulk_equal():
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    attrs = rng.random((600, 2)).astype(np.float32)
    want = JIRange.build(vecs, attrs, M=8, builder="bulk")
    got = IRangeGraph.build(vecs, attrs, M=8, builder="bulk", device="cpu")
    np.testing.assert_array_equal(got.nbrs, want.nbrs)
    assert got.graph_size_bytes() == want.graph_size_bytes()


def test_prefiltering_equal_on_floats(tiny_data):
    vecs, attrs = tiny_data
    want = JPre.build(vecs, attrs)
    got = Prefiltering.build(vecs, attrs, device="cpu")
    rng = np.random.default_rng(5)
    for i in range(16):
        q = rng.standard_normal(vecs.shape[1]).astype(np.float32)
        c = attrs[rng.integers(0, len(attrs))]
        w = rng.random(attrs.shape[1]).astype(np.float32) * 2
        lo, hi = c - w, c + w
        ids = got.query(q, Predicate(lo, hi), 10)
        assert ids.dtype == np.int64
        np.testing.assert_array_equal(ids, want.query(q, JPred(lo, hi), 10))
    empty = Predicate(np.full(attrs.shape[1], 9e9), np.full(attrs.shape[1],
                                                             9e9 + 1))
    assert got.query(vecs[0], empty, 10).shape == (0,)


def test_postfiltering_equal(grid_case):
    vecs, attrs, Q, lo, hi = grid_case
    want = JPost.build(vecs, attrs, M=8)
    got = Postfiltering.build(vecs, attrs, M=8, device="cpu")
    np.testing.assert_array_equal(got.adj, want.adj)
    carried = Postfiltering(want.vecs, want.attrs, want.adj, device="cpu")
    for i in range(len(Q)):
        w = want.query(Q[i], JPred(lo[i], hi[i]), 5, ef=32)
        for idx in (got, carried):
            np.testing.assert_array_equal(
                idx.query(Q[i], Predicate(lo[i], hi[i]), 5, ef=32), w)


def test_sizes_equal_on_the_reference_index(tiny_index):
    """The reference's own index carried across: the same sizes."""
    t = tiny_index
    got = KHIIndex(vecs=t.vecs, attrs=t.attrs, tree=t.tree,
                   nbrs=torch.as_tensor(t.nbrs), config=KHIConfig(
                       **dataclasses.asdict(t.config)))
    assert got.graph_size_bytes() == t.graph_size_bytes()
    assert got.total_size_bytes() == t.total_size_bytes()


def test_build_sharded_incremental_equal():
    vecs, attrs = _grid(31, 400)
    want = jbuild_sharded(vecs, attrs, 2, JConfig(M=8))
    got = build_sharded(vecs, attrs, 2, KHIConfig(M=8), device="cpu")
    np.testing.assert_array_equal(got.di.nbrs.numpy(),
                                  np.asarray(want.di.nbrs))
    np.testing.assert_array_equal(got.di.order.numpy(),
                                  np.asarray(want.di.order))


def _jax_compact(js):
    """The reference's ``compact`` with no tombstones handed to the new
    epoch's planner (ROADMAP Queue 3, F5; ``test_torch_streaming.py``)."""
    stream = js._stream
    stream.deleted_locals = lambda: [np.zeros(0, np.int64)] * stream.S
    try:
        js.compact()
    finally:
        del stream.deleted_locals


def test_streaming_compaction_incremental_equal():
    """One compaction under ``KHIConfig(builder="incremental")``: the new
    epoch's graph and answers equal the JAX service's."""
    vecs, attrs = _grid(41, 260, m=2)
    kw = dict(k=6, ef=24, c_n=16, expand_width=4, strategy="graph")
    js = JService(JIndex.build(vecs, attrs, JConfig(M=8)),
                  jeng.SearchParams(backend="jnp", **kw),
                  config=JServeConfig(buckets=(4, 8)))
    ts = KHIService(KHIIndex.build(vecs, attrs, KHIConfig(M=8),
                                   device="cpu"),
                    teng.SearchParams(**kw), config=ServeConfig(
                        buckets=(4, 8)), device="cpu")
    js.enable_streaming(capacity=64, build_config=JConfig(M=8))
    ts.enable_streaming(capacity=64, build_config=KHIConfig(M=8))
    nv, na = _grid(42, 40, m=2)
    np.testing.assert_array_equal(ts.insert(nv, na), js.insert(nv, na))
    dead = np.arange(0, 300, 7)
    assert ts.delete(dead) == js.delete(dead)
    _jax_compact(js)
    ts.compact()
    assert ts.epoch == js.epoch
    np.testing.assert_array_equal(ts.index.nbrs.cpu().numpy(),
                                  np.asarray(js.index.nbrs))
    rng = np.random.default_rng(43)
    Q = (rng.integers(-64, 64, size=(8, 16)) / 32).astype(np.float32)
    lo, hi = _boxes(44, 8, m=2)
    gi, gd = ts.search(Q, lo, hi)
    wi, wd = js.search(Q, lo, hi)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
