"""The port's data generators, tree, device graph builder, npz format and
DeviceIndex against the JAX package: the same seed and inputs give equal
arrays. The builder comparison runs on a 1/32-grid corpus, where every
squared distance is exact in f32 whatever the reduce order, so the
neighbour lists must agree bit for bit, ties included."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core import build_device as jbd
from repro.core import engine as jeng
from repro.core.khi import KHIConfig as JConfig, KHIIndex as JIndex
from repro.core.tree import build_tree as jbuild_tree
from repro.data import synthetic as jsyn

from repro_torch.core import build_device as tbd
from repro_torch.core import engine as teng
from repro_torch.core.khi import KHIConfig, KHIIndex
from repro_torch.core.tree import build_tree
from repro_torch.data import synthetic as tsyn

from test_torch_hnsw import _marked_visited_fresh

TREE_FIELDS = ("left", "right", "parent", "dim", "split", "bl", "level",
               "lo", "hi", "order", "start", "count", "path")


def _grid_corpus(seed, n=600, d=16, m=3):
    rng = np.random.default_rng(seed)
    vecs = (rng.integers(-64, 64, size=(n, d)) / 32).astype(np.float32)
    attrs = rng.integers(0, 16, size=(n, m)).astype(np.float32)
    return vecs, attrs


@pytest.mark.parametrize("preset", ["youtube", "dblp", "msmarco", "laion"])
def test_make_dataset_and_queries_equal(preset):
    spec = dataclasses.replace(jsyn.DATASET_PRESETS[preset], n=700, d=20)
    tspec = tsyn.DatasetSpec(**dataclasses.asdict(spec))
    jv, ja = jsyn.make_dataset(spec)
    tv, ta = tsyn.make_dataset(tspec)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(ja, ta)
    jq, jp = jsyn.make_queries(jv, ja, n_queries=6, sigma=1 / 8, seed=5)
    tq, tp = tsyn.make_queries(tv, ta, n_queries=6, sigma=1 / 8, seed=5)
    np.testing.assert_array_equal(jq, tq)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a.lo, b.lo)
        np.testing.assert_array_equal(a.hi, b.hi)


@pytest.mark.parametrize("tau,leaf", [(3.0, 2), (1.5, 4)])
def test_build_tree_equal(tiny_data, tau, leaf):
    _, attrs = tiny_data
    a = jbuild_tree(attrs, tau=tau, leaf_capacity=leaf)
    b = build_tree(attrs, tau=tau, leaf_capacity=leaf)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    b.validate()


@pytest.mark.parametrize("dist", ["jnp", "pallas"])
@pytest.mark.parametrize("large_node", [4096, 96])
def test_build_graphs_device_equal_on_grid(dist, large_node):
    """``dist="pallas"`` is the kernel wrapper (its plain version on the
    CPU); ``large_node=96`` sends the top nodes through the row-blocked
    path (the reference pads their columns, the port does not)."""
    vecs, attrs = _grid_corpus(7)
    tree = jbuild_tree(attrs)
    want = jbd.build_graphs_device(tree, vecs, M=8, dist="jnp",
                                   large_node=large_node, row_block=64)
    got = tbd.build_graphs_device(tree, vecs, M=8, dist=dist,
                                  large_node=large_node, row_block=40,
                                  device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_khi_build_device_equal_on_grid(monkeypatch):
    vecs, attrs = _grid_corpus(11, n=500)
    want = JIndex.build(vecs, attrs, JConfig(M=8, builder="device"))
    got = KHIIndex.build(vecs, attrs, KHIConfig(M=8, builder="device"),
                         device="cpu")
    np.testing.assert_array_equal(got.nbrs_numpy(), want.nbrs)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(got.tree, f),
                                      getattr(want.tree, f))
    # the default builder (Algorithm 5, "incremental") equals the
    # reference's run with its visited mark repaired (ROADMAP F6)
    monkeypatch.setattr(jbeam, "np_visited_fresh_mark", _marked_visited_fresh)
    default = KHIIndex.build(vecs, attrs, KHIConfig(M=8), device="cpu")
    np.testing.assert_array_equal(default.nbrs_numpy(),
                                  JIndex.build(vecs, attrs,
                                               JConfig(M=8)).nbrs)


def test_npz_round_trip_and_device_index(tiny_index, tmp_path):
    """A JAX-saved index loads into the port, and the port's DeviceIndex
    holds the same values as the JAX one; the port's save loads back in
    the JAX package."""
    path = str(tmp_path / "idx.npz")
    tiny_index.save(path)
    loaded = KHIIndex.load(path)
    assert loaded.config == KHIConfig(**dataclasses.asdict(
        tiny_index.config))
    want = jeng.device_put_index(tiny_index)
    for di in (teng.device_put_index(loaded, device="cpu"),
               teng.device_put_index(tiny_index, device="cpu")):
        for f in ("vecs", "attrs", "nbrs", "left", "right", "dim", "bl",
                  "lo", "hi", "start", "count", "order"):
            np.testing.assert_array_equal(getattr(di, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert di.root == int(want.root)
        assert di.n == want.n and di.height == want.height
    path2 = str(tmp_path / "idx2.npz")
    loaded.save(path2)
    back = JIndex.load(path2)
    np.testing.assert_array_equal(back.nbrs, tiny_index.nbrs)
    np.testing.assert_array_equal(back.tree.order, tiny_index.tree.order)


def test_search_params_validation_matches_reference(tiny_index):
    di_t = teng.device_put_index(tiny_index, device="cpu")
    di_j = jeng.device_put_index(tiny_index)
    p = teng.SearchParams(k=10, ef=32, c_n=16)
    jp = jeng.SearchParams(k=10, ef=32, c_n=16)
    got = teng.derive_search_params(p, di_t)
    want = jeng.derive_search_params(jp, di_j)
    assert (got.scan_budget, got.stack_cap, got.frontier_cap) == (
        want.scan_budget, want.stack_cap, want.frontier_cap)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="undersized"):
        teng.validate_search_params(p, di_t)
    with pytest.raises(ValueError, match="incompatible"):
        teng.validate_search_params(
            dataclasses.replace(p, strategy="scan", backend="pallas_l2"),
            di_t)
    for bad in (dict(expand_width=0), dict(c_e=40), dict(strategy="x"),
                dict(quant="fp4"), dict(router="bfs")):
        with pytest.raises(ValueError):
            teng.SearchParams(ef=32, **bad)
