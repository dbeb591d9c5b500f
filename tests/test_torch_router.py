"""The port's compacted level router and chunked cardinality estimator
against the reference's dense forms: equal entries (ids and order) and
equal cards, at the derived frontier width and at undersized widths and
windows (``on_undersized="ignore"``), where both must drop the same
branches and miss the same entries."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import engine as jeng
from repro.core import router as jr
from repro.data import make_queries

from repro_torch.core import engine as teng
from repro_torch.core import router as tr


@pytest.fixture(scope="module")
def both(tiny_index):
    return (jeng.device_put_index(tiny_index),
            teng.device_put_index(tiny_index, device="cpu"))


def _boxes(tiny_data, seed):
    vecs, attrs = tiny_data
    out = []
    for i, sigma in enumerate((1 / 2, 1 / 16, 1 / 128)):
        _, preds = make_queries(vecs, attrs, n_queries=6, sigma=sigma,
                                seed=seed + i)
        out += preds
    lo = np.stack([p.lo for p in preds] + [p.lo for p in out])
    hi = np.stack([p.hi for p in preds] + [p.hi for p in out])
    m = attrs.shape[1]
    lo = np.concatenate([lo, np.full((1, m), np.inf), np.full((1, m),
                                                              -np.inf)])
    hi = np.concatenate([hi, np.full((1, m), -np.inf), np.full((1, m),
                                                               np.inf)])
    return lo.astype(np.float32), hi.astype(np.float32)


def _route(both, lo, hi, p_j, p_t):
    dj, dt = both
    fn = jax.jit(jax.vmap(lambda a, b: jr.route_level_sync(dj, a, b, p_j)))
    je, jc = fn(jnp.asarray(lo), jnp.asarray(hi))
    te, tc = tr.route_level_sync(dt, torch.as_tensor(lo),
                                 torch.as_tensor(hi), p_t)
    return (np.asarray(je), np.asarray(jc)), (te.numpy(), tc.numpy())


@pytest.mark.parametrize("seed", [0, 100])
def test_route_level_sync_equal_at_derived_cap(tiny_data, both, seed):
    lo, hi = _boxes(tiny_data, seed)
    p_j = jeng.derive_search_params(jeng.SearchParams(c_e=10), both[0])
    p_t = teng.derive_search_params(teng.SearchParams(c_e=10), both[1])
    assert p_t.frontier_cap == p_j.frontier_cap
    (je, jc), (te, tc) = _route(both, lo, hi, p_j, p_t)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tc, jc)
    assert (te[-2] == -1).all() and tc[-2] == 0          # empty box
    assert (te >= 0).any(axis=1)[:-2].any()


@pytest.mark.parametrize("cap,budget,c_e", [(4, 64, 10), (16, 2, 10),
                                            (1, 1, 3), (32, 8, 25)])
def test_route_level_sync_equal_when_undersized(tiny_data, both, cap,
                                                budget, c_e):
    lo, hi = _boxes(tiny_data, 7)
    kw = dict(c_e=c_e, ef=32, frontier_cap=cap, scan_budget=budget)
    (je, jc), (te, tc) = _route(both, lo, hi, jeng.SearchParams(**kw),
                                teng.SearchParams(**kw))
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tc, jc)


def test_validate_ignore_keeps_undersized_params(both):
    p = teng.SearchParams(frontier_cap=4, scan_budget=2)
    assert teng.validate_search_params(p, both[1],
                                       on_undersized="ignore") is p
    with pytest.raises(ValueError, match="frontier_cap is unset"):
        tr.route_level_sync(both[1], torch.zeros((1, 3)),
                            torch.ones((1, 3)), teng.SearchParams())


@pytest.mark.parametrize("chunk", [1, 5, None])
def test_card_estimator_chunked_equals_reference(tiny_index, tiny_data,
                                                 chunk):
    lo, hi = _boxes(tiny_data, 3)
    t = tiny_index.tree
    args = (t.left, t.right, t.dim, t.bl, t.lo, t.hi, t.count,
            int(np.nonzero(t.parent < 0)[0][0]))
    want = jr.HostCardEstimator(*args).cards(lo, hi)
    got = tr.HostCardEstimator(*args, device="cpu").cards(lo, hi,
                                                          chunk=chunk)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tr.HostCardEstimator(*args, chunk_elems=1).antichain(lo, hi).numpy(),
        jr.HostCardEstimator(*args).antichain(lo, hi))


def test_deleted_per_node_and_frontier_cap(tiny_index, both):
    t = tiny_index.tree
    rows = np.random.default_rng(0).choice(t.n, size=50, replace=False)
    np.testing.assert_array_equal(
        tr.deleted_per_node(t.order, t.start, t.count, rows),
        jr.deleted_per_node(t.order, t.start, t.count, rows))
    assert tr.required_frontier_cap(both[1]) == \
        jr.required_frontier_cap(both[0])
