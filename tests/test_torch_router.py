"""The port's compacted level router, batched stack DFS and chunked
cardinality estimator against the reference's dense forms: equal entries
(ids and order) and equal cards, at the derived frontier width and stack
depth and at undersized widths, depths, windows and pop budgets
(``on_undersized="ignore"``), where both must drop the same branches and
miss the same entries. The DFS is also held to the host twin
``query_ref.range_filter``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import engine as jeng
from repro.core import router as jr
from repro.core.query_ref import Predicate as JPredicate, range_filter
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


def _route_dfs(both, lo, hi, p_j, p_t):
    dj, dt = both
    fn = jax.jit(jax.vmap(lambda a, b: jr.route_dfs(dj, a, b, p_j)))
    je, jc = fn(jnp.asarray(lo), jnp.asarray(hi))
    te, tc, steps = tr.route_dfs(dt, torch.as_tensor(lo),
                                 torch.as_tensor(hi), p_t, with_steps=True)
    return (np.asarray(je), np.asarray(jc)), (te.numpy(), tc.numpy()), steps


@pytest.mark.parametrize("seed", [0, 100])
def test_route_dfs_equal_at_derived_params(tiny_index, tiny_data, both,
                                           seed):
    """At the derived stack depth and window the DFS gives the reference
    DFS's entries and count sums, the host twin's entries, and the level
    router's entries (the reference pins the two routers equal)."""
    lo, hi = _boxes(tiny_data, seed)
    p_j = jeng.derive_search_params(jeng.SearchParams(c_e=10,
                                                      router="dfs"), both[0])
    p_t = teng.derive_search_params(teng.SearchParams(c_e=10,
                                                      router="dfs"), both[1])
    assert (p_t.stack_cap, p_t.scan_budget) == (p_j.stack_cap,
                                                p_j.scan_budget)
    (je, jc), (te, tc), steps = _route_dfs(both, lo, hi, p_j, p_t)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tc, jc)
    assert (te[-2] == -1).all() and tc[-2] == 0          # empty box
    assert (steps < p_t.max_steps).all()
    for i in range(len(lo)):
        want = range_filter(tiny_index, JPredicate(lo[i], hi[i]), 10,
                            scan_budget=p_t.scan_budget)
        assert te[i][te[i] >= 0].tolist() == want
    p_lvl = teng.derive_search_params(teng.SearchParams(c_e=10), both[1])
    le, _ = tr.route_level_sync(both[1], torch.as_tensor(lo),
                                torch.as_tensor(hi), p_lvl)
    np.testing.assert_array_equal(te, le.numpy())


@pytest.mark.parametrize("stack,budget,steps,c_e",
                         [(2, 64, 4096, 10), (6, 2, 4096, 10),
                          (1, 1, 4096, 3), (40, 64, 3, 10),
                          (3, 8, 17, 25)])
def test_route_dfs_equal_when_undersized(tiny_data, both, stack, budget,
                                         steps, c_e):
    """Undersized stack (pushes past it drop and the pointer clamps),
    window and pop budget: the same entries and count sums as the
    reference."""
    lo, hi = _boxes(tiny_data, 7)
    kw = dict(c_e=c_e, ef=32, stack_cap=stack, scan_budget=budget,
              max_steps=steps, router="dfs")
    p_t = teng.SearchParams(**kw)
    assert teng.validate_search_params(p_t, both[1],
                                       on_undersized="ignore") is p_t
    (je, jc), (te, tc), n_pops = _route_dfs(both, lo, hi,
                                            jeng.SearchParams(**kw), p_t)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tc, jc)
    assert (n_pops <= steps).all()


def test_resolve_router(both):
    assert tr.resolve_router("level") is tr.route_level_sync
    assert tr.resolve_router("dfs") is tr.route_dfs
    with pytest.raises(ValueError, match="unknown router"):
        tr.resolve_router("bfs")
    with pytest.raises(ValueError, match="stack_cap >= 1"):
        tr.route_dfs(both[1], torch.zeros((1, 3)), torch.ones((1, 3)),
                     teng.SearchParams(stack_cap=0))
