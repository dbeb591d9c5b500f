"""The port's batched pool and visited ops against the reference's jax ops
vmapped over the batch, slot by slot. Distances come from a small
integer range, so ties are common and the stable-sort order is what the
comparison checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import beam as jb
from repro_torch.core import beam as tb

B, EF, TAIL = 6, 12, 8
P = EF + TAIL


def _pools(seed):
    """A batch of valid pools reached by seeding then merging, in both
    packages (seeded from the same numpy arrays)."""
    rng = np.random.default_rng(seed)
    k = 7
    ids = rng.integers(0, 1000, size=(B, k)).astype(np.int32)
    dists = rng.integers(0, 6, size=(B, k)).astype(np.float32)
    valid = rng.random((B, k)) < 0.8
    valid[0] = False                                      # an empty lane
    ids = np.where(valid, ids, -1).astype(np.int32)
    jp = jax.vmap(lambda i, d, v: jb.pool_seed(P, i, d, v))(
        jnp.asarray(ids), jnp.asarray(dists), jnp.asarray(valid))
    tp = tb.pool_seed(P, torch.as_tensor(ids, dtype=torch.int64),
                      torch.as_tensor(dists), torch.as_tensor(valid))
    return rng, jp, tp


def _same(jp, tp):
    np.testing.assert_array_equal(tp.ids.numpy(), np.asarray(jp.ids))
    np.testing.assert_array_equal(tp.dists.numpy(), np.asarray(jp.dists))
    np.testing.assert_array_equal(tp.expanded.numpy(),
                                  np.asarray(jp.expanded))


def _merge(rng, jp, tp):
    new_ids = rng.integers(0, 1000, size=(B, TAIL)).astype(np.int32)
    new_d = rng.integers(0, 6, size=(B, TAIL)).astype(np.float32)
    new_v = rng.random((B, TAIL)) < 0.7
    jp = jax.vmap(lambda p, i, d, v: jb.pool_merge_tail(p, EF, i, d, v))(
        jp, jnp.asarray(new_ids), jnp.asarray(new_d), jnp.asarray(new_v))
    tp = tb.pool_merge_tail(tp, EF,
                            torch.as_tensor(new_ids, dtype=torch.int64),
                            torch.as_tensor(new_d), torch.as_tensor(new_v))
    return jp, tp


@pytest.mark.parametrize("seed", range(4))
def test_pool_seed_and_merge(seed):
    rng, jp, tp = _pools(seed)
    _same(jp, tp)
    for _ in range(3):
        jp, tp = _merge(rng, jp, tp)
        _same(jp, tp)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("width", [1, 3])
def test_top_unexpanded_and_mark(seed, width):
    rng, jp, tp = _pools(seed)
    for _ in range(4):
        jp, tp = _merge(rng, jp, tp)
        alive_j = jax.vmap(lambda p: jb.pool_frontier_alive(p, EF))(jp)
        np.testing.assert_array_equal(
            tb.pool_frontier_alive(tp, EF).numpy(), np.asarray(alive_j))
        js, ji, jv = jax.vmap(
            lambda p: jb.pool_top_unexpanded(p, EF, width))(jp)
        ts, ti, tv = tb.pool_top_unexpanded(tp, EF, width)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        # slots/ids past the valid ones are don't-care in both packages
        np.testing.assert_array_equal(
            np.where(tv.numpy(), ts.numpy(), -1),
            np.where(np.asarray(jv), np.asarray(js), -1))
        np.testing.assert_array_equal(
            np.where(tv.numpy(), ti.numpy(), -1),
            np.where(np.asarray(jv), np.asarray(ji), -1))
        jp = jax.vmap(jb.pool_mark_expanded_many)(jp, js, jv)
        tp = tb.pool_mark_expanded_many(tp, ts, tv)
        _same(jp, tp)


@pytest.mark.parametrize("seed", range(3))
def test_visited_mark(seed):
    rng = np.random.default_rng(seed)
    n = 40
    ids = rng.integers(0, n, size=(B, 15)).astype(np.int32)
    valid = rng.random((B, 15)) < 0.6
    want = jax.vmap(lambda i, v: jb.visited_mark(jb.visited_init(n), i, v))(
        jnp.asarray(ids), jnp.asarray(valid))
    got = tb.visited_mark(tb.visited_init(B, n, "cpu"),
                          torch.as_tensor(ids, dtype=torch.int64),
                          torch.as_tensor(valid))
    np.testing.assert_array_equal(got[:, :n].numpy(), np.asarray(want))
    assert not got[:, n].any() or (~valid).any()
