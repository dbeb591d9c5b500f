"""The windowed scan's coverage rule on the CPU: ``ref.window_cover_ref``,
the packed (B, ceil(N / 32)) bitmap that the CUDA pre-pass builds, against
a numpy loop over each window's rows and against the rows the JAX
package's windowed oracle lets through; and the windowed scan's plain
version equal to a brute force over the rows that bitmap covers.

Cases: windows that nest across lanes, adjacent windows that share a
32-row word, overlapping windows of one lane, a window that ends exactly
at N and one that runs past it, a window that starts at or past N, a lane
with no window (pads: start < 0, count 0 or negative), one-row windows,
N = 1 and N a multiple of 32, and W = 64 random windows a lane. The
scan's corpus lies on a 1/32 grid, so every distance is exact in f32 and
ids and distances compare bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ref import scan_topk_windows_ref as j_windows_ref

from repro_torch.kernels import ops, ref


def _lanes(N, lanes):
    """(starts, counts) (B, W) int32 from per-lane lists of (start,
    count), padded with (-1, 0)."""
    W = max(1, max(len(w) for w in lanes))
    st = np.full((len(lanes), W), -1, np.int32)
    ct = np.zeros((len(lanes), W), np.int32)
    for b, ws in enumerate(lanes):
        for j, (s, c) in enumerate(ws):
            st[b, j], ct[b, j] = s, c
    return N, st, ct


def _random_lanes(rng, B, N, W):
    lanes = []
    for _ in range(B):
        nw = int(rng.integers(1, W + 1))
        cut = np.sort(rng.choice(N, size=2 * nw, replace=False))
        lanes.append(list(zip(cut[0::2], cut[1::2] - cut[0::2])))
    return lanes


CASES = {
    "nested_across_lanes": lambda rng: _lanes(
        300, [[(0, 200)], [(32, 32), (100, 50)], [(40, 8)], [(101, 1)]]),
    "adjacent_share_a_word": lambda rng: _lanes(
        200, [[(10, 10), (20, 10), (30, 3), (33, 31), (64, 6)],
              [(31, 1), (32, 1)]]),
    "overlapping_in_a_lane": lambda rng: _lanes(
        150, [[(10, 40), (30, 60)], [(70, 5), (0, 100)]]),
    "ends_at_n_and_past_n": lambda rng: _lanes(
        300, [[(250, 50)], [(280, 1000)], [(0, 2**31 - 1)],
              [(299, 1), (298, 2)]]),
    "pads_and_starts_past_n": lambda rng: _lanes(
        100, [[], [(-1, 40), (5, 0), (7, -3)], [(100, 5), (150, 1)],
              [(-5, 0), (3, 4)]]),
    "one_row_windows": lambda rng: _lanes(
        97, [[(0, 1), (5, 1), (31, 1), (32, 1), (63, 1), (96, 1)]]),
    "n_is_one": lambda rng: _lanes(1, [[(0, 1)], [(0, 5)], [], [(1, 1)]]),
    "n_multiple_of_32": lambda rng: _lanes(
        256, [[(0, 256)], [(224, 32)], [(0, 32), (96, 64)]]),
    "w64_random": lambda rng: _lanes(3001, _random_lanes(rng, 37, 3001, 64)),
}


def _case(name):
    return CASES[name](np.random.default_rng(len(name)))


def _numpy_cover(N, st, ct):
    """The bitmap by a loop over each window's rows, as uint32 words."""
    B = st.shape[0]
    words = np.zeros((B, -(-N // 32)), np.uint32)
    for b in range(B):
        for s, c in zip(st[b].tolist(), ct[b].tolist()):
            if s < 0 or c <= 0:
                continue
            for r in range(s, min(s + c, N)):
                words[b, r // 32] |= np.uint32(1 << (r % 32))
    return words


def _unpack(words, N):
    """(B, nwords) int32 words -> (B, N) bool coverage."""
    w = torch.as_tensor(words).to(torch.int64) & 0xFFFFFFFF
    bits = (w[:, :, None] >> torch.arange(32)) & 1
    return bits.reshape(w.shape[0], -1)[:, :N].bool()


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_cover_ref_matches_numpy_loop(name):
    N, st, ct = _case(name)
    got = ref.window_cover_ref(torch.as_tensor(st), torch.as_tensor(ct), N)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (st.shape[0], -(-N // 32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  _numpy_cover(N, st, ct))


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_cover_matches_jax_oracle_rows(name):
    """The JAX oracle over a zero corpus, every box open and k = N returns
    each lane's covered positions (ascending: equal distances go to the
    lowest position) and -1 past them: the same rows as the bitmap."""
    N, st, ct = _case(name)
    B = st.shape[0]
    z = jnp.zeros((N, 4), jnp.float32)
    ids, _ = j_windows_ref(z, jnp.zeros((N, 2), jnp.float32),
                           jnp.zeros((B, 4), jnp.float32),
                           jnp.full((B, 2), -jnp.inf),
                           jnp.full((B, 2), jnp.inf), jnp.asarray(st),
                           jnp.asarray(ct), N)
    ids = np.asarray(ids)
    cov = _unpack(ref.window_cover_ref(torch.as_tensor(st),
                                       torch.as_tensor(ct), N), N).numpy()
    for b in range(B):
        np.testing.assert_array_equal(ids[b][ids[b] >= 0],
                                      np.nonzero(cov[b])[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_windowed_scan_is_the_box_scan_over_covered_rows(name):
    """The windowed scan (the wrapper's CPU path, its plain version) equals
    a brute force over the rows the bitmap covers that pass the box, by
    (distance, position): the rule the CUDA kernel runs."""
    N, st, ct = _case(name)
    B, d, m = st.shape[0], 12, 2
    rng = np.random.default_rng(N + B)
    corpus = torch.as_tensor((rng.integers(-64, 64, (N, d)) / 32)
                             .astype(np.float32))
    attrs = torch.as_tensor(rng.random((N, m)).astype(np.float32))
    attrs[3::7, 1] = float("nan")
    q = torch.as_tensor((rng.integers(-64, 64, (B, d)) / 32)
                        .astype(np.float32))
    lo = torch.as_tensor((rng.random((B, m)) * 0.3).astype(np.float32))
    hi = lo + 0.6
    lo[0], hi[0] = -float("inf"), float("inf")
    starts, counts = torch.as_tensor(st), torch.as_tensor(ct)
    cov = _unpack(ref.window_cover_ref(starts, counts, N), N)
    ok = ((attrs[None] >= lo[:, None]) & (attrs[None] <= hi[:, None])).all(-1)
    dist = ((corpus[None] - q[:, None]) ** 2).sum(-1)
    dist = torch.where(ok & cov, dist, torch.full_like(dist, float("inf")))
    for k in sorted({1, min(10, N), N}):
        want_d, want_i = ref.lex_smallest(dist, k)
        want_i = torch.where(torch.isfinite(want_d), want_i.to(torch.int32),
                             torch.full_like(want_i, -1, dtype=torch.int32))
        got_i, got_d = ops.scan_topk_windows(corpus, attrs, q, lo, hi,
                                             starts, counts, k=k)
        assert torch.equal(got_i, want_i), (name, k)
        assert torch.equal(got_d, want_d), (name, k)
