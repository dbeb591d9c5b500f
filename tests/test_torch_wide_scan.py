"""The wide scan forms' candidate-list pipeline (``scan_topk_wide.cu``'s
box, windowed and bitmask forms) as its plain twin
(``ref.wide_select_twin``): the threshold from a sample of row tiles, the
candidate lists of a given capacity, the exact re-pass of a query whose
list overflows and the (distance, id) select, held to the plain versions
(``ref.scan_topk_ref``, ``scan_topk_q8_ref``, ``scan_topk_mask_ref``,
``scan_topk_windows_ref``), to the JAX package's plain windowed
reference and to its Pallas kernels in interpret mode; then the
wrapper's scratch and capacity plan (``ops._wide_plan``), which is pure
Python.

Tolerances: on 1/32-grid inputs every squared distance is exact in f32
whatever the reduce order, so distances are compared bit for bit; on
float inputs rtol = atol = 1e-5 against the JAX kernels (other reduce
orders), bit for bit against the plain versions (the same arithmetic).
Ids are always equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ref import scan_topk_windows_ref as j_windows_ref
from repro.kernels.scan_topk import (scan_topk_mask_raw, scan_topk_q8_raw,
                                     scan_topk_raw, scan_topk_windows_raw)

from repro_torch.kernels import ops, ref
from test_torch_cuda import _windows

N, D, B = 450, 24, 10
KS = (65, 100, 400, N)
MS = (4, 9, 12)
# (sample stride, tile height): the card's box pass (16 tiles of 256
# rows: at N = 450 its sample is the first tile) and a finer one whose
# sample spreads over the corpus
SAMPLES = ((16, 256), (4, 32))


def _grid(rng, shape):
    return (rng.integers(-64, 65, size=shape) / 32).astype(np.float32)


def _case(seed, m, grid=True):
    """A corpus, its int8 replica, attrs and boxes: lanes 0-3 an empty,
    an all-pass (every row but the NaN ones), a 20-row and a one-row box;
    the rest a range of attr 0 and wide boxes on the others."""
    rng = np.random.default_rng(seed)
    corpus = (_grid(rng, (N, D)) if grid
              else rng.standard_normal((N, D)).astype(np.float32))
    qv = rng.integers(-32, 33, size=(N, D)).astype(np.int8)
    qs = rng.choice([1 / 16, 1 / 32], size=(N, 1)).astype(np.float32)
    a = rng.random((N, m)).astype(np.float32)
    a[:, 0] = rng.permutation(N)
    a[5::41, 1] = np.nan
    lo = (rng.random((B, m)) * 0.05).astype(np.float32)
    hi = lo + 0.97
    lo[:, 0] = rng.integers(0, N // 2, size=B)
    hi[:, 0] = lo[:, 0] + rng.integers(20, N, size=B)
    lo[0, 0], hi[0, 0] = 1.0, 0.0                    # empty
    lo[1], hi[1] = -1.0, float(N)                    # all but NaN rows
    lo[2], hi[2] = -1.0, float(N)
    lo[2, 0], hi[2, 0] = 100.0, 119.0                # 20 rows at most
    lo[3], hi[3] = -1.0, float(N)
    lo[3, 0], hi[3, 0] = 7.0, 7.0                    # one row
    q = (_grid(rng, (B, D)) if grid
         else rng.standard_normal((B, D)).astype(np.float32))
    mask = (rng.random((N, 1)) - 0.3).astype(np.float32)
    mask[::31] = np.nan
    mask[::37] = 0.0
    return corpus, qv, qs, a, lo, hi, q, mask


def _t(*arrays):
    return [torch.as_tensor(np.asarray(x)) for x in arrays]


def _equal(got, want, grid=True):
    gi, gd = got[0], got[1]
    wi, wd = want
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    gd, wd = np.asarray(gd), np.asarray(wd)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    if grid:
        np.testing.assert_array_equal(gd[fin], wd[fin])
    else:
        np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k", KS)
def test_box_twin_equals_plain_version_on_grid(k, m, sample):
    corpus, qv, qs, a, lo, hi, q, _ = _case(k + m, m)
    stride, tile = sample
    c, at, qq, lo_t, hi_t = _t(corpus, a, q, lo, hi)
    got = ref.scan_topk_wide_twin(c, at, qq, lo_t, hi_t, k, stride=stride,
                                  tile=tile)
    _equal(got, ref.scan_topk_ref(c, at, qq, lo_t, hi_t, k))
    assert (got[0][0] == -1).all() and int((got[0][2] >= 0).sum()) <= 20
    assert int((got[0][3] >= 0).sum()) == 1 and got[3] == 0
    v, s = _t(qv, qs)
    got = ref.scan_topk_wide_twin(v, at, qq, lo_t, hi_t, k, qscale=s,
                                  stride=stride, tile=tile)
    _equal(got, ref.scan_topk_q8_ref(v, s, at, qq, lo_t, hi_t, k))


@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("k", KS)
def test_mask_twin_equals_plain_version_on_grid(k, sample):
    corpus, _, _, _, _, _, q, mask = _case(7 * k, 4)
    stride, _ = sample
    c, qq, mk = _t(corpus, q, mask)
    got = ref.scan_topk_mask_wide_twin(c, mk, qq, k, stride=stride)
    _equal(got, ref.scan_topk_mask_ref(c, mk, qq, k))
    n_pass = int((mask[:, 0] > 0).sum())
    assert (got[0] >= 0).sum(1).tolist() == [min(k, n_pass)] * B


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("grid", [True, False])
def test_box_twin_matches_pallas(k, m, grid):
    """Against the reference's scan_topk_raw and scan_topk_q8_raw
    (interpret mode)."""
    corpus, qv, qs, a, lo, hi, q, _ = _case(3 * k + m, m, grid)
    c, at, qq, lo_t, hi_t = _t(corpus, a, q, lo, hi)
    got = ref.scan_topk_wide_twin(c, at, qq, lo_t, hi_t, k, stride=4,
                                  tile=32)
    want = scan_topk_raw(*[jnp.asarray(x) for x in (corpus, a, q, lo, hi)],
                         k=k, n_blk=64, interpret=True)
    _equal(got, want, grid)
    v, s = _t(qv, qs)
    got = ref.scan_topk_wide_twin(v, at, qq, lo_t, hi_t, k, qscale=s,
                                  stride=4, tile=32)
    want = scan_topk_q8_raw(*[jnp.asarray(x) for x in (qv, qs, a, q, lo,
                                                       hi)],
                            k=k, n_blk=64, interpret=True)
    _equal(got, want, grid)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("grid", [True, False])
def test_mask_twin_matches_pallas(k, grid):
    """Against the reference's scan_topk_mask_raw (interpret mode)."""
    corpus, _, _, _, _, _, q, mask = _case(5 * k, 4, grid)
    c, qq, mk = _t(corpus, q, mask)
    got = ref.scan_topk_mask_wide_twin(c, mk, qq, k, stride=4)
    want = scan_topk_mask_raw(*[jnp.asarray(x) for x in (corpus, mask, q)],
                              k=k, n_blk=64, interpret=True)
    _equal(got, want, grid)


@pytest.mark.parametrize("k", [65, 100])
def test_tau_is_a_bound_from_the_sample(k):
    """Where a query's sample holds k passing rows, its threshold is
    their k-th distance, so it lists at least k and far fewer than its
    passing rows; where the sample holds fewer than k (a sample too
    sparse: 1 tile of 32 in 64), tau is +inf and the list is every
    passing row."""
    corpus, _, _, a, lo, hi, q, _ = _case(11, 4)
    c, at, qq, lo_t, hi_t = _t(corpus, a, q, lo, hi)
    ok = ref._box_ok(at, lo_t, hi_t)
    n_pass = ok.sum(1)
    got = ref.scan_topk_wide_twin(c, at, qq, lo_t, hi_t, k, stride=2,
                                  tile=32)
    _equal(got, ref.scan_topk_ref(c, at, qq, lo_t, hi_t, k))
    sampled = ok & ((torch.arange(N) // 32) % 2 == 0)
    finite = sampled.sum(1) >= k
    assert finite.any()
    assert (got[2][finite] >= k).all()
    assert (got[2][finite] < n_pass[finite]).all()
    assert torch.equal(got[2][~finite], n_pass[~finite])
    sparse = ref.scan_topk_wide_twin(c, at, qq, lo_t, hi_t, k, stride=64,
                                     tile=32)
    assert torch.equal(sparse[2], n_pass)           # tau = +inf: all listed
    _equal(sparse, ref.scan_topk_ref(c, at, qq, lo_t, hi_t, k))


@pytest.mark.parametrize("k", KS)
def test_ties_and_forced_overflow(k):
    """Every row at one distance from every query (all rows equal): the
    list takes every passing row, ties go to the lowest ids. With the
    capacity forced down to k the lists overflow and the exact re-pass
    gives the same answer; so it does on the grid corpus's own ties."""
    corpus, qv, qs, a, lo, hi, q, mask = _case(13, 9)
    flat = np.repeat(corpus[:1], N, axis=0)
    for base in (flat, corpus):
        c, at, qq, lo_t, hi_t, mk = _t(base, a, q, lo, hi, mask)
        want = ref.scan_topk_ref(c, at, qq, lo_t, hi_t, k)
        for cap in (None, k):
            got = ref.scan_topk_wide_twin(c, at, qq, lo_t, hi_t, k, cap=cap,
                                          stride=4, tile=32)
            _equal(got, want)
            over = int((got[2] > (N if cap is None else cap)).sum())
            assert got[3] == over
            if cap == k and k < N:
                assert got[3] > 0               # lanes 1 and more overflow
        wm = ref.scan_topk_mask_ref(c, mk, qq, k)
        got = ref.scan_topk_mask_wide_twin(c, mk, qq, k, cap=k, stride=4)
        _equal(got, wm)
        if k < int((mask[:, 0] > 0).sum()):
            assert got[3] > 0
    if k < N:                                   # the flat corpus's order
        got = ref.scan_topk_wide_twin(*_t(flat, a, q, lo, hi), k, cap=k)
        lane1 = np.nonzero(~np.isnan(a[:, 1]))[0][:k]
        np.testing.assert_array_equal(got[0][1].numpy(), lane1)


def test_empty_mask_and_one_row_box():
    corpus, _, _, a, lo, hi, q, mask = _case(17, 12)
    c, at, qq = _t(corpus, a, q)
    empty = torch.full((N, 1), -1.0)
    ids, dd, counts, over = ref.scan_topk_mask_wide_twin(c, empty, qq, 100)
    assert (ids == -1).all() and torch.isinf(dd).all()
    assert (counts == 0).all() and over == 0
    lo1, hi1 = np.full((B, 12), -1.0, np.float32), np.full((B, 12), 2.0,
                                                           np.float32)
    lo1[:, 0] = hi1[:, 0] = np.arange(B) * 11.0      # row of attr 0 = 11 b
    lo1[:, 1], hi1[:, 1] = -np.inf, np.inf
    got = ref.scan_topk_wide_twin(c, at, qq, *_t(lo1, hi1), N, cap=N)
    _equal(got, ref.scan_topk_ref(c, at, qq, *_t(lo1, hi1), N))
    assert ((got[0] >= 0).sum(1) == 1).all()
    assert (got[0][:, 0].numpy() == np.argsort(a[:, 0])[np.arange(B) * 11]
            ).all()


def test_twin_refuses_a_capacity_below_k():
    dist = torch.zeros((2, 10))
    with pytest.raises(ValueError, match="cap"):
        ref.wide_select_twin(dist, 5, torch.ones(10, dtype=torch.bool), 4)


def _win_case(seed, m, W=16):
    """``_case``'s corpus, attrs and boxes with ``_windows``'s windows:
    lanes whose windows nest inside the previous lane's, tile a span back
    to back (sharing 32-row words), are one row long (rows 0 and N - 1),
    end at N or run past it, and lane B // 2 with none."""
    corpus, _, _, a, lo, hi, q, _ = _case(seed, m)
    st, ct = _windows(np.random.default_rng(seed), B, N, W, "cpu")
    return _t(corpus, a, q, lo, hi) + [st, ct]


@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k", KS)
def test_windows_twin_equals_references_on_grid(k, m, sample):
    """The windowed twin bit-equal to the port's plain version and to the
    JAX package's plain windowed reference (the Pallas kernel's oracle,
    which takes nested and overlapping windows), ids as positions; lane B
    // 2 (no window) and lane 0 (an empty box) get no position."""
    c, at, qq, lo, hi, st, ct = _win_case(k + 5 * m, m)
    stride, tile = sample
    got = ref.scan_topk_windows_wide_twin(c, at, qq, lo, hi, st, ct, k,
                                          stride=stride, tile=tile)
    _equal(got, ref.scan_topk_windows_ref(c, at, qq, lo, hi, st, ct, k))
    _equal(got, j_windows_ref(*[jnp.asarray(x.numpy()) for x in
                                (c, at, qq, lo, hi, st, ct)], k=k))
    assert (got[0][0] == -1).all() and (got[0][B // 2] == -1).all()
    assert got[3] == 0
    cbf = c.to(torch.bfloat16)                     # exact on the grid
    _equal(ref.scan_topk_windows_wide_twin(cbf, at, qq, lo, hi, st, ct, k,
                                           stride=stride, tile=tile),
           got[:2])


@pytest.mark.parametrize("k", (65, 100, N))
@pytest.mark.parametrize("grid", [True, False])
def test_windows_twin_matches_pallas(k, grid):
    """Against the reference's scan_topk_windows_raw (interpret mode) on
    disjoint windows ascending by start, as its contract asks."""
    corpus, _, _, a, lo, hi, q, _ = _case(19 * k, 4, grid)
    rng = np.random.default_rng(k)
    W = 4
    st = np.full((B, W), -1, np.int32)
    ct = np.zeros((B, W), np.int32)
    for b in range(1, B):
        cut = np.sort(rng.choice(N, size=2 * W, replace=False))
        st[b], ct[b] = cut[0::2], cut[1::2] - cut[0::2]
    got = ref.scan_topk_windows_wide_twin(*_t(corpus, a, q, lo, hi, st, ct),
                                          k, stride=4, tile=32)
    want = scan_topk_windows_raw(*[jnp.asarray(x) for x in
                                   (corpus, a, q, lo, hi, st, ct)],
                                 k=k, w_cap=int(ct.max()), interpret=True)
    _equal(got, want, grid)


@pytest.mark.parametrize("k", KS)
def test_windows_twin_forced_overflow_and_tau_bound(k):
    """With the lists' capacity forced down to k, lanes whose windows hold
    more than k candidates overflow and the exact re-pass gives the same
    positions (lane 0's box is empty, the others pass every row but the
    NaN ones, so the windows alone choose); on a corpus whose rows are all equal, ties go to the lowest
    position. Where a lane's sample holds k passing pairs, its threshold
    (their k-th distance) bounds the final k-th distance and the lane
    lists at least k pairs, fewer than it passes."""
    c, at, qq, lo, hi, st, ct = _win_case(23, 9)
    lo[1:], hi[1:] = -1.0, float(N)    # lanes 1.. pass all but NaN rows
    want = ref.scan_topk_windows_ref(c, at, qq, lo, hi, st, ct, k)
    for cap in (None, k):
        got = ref.scan_topk_windows_wide_twin(c, at, qq, lo, hi, st, ct, k,
                                              cap=cap, stride=2, tile=32)
        _equal(got, want)
        assert got[3] == int((got[2] > (N if cap is None else cap)).sum())
        if cap == k:                    # a lane with more than k overflows
            assert (got[3] > 0) == bool((got[2] > k).any())
            assert k >= 400 or got[3] > 0
    flat = c[:1].expand_as(c).contiguous()
    fw = ref.scan_topk_windows_ref(flat, at, qq, lo, hi, st, ct, k)
    _equal(ref.scan_topk_windows_wide_twin(flat, at, qq, lo, hi, st, ct, k,
                                           cap=k, stride=2, tile=32), fw)
    ok = ref._box_ok(at, lo, hi) & ref._window_rows(st, ct, N)
    dist = ((qq[:, None] - c[None]) ** 2).sum(-1)        # exact on the grid
    dist = torch.where(ok, dist, torch.inf)
    sampled = ok & ((torch.arange(N) // 32) % 2 == 0)
    got = ref.scan_topk_windows_wide_twin(c, at, qq, lo, hi, st, ct, k,
                                          stride=2, tile=32)
    n_pass = ok.sum(1)
    lanes = torch.nonzero(sampled.sum(1) >= k)[:, 0]
    if k <= 100:
        assert lanes.numel() > 0
    for b in lanes.tolist():
        tau = torch.sort(dist[b][sampled[b]]).values[k - 1]
        assert got[1][b, k - 1] <= tau
        assert k <= int(got[2][b]) <= int(n_pass[b])
        assert int(got[2][b]) == int((dist[b] <= tau).sum())


@pytest.mark.parametrize("form", ["box", "mask", "windows"])
@pytest.mark.parametrize("k", [100, 400])
def test_wide_plan_fits_the_scratch_at_the_served_shape(k, form):
    """B = 256, N = 1M: one chunk of every query, a list of at least 16 k
    (the sample's inverse) keys a query, within WIDE_SCRATCH_BYTES (the
    windowed form's coverage of the chunk in it: a bitmap row a query and
    a byte per (query block, 64-row tile))."""
    mask, win = form == "mask", form == "windows"
    p = ops._wide_plan(256, 1_000_000, k, mask, win)
    assert p.chunk == 256
    assert p.cap >= 4 * ops.WIDE_SAMPLE_STRIDE * k and p.cap >= k
    assert p.scratch <= ops.WIDE_SCRATCH_BYTES
    lists = p.chunk * (8 * p.cap + 16 * k)
    rows = 4 * (1_000_000 + -(-1_000_000 // ops.MASK_SEGMENT) + 1)
    cover = 256 * 4 * 31_250 + 4 * -(-15_625 // 4) + 4 * (1 + 3 + 1)
    assert p.scratch == lists + 12 * 256 + 4 + (
        rows if mask else cover if win else 4 * (1 + 3))


@pytest.mark.parametrize("B,N,k", [(1, 1, 1), (37, 1500, 1500),
                                   (256, 1_000_000, 1_000_000),
                                   (1000, 3001, 65), (65536, 10_000, 400)])
def test_wide_plan_bounds(B, N, k):
    """The capacity lies in [k, N] (no list can outgrow N rows), the
    chunk in [1, B], the scratch within the cap whenever one query's
    lists fit it; a forced capacity is raised to k."""
    p = ops._wide_plan(B, N, k)
    assert k <= p.cap <= max(N, k) and 1 <= p.chunk <= B
    if 8 * p.cap + 16 * k + 12 * B + 4 + 16 <= ops.WIDE_SCRATCH_BYTES:
        assert p.scratch <= ops.WIDE_SCRATCH_BYTES
    if p.chunk < B:                  # the next query would not fit
        assert p.scratch + 8 * p.cap + 16 * k > ops.WIDE_SCRATCH_BYTES
    saved = ops.WIDE_CAPACITY
    try:
        ops.WIDE_CAPACITY = 1
        assert ops._wide_plan(B, N, k).cap == k
    finally:
        ops.WIDE_CAPACITY = saved
