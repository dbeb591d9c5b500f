"""The port's kernel plain versions against the JAX package's Pallas
kernels (run in interpret mode on the CPU), the wrappers' device rule and
counters, and the CUDA build command.

Tolerances: on 1/32-grid inputs every squared distance is exact in f32
whatever the reduce order, so distances are compared bit for bit; on
float inputs the two reduce orders differ, so rtol = atol = 1e-5; the
l2dist expansion (``l2dist_qn``, ``l2dist_qc``) cancels, so rtol 1e-4,
atol 1e-3. Ids are always equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gather_l2 import gather_l2_blocked_raw, gather_l2_raw
from repro.kernels.gather_l2_filter import gather_l2_filter_blocked_raw
from repro.kernels.l2dist import l2dist_qc_raw
from repro.kernels.scan_topk import scan_topk_raw

from repro_torch.kernels import _build, ops, ref


def _grid(rng, shape):
    return (rng.integers(-64, 64, size=shape) / 32).astype(np.float32)


def _vecs(rng, shape, grid):
    return _grid(rng, shape) if grid else rng.standard_normal(shape).astype(
        np.float32)


def _close(got, want, grid, rtol=1e-5, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    if grid:
        np.testing.assert_array_equal(got[fin], want[fin])
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _boxes(rng, B, m, lo_max=12, width=6):
    lo = rng.integers(0, lo_max, size=(B, m)).astype(np.float32)
    hi = lo + rng.integers(0, width, size=(B, m)).astype(np.float32)
    return lo, hi


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_l2_filter_matches_pallas(grid, seed):
    rng = np.random.default_rng(seed)
    N, d, m, B, C = 300, 24, 3, 5, 40
    corpus = _vecs(rng, (N, d), grid)
    attrs = rng.integers(0, 16, size=(N, m)).astype(np.float32)
    attrs[::11, 1] = np.nan                              # tombstone rows
    q = _vecs(rng, (B, d), grid)
    qlo, qhi = _boxes(rng, B, m)
    qlo[2], qhi[2] = 100.0, 200.0                        # all out of range
    idx = rng.integers(0, N, size=(B, C)).astype(np.int32)
    idx[:, ::7] = -1                                     # pad lanes
    idx[4] = -1
    want = gather_l2_filter_blocked_raw(
        jnp.asarray(idx), jnp.asarray(corpus), jnp.asarray(attrs),
        jnp.asarray(q), jnp.asarray(qlo), jnp.asarray(qhi), c_blk=16,
        interpret=True)
    got = ref.gather_l2_filter_ref(*_t(idx, corpus, attrs, q, qlo, qhi))
    _close(got.numpy(), want, grid)
    assert np.isinf(got.numpy()[2]).all() and np.isinf(got.numpy()[4]).all()
    assert np.isinf(got.numpy()[:, ::7]).all()


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_scan_topk_matches_pallas(grid, k):
    rng = np.random.default_rng(10 + k)
    N, d, m, B = 200, 16, 3, 6
    corpus = _vecs(rng, (N, d), grid)
    if grid:
        corpus[100:140] = corpus[20:60]                  # exact duplicates
    attrs = rng.integers(0, 8, size=(N, m)).astype(np.float32)
    attrs[5::13, 0] = np.nan
    q = _vecs(rng, (B, d), grid)
    qlo, qhi = _boxes(rng, B, m, lo_max=4, width=5)
    qlo[1], qhi[1] = 50.0, 60.0                          # nothing in range
    qlo[3], qhi[3] = -np.inf, np.inf                     # everything but NaN
    want_i, want_d = scan_topk_raw(
        jnp.asarray(corpus), jnp.asarray(attrs), jnp.asarray(q),
        jnp.asarray(qlo), jnp.asarray(qhi), k=k, n_blk=64, interpret=True)
    got_i, got_d = ref.scan_topk_ref(*_t(corpus, attrs, q, qlo, qhi), k,
                                     budget=B * d * 48)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _close(got_d.numpy(), want_d, grid)
    assert (got_i.numpy()[1] == -1).all()
    if k == 64:                                          # k > in-range count
        assert (got_i.numpy() == -1).any()


def test_scan_topk_grid_ties_go_to_lowest_id():
    rng = np.random.default_rng(3)
    N, d, m = 96, 8, 2
    base = _grid(rng, (12, d))
    corpus = np.repeat(base, 8, axis=0)                  # 8-way exact ties
    attrs = np.zeros((N, m), np.float32)
    q = _grid(rng, (4, d))
    lo = np.full((4, m), -1.0, np.float32)
    hi = np.full((4, m), 1.0, np.float32)
    want_i, _ = jax.jit(lambda *a: scan_topk_raw(*a, k=20, n_blk=32,
                                                 interpret=True))(
        corpus, attrs, q, lo, hi)
    got_i, _ = ref.scan_topk_ref(*_t(corpus, attrs, q, lo, hi), 20)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("shape", [(17, 40, 24), (64, 300, 130)])
def test_l2dist_qn_matches_pallas(shape):
    B, N, d = shape
    rng = np.random.default_rng(B)
    q = rng.standard_normal((B, d)).astype(np.float32)
    c = rng.standard_normal((N, d)).astype(np.float32)
    want = np.asarray(jops.l2dist(jnp.asarray(q), jnp.asarray(c),
                                  interpret=True))
    got = ref.l2dist_qn_ref(*_t(q, c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # the batched form is the 2D form per batch item
    qb = torch.as_tensor(np.stack([q, q[::-1].copy()]))
    cb = torch.as_tensor(np.stack([c, c[::-1].copy()]))
    gb = ref.l2dist_qn_ref(qb, cb).numpy()
    np.testing.assert_allclose(gb[0], got, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("shape", [(5, 40, 300, 24), (3, 130, 90, 36)])
def test_gather_l2_matches_pallas(grid, shape):
    """``gather_l2_ref`` against both Pallas gathers (row-per-step and
    blocked, which the reference pins bitwise equal), and its lanes
    against ``gather_l2_filter_ref``'s finite lanes under an all-pass box
    on the same ids; an id outside [0, N) gives +inf."""
    B, C, N, d = shape
    rng = np.random.default_rng(B * C)
    corpus = _vecs(rng, (N, d), grid)
    q = _vecs(rng, (B, d), grid)
    idx = rng.integers(0, N, size=(B, C)).astype(np.int32)
    idx[:, ::5] = idx[:, 1::5][:, : idx[:, ::5].shape[1]]  # repeated ids
    rows = jnp.asarray(idx), jnp.asarray(corpus), jnp.asarray(q)
    want_rows = gather_l2_raw(*rows, interpret=True)
    want_blk = gather_l2_blocked_raw(*rows, c_blk=16, interpret=True)
    got = ref.gather_l2_ref(*_t(idx, corpus, q)).numpy()
    _close(got, want_rows, grid)
    _close(got, want_blk, grid)
    attrs = np.zeros((N, 2), np.float32)
    lo, hi = np.full((B, 2), -1.0, np.float32), np.ones((B, 2), np.float32)
    filt = ref.gather_l2_filter_ref(*_t(idx, corpus, attrs, q, lo, hi))
    np.testing.assert_array_equal(got, filt.numpy())
    bad = idx.copy()
    bad[0, 0], bad[-1, -1] = -1, N
    out = ref.gather_l2_ref(*_t(bad, corpus, q)).numpy()
    assert np.isinf(out[0, 0]) and np.isinf(out[-1, -1])
    np.testing.assert_array_equal(out[1:-1], got[1:-1])


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("shape", [(4, 40, 24), (2, 130, 300), (3, 9, 768)])
def test_l2dist_qc_matches_pallas(grid, shape):
    """Both plain forms of the per-candidate distance against
    ``l2dist_qc_raw`` (interpret mode, at the reference engine's tiling:
    one query a step, ``tc = min(128, ceil8(C))``, ``td = min(128,
    ceil8(d))`` over zero padding) and the JAX package's direct oracle.
    The expansion cancels: rtol 1e-4, atol 1e-3 on floats; bit-equal on
    the grid, where every partial sum is exact."""
    B, C, d = shape
    rng = np.random.default_rng(C + d)
    q = _vecs(rng, (B, d), grid)
    c = _vecs(rng, (B, C, d), grid)
    tc = min(128, -(-C // 8) * 8)
    td = ref.qc_tile_width(d)
    assert td == min(128, -(-d // 8) * 8)
    Cp, dp = -(-C // tc) * tc, -(-d // td) * td
    qp = np.zeros((B, dp), np.float32)
    qp[:, :d] = q
    cp = np.zeros((B, Cp, dp), np.float32)
    cp[:, :C, :d] = c
    want = np.stack([np.asarray(l2dist_qc_raw(
        jnp.asarray(qp[b:b + 1]), jnp.asarray(cp[b:b + 1]), tb=1, tc=tc,
        td=td, interpret=True))[0, :C] for b in range(B)])
    oracle = np.asarray(jref.l2dist_qc_ref(jnp.asarray(q), jnp.asarray(c)))
    tq, tcand = _t(q, c)
    got = ref.l2dist_qc_ref(tq, tcand).numpy()
    direct = ref.l2dist_qc_direct(tq, tcand).numpy()
    tol = dict(rtol=1e-4, atol=1e-3)
    _close(got, want, grid, **tol)
    _close(got, oracle, grid, **tol)
    _close(direct, want, grid, **tol)
    _close(direct, oracle, grid)
    # the public wrapper dispatches a 3-D c to it, at the same tiling
    np.testing.assert_array_equal(ops.l2dist(tq, tcand).numpy(), got)


@pytest.mark.parametrize("width", [50, 20000])
def test_lex_smallest_is_lax_top_k(width):
    """Ties on a small integer range, narrow rows (keyed path) and wide
    rows (float top-k plus tie repair) both give lax.top_k's order."""
    rng = np.random.default_rng(width)
    x = rng.integers(0, 40, size=(6, width)).astype(np.float32)
    x[1, :] = 7.0                                        # all tied
    x[2, : width // 2] = np.inf
    k = 33
    neg, want_i = jax.lax.top_k(-jnp.asarray(x), k)
    v, i = ref.lex_smallest(torch.as_tensor(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(v.numpy(), -np.asarray(neg))


def test_cpu_tensors_run_the_plain_versions_and_count():
    rng = np.random.default_rng(0)
    corpus = torch.as_tensor(rng.standard_normal((50, 8)).astype(np.float32))
    attrs = torch.zeros((50, 2))
    q = corpus[:3].clone()
    lo = torch.full((3, 2), -1.0)
    hi = torch.full((3, 2), 1.0)
    idx = torch.arange(12).reshape(3, 4)
    ops.reset_launches()
    ref.reset_calls()
    filt = ops.gather_l2_filter(idx, corpus, attrs, q, lo, hi)
    ids, _ = ops.scan_topk(corpus, attrs, q, lo, hi, k=5)
    ops.l2dist_qn(q, corpus)
    mids, _ = ops.scan_topk_mask(corpus, torch.ones(50), q, k=5)
    wids, _ = ops.scan_topk_windows(
        corpus, attrs, q, lo, hi, torch.zeros((3, 1), dtype=torch.int32),
        torch.full((3, 1), 50, dtype=torch.int32), k=5)
    rows = ops.gather_l2(idx, corpus, q)
    blk = ops.gather_l2(idx.to(torch.int32), corpus, q, c_blk=128)
    qc = ops.l2dist(q, corpus[idx])
    assert ids[:, 0].tolist() == [0, 1, 2]
    assert torch.equal(mids, ids) and torch.equal(wids, ids)
    assert torch.equal(rows, filt) and torch.equal(blk, filt)
    torch.testing.assert_close(qc, filt, rtol=1e-4, atol=1e-4)
    assert {k: v["cpu"] for k, v in ref.CALLS.items()} == {
        "gather_l2_filter": 1, "scan_topk": 1, "l2dist_qn": 1,
        "gather_l2_filter_q8": 0, "scan_topk_q8": 0, "scan_topk_mask": 1,
        "scan_topk_windows": 1, "gather_l2": 2, "l2dist_qc": 1}
    assert all(v["cuda"] == 0 for v in ref.CALLS.values())
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_wrappers_refuse_other_devices_without_fallback():
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.l2dist_qn(meta, meta)
    cpu = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="one device"):
        ops.l2dist_qn(cpu, meta)
    idx = torch.zeros((4, 6), dtype=torch.int64)[:, :3]  # a strided view
    with pytest.raises(ValueError, match="contiguous"):
        ops.gather_l2_filter(idx, cpu, torch.zeros((4, 2)), cpu,
                             torch.zeros((4, 2)), torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="k must be"):
        ops.scan_topk(cpu, torch.zeros((4, 2)), cpu, torch.zeros((4, 2)),
                      torch.zeros((4, 2)), k=5)
    with pytest.raises(ValueError, match="gather_l2 shape mismatch"):
        ops.gather_l2(torch.zeros((3, 2), dtype=torch.int64), cpu, cpu)
    with pytest.raises(ValueError, match="l2dist_qc takes"):
        ops.l2dist_qc(cpu, torch.zeros((3, 2, 8)))
    with pytest.raises(ValueError, match="bad candidate rank"):
        ops.l2dist(cpu, torch.zeros(8))


def test_nvcc_command_targets_sm90a(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path
    for name, src in _build.SOURCES.items():
        cmd = _build.nvcc_command(name, tmp_path / "x.so")
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined
        assert "-shared" in cmd and "-fPIC" in cmd and "-O3" in cmd
        assert cmd[-1].endswith(src)
        text = (_build.CSRC / src).read_text()
        assert "Replaces: src/repro/kernels/" in text
        assert "Bound on the H100" in text and "Design:" in text
