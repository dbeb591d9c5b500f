"""The rounding of the CUDA ``l2dist_qn`` kernel's 3xTF32 split, emulated
on the CPU, and the bitmask scan's chunking.

The kernel (``kernels/csrc/l2dist.cu``) runs each fp32 product on the
tensor cores as three TF32 products: ``hi = tf32_rna(x)``,
``lo = tf32_rna(x - hi)``, and ``lo*hi + hi*lo + hi*hi`` summed in fp32.
The emulation here rounds to TF32 by integer bit masking (round to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and forms the
three products exactly (two 11-bit significands fit in fp32), but sums
them with torch matmul, not in the kernel's order (per-slab partials,
compensated norms). So it checks what the split's rounding alone costs:
within the kernel's stated tolerance of the plain version (rtol 1e-4,
atol 1e-3, as every l2dist check: the expansion cancels) and within
twice the plain version's error against float64, where one TF32 pass is
not. The kernel's own summation is held to float64 on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Inputs are seeded
numpy arrays, the same ones the JAX package's ``l2dist`` (interpret
mode) receives.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops

from repro_torch.kernels import ops, ref


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 stored mantissa bits), round to nearest with ties
    away from zero: add half of the 13 dropped bits' weight to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _l2dist_3xtf32(q: torch.Tensor, c: torch.Tensor, passes: int = 3
                   ) -> torch.Tensor:
    """(|q|^2 + |c|^2) - 2 q.c with q.c from ``passes`` TF32 products
    (3: lo*hi + hi*lo + hi*hi, small terms first; 1: hi*hi)."""
    qh, ql = _split(q)
    ch, cl = _split(c)
    ct = lambda t: t.transpose(-1, -2)  # noqa: E731
    dot = qh @ ct(ch)
    if passes == 3:
        dot = ((ql @ ct(ch)) + (qh @ ct(cl))) + dot
    qs = (q * q).sum(-1, keepdim=True)
    cs = (c * c).sum(-1).unsqueeze(-2)
    return (qs + cs) - 2.0 * dot


def _f64(q, c):
    q, c = q.double(), c.double()
    return ((q[..., :, None, :] - c[..., None, :, :]) ** 2).sum(-1)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32 spacing in [1, 2)
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         0.0], dtype=torch.float32)
    assert torch.equal(_tf32_rna(x), want)
    hi, lo = _split(torch.tensor([np.float32(np.pi)]))
    # hi keeps 11 significant bits, lo the next 11: |x - hi| <= 2^-11 |x|,
    # |x - hi - lo| <= 2^-22 |x|
    x = np.float64(np.float32(np.pi))
    assert abs(x - float(hi)) <= 2.0 ** -11 * x
    assert abs(x - float(hi) - float(lo)) <= 2.0 ** -22 * x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(1, 48, 256, 768), (3, 20, 70, 768),
                                   (1, 33, 90, 100)])
def test_3xtf32_emulation_within_kernel_tolerance(seed, shape):
    G, B, N, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((G, B, d)).astype(np.float32)
    c = rng.standard_normal((G, N, d)).astype(np.float32)
    qt, ctn = torch.as_tensor(q), torch.as_tensor(c)
    plain = ref.l2dist_qn_ref(qt, ctn)
    emul = _l2dist_3xtf32(qt, ctn)
    torch.testing.assert_close(emul, plain, rtol=1e-4, atol=1e-3)
    if G == 1:
        jax_out = np.asarray(jops.l2dist(jnp.asarray(q[0]), jnp.asarray(c[0]),
                                         interpret=True))
        np.testing.assert_allclose(emul[0].numpy(), jax_out, rtol=1e-4,
                                   atol=1e-3)
    truth = _f64(qt, ctn)
    err_plain = float((plain.double() - truth).abs().max())
    err_emul = float((emul.double() - truth).abs().max())
    err_one = float((_l2dist_3xtf32(qt, ctn, passes=1).double() - truth)
                    .abs().max())
    assert err_emul <= 2.0 * err_plain, (err_emul, err_plain)
    # one TF32 pass keeps ~3 digits: far outside the same bound
    assert err_one > 2.0 * err_plain, (err_one, err_plain)


@pytest.mark.parametrize("B", [1, 9, 128, 129, 256, 4096])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 6000, 539_333, 1_000_000,
                               50_000_000])
@pytest.mark.parametrize("sms", [1, 132])
def test_mask_chunking_covers_n_in_tile_multiples(B, N, sms):
    nchunks = ops._mask_chunking(B, N, sms)
    qtiles = -(-B // ops.MASK_QUERY_TILE)
    # the grid is (query tiles, chunks): chunks on y, at most 65535
    assert 1 <= nchunks <= min(65535, max(1, -(-8 * sms // qtiles)))
    # the kernel's even split of a passing count, in 64-row tiles
    for count in {0, 1, N // 3, N}:
        per = -(-count // nchunks)
        per = -(-per // ops.MASK_ROW_TILE) * ops.MASK_ROW_TILE
        assert per % ops.MASK_ROW_TILE == 0 and per * nchunks >= count
    assert per * (nchunks - 1) < N          # all pass: no chunk is empty
