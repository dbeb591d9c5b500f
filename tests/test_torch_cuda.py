"""The port's CUDA kernels against their plain versions, on a card.

Needs a CUDA device and skips without one. The JAX package is not
needed, so on a machine without it run:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Each kernel against its plain version at small shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    N, d, m, B = 5000, 96, 4, 40
    corpus = torch.randn((N, d), generator=g, device=dev)
    attrs = torch.rand((N, m), generator=g, device=dev)
    q = torch.randn((B, d), generator=g, device=dev)
    lo = torch.rand((B, m), generator=g, device=dev) * 0.4
    hi = lo + 0.6
    idx = torch.randint(-1, N, (B, 64), generator=g, device=dev)
    got = ops.gather_l2_filter(idx, corpus, attrs, q, lo, hi)
    want = ref.gather_l2_filter_ref(idx, corpus, attrs, q, lo, hi)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    ids, dd = ops.scan_topk(corpus, attrs, q, lo, hi, k=10)
    rids, rdd = ref.scan_topk_ref(corpus, attrs, q, lo, hi, 10)
    assert torch.equal(ids, rids)
    torch.testing.assert_close(dd, rdd, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ops.l2dist_qn(q, corpus),
                               ref.l2dist_qn_ref(q, corpus),
                               rtol=1e-4, atol=1e-3)
