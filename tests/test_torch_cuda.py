"""The port's CUDA kernels against their plain versions, on a card.

Needs a CUDA device and skips without one. The JAX package is not
needed, so on a machine without it run:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
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


@pytest.mark.gpu
def test_cuda_replica_kernels_match_plain_versions():
    """The bf16 forms of the gather and scan kernels and their int8 (q8)
    forms against their plain versions, at a d that takes the 16-byte row
    loads (96) and one that does not (36); then the int8 gather's edges
    (d in {33, 768}, C in {1, 70, 129}, pad, out-of-range and failing
    lanes, both id types, a misaligned replica view). Scan ids are equal;
    distances within rtol 1e-5, atol 1e-4 (reduce order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.kernels import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    N, m, B = 5000, 4, 40
    for d in (96, 36):
        corpus = torch.randn((N, d), generator=g, device=dev)
        attrs = torch.rand((N, m), generator=g, device=dev)
        attrs[3::41, 2] = float("nan")
        q = torch.randn((B, d), generator=g, device=dev)
        lo = torch.rand((B, m), generator=g, device=dev) * 0.4
        hi = lo + 0.6
        idx = torch.randint(-1, N, (B, 64), generator=g, device=dev)
        qv, qs = quant.quant_replica(corpus, "int8")
        cb, _ = quant.quant_replica(corpus, "bf16")
        # the replica made on the card is the CPU's, bit for bit
        cq, cs = quant.quant_replica(corpus.cpu(), "int8")
        assert torch.equal(qv.cpu(), cq) and torch.equal(qs.cpu(), cs)
        torch.testing.assert_close(
            ops.gather_l2_filter_q8(idx, qv, qs, attrs, q, lo, hi),
            ref.gather_l2_filter_q8_ref(idx, qv, qs, attrs, q, lo, hi),
            rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(
            ops.gather_l2_filter(idx, cb, attrs, q, lo, hi),
            ref.gather_l2_filter_ref(idx, cb, attrs, q, lo, hi),
            rtol=1e-5, atol=1e-4)
        for k in (10, 40):
            ids, dd = ops.scan_topk_q8(qv, qs, attrs, q, lo, hi, k=k)
            rids, rdd = ref.scan_topk_q8_ref(qv, qs, attrs, q, lo, hi, k)
            assert torch.equal(ids, rids)
            torch.testing.assert_close(dd, rdd, rtol=1e-5, atol=1e-4)
            ids, dd = ops.scan_topk(cb, attrs, q, lo, hi, k=k)
            rids, rdd = ref.scan_topk_ref(cb, attrs, q, lo, hi, k)
            assert torch.equal(ids, rids)
            torch.testing.assert_close(dd, rdd, rtol=1e-5, atol=1e-4)

    # the int8 gather's edges, as in the grid-corpus test: d in {33, 768},
    # C in {1, 70, 129}, an all-pad lane, a lane no id passes, NaN attrs,
    # int32 and int64 ids, and the replica as a misaligned view
    for d in (33, 768):
        corpus = torch.randn((N, d), generator=g, device=dev)
        attrs = torch.rand((N, m), generator=g, device=dev)
        attrs[3::41, 2] = float("nan")
        qv, qs = quant.quant_replica(corpus, "int8")
        flat = torch.empty(N * d + 33, dtype=torch.int8, device=dev)
        flat[33:] = qv.reshape(-1)
        for C in (1, 70, 129):
            q = torch.randn((B, d), generator=g, device=dev)
            lo = torch.rand((B, m), generator=g, device=dev) * 0.4
            hi = lo + 0.6
            lo[2, 0], hi[2, 0] = 2.0, 3.0                # every id fails
            idx = torch.randint(-1, N + 2, (B, C), generator=g, device=dev)
            idx[1] = -1                                  # all pad
            for ids in (idx, idx.to(torch.int32)):
                want = ref.gather_l2_filter_q8_ref(ids, qv, qs, attrs, q,
                                                   lo, hi)
                assert bool(torch.isinf(want[1:3]).all())
                for qx in (qv, flat[33:].view(N, d)):
                    got = ops.gather_l2_filter_q8(ids, qx, qs, attrs, q,
                                                  lo, hi)
                    assert torch.equal(torch.isinf(got), torch.isinf(want))
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-4)


@pytest.mark.gpu
def test_cuda_windows_and_mask_kernels_match_plain_versions():
    """The windowed scan (windows of thousands of rows, an empty lane,
    windows that end at N and one that runs past it; then the windows of
    ``_windows``: nesting across lanes, adjacent ones sharing a 32-row
    word, one-row ones, W = 64, at B in {1, 37, 300}) and the bitmask scan
    (NaN, zero and negative mask values) against their plain versions.
    Ids are equal; distances within rtol 1e-5, atol 1e-4 (reduce
    order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    N, m, B = 6000, 3, 9
    for d in (96, 36):
        corpus = torch.randn((N, d), generator=g, device=dev)
        attrs = torch.rand((N, m), generator=g, device=dev)
        attrs[5::53, 1] = float("nan")
        q = torch.randn((B, d), generator=g, device=dev)
        lo = torch.rand((B, m), generator=g, device=dev) * 0.3
        hi = lo + 0.7
        starts = torch.tensor([[0, 2500, -1, -1], [-1, -1, -1, -1],
                               [100, 1200, 4000, N - 7],
                               [N - 3000, -1, -1, -1],
                               [10, 20, 30, 40], [5990, -1, -1, -1],
                               [0, -1, -1, -1], [3000, 3100, -1, -1],
                               [1, 2, 3, 4]],
                              dtype=torch.int32, device=dev)
        counts = torch.tensor([[2400, 3000, 0, 0], [0, 0, 0, 0],
                               [50, 1500, 1, 7], [3000, 0, 0, 0],
                               [5, 5, 5, 5], [40, 0, 0, 0],
                               [N, 0, 0, 0], [100, 2900, 0, 0],
                               [1, 1, 1, 1]],
                              dtype=torch.int32, device=dev)
        for k in (10, 40):
            ids, dd = ops.scan_topk_windows(corpus, attrs, q, lo, hi, starts,
                                            counts, k=k)
            rids, rdd = ref.scan_topk_windows_ref(corpus, attrs, q, lo, hi,
                                                  starts, counts, k)
            assert torch.equal(ids, rids)
            torch.testing.assert_close(dd, rdd, rtol=1e-5, atol=1e-4)
            assert bool((ids[1] == -1).all())
            mask = torch.rand((N, 1), generator=g, device=dev) - 0.4
            mask[::31] = float("nan")
            mask[::37] = 0.0
            ids, dd = ops.scan_topk_mask(corpus, mask, q, k=k)
            rids, rdd = ref.scan_topk_mask_ref(corpus, mask, q, k)
            assert torch.equal(ids, rids)
            torch.testing.assert_close(dd, rdd, rtol=1e-5, atol=1e-4)
        rng = np.random.default_rng(d)
        for nb in (1, 37, 300):
            qb = torch.randn((nb, d), generator=g, device=dev)
            lob = torch.rand((nb, m), generator=g, device=dev) * 0.3
            hib = lob + 0.7
            st, ct = _windows(rng, nb, N, 64, dev)
            for k in (1, 10, 64):
                ids, dd = ops.scan_topk_windows(corpus, attrs, qb, lob, hib,
                                                st, ct, k=k)
                rids, rdd = ref.scan_topk_windows_ref(corpus, attrs, qb, lob,
                                                      hib, st, ct, k)
                assert torch.equal(ids, rids), (d, nb, k)
                torch.testing.assert_close(dd, rdd, rtol=1e-5, atol=1e-4)


def _windows(rng, B, N, W, dev):
    """(B, W) int32 starts/counts as the hybrid planner builds them, and
    harder: lane b takes, by b % 6, up to W random disjoint windows
    ascending by start; lane b - 1's windows shrunk inside them (nesting
    across lanes); windows that tile a random span back to back (adjacent
    windows sharing 32-row words); one-row windows, rows 0 and N - 1
    among them; a window ending exactly at N; one running past N. Lane
    B // 2 of a batch of more than one has no window."""
    st = np.full((B, W), -1, np.int64)
    ct = np.zeros((B, W), np.int64)
    for b in range(B):
        kind = b % 6
        if kind == 0 or (kind == 1 and b == 0):
            nw = int(rng.integers(1, W + 1))
            cut = np.sort(rng.choice(N, size=2 * nw, replace=False))
            s, c = cut[0::2], cut[1::2] - cut[0::2]
        elif kind == 1:
            live = st[b - 1] >= 0
            s = st[b - 1][live] + ct[b - 1][live] // 4
            c = np.maximum(1, ct[b - 1][live] // 2)
        elif kind == 2:
            cut = np.sort(rng.choice(N, size=int(rng.integers(2, W + 2)),
                                     replace=False))
            s, c = cut[:-1], np.diff(cut)
        elif kind == 3:
            s = np.sort(rng.choice(N, size=int(rng.integers(1, W + 1)),
                                   replace=False))
            s[0], s[-1] = 0, N - 1
            s = np.unique(s)
            c = np.ones_like(s)
        elif kind == 4:
            s, c = np.array([10, N - 700]), np.array([300, 700])
        else:
            s, c = np.array([N - 45]), np.array([N])
        st[b, :len(s)], ct[b, :len(s)] = s, c
    if B > 1:
        st[B // 2], ct[B // 2] = -1, 0
    return (torch.as_tensor(st, dtype=torch.int32, device=dev),
            torch.as_tensor(ct, dtype=torch.int32, device=dev))


@pytest.mark.gpu
def test_cuda_unfused_kernels_match_plain_versions():
    """The unfused gather in both forms (blocked and row-per-step), f32 and
    bf16 corpora, int32 and int64 ids, at a d that takes the 16-byte row
    loads (96) and one that does not (36): within rtol 1e-5, atol 1e-4 of
    the plain version, the two forms bitwise equal to each other and to
    gather_l2_filter's lanes under an all-pass box; +inf for ids outside
    [0, N). l2dist_qc (f32 and bf16 candidates) within rtol 1e-4, atol
    1e-3 of its plain version (the expansion cancels), also at d in {33,
    96, 264, 300, 768, 770, 1104}, C in {1, 70, 129} and a misaligned
    view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    N, m, B, C = 5000, 3, 40, 70
    for d in (96, 36):
        corpus = torch.randn((N, d), generator=g, device=dev)
        attrs = torch.rand((N, m), generator=g, device=dev)
        q = torch.randn((B, d), generator=g, device=dev)
        lo = torch.full((B, m), -1.0, device=dev)
        hi = torch.full((B, m), 2.0, device=dev)
        idx = torch.randint(0, N, (B, C), generator=g, device=dev)
        idx[:, ::9] = idx[:, 1::9][:, : idx[:, ::9].shape[1]]
        for cb in (corpus, corpus.to(torch.bfloat16)):
            for ids in (idx, idx.to(torch.int32)):
                rows = ops.gather_l2(ids, cb, q)
                blk = ops.gather_l2(ids, cb, q, c_blk=128)
                assert torch.equal(rows, blk)
                torch.testing.assert_close(blk, ref.gather_l2_ref(ids, cb, q),
                                           rtol=1e-5, atol=1e-4)
                assert torch.equal(blk, ops.gather_l2_filter(ids, cb, attrs,
                                                             q, lo, hi))
        bad = idx.clone()
        bad[0, 0], bad[1, 1] = -1, N
        out = ops.gather_l2(bad, corpus, q, c_blk=128)
        assert torch.isinf(out[0, 0]) and torch.isinf(out[1, 1])
        assert torch.isinf(ops.gather_l2(bad, corpus, q)[1, 1])
        cand = corpus[idx]
        for c in (cand, cand.to(torch.bfloat16)):
            torch.testing.assert_close(ops.l2dist_qc(q, c),
                                       ref.l2dist_qc_ref(q, c),
                                       rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(ops.l2dist(q, cand),
                                   ref.l2dist_qc_direct(q, cand),
                                   rtol=1e-4, atol=1e-3)

    # l2dist_qc at the grid-corpus test's edges: d in {33, 96, 264, 300,
    # 768, 770, 1104}, C in {1, 70, 129}, f32, bf16 and a misaligned view
    for d in (33, 96, 264, 300, 768, 770, 1104):
        for C in (1, 70, 129):
            q = torch.randn((B, d), generator=g, device=dev)
            cand = torch.randn((B, C, d), generator=g, device=dev)
            flat = torch.empty(B * C * d + 1, device=dev)
            flat[1:] = cand.reshape(-1)
            for c in (cand, cand.to(torch.bfloat16), flat[1:].view(B, C, d)):
                torch.testing.assert_close(ops.l2dist_qc(q, c),
                                           ref.l2dist_qc_ref(q, c),
                                           rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_cuda_l2dist_qn_ragged_shapes():
    """l2dist_qn (3xTF32 on the tensor cores) against its plain version at
    shapes that fill no 128 x 128 tile and d that is not a multiple of 4 or
    of the 32-wide slab: d in {1, 33, 96, 768}, B and N in {1, 7, 130,
    5000}, G in {1, 3} (the builder's batched form; G = 1 as the 2-D form).
    Tolerance rtol 1e-4, atol 1e-3 (the expansion cancels). For d in {33,
    768} (4-byte loads with a partial last slab; 16-byte loads) and B, N in
    {130, 5000}, also against float64 on the card: the kernel's max abs
    error is at most twice the plain fp32 version's, which a lost lo term
    or a missing per-slab promotion breaks. A grid of more than 65535
    batches raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    for d in (1, 33, 96, 768):
        for B in (1, 7, 130, 5000):
            for N in (1, 7, 130, 5000):
                for G in (1, 3):
                    q = torch.randn((G, B, d), generator=g, device=dev)
                    c = torch.randn((G, N, d), generator=g, device=dev)
                    if G == 1:
                        q, c = q[0], c[0]
                    got = ops.l2dist_qn(q, c)
                    want = ref.l2dist_qn_ref(q, c)
                    torch.testing.assert_close(got, want, rtol=1e-4,
                                               atol=1e-3)
                    if d in (33, 768) and B >= 130 and N >= 130:
                        q64, c64 = q.double(), c.double()
                        t64 = ((q64 * q64).sum(-1)[..., :, None]
                               + (c64 * c64).sum(-1)[..., None, :]
                               - 2.0 * (q64 @ c64.transpose(-1, -2)))
                        e64 = float((got.double() - t64).abs().max())
                        p64 = float((want.double() - t64).abs().max())
                        assert e64 <= 2.0 * p64, (d, B, N, G, e64, p64)
    z = torch.zeros((65536, 1, 1), device=dev)
    with pytest.raises(ValueError, match="grid too large"):
        ops.l2dist_qn(z, z)


@pytest.mark.gpu
def test_cuda_mask_scan_compaction():
    """The bitmask scan (compaction, then pass 1 over the passing rows)
    against its plain version for k in {1, 10, 64}, with masks that are
    empty, all-pass, dense in one region, sparser than k, and random (NaN,
    zero and negative values fail), one and two 128-query tiles, at a d
    that takes the 16-byte loads (96) and one that does not (33). Ids and
    distances equal bit for bit to the f32 box scan's over the mask as its
    one attribute with the box [1e-30, +inf]; against the plain version,
    distances within rtol 1e-5, atol 1e-4 (reduce order) and ids equal
    except on near-ties (distances within 1e-5 relative), as
    chip_smoke.py's topk_agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    N = 20000
    rows = torch.arange(N, device=dev)
    for d in (96, 33):
        corpus = torch.randn((N, d), generator=g, device=dev)
        rand = torch.rand((N, 1), generator=g, device=dev) - 0.4
        rand[::31] = float("nan")
        rand[::37] = 0.0
        few = torch.zeros((N, 1), device=dev)
        few[[5, 77, 19999]] = 2.0
        masks = {"empty": torch.full((N, 1), -1.0, device=dev),
                 "all": torch.ones((N, 1), device=dev),
                 "region": ((rows >= 12000) & (rows < 15000)).float()
                 [:, None].contiguous(),
                 "few": few, "random": rand}
        for B in (9, 200):
            q = torch.randn((B, d), generator=g, device=dev)
            lo = torch.full((B, 1), 1e-30, device=dev)
            hi = torch.full((B, 1), float("inf"), device=dev)
            for name, mask in masks.items():
                for k in (1, 10, 64):
                    ids, dd = ops.scan_topk_mask(corpus, mask, q, k=k)
                    bids, bdd = ops.scan_topk(corpus, mask, q, lo, hi, k=k)
                    assert torch.equal(ids, bids) and torch.equal(dd, bdd), \
                        (name, B, k)
                    rids, rdd = ref.scan_topk_mask_ref(corpus, mask, q, k)
                    torch.testing.assert_close(dd, rdd, rtol=1e-5,
                                               atol=1e-4)
                    # ids equal wherever the two distances are not a
                    # near-tie that the two sum orders may break apart
                    near = (dd - rdd).abs() <= 1e-5 * rdd.abs().clamp_min(1)
                    assert bool(((ids == rids) | near).all()), (name, B, k)
            assert bool((ops.scan_topk_mask(corpus, masks["empty"], q,
                                            k=10)[0] == -1).all())


def _grid(rng, shape, lim=64):
    """k/32 values with |k| <= lim: with lim = 64 every squared difference
    is a multiple of 1/1024 below 16 and every partial sum over d <= 768
    stays below 2^14, so each f32 sum is exact in any order (and each
    value is exact in bf16 and TF32)."""
    return (rng.integers(-lim, lim + 1, size=shape) / 32).astype(np.float32)


@pytest.mark.gpu
def test_cuda_kernels_bit_equal_on_grid_corpus():
    """Every kernel form bit-equal to its plain version on a 1/32-grid
    corpus, where every f32 partial sum is exact in any order, so ids and
    distances must be ``torch.equal`` (ties to the lowest id included):
    the fused gather (f32, bf16, int8; the int8 form also at C in {1, 70,
    129}, with an all-pad lane and a lane no id passes, int32 and int64
    ids, and its replica as a misaligned view), the unfused gather in both
    forms (f32, bf16), l2dist_qc (f32, bf16; also at d in {33, 96, 264,
    300, 768, 770, 1104}, C in {1, 70, 129} and a misaligned view),
    l2dist_qn (2-D and batched; its 3xTF32 split of a grid value has a
    zero lo part), and the scan in
    f32, bf16 and int8 (int8 rows built with power-of-two scales, so the
    dequantized rows lie on the grid) plus its bitmask and windowed forms.
    The box scan's edges: N = 3001 (no multiple of any row tile), d in
    {33, 768}, B in {1, 37, 300} (300: two query blocks), k in {1, 10,
    40, 64}, and lanes with an empty box, an all-pass box, a one-row box
    and boxes of about 5%, 30% and 60% of the rows (sparse tiles, sparse
    tiles of two rounds, dense tiles); then every lane all-pass (every
    tile of the first query block dense). The windowed scan at random
    overlapping windows, at ``_windows``'s (nesting across lanes, shared
    32-row words, one-row windows, a window ending at N and one past it,
    an empty lane, W = 64) and at a batch with no window, k up to 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0xF4)
    N, m = 3001, 3
    for d in (33, 768):
        corpus = torch.as_tensor(_grid(rng, (N, d)), device=dev)
        cb = corpus.to(torch.bfloat16)
        qv = torch.as_tensor(rng.integers(-32, 33, size=(N, d)),
                             dtype=torch.int8, device=dev)
        qs = torch.as_tensor(rng.choice([1 / 16, 1 / 32], size=(N, 1)),
                             dtype=torch.float32, device=dev)
        qv[qs[:, 0] == 1 / 32] *= 2                  # |row| <= 2 either way
        attrs = rng.random((N, m)).astype(np.float32)
        attrs[:, 0] = rng.permutation(N)             # unique: one-row boxes
        attrs[5::41, 1] = np.nan
        attrs = torch.as_tensor(attrs, device=dev)

        # gathers and l2dist_qc at B = 37 lanes of C = 70 ids
        B, C = 37, 70
        q = torch.as_tensor(_grid(rng, (B, d)), device=dev)
        lo = torch.full((B, m), -1.0, device=dev)
        hi = torch.full((B, m), 2.0 * N, device=dev)
        lo[::3, 2], hi[::3, 2] = 0.3, 0.6
        idx = torch.as_tensor(rng.integers(0, N, size=(B, C)), device=dev)
        idx[:, ::9] = -1
        idx[:, 4::11] = N + 3
        for cx in (corpus, cb):
            assert torch.equal(
                ops.gather_l2_filter(idx, cx, attrs, q, lo, hi),
                ref.gather_l2_filter_ref(idx, cx, attrs, q, lo, hi))
            for ids in (idx, idx.to(torch.int32)):
                want = ref.gather_l2_ref(ids, cx, q)
                assert torch.equal(ops.gather_l2(ids, cx, q), want)
                assert torch.equal(ops.gather_l2(ids, cx, q, c_blk=128), want)
            cand = cx[idx.clamp(0, N - 1)]
            assert torch.equal(ops.l2dist_qc(q, cand), ref.l2dist_qc_ref(q, cand))
        # the int8 gather's edges: C not a multiple of its 32-lane tile,
        # an all-pad lane, a lane whose box no row passes, both id types,
        # and the replica as a view one odd-width row off 16-byte
        # alignment (its byte-load path)
        flat = torch.empty(N * d + 33, dtype=torch.int8, device=dev)
        flat[33:] = qv.reshape(-1)
        qv_off = flat[33:].view(N, d)
        rng8 = np.random.default_rng(0xF8)
        for C in (1, 70, 129):
            idx = torch.as_tensor(rng8.integers(0, N, size=(B, C)),
                                  device=dev)
            idx[:, ::9] = -1
            idx[:, 4::11] = N + 3
            idx[1] = -1                                  # all pad
            lo8, hi8 = lo.clone(), hi.clone()
            lo8[2, 1], hi8[2, 1] = 5.0, 5.0              # every id fails
            for ids in (idx, idx.to(torch.int32)):
                want = ref.gather_l2_filter_q8_ref(ids, qv, qs, attrs, q,
                                                   lo8, hi8)
                assert bool(torch.isinf(want[1:3]).all())
                for qx in (qv, qv_off):
                    got = ops.gather_l2_filter_q8(ids, qx, qs, attrs, q,
                                                  lo8, hi8)
                    assert torch.equal(got, want), (d, C, ids.dtype)
        for G in (1, 3):
            qq = torch.as_tensor(_grid(rng, (G, 130, d)), device=dev)
            cc = torch.as_tensor(_grid(rng, (G, 700, d)), device=dev)
            if G == 1:
                qq, cc = qq[0], cc[0]
            assert torch.equal(ops.l2dist_qn(qq, cc), ref.l2dist_qn_ref(qq, cc))

        # the box scan in its three forms, and the bitmask and windowed scans
        for B in (1, 37, 300):
            q = torch.as_tensor(_grid(rng, (B, d)), device=dev)
            frac = rng.choice([0.05, 0.3, 0.6], size=(B, 1)) ** (1 / 2)
            lo_np = (rng.random((B, m)) * (1 - frac)).astype(np.float32)
            hi_np = (lo_np + frac).astype(np.float32)
            lo_np[:, 0], hi_np[:, 0] = -1.0, N
            lo_np[0], hi_np[0] = np.inf, -np.inf     # empty
            if B > 2:
                lo_np[1], hi_np[1] = -1.0, N         # all-pass (NaN rows fail)
                r = int(rng.choice(np.nonzero(
                    torch.isfinite(attrs).all(1).cpu().numpy())[0]))
                lo_np[2], hi_np[2] = -1.0, 2.0
                lo_np[2, 0] = hi_np[2, 0] = attrs[r, 0].item()   # one row
            boxes = [(torch.as_tensor(lo_np, device=dev),
                      torch.as_tensor(hi_np, device=dev)),
                     (torch.full((B, m), -1.0, device=dev),
                      torch.full((B, m), float(N), device=dev))]
            for (blo, bhi) in boxes:
                for k in (1, 10, 40, 64):
                    for cx in (corpus, cb):
                        got = ops.scan_topk(cx, attrs, q, blo, bhi, k=k)
                        want = ref.scan_topk_ref(cx, attrs, q, blo, bhi, k)
                        assert torch.equal(got[0], want[0]), (d, B, k)
                        assert torch.equal(got[1], want[1]), (d, B, k)
                    got = ops.scan_topk_q8(qv, qs, attrs, q, blo, bhi, k=k)
                    want = ref.scan_topk_q8_ref(qv, qs, attrs, q, blo, bhi, k)
                    assert torch.equal(got[0], want[0]), (d, B, k)
                    assert torch.equal(got[1], want[1]), (d, B, k)
            mask = attrs[:, 1:2] - 0.4                     # NaN fails
            for k in (1, 10, 64):
                got = ops.scan_topk_mask(corpus, mask.contiguous(), q, k=k)
                want = ref.scan_topk_mask_ref(corpus, mask, q, k)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                    want[1])
            # windows: random and overlapping (W = 3), the planner's kinds
            # and harder ones (W = 64), and none at all
            wins = [(torch.as_tensor(rng.integers(-1, N, size=(B, 3)),
                                     dtype=torch.int32, device=dev),
                     torch.as_tensor(rng.integers(0, 1500, size=(B, 3)),
                                     dtype=torch.int32, device=dev)),
                    _windows(rng, B, N, 64, dev),
                    (torch.full((B, 2), -1, dtype=torch.int32, device=dev),
                     torch.zeros((B, 2), dtype=torch.int32, device=dev))]
            blo, bhi = boxes[0]
            for st, ct in wins:
                for k in (1, 10, 40, 64):
                    got = ops.scan_topk_windows(corpus, attrs, q, blo, bhi,
                                                st, ct, k=k)
                    want = ref.scan_topk_windows_ref(corpus, attrs, q, blo,
                                                     bhi, st, ct, k)
                    assert torch.equal(got[0], want[0]), (d, B, k)
                    assert torch.equal(got[1], want[1]), (d, B, k)
            assert bool((got[0] == -1).all())            # nothing covered

    # l2dist_qc's edges: one tile narrower than 128 (96), ragged last
    # tiles (264, 300), d % 4 != 0 (33, 770), two 8-tile rounds (1104),
    # C in {1, 70, 129}, f32 and bf16, and a view off 16-byte alignment;
    # values within 1, so every sum stays below 2^14 up to d = 4096
    rng = np.random.default_rng(0xE5)
    for d in (33, 96, 264, 300, 768, 770, 1104):
        for C in (1, 70, 129):
            B = 37
            q = torch.as_tensor(_grid(rng, (B, d), lim=32), device=dev)
            cand = torch.as_tensor(_grid(rng, (B, C, d), lim=32), device=dev)
            flat = torch.empty(B * C * d + 1, device=dev)
            flat[1:] = cand.reshape(-1)
            for cx in (cand, cand.to(torch.bfloat16), flat[1:].view(B, C, d)):
                assert torch.equal(ops.l2dist_qc(q, cx),
                                   ref.l2dist_qc_ref(q, cx)), (d, C, cx.dtype)


@pytest.mark.gpu
def test_cuda_bf16_windows_and_mask_bit_equal_on_grid_corpus():
    """The windowed and bitmask scans' bf16 forms (an index stored in
    bf16) ``torch.equal`` to their plain versions and to the f32 forms on
    a 1/32-grid corpus (every grid value is exact in bf16, every f32 sum
    exact in any order), with ragged shapes: N in {777, 3001}, d in {33,
    96, 768} (33: the scalar loads, d % 8 != 0), B in {1, 37, 300}, k in
    {1, 10, 64}, ``_windows``'s windows, a mask with NaN, zero and
    negative values, and the corpus as a misaligned view (scalar loads at
    any d). Each call of a bf16 form counts one launch of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0xB16)
    m = 3
    for N in (777, 3001):
        for d in (33, 96, 768):
            flat = torch.zeros(N * d + 1, dtype=torch.bfloat16, device=dev)
            for view in (False, True):
                corpus = torch.as_tensor(_grid(rng, (N, d)), device=dev)
                cb = corpus.to(torch.bfloat16)
                if view:                         # 2 bytes off 16-byte
                    flat[1:] = cb.reshape(-1)
                    cb = flat[1:].view(N, d)
                attrs = torch.as_tensor(rng.random((N, m)).astype(
                    np.float32), device=dev)
                attrs[7::41, 1] = float("nan")
                mask = torch.as_tensor(rng.random((N, 1)).astype(
                    np.float32), device=dev) - 0.4
                mask[::31] = float("nan")
                mask[::37] = 0.0
                for B in (1, 37, 300):
                    q = torch.as_tensor(_grid(rng, (B, d)), device=dev)
                    lo = torch.as_tensor(rng.random((B, m)).astype(
                        np.float32) * 0.3, device=dev)
                    hi = lo + 0.6
                    st, ct = _windows(rng, B, N, 16, dev)
                    for k in (1, 10, 64):
                        ops.reset_launches()
                        ids, dd = ops.scan_topk_windows(cb, attrs, q, lo, hi,
                                                        st, ct, k=k)
                        mi, md = ops.scan_topk_mask(cb, mask, q, k=k)
                        assert ops.LAUNCHES["scan_topk_windows_bf16"] == 1
                        assert ops.LAUNCHES["scan_topk_mask_bf16"] == 1
                        assert ops.LAUNCHES["scan_topk_windows"] == 0
                        assert ops.LAUNCHES["scan_topk_mask"] == 0
                        for got, want in (
                                ((ids, dd), ref.scan_topk_windows_ref(
                                    cb, attrs, q, lo, hi, st, ct, k)),
                                ((ids, dd), ops.scan_topk_windows(
                                    corpus, attrs, q, lo, hi, st, ct, k=k)),
                                ((mi, md), ref.scan_topk_mask_ref(
                                    cb, mask, q, k)),
                                ((mi, md), ops.scan_topk_mask(
                                    corpus, mask, q, k=k))):
                            ctx = (N, d, view, B, k)
                            assert torch.equal(got[0], want[0]), ctx
                            assert torch.equal(got[1], want[1]), ctx


@pytest.mark.gpu
def test_cuda_window_cover_matches_plain_version():
    """The windowed scan's pre-pass: its bitmap equal to
    ``ref.window_cover_ref`` and its tile flags to the tiles some lane of
    each 256-lane block covers, at ``_windows``'s windows, random
    overlapping ones and one window per lane running far past N (N =
    3001 and 4096, B in {1, 37, 300}, the tile heights of k = 10 and 64);
    W = 1 with B = 1 included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for N in (3001, 4096):
        for B in (1, 37, 300):
            wins = [_windows(rng, B, N, 64, dev),
                    (torch.as_tensor(rng.integers(-1, N, size=(B, 5)),
                                     dtype=torch.int32, device=dev),
                     torch.as_tensor(rng.integers(-2, 900, size=(B, 5)),
                                     dtype=torch.int32, device=dev)),
                    (torch.as_tensor(rng.integers(0, N, size=(B, 1)),
                                     dtype=torch.int32, device=dev),
                     torch.full((B, 1), 2**31 - N, dtype=torch.int32,
                                device=dev))]
            for st, ct in wins:
                want = ref.window_cover_ref(st, ct, N)
                nwords = want.shape[1]
                cov = want.cpu().numpy().view(np.uint32)
                rows = ((cov[:, :, None] >> np.arange(32, dtype=np.uint32))
                        & 1).reshape(B, -1)[:, :N].astype(bool)
                for k in (10, 64):
                    plan = ops._scan_plan(B, N, k, 132)
                    got = ops._window_cover(st, ct, N, plan)
                    assert torch.equal(got[:B * nwords].view(B, nwords),
                                       want), (N, B, k)
                    tr, nt = plan.tile_rows, plan.tiles
                    pad = np.zeros((B, nt * tr), bool)
                    pad[:, :N] = rows
                    lanes = pad.reshape(B, nt, tr).any(-1)
                    flags = np.zeros((plan.query_blocks, nt), np.uint8)
                    for y in range(plan.query_blocks):
                        flags[y] = lanes[256 * y:256 * (y + 1)].any(0)
                    got_f = got[B * nwords:].cpu().numpy().view(np.uint8)
                    np.testing.assert_array_equal(
                        got_f[:plan.query_blocks * nt].reshape(flags.shape),
                        flags)


@pytest.mark.gpu
def test_cuda_windows_covering_all_rows_equal_box_scan():
    """On a float corpus, a windowed scan whose every lane's windows cover
    [0, N) -- one window, windows tiling it back to back at random cuts
    (edges inside 32-row words), overlapping windows, pads among them, a
    window running past N -- is ``torch.equal`` to the f32 box scan on the
    same rows: the same tiles, pass bits and fmaf chain, and positions
    are row ids. d in {33, 96}, B in {1, 37, 300}, k in {1, 10, 64}, boxes
    of about 5-60% of the rows, NaN attrs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    rng = np.random.default_rng(8)
    N, m = 5000, 3
    for d in (33, 96):
        corpus = torch.randn((N, d), generator=g, device=dev)
        attrs = torch.rand((N, m), generator=g, device=dev)
        attrs[5::41, 1] = float("nan")
        for B in (1, 37, 300):
            q = torch.randn((B, d), generator=g, device=dev)
            lo = torch.rand((B, m), generator=g, device=dev) * 0.3
            hi = lo + torch.rand((B, m), generator=g, device=dev) * 0.5 + 0.3
            W = 12
            st = np.full((B, W), -1, np.int64)
            ct = np.zeros((B, W), np.int64)
            for b in range(B):
                kind = b % 4
                if kind == 0:
                    st[b, 0], ct[b, 0] = 0, N
                elif kind == 1:
                    cut = np.concatenate([[0], np.sort(rng.choice(
                        np.arange(1, N), size=W - 1, replace=False)), [N]])
                    st[b], ct[b] = cut[:-1], np.diff(cut)
                elif kind == 2:
                    st[b, :3], ct[b, :3] = [0, 1000, 2500], [1500, 2000, 2500]
                else:
                    st[b, 2:4], ct[b, 2:4] = [0, 2999], [3000, 10 * N]
            st = torch.as_tensor(st, dtype=torch.int32, device=dev)
            ct = torch.as_tensor(ct, dtype=torch.int32, device=dev)
            for k in (1, 10, 64):
                got = ops.scan_topk_windows(corpus, attrs, q, lo, hi, st, ct,
                                            k=k)
                want = ops.scan_topk(corpus, attrs, q, lo, hi, k=k)
                assert torch.equal(got[0], want[0]), (d, B, k)
                assert torch.equal(got[1], want[1]), (d, B, k)
                uncovered = int(ops.SCAN_TILES["scan_topk_windows"][0])
                assert uncovered == 0, (d, B, k)


@pytest.mark.gpu
def test_cuda_scan_and_rerank_bit_equal_at_delta_shapes():
    """The box scan in f32, bf16 and int8 and the f32 rerank gather at the
    streaming delta's shapes, on a 1/32-grid corpus (every sum exact in
    any order), each ``torch.equal`` to its plain version: N in {1, 16,
    32, 4096, 131072} rows of which none, one, half or all are live (the
    rest NaN attrs, as unwritten and deleted slots; the unwritten half of
    the rows zero), k in {N when N <= 64, 10, 40} capped at N, B in {1,
    37, 256} lanes with an all-pass, an empty and narrower boxes; the
    rerank gathers the int8 scan's ids, -1 past its in-range count. Then
    one full-width case: N = 131072, d = 768, B = 256, half live."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0xD17A)
    m = 4

    def case(N, d, live, B, ks):
        vecs = _grid(rng, (N, d))
        attrs = rng.integers(0, 16, size=(N, m)).astype(np.float32)
        dead = np.ones(N, bool)
        dead[rng.choice(N, size=live, replace=False)] = False
        attrs[dead] = np.nan
        vecs[N - (N - live) // 2:] = 0.0       # unwritten slots
        corpus = torch.as_tensor(vecs, device=dev)
        at = torch.as_tensor(attrs, device=dev)
        qv = torch.as_tensor(rng.integers(-32, 33, size=(N, d)),
                             dtype=torch.int8, device=dev)
        qs = torch.as_tensor(rng.choice([1 / 16, 1 / 32], size=(N, 1)),
                             dtype=torch.float32, device=dev)
        qv[qs[:, 0] == 1 / 32] *= 2
        q = torch.as_tensor(_grid(rng, (B, d)), device=dev)
        lo = rng.integers(0, 10, size=(B, m)).astype(np.float32)
        hi = lo + rng.integers(2, 8, size=(B, m)).astype(np.float32)
        lo[::3], hi[::3] = -1.0, 16.0                  # all-pass
        lo[1::7], hi[1::7] = np.inf, -np.inf           # empty
        lo = torch.as_tensor(lo, device=dev)
        hi = torch.as_tensor(hi, device=dev)
        for k in sorted({min(k, N) for k in ks}):
            for cx in (corpus, corpus.to(torch.bfloat16)):
                got = ops.scan_topk(cx, at, q, lo, hi, k=k)
                want = ref.scan_topk_ref(cx, at, q, lo, hi, k)
                assert torch.equal(got[0], want[0]), (N, live, B, k)
                assert torch.equal(got[1], want[1]), (N, live, B, k)
            got = ops.scan_topk_q8(qv, qs, at, q, lo, hi, k=k)
            want = ref.scan_topk_q8_ref(qv, qs, at, q, lo, hi, k)
            assert torch.equal(got[0], want[0]), (N, live, B, k)
            assert torch.equal(got[1], want[1]), (N, live, B, k)
            cids = want[0]
            assert torch.equal(
                ops.gather_l2_filter(cids, corpus, at, q, lo, hi),
                ref.gather_l2_filter_ref(cids, corpus, at, q, lo, hi))
            if live == 0:
                assert bool((got[0] == -1).all())

    for N in (1, 16, 32, 4096, 131072):
        for live in sorted({0, 1, N // 2, N}):
            for B in (1, 37, 256):
                case(N, 96, live, B, ((N,) if N <= 64 else ()) + (10, 40))
    case(131072, 768, 65536, 256, (10, 40))


@pytest.mark.gpu
def test_cuda_sharded_fanout_matches_plain_versions():
    """The sharded index on the card: a 1/32-grid corpus (d = 32, every
    distance exact) built by ``build_sharded`` into 3 shards of unequal
    size, served by the kernels (``pallas_gather_l2_filter``) and by the
    plain versions (``jnp``) on the same stacked index, under the graph
    fan-out (ids and per-shard hops), scan, auto, hybrid and the bitmask
    expression: ids and distances equal, and every kernel of the path
    launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.core import KHIConfig, engine, sharded
    from repro_torch.core.predicate import parse_expr

    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    n, d, B = 3001, 32, 40
    vecs = _grid(rng, (n, d))
    attrs = rng.integers(0, 16, size=(n, 3)).astype(np.float32)
    skhi = sharded.build_sharded(vecs, attrs, 3, KHIConfig(M=16,
                                                           builder="device"),
                                 device=dev)
    assert skhi.pad_waste[0] > 0
    q = _grid(rng, (B, d))
    lo = rng.integers(0, 8, size=(B, 3)).astype(np.float32)
    hi = lo + rng.integers(3, 12, size=(B, 3)).astype(np.float32)
    lo[::4], hi[::4] = -1.0, 16.0                      # wide: graph lanes

    def params(backend, **kw):
        return engine.SearchParams(k=10, ef=48, c_n=16, expand_width=4,
                                   backend=backend, scan_threshold=300,
                                   node_scan_threshold=40, **kw)

    ops.reset_launches()
    got = sharded.search_sharded_emulated(
        skhi, q, lo, hi, params("pallas_gather_l2_filter"))
    want = sharded.search_sharded_emulated(skhi, q, lo, hi, params("jnp"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2].shape == (3, B) and ops.LAUNCHES["gather_l2_filter"] > 0
    expr = parse_expr("a0 in [1, 3, 5, 7, 9, 11, 13, 15, 17, 19] and "
                      "a1 <= 9", 3)
    for strategy in ("scan", "auto", "hybrid"):
        ops.reset_launches()
        pk = engine.Planner(skhi, params("pallas_gather_l2_filter",
                                         strategy=strategy))
        pj = engine.Planner(skhi, params("jnp", strategy=strategy))
        for a, b in zip(pk.search(q, lo, hi)[:3], pj.search(q, lo, hi)[:3]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(pk.search_expr(q, expr)[:3],
                        pj.search_expr(q, expr)[:3]):
            np.testing.assert_array_equal(a, b)
        want_k = {"scan": "scan_topk", "auto": "scan_topk",
                  "hybrid": "scan_topk_windows"}[strategy]
        assert ops.LAUNCHES[want_k] > 0 and ops.LAUNCHES["scan_topk_mask"] > 0


def _wide_case(rng, N, d, m, B, dev):
    """A grid corpus (f32, bf16 and an int8 replica on the grid), attrs
    whose column 0 is a permutation of [0, N) (so a box on it holds an
    exact number of rows) with NaNs in column 1, and B lanes of boxes:
    lane 0 empty, lane 1 all-pass (every row but the NaN ones), lane 2 sparser than any k here (20
    rows), lane 3 one row, the rest random boxes on every attribute."""
    corpus = torch.as_tensor(_grid(rng, (N, d)), device=dev)
    qv = torch.as_tensor(rng.integers(-32, 33, size=(N, d)),
                         dtype=torch.int8, device=dev)
    qs = torch.as_tensor(rng.choice([1 / 16, 1 / 32], size=(N, 1)),
                         dtype=torch.float32, device=dev)
    qv[qs[:, 0] == 1 / 32] *= 2
    a = rng.random((N, m)).astype(np.float32)
    a[:, 0] = rng.permutation(N)
    a[5::41, 1] = np.nan
    lo = (rng.random((B, m)) * 0.3).astype(np.float32)
    hi = lo + 0.55
    lo[:, 0], hi[:, 0] = -1.0, float(N)
    lo[0, 0], hi[0, 0] = 1.0, 0.0                    # empty
    lo[1], hi[1] = -1.0, float(N)                    # all but NaN rows
    lo[2], hi[2] = -1.0, float(N)
    lo[2, 0], hi[2, 0] = 100.0, 119.0                # 20 rows at most
    lo[3], hi[3] = -1.0, float(N)
    lo[3, 0], hi[3, 0] = 7.0, 7.0                    # one row
    q = torch.as_tensor(_grid(rng, (B, d)), device=dev)
    return (corpus, qv, qs, torch.as_tensor(a, device=dev), q,
            torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev))


def _check_lists(name, counts, forced):
    """A wide form's stats of its last call: the
    overflowed queries (the count past the lists' capacity), and where no
    list was forced small each query's listed count equal to the plain
    twin's (the sample then lists every sampled pair, so the thresholds,
    and the pairs within them, are the twin's)."""
    st = ops.WIDE_STATS[name].cpu()
    if forced:
        assert int(st[-1]) > 0, name
    else:
        assert int(st[-1]) == 0, name
        assert torch.equal(st[:-1].long(), counts.cpu()), name


@pytest.mark.gpu
@pytest.mark.parametrize("m", [3, 9, 12])
def test_cuda_wide_scan_forms_bit_equal_on_grid_corpus(m, monkeypatch):
    """The scan family's wide form (any k, any m) ``torch.equal`` to its
    plain version on a 1/32-grid corpus, where every f32 sum is exact in
    any order: the box scan (f32, bf16, int8) and the windowed scan (f32,
    bf16) at m in {3, 9, 12}, the bitmask scan (f32, bf16; it reads no
    attrs), each at k in {65, 100, 400, N} with N = 1500, d in {33, 96},
    lanes with an empty, an all-pass, a 20-row and a one-row box, and
    ``_windows``'s windows. The wide form scores and selects the batch in
    chunks: the scratch is cut so B = 37 takes three to five. At m > 8 k =
    10 takes the wide form too. Each call counts one launch of its wide
    form and none of a narrow one.

    Every form runs each case at the sample stride the wrapper uses (16:
    at N = 1500 its samples are one row tile, so at k >= 400 every
    threshold is +inf) and at 2 (finite thresholds), its listed counts
    equal to the plain twin's; then on a corpus whose rows are all equal
    (every pair of a query at one distance: ties to the lowest id or
    position), and with the lists' capacity forced down to k, where the
    overflow counter must count the queries the exact re-pass
    finished."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0xF8 + m)
    N, B = 1500, 37
    for d in (33, 96):
        corpus, qv, qs, attrs, q, lo, hi = _wide_case(rng, N, d, m, B, dev)
        cb = corpus.to(torch.bfloat16)
        mask = torch.as_tensor(rng.random((N, 1)).astype(np.float32),
                               device=dev) - 0.3
        mask[::31] = float("nan")
        mask[::37] = 0.0
        st, ct = _windows(rng, B, N, 16, dev)
        ks = (65, 100, 400, N) + ((10,) if m > 8 else ())
        for k in ks:
            monkeypatch.setattr(ops, "WIDE_SCRATCH_BYTES",
                                16 * (4 * N + 16 * k))
            cases = [
                ("scan_topk_wide",
                 lambda: ops.scan_topk(corpus, attrs, q, lo, hi, k=k),
                 lambda: ref.scan_topk_ref(corpus, attrs, q, lo, hi, k)),
                ("scan_topk_wide_bf16",
                 lambda: ops.scan_topk(cb, attrs, q, lo, hi, k=k),
                 lambda: ref.scan_topk_ref(cb, attrs, q, lo, hi, k)),
                ("scan_topk_wide_q8",
                 lambda: ops.scan_topk_q8(qv, qs, attrs, q, lo, hi, k=k),
                 lambda: ref.scan_topk_q8_ref(qv, qs, attrs, q, lo, hi, k)),
                ("scan_topk_windows_wide",
                 lambda: ops.scan_topk_windows(corpus, attrs, q, lo, hi, st,
                                               ct, k=k),
                 lambda: ref.scan_topk_windows_ref(corpus, attrs, q, lo, hi,
                                                   st, ct, k)),
                ("scan_topk_windows_wide_bf16",
                 lambda: ops.scan_topk_windows(cb, attrs, q, lo, hi, st, ct,
                                               k=k),
                 lambda: ref.scan_topk_windows_ref(cb, attrs, q, lo, hi, st,
                                                   ct, k)),
            ]
            if k > ops.SCAN_KMAX:
                cases += [
                    ("scan_topk_mask_wide",
                     lambda: ops.scan_topk_mask(corpus, mask, q, k=k),
                     lambda: ref.scan_topk_mask_ref(corpus, mask, q, k)),
                    ("scan_topk_mask_wide_bf16",
                     lambda: ops.scan_topk_mask(cb, mask, q, k=k),
                     lambda: ref.scan_topk_mask_ref(cb, mask, q, k)),
                ]
            for name, kern, plain in cases:
                ops.reset_launches()
                ids, dd = kern()
                torch.cuda.synchronize()
                launched = {n for n, c in ops.LAUNCHES.items() if c}
                assert launched == {name}, (name, launched)
                rids, rdd = plain()
                ctx = (name, d, m, k)
                assert torch.equal(ids, rids), ctx
                assert torch.equal(dd, rdd), ctx
                if "mask" not in name:       # the boxes' lanes
                    assert bool((ids[0] == -1).all()), ctx
                    assert int((ids[2] >= 0).sum()) <= 20, ctx
            _list_cases(corpus, cb, qv, qs, attrs, q, lo, hi, mask, st, ct,
                        k, monkeypatch)


def _list_cases(corpus, cb, qv, qs, attrs, q, lo, hi, mask, st, ct, k,
                monkeypatch):
    """The box, windowed and bitmask wide forms at sample strides 16 and
    2, on the corpus and on one whose rows are all equal (its int8
    replica too), then with their lists' capacity forced down to k: each
    call ``torch.equal`` to its plain version, its form launched, its
    stats checked by ``_check_lists`` against the plain twin."""
    flat = corpus[:1].expand_as(corpus).contiguous()
    flat_v = qv[:1].expand_as(qv).contiguous()
    flat_s = qs[:1].expand_as(qs).contiguous()
    for (c32, v8, s8), stride, cap in (
            ((corpus, qv, qs), 16, None), ((corpus, qv, qs), 2, None),
            ((flat, flat_v, flat_s), 2, None), ((corpus, qv, qs), 2, k),
            ((flat, flat_v, flat_s), 16, k)):
        monkeypatch.setattr(ops, "WIDE_SAMPLE_STRIDE", stride)
        monkeypatch.setattr(ops, "WIDE_CAPACITY", cap)
        cbf = c32.to(torch.bfloat16)
        twin_box = ref.scan_topk_wide_twin(c32, attrs, q, lo, hi, k,
                                           stride=stride, cap=cap)
        twin_q8 = ref.scan_topk_wide_twin(v8, attrs, q, lo, hi, k,
                                          qscale=s8, stride=stride, cap=cap)
        twin_mask = ref.scan_topk_mask_wide_twin(c32, mask, q, k,
                                                 stride=stride, cap=cap)
        twin_win = ref.scan_topk_windows_wide_twin(
            c32, attrs, q, lo, hi, st, ct, k, stride=stride, cap=cap)
        cases = [
            ("scan_topk_wide", twin_box,
             lambda: ops.scan_topk(c32, attrs, q, lo, hi, k=k),
             lambda: ref.scan_topk_ref(c32, attrs, q, lo, hi, k)),
            ("scan_topk_wide_bf16", twin_box,
             lambda: ops.scan_topk(cbf, attrs, q, lo, hi, k=k),
             lambda: ref.scan_topk_ref(cbf, attrs, q, lo, hi, k)),
            ("scan_topk_wide_q8", twin_q8,
             lambda: ops.scan_topk_q8(v8, s8, attrs, q, lo, hi, k=k),
             lambda: ref.scan_topk_q8_ref(v8, s8, attrs, q, lo, hi, k)),
            ("scan_topk_windows_wide", twin_win,
             lambda: ops.scan_topk_windows(c32, attrs, q, lo, hi, st, ct,
                                           k=k),
             lambda: ref.scan_topk_windows_ref(c32, attrs, q, lo, hi, st,
                                               ct, k)),
            ("scan_topk_windows_wide_bf16", twin_win,
             lambda: ops.scan_topk_windows(cbf, attrs, q, lo, hi, st, ct,
                                           k=k),
             lambda: ref.scan_topk_windows_ref(cbf, attrs, q, lo, hi, st,
                                               ct, k))]
        if k > ops.SCAN_KMAX:
            cases += [
                ("scan_topk_mask_wide", twin_mask,
                 lambda: ops.scan_topk_mask(c32, mask, q, k=k),
                 lambda: ref.scan_topk_mask_ref(c32, mask, q, k)),
                ("scan_topk_mask_wide_bf16", twin_mask,
                 lambda: ops.scan_topk_mask(cbf, mask, q, k=k),
                 lambda: ref.scan_topk_mask_ref(cbf, mask, q, k))]
        for name, twin, kern, plain in cases:
            ops.reset_launches()
            ids, dd = kern()
            torch.cuda.synchronize()
            launched = {n for n, c in ops.LAUNCHES.items() if c}
            assert launched == {name}, (name, launched)
            rids, rdd = plain()
            ctx = (name, k, stride, cap, c32 is flat)
            assert torch.equal(ids, rids) and torch.equal(dd, rdd), ctx
            assert torch.equal(ids.cpu(), twin[0].cpu()), ctx
            # forced: some list holds more than k pairs within its tau
            _check_lists(name, twin[2], cap is not None and twin[3] > 0)


@pytest.mark.gpu
def test_cuda_wide_mask_equals_wide_box_scan():
    """The bitmask scan's wide form at k = 100 equals the f32 box scan's
    wide form on the mask given as a one-attribute box ([1e-30, +inf]
    passes exactly the rows whose mask is > 0): both run one fmaf chain a
    distance and the same selection. At N = 20,000, d = 768, B = 256 (one
    chunk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    N, d, B, k = 20_000, 768, 256, 100
    corpus = torch.randn((N, d), generator=g, device=dev)
    q = torch.randn((B, d), generator=g, device=dev)
    mask = torch.where(torch.rand((N, 1), generator=g, device=dev) < 0.3,
                       1.0, -1.0)
    mask[::53] = float("nan")
    mask[::59] = 0.0
    ids, dd = ops.scan_topk_mask(corpus, mask, q, k=k)
    bids, bdd = ops.scan_topk(corpus, mask, q,
                              torch.full((B, 1), 1e-30, device=dev),
                              torch.full((B, 1), float("inf"), device=dev),
                              k=k)
    torch.cuda.synchronize()
    assert torch.equal(ids, bids) and torch.equal(dd, bdd)
    rids, rdd = ref.scan_topk_mask_ref(corpus, mask, q, k)
    torch.testing.assert_close(dd, rdd, rtol=1e-5, atol=1e-3)
