"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes exactly what its CUDA kernel in ``kernels/csrc``
computes, with the arithmetic of ``repro.kernels.ref`` (the JAX package's
oracles): the CPU runs these, the tests hold them against the JAX kernels,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
``ops.py`` calls them only for tensors that lie on the CPU.

``CALLS`` counts calls per device type, so a run can show that the CUDA
main path never fell through to a plain version.
"""

from __future__ import annotations

import torch

from .quant import dequant_rows

__all__ = ["CALLS", "reset_calls", "lex_smallest", "l2dist_qn_ref",
           "l2dist_qc_ref", "l2dist_qc_direct", "qc_tile_width",
           "gather_l2_ref", "gather_l2_filter_ref", "scan_topk_ref",
           "gather_l2_filter_q8_ref", "scan_topk_q8_ref",
           "scan_topk_mask_ref", "scan_topk_windows_ref",
           "window_cover_ref", "wide_select_twin", "scan_topk_wide_twin",
           "scan_topk_mask_wide_twin"]

CALLS = {name: {"cpu": 0, "cuda": 0}
         for name in ("gather_l2_filter", "scan_topk", "l2dist_qn",
                      "gather_l2_filter_q8", "scan_topk_q8",
                      "scan_topk_mask", "scan_topk_windows", "gather_l2",
                      "l2dist_qc")}

_INF = float("inf")


def reset_calls() -> None:
    for c in CALLS.values():
        c["cpu"] = c["cuda"] = 0


def _count(name: str, t: torch.Tensor) -> None:
    kind = t.device.type
    if kind in CALLS[name]:
        CALLS[name][kind] += 1


def _order_key(vals: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order is the float32 order of ``vals`` with
    the column index as the tie-break: (monotone float bits << 32) | col.
    Keys are unique per row, so any top-k over them is deterministic."""
    bits = vals.to(torch.float32).contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    col = torch.arange(vals.shape[-1], device=vals.device, dtype=torch.int64)
    return (bits << 32) + col


def _lex_smallest_keyed(vals: torch.Tensor, k: int):
    key = _order_key(vals)
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    idx = top & 0xFFFFFFFF
    return vals.gather(-1, idx), idx


def lex_smallest(vals: torch.Tensor, k: int):
    """The k smallest entries of the last axis, ascending, ties to the
    lowest index: the ``lax.top_k(-vals, k)`` contract. Returns (values,
    indices int64).

    Wide rows take a plain float top-k first: where exactly k entries are
    <= the k-th value, that set is the answer and only its k members are
    ordered by (value, index); rows with a tie at the k-th value (or
    fewer than k finite entries) are redone with the exact int64 key."""
    shape = vals.shape
    C = shape[-1]
    if C <= (1 << 14):
        return _lex_smallest_keyed(vals, k)
    flat = vals.reshape(-1, C)
    v, i = torch.topk(flat, k, dim=-1, largest=False, sorted=False)
    kth = v.max(-1, keepdim=True).values
    tied = (flat <= kth).sum(-1) != k
    key = (_order_key(v) >> 32 << 32) + i
    o = torch.argsort(key, dim=-1)
    v, i = v.gather(-1, o), i.gather(-1, o)
    if bool(tied.any()):
        rows = torch.nonzero(tied).squeeze(1)
        v[rows], i[rows] = _lex_smallest_keyed(flat[rows], k)
    return v.reshape(shape[:-1] + (k,)), i.reshape(shape[:-1] + (k,))


def l2dist_qn_ref(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """All-pairs squared L2 by the expansion ‖q‖²+‖c‖²−2q·c:
    q (B, d), c (N, d) -> (B, N), or batched (G, B, d), (G, N, d) ->
    (G, B, N), f32."""
    _count("l2dist_qn", q)
    # full fp32 products: TF32 would keep ~3 decimal digits, and the
    # kernel this version checks accumulates in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    q = q.to(torch.float32)
    c = c.to(torch.float32)
    qs = (q * q).sum(-1, keepdim=True)
    cs = (c * c).sum(-1).unsqueeze(-2)
    return qs + cs - 2.0 * (q @ c.transpose(-1, -2))


def qc_tile_width(d: int) -> int:
    """The d-tile width of the per-candidate expansion: the reference's
    ``_dist_ids_pallas_l2`` tiles d by ``min(128, ceil8(d))``."""
    return min(128, -(-d // 8) * 8)


def l2dist_qc_ref(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per-query candidates by the expansion, as the TPU kernel
    ``l2dist_qc_kernel`` computes it: q (B, d), c (B, C, d) (any float,
    upcast) -> (B, C) f32, the sum over d-tiles of width
    ``qc_tile_width(d)`` of ``|q_t|^2 + |c_t|^2 - 2 q_t.c_t``, added
    tile by tile. The expansion cancels, so it loses digits against the
    direct form (``l2dist_qc_direct``) where a distance is small next to
    the norms."""
    _count("l2dist_qc", c)
    q = q.to(torch.float32)
    c = c.to(torch.float32)
    d = q.shape[-1]
    td = qc_tile_width(d)
    out = torch.zeros(c.shape[:-1], dtype=torch.float32, device=c.device)
    for t0 in range(0, d, td):
        qt = q[:, t0:t0 + td]
        ct = c[:, :, t0:t0 + td]
        qs = (qt * qt).sum(-1, keepdim=True)              # (B, 1)
        cs = (ct * ct).sum(-1)                            # (B, C)
        qc = (ct * qt[:, None, :]).sum(-1)                # (B, C)
        out = out + (qs + cs - 2.0 * qc)
    return out


def l2dist_qc_direct(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The direct form ``sum((c - q)^2)`` of the JAX package's
    ``ref.l2dist_qc_ref``: q (B, d), c (B, C, d) -> (B, C) f32. An oracle
    for the tests; no kernel computes it this way."""
    diff = c.to(torch.float32) - q.to(torch.float32)[:, None, :]
    return (diff * diff).sum(-1)


def gather_l2_ref(idx: torch.Tensor, corpus: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """Fused gather + squared L2 with no predicate: idx (B, C) into corpus
    (N, d) f32 or bf16, q (B, d) -> (B, C) f32, ``sum((q - row)^2)`` with
    the row upcast to f32. The caller clamps ids into range; an id outside
    [0, N) gives +inf, as in the kernel, which never reads past the
    corpus."""
    _count("gather_l2", corpus)
    N = corpus.shape[0]
    valid = (idx >= 0) & (idx < N)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    diff = dequant_rows(corpus[safe]) - q.to(torch.float32)[:, None, :]
    dist = (diff * diff).sum(-1)
    return torch.where(valid, dist, torch.full_like(dist, _INF))


def _gather_l2_filter(idx, N, rows_of, attrs, q, qlo, qhi):
    valid = (idx >= 0) & (idx < N)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    rows = rows_of(safe)                                  # (B, C, d) f32
    diff = rows - q.to(torch.float32)[:, None, :]
    dist = (diff * diff).sum(-1)
    a = attrs[safe].to(torch.float32)                     # (B, C, m)
    ok = ((a >= qlo[:, None, :]) & (a <= qhi[:, None, :])).all(-1)
    return torch.where(ok & valid, dist, torch.full_like(dist, _INF))


def gather_l2_filter_ref(idx: torch.Tensor, corpus: torch.Tensor,
                         attrs: torch.Tensor, q: torch.Tensor,
                         qlo: torch.Tensor, qhi: torch.Tensor) -> torch.Tensor:
    """idx (B, C) (-1 = pad) into corpus (N, d) f32 or bf16 / attrs
    (N, m), q (B, d), qlo/qhi (B, m) -> (B, C) f32:
    ``sum((q - corpus[idx])^2)`` with the row upcast to f32, or +inf when
    the lane is a pad, lies outside [0, N), or its attribute row fails
    ``all(qlo <= a <= qhi)`` (NaN fails)."""
    _count("gather_l2_filter", corpus)
    return _gather_l2_filter(idx, corpus.shape[0],
                             lambda safe: dequant_rows(corpus[safe]),
                             attrs, q, qlo, qhi)


def gather_l2_filter_q8_ref(idx: torch.Tensor, qcorpus: torch.Tensor,
                            qscale: torch.Tensor, attrs: torch.Tensor,
                            q: torch.Tensor, qlo: torch.Tensor,
                            qhi: torch.Tensor) -> torch.Tensor:
    """``gather_l2_filter_ref`` over an int8 replica: qcorpus (N, d) int8
    with its per-row scale (N, 1) f32; the gathered rows dequantize
    (``dequant_rows``) before they are scored."""
    _count("gather_l2_filter_q8", qcorpus)
    return _gather_l2_filter(
        idx, qcorpus.shape[0],
        lambda safe: dequant_rows(qcorpus[safe], qscale[safe]),
        attrs, q, qlo, qhi)


def _box_ok(a, qlo, qhi):
    """(ch, m) attrs x (B, m) boxes -> (B, ch) bool; NaN fails."""
    a = a.to(torch.float32)
    return ((a[None] >= qlo[:, None, :]) & (a[None] <= qhi[:, None, :])
            ).all(-1)


def _masked_dist(c, ok, q):
    """(B, ch) f32 squared distances of q (B, d) to the rows c (ch, d),
    +inf where ``ok`` (broadcast to (B, ch)) is False."""
    diff = c[None, :, :] - q[:, None, :]
    dist = (diff * diff).sum(-1)
    return torch.where(ok, dist, torch.full_like(dist, _INF))


def _scan_topk(N, rows_of, ok_of, q, k, budget):
    """The running top-k over rows [0, N) in chunks: ``rows_of(s, e)``
    gives the rows as f32, ``ok_of(s, e)`` which (query, row) pairs pass,
    (B, e - s) or (1, e - s)."""
    B, d = q.shape
    if not 1 <= k <= N:
        raise ValueError(f"k must be in [1, N={N}], got {k}")
    q = q.to(torch.float32)
    dev = q.device
    best_d = torch.empty((B, 0), dtype=torch.float32, device=dev)
    best_i = torch.empty((B, 0), dtype=torch.int64, device=dev)
    step = max(1, budget // max(1, B * d))
    for s in range(0, N, step):
        c = rows_of(s, min(N, s + step))                  # (ch, d) f32
        dist = _masked_dist(c, ok_of(s, s + c.shape[0]), q)  # (B, ch)
        rows = torch.arange(s, s + c.shape[0], device=dev,
                            dtype=torch.int64).expand(B, -1)
        cand_d = torch.cat([best_d, dist], 1)
        cand_i = torch.cat([best_i, rows], 1)
        best_d, pos = lex_smallest(cand_d, min(k, cand_d.shape[1]))
        best_i = cand_i.gather(1, pos)
    ids = torch.where(torch.isfinite(best_d), best_i,
                      torch.full_like(best_i, -1))
    return ids.to(torch.int32), best_d


def scan_topk_ref(corpus: torch.Tensor, attrs: torch.Tensor, q: torch.Tensor,
                  qlo: torch.Tensor, qhi: torch.Tensor, k: int, *,
                  budget: int = 1 << 27):
    """Exact predicate-masked top-k over every row: corpus (N, d) f32 or
    bf16 (upcast), attrs (N, m), q (B, d), qlo/qhi (B, m) -> (ids (B, k)
    int32, dists (B, k) f32), ascending, distance ties to the lowest row
    id, (-1, +inf) past the in-range count; NaN attrs never match.

    Rows stream in chunks of at most ``budget`` (query, row, dim)
    elements, folding each chunk into a running top-k: the running list
    precedes the chunk, so position order is row-id order and the
    lowest-index tie-break of ``lex_smallest`` is the lowest-id one."""
    _count("scan_topk", corpus)
    return _scan_topk(corpus.shape[0],
                      lambda s, e: dequant_rows(corpus[s:e]),
                      lambda s, e: _box_ok(attrs[s:e], qlo, qhi),
                      q, k, budget)


def scan_topk_q8_ref(qcorpus: torch.Tensor, qscale: torch.Tensor,
                     attrs: torch.Tensor, q: torch.Tensor,
                     qlo: torch.Tensor, qhi: torch.Tensor, k: int, *,
                     budget: int = 1 << 27):
    """``scan_topk_ref`` over an int8 replica (qcorpus (N, d) int8, qscale
    (N, 1) f32), dequantized chunk by chunk within ``budget``. Distances
    are over the quantized rows: the engine reranks the returned ids
    through the f32 path."""
    _count("scan_topk_q8", qcorpus)
    return _scan_topk(qcorpus.shape[0],
                      lambda s, e: dequant_rows(qcorpus[s:e], qscale[s:e]),
                      lambda s, e: _box_ok(attrs[s:e], qlo, qhi),
                      q, k, budget)


def scan_topk_mask_ref(corpus: torch.Tensor, mask: torch.Tensor,
                       q: torch.Tensor, k: int, *, budget: int = 1 << 27):
    """Exact top-k under one row mask shared by the batch: corpus (N, d)
    f32 or bf16 (rows upcast to f32, as the reference's kernel body does),
    mask (N,) or (N, 1) f32 (a row passes iff its value is > 0, so NaN
    fails), q (B, d) -> (ids (B, k) int32, dists (B, k) f32),
    ascending by (distance, id), (-1, +inf) past the passing count. Rows
    stream in chunks of at most ``budget`` elements, as
    ``scan_topk_ref``."""
    _count("scan_topk_mask", corpus)
    ok = mask.reshape(-1).to(torch.float32) > 0.0
    return _scan_topk(corpus.shape[0],
                      lambda s, e: dequant_rows(corpus[s:e]),
                      lambda s, e: ok[None, s:e], q, k, budget)


def scan_topk_windows_ref(corpus: torch.Tensor, attrs: torch.Tensor,
                          q: torch.Tensor, qlo: torch.Tensor,
                          qhi: torch.Tensor, starts: torch.Tensor,
                          counts: torch.Tensor, k: int, *,
                          budget: int = 1 << 27):
    """Exact masked top-k over each query's windows of a position-ordered
    corpus: corpus (N, d) f32 or bf16 (rows upcast to f32, as the
    reference's kernel body does) and attrs (N, m) in position order,
    q (B, d),
    qlo/qhi (B, m), starts/counts (B, W) int32 (a window with start < 0 is
    a pad) -> (positions (B, k) int32, dists (B, k) f32). A row takes
    part for query b iff it lies in one of b's windows and passes b's box
    (NaN fails); ascending by (distance, position), (-1, +inf) past the
    passing count.

    The reference's oracle builds a dense (B, W, N) coverage plane; this
    version gathers each lane's covered positions instead (their union,
    sorted, so window order and overlap do not matter), scores the
    (lane, position) pairs in chunks of at most ``budget`` elements, and
    ranks each lane's pairs by (distance, position) with stable sorts."""
    _count("scan_topk_windows", corpus)
    N = corpus.shape[0]
    B, d = q.shape
    if not 1 <= k <= N:
        raise ValueError(f"k must be in [1, N={N}], got {k}")
    dev = corpus.device
    q = q.to(torch.float32)
    ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    dists = torch.full((B, k), _INF, dtype=torch.float32, device=dev)
    st = starts.to(torch.int64)
    live = (st >= 0) & (counts > 0)
    st = torch.where(live, st, torch.zeros_like(st))
    en = torch.where(live, torch.clamp(st + counts.to(torch.int64), max=N),
                     st)
    ct = torch.clamp(en - st, min=0)                      # (B, W)
    per_lane = ct.sum(1).cpu().tolist()
    # lanes in groups of at most ``cap`` covered pairs (a lane alone may
    # exceed it: its pairs are at most N)
    cap = max(N, 1 << 24)
    step = max(1, budget // max(1, d))
    b0 = 0
    while b0 < B:
        b1, tot = b0, 0
        while b1 < B and (b1 == b0 or tot + per_lane[b1] <= cap):
            tot += per_lane[b1]
            b1 += 1
        if tot:
            c = ct[b0:b1].reshape(-1)
            w_lane = torch.arange(b0, b1, device=dev).repeat_interleave(
                ct.shape[1])
            lane = w_lane.repeat_interleave(c)
            first = torch.cumsum(c, 0) - c
            pos = (st[b0:b1].reshape(-1).repeat_interleave(c)
                   + torch.arange(lane.numel(), device=dev)
                   - first.repeat_interleave(c))
            key = torch.unique(lane * (N + 1) + pos)      # sorted, distinct
            lane, pos = key // (N + 1), key % (N + 1)
            dist = torch.empty(key.numel(), dtype=torch.float32, device=dev)
            for s in range(0, key.numel(), step):
                pl, pp = lane[s:s + step], pos[s:s + step]
                diff = dequant_rows(corpus[pp]) - q[pl]
                dd = (diff * diff).sum(-1)
                a = attrs[pp].to(torch.float32)
                ok = ((a >= qlo[pl]) & (a <= qhi[pl])).all(-1)
                dist[s:s + step] = torch.where(ok, dd,
                                               torch.full_like(dd, _INF))
            # (lane, distance, position): pairs are in (lane, position)
            # order, so two stable sorts finish the ranking
            o = torch.argsort(dist, stable=True)
            o = o[torch.argsort(lane[o], stable=True)]
            lane, pos, dist = lane[o], pos[o], dist[o]
            n_lane = torch.bincount(lane - b0, minlength=b1 - b0)
            rank = torch.arange(lane.numel(), device=dev) - (
                torch.cumsum(n_lane, 0) - n_lane)[lane - b0]
            sel = (rank < k) & torch.isfinite(dist)
            ids[lane[sel], rank[sel]] = pos[sel].to(torch.int32)
            dists[lane[sel], rank[sel]] = dist[sel]
        b0 = b1
    return ids, dists


def _dist_plane(N, rows_of, ok_of, q, budget):
    """(B, N) f32 distances of every (query, row) pair, +inf where the
    pair fails, in chunks of at most ``budget`` (query, row, dim) elements,
    with ``_scan_topk``'s arithmetic."""
    B, d = q.shape
    q = q.to(torch.float32)
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    step = max(1, budget // max(1, B * d))
    for s in range(0, N, step):
        c = rows_of(s, min(N, s + step))                  # (ch, d) f32
        e = s + c.shape[0]
        out[:, s:e] = _masked_dist(c, ok_of(s, e), q)
    return out


def wide_select_twin(dist: torch.Tensor, k: int, sampled: torch.Tensor,
                     cap: int):
    """The wide box and bitmask forms' selection (``scan_topk_wide.cu``)
    in plain PyTorch, for tests: dist (B, N) f32 of the passing pairs (+inf
    or NaN elsewhere: only finite distances take part), sampled (N,) bool
    (the rows the sample pass scores), cap >= k (keys a query's candidate
    list holds). Per query:

    - tau: the k-th smallest distance among its first ``cap`` sampled
      pairs, +inf where fewer than k (the card's list keeps whichever cap
      pairs its blocks append first; any k passing rows bound the k-th
      distance from above);
    - the candidates: its pairs with distance <= tau; the list keeps the
      first ``cap`` of them, counting all;
    - an overflow (more than cap): the exact re-pass finds the k-th
      smallest (distance, id) key over all the candidates and refills
      the list with the k keys up to it;
    - the select: the list's k smallest keys by (distance, id),
      ascending, (-1, +inf) past their count.

    Returns (ids (B, k) int32, dists (B, k) f32, candidates (B,) int64,
    overflowed queries)."""
    B, N = dist.shape
    if not 1 <= k <= min(N, cap):
        raise ValueError(f"need 1 <= k <= min(N, cap), got k={k}, N={N}, "
                         f"cap={cap}")
    dev = dist.device
    ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    dists = torch.full((B, k), _INF, dtype=torch.float32, device=dev)
    counts = torch.zeros(B, dtype=torch.int64, device=dev)
    overflowed = 0
    fin = torch.isfinite(dist)
    for b in range(B):
        sample = dist[b][fin[b] & sampled][:cap]
        tau = (torch.sort(sample).values[k - 1] if sample.numel() >= k
               else torch.tensor(_INF, device=dev))
        cand = torch.nonzero(fin[b] & (dist[b] <= tau))[:, 0]  # row order
        counts[b] = cand.numel()
        if cand.numel() > cap:
            overflowed += 1
            key = _order_key(dist[b, cand]) - torch.arange(
                cand.numel(), device=dev) + cand          # (dist, row) keys
            kth = torch.sort(key).values[k - 1]
            listed = cand[key <= kth]
        else:
            listed = cand
        n = min(k, listed.numel())
        if n:
            v, pos = lex_smallest(dist[b, listed][None], n)
            dists[b, :n] = v[0]
            ids[b, :n] = listed[pos[0]].to(torch.int32)
    return ids, dists, counts, overflowed


def _tile_sample(n: int, tile: int, stride: int, device) -> torch.Tensor:
    """(n,) bool: the entries in tiles t (of ``tile`` entries) with t %
    stride == 0, the sample pass's."""
    return (torch.arange(n, device=device) // tile) % stride == 0


def scan_topk_wide_twin(corpus: torch.Tensor, attrs: torch.Tensor,
                        q: torch.Tensor, qlo: torch.Tensor,
                        qhi: torch.Tensor, k: int, *, cap=None,
                        qscale=None, windows=None, stride: int = 16,
                        tile: int = 256, budget: int = 1 << 27):
    """The wide box form (f32, bf16, or int8 with ``qscale``; windowed
    with ``windows`` = (starts, counts): a pair takes part only where the
    lane's windows cover the row) through ``wide_select_twin``: the
    sample is 1 in ``stride`` row tiles of ``tile`` rows (the box pass's,
    at which the windowed form's pre-pass flags its tiles), ``cap``
    defaults to N. Returns ``wide_select_twin``'s four results."""
    N = corpus.shape[0]
    cov = None if windows is None else _window_rows(*windows, N)

    def ok_of(s, e):
        ok = _box_ok(attrs[s:e], qlo, qhi)
        return ok if cov is None else ok & cov[:, s:e]

    dist = _dist_plane(
        N, lambda s, e: dequant_rows(corpus[s:e], None if qscale is None
                                     else qscale[s:e]), ok_of, q, budget)
    return wide_select_twin(dist, k, _tile_sample(N, tile, stride,
                                                  dist.device),
                            N if cap is None else cap)


def scan_topk_mask_wide_twin(corpus: torch.Tensor, mask: torch.Tensor,
                             q: torch.Tensor, k: int, *, cap=None,
                             stride: int = 16, tile: int = 64,
                             budget: int = 1 << 27):
    """The wide bitmask form through ``wide_select_twin``: the sample is 1
    in ``stride`` tiles of ``tile`` entries of the passing rows' ascending
    list (the compaction's)."""
    N = corpus.shape[0]
    ok = mask.reshape(-1).to(torch.float32) > 0.0
    dist = _dist_plane(N, lambda s, e: dequant_rows(corpus[s:e]),
                       lambda s, e: ok[None, s:e], q, budget)
    pos = torch.cumsum(ok.to(torch.int64), 0) - 1        # place in the list
    sampled = ok & ((pos // tile) % stride == 0)
    return wide_select_twin(dist, k, sampled, N if cap is None else cap)


def scan_topk_windows_wide_twin(corpus: torch.Tensor, attrs: torch.Tensor,
                                q: torch.Tensor, qlo: torch.Tensor,
                                qhi: torch.Tensor, starts: torch.Tensor,
                                counts: torch.Tensor, k: int, **kw):
    """The wide windowed form (f32 or bf16 corpus in position order):
    ``scan_topk_wide_twin`` over the rows the windows cover, ids as
    positions."""
    return scan_topk_wide_twin(corpus, attrs, q, qlo, qhi, k,
                               windows=(starts, counts), **kw)


def _window_rows(starts: torch.Tensor, counts: torch.Tensor,
                 N: int) -> torch.Tensor:
    """(B, N) bool: row r lies in one of lane b's windows (a window with
    start < 0 or count <= 0 is a pad; the union, so order and overlap do
    not matter)."""
    B = starts.shape[0]
    dev = starts.device
    st = starts.to(torch.int64)
    live = (st >= 0) & (counts > 0)
    s = torch.where(live, st.clamp(max=N), N)
    e = torch.where(live, (st + counts.to(torch.int64)).clamp(max=N), N)
    # +1 where a window starts, -1 where it ends: a row is covered where
    # the running sum is positive
    edge = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    edge.scatter_add_(1, s, torch.ones_like(s))
    edge.scatter_add_(1, e, -torch.ones_like(e))
    return edge.cumsum(1)[:, :N] > 0


def window_cover_ref(starts: torch.Tensor, counts: torch.Tensor,
                     N: int) -> torch.Tensor:
    """The rows each lane's windows cover, packed as the windowed kernel's
    pre-pass packs them: starts/counts (B, W) int32 (a window with start
    < 0 or count <= 0 is a pad) -> (B, ceil(N / 32)) int32 whose word
    r // 32 has bit r % 32 set iff row r of [0, N) lies in one of the
    lane's windows (their union: order and overlap do not matter)."""
    B = starts.shape[0]
    nwords = -(-N // 32)
    dev = starts.device
    cov = torch.nn.functional.pad(_window_rows(starts, counts, N),
                                  (0, nwords * 32 - N))
    shift = torch.arange(32, device=dev, dtype=torch.int64)
    words = (cov.view(B, nwords, 32).to(torch.int64) << shift).sum(-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)
