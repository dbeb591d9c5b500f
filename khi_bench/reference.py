"""The plain reference of the benchmark: exact filtered k-nearest
neighbours in float64, in plain PyTorch. It imports nothing of the
program; it works from the corpus, attributes, queries and boxes that the
benchmark made and handed to both sides."""

from __future__ import annotations

import torch

__all__ = ["in_box", "box_counts", "exact_topk", "dist64"]


def in_box(attrs: torch.Tensor, lo: torch.Tensor,
           hi: torch.Tensor) -> torch.Tensor:
    """attrs (..., m) against boxes lo/hi broadcast to it -> (...) bool,
    inclusive on both ends (a NaN attribute fails every box)."""
    return ((attrs >= lo) & (attrs <= hi)).all(-1)


def box_counts(attrs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               block: int = 64) -> torch.Tensor:
    """Rows of ``attrs`` (n, m) inside each box of lo/hi (B, m) -> (B,)
    int64."""
    return torch.cat([in_box(attrs[None], lo[s:s + block, None],
                             hi[s:s + block, None]).sum(1)
                      for s in range(0, lo.shape[0], block)])


def dist64(vecs: torch.Tensor, q: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """Squared L2 in float64 by the direct form between each query q (B, d)
    and its rows ``ids`` (B, c) of ``vecs``; +inf where the id is out of
    [0, n)."""
    n = vecs.shape[0]
    ok = (ids >= 0) & (ids < n)
    rows = vecs[torch.where(ok, ids, torch.zeros_like(ids))].double()
    diff = rows - q.double()[:, None, :]
    d = (diff * diff).sum(-1)
    return torch.where(ok, d, torch.full_like(d, float("inf")))


def exact_topk(vecs: torch.Tensor, attrs: torch.Tensor, q: torch.Tensor,
               lo: torch.Tensor, hi: torch.Tensor, k: int,
               block: int = 128, row_block: int = 262144):
    """Exact filtered top-k: -> (ids (B, k) int64, -1 padded, dists (B, k)
    float64 by the direct form, +inf padded, counts (B,) int64 of rows in
    each box). Candidates come from float64 products over row blocks; the
    kept ones are rescored by the direct form and ordered by (distance,
    id)."""
    B, n = q.shape[0], vecs.shape[0]
    out_i, out_d, out_c = [], [], []
    for s in range(0, B, block):
        qb = q[s:s + block].double()
        qn = (qb * qb).sum(1)
        lb, hb = lo[s:s + block], hi[s:s + block]
        best_d = torch.full((qb.shape[0], 0), float("inf"),
                            dtype=torch.float64, device=q.device)
        best_i = torch.zeros((qb.shape[0], 0), dtype=torch.int64,
                             device=q.device)
        count = torch.zeros(qb.shape[0], dtype=torch.int64, device=q.device)
        for r in range(0, n, row_block):
            c = vecs[r:r + row_block].double()
            d2 = qn[:, None] + (c * c).sum(1)[None] - 2.0 * (qb @ c.T)
            ok = in_box(attrs[None, r:r + row_block], lb[:, None],
                        hb[:, None])
            count += ok.sum(1)
            d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
            kk = min(2 * k, d2.shape[1])
            vd, vi = torch.topk(d2, kk, dim=1, largest=False)
            best_d = torch.cat([best_d, vd], 1)
            best_i = torch.cat([best_i, vi + r], 1)
        best_i = torch.where(torch.isinf(best_d), torch.full_like(best_i, -1),
                             best_i)
        exact = dist64(vecs, qb, best_i)
        key_i = torch.where(best_i >= 0, best_i,
                            torch.full_like(best_i, n))
        o = torch.argsort(key_i, dim=1, stable=True)
        o = o.gather(1, torch.argsort(exact.gather(1, o), dim=1,
                                      stable=True))[:, :k]
        ids, dd = best_i.gather(1, o), exact.gather(1, o)
        if ids.shape[1] < k:
            pad = k - ids.shape[1]
            ids = torch.cat([ids, ids.new_full((ids.shape[0], pad), -1)], 1)
            dd = torch.cat([dd, dd.new_full((dd.shape[0], pad),
                                            float("inf"))], 1)
        out_i.append(ids)
        out_d.append(dd)
        out_c.append(count)
    return torch.cat(out_i), torch.cat(out_d), torch.cat(out_c)
