"""Device-native bulk graph builder, ported from
``repro.core.build_device``.

Per tree node, every member's exact top-``ef_b`` in-node candidate list
comes from an all-pairs distance block, and the HNSW RNG pruning rule
keeps a candidate unless an already-kept neighbour shields it
(``d(e, r) < d(e, o)``). The output is the ``(H, n, M)`` int32 ``nbrs``
plane of the reference, as a tensor on the build device.

  * ``dist="pallas"`` (the default on CUDA through ``"auto"``) computes
    the candidate distances in the hand-written ``l2dist`` CUDA kernel
    (``kernels/csrc/l2dist.cu``); ``dist="jnp"`` uses ``torch.matmul``
    with the reference's evaluation order ``(|p|^2 - 2 r.p) + |r|^2``,
    in full fp32 (TF32 off).
  * Top-K keeps ``lax.top_k``'s lowest-index tie-break
    (``kernels.ref.lex_smallest``).
  * The prune reads candidate-to-candidate distances from one small
    batched product per row block instead of carrying the kept vectors
    through the K-step loop; the loop itself runs on a (rows, K) mask.
  * Nodes are grouped by member count padded to a power of two (the
    reference's size classes, so K and M_eff match it); nodes above
    ``large_node`` are processed in row blocks over their real columns.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .tree import PartitionTree
from .util import resolve_device
from ..kernels import ops as _ops
from ..kernels.ref import lex_smallest

__all__ = ["build_graphs_device"]

_INF = float("inf")


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _pairwise_d2(rows: torch.Tensor, pool: torch.Tensor, dist: str
                 ) -> torch.Tensor:
    """Squared L2 rows (..., R, d) x pool (..., C, d) -> (..., R, C) f32."""
    if dist == "pallas":
        return _ops.l2dist_qn(rows, pool)
    # the builder's fp32 products stay fp32 (TF32 would change decisions)
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = (rows * rows).sum(-1)
    ps = (pool * pool).sum(-1)
    mm = rows @ pool.transpose(-1, -2)
    return (ps.unsqueeze(-2) - 2.0 * mm) + rs.unsqueeze(-1)


def _prune(cand_vecs: torch.Tensor, dd: torch.Tensor, idx: torch.Tensor,
           row_pos: torch.Tensor, M_eff: int) -> torch.Tensor:
    """RNG prune of X candidate lists at once: cand_vecs (X, K, d) the
    candidates' vectors, dd/idx (X, K) their distances/pool positions in
    ascending order, row_pos (X,) each row's own pool position. Returns
    (X, M_eff) kept pool positions in scan order, -1 padded."""
    X, K = idx.shape
    en = (cand_vecs * cand_vecs).sum(-1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dcc = en[:, :, None] + en[:, None, :] \
        - 2.0 * (cand_vecs @ cand_vecs.transpose(1, 2))   # (X, K, K)
    kept = torch.zeros((X, K), dtype=torch.bool, device=idx.device)
    cnt = torch.zeros(X, dtype=torch.int64, device=idx.device)
    fin = torch.isfinite(dd)
    not_self = idx != row_pos[:, None]
    for j in range(K):
        shielded = (kept & (dcc[:, :, j] < dd[:, j, None])).any(1)
        accept = fin[:, j] & not_self[:, j] & ~shielded & (cnt < M_eff)
        kept[:, j] = accept
        cnt += accept
    order = torch.argsort((~kept).to(torch.int8), dim=1, stable=True)
    order = order[:, :M_eff]
    return torch.where(kept.gather(1, order), idx.gather(1, order),
                       torch.full_like(order, -1))


def _node_block(pool: torch.Tensor, rows: torch.Tensor, row_pos, count,
                K: int, M_eff: int, dist: str) -> torch.Tensor:
    """Top-K + RNG prune for row blocks of G nodes: pool (G, C, d), rows
    (G, R, d), row_pos (G, R), count (G,) real members -> (G, R, M_eff)
    pool-local kept positions, -1 padded."""
    G, C, d = pool.shape
    R = rows.shape[1]
    d2 = _pairwise_d2(rows, pool, dist)                      # (G, R, C)
    col_valid = torch.arange(C, device=pool.device)[None, :] < count[:, None]
    d2 = torch.where(col_valid[:, None, :], d2, torch.full_like(d2, _INF))
    dd, idx = lex_smallest(d2, K)                            # (G, R, K)
    flat = pool.reshape(G * C, d)
    goff = (torch.arange(G, device=pool.device) * C)[:, None, None]
    cand = flat[(idx + goff).reshape(-1)].reshape(G * R, K, d)
    kept = _prune(cand, dd.reshape(G * R, K), idx.reshape(G * R, K),
                  row_pos.reshape(G * R), M_eff)
    return kept.reshape(G, R, M_eff)


def build_graphs_device(
    tree: PartitionTree,
    vecs,
    *,
    M: int = 32,
    ef_b: Optional[int] = None,
    row_block: int = 2048,
    large_node: int = 4096,
    group_row_cap: int = 16384,
    dist: str = "auto",
    device=None,
    verbose: bool = False,
) -> torch.Tensor:
    """Bulk build on ``device`` (default ``cuda``): returns ``nbrs``
    (H, n, M) int32, -1 padded, as a tensor on that device.

    ``dist``: "auto" (the CUDA kernel on a CUDA device, torch.matmul on
    the CPU) | "jnp" (torch.matmul) | "pallas" (the kernel wrapper, whose
    CPU form is its plain version)."""
    dev = resolve_device(device)
    ef_b = ef_b or max(M, 2 * M)
    if dist == "auto":
        dist = "pallas" if dev.type == "cuda" else "jnp"
    if dist not in ("jnp", "pallas"):
        raise ValueError(f"dist must be auto|jnp|pallas, got {dist!r}")
    vecs_t = torch.as_tensor(vecs).to(device=dev, dtype=torch.float32)
    n, d = vecs_t.shape
    H = tree.height
    nbrs = torch.full((H, n, M), -1, dtype=torch.int32, device=dev)

    start = np.asarray(tree.start, np.int64)
    count = np.asarray(tree.count, np.int64)
    level = np.asarray(tree.level, np.int64)
    order = np.asarray(tree.order, np.int64)
    order_t = torch.as_tensor(order, device=dev)
    nodes = np.nonzero(count > 1)[0]
    cls = np.maximum(8, np.left_shift(1, np.ceil(np.log2(
        np.maximum(count[nodes], 1))).astype(np.int64)))

    def write(lvl_t, objs_t, kept, real, M_eff):
        """kept (G, R, M_eff) pool-local -> global ids into nbrs rows."""
        gid = torch.where(kept >= 0, objs_t.gather(
            1, kept.clamp_min(0).reshape(kept.shape[0], -1)).reshape(
                kept.shape), torch.full_like(kept, -1))
        nbrs[lvl_t[real], objs_t[:, :kept.shape[1]][real], :M_eff] = \
            gid[real].to(torch.int32)

    # small/medium nodes: one batched program per size class
    for C in sorted(set(cls[cls <= large_node].tolist())):
        t0 = time.perf_counter()
        members = nodes[cls == C]
        K = min(ef_b + 1, C)
        M_eff = min(M, K - 1)
        Gc = max(1, group_row_cap // C)
        for s in range(0, len(members), Gc):
            chunk = members[s:s + Gc]
            pos = start[chunk, None] + np.arange(C)[None, :]
            real = np.arange(C)[None, :] < count[chunk, None]
            objs = torch.as_tensor(np.where(real, pos, 0), device=dev)
            real_t = torch.as_tensor(real, device=dev)
            objs_t = torch.where(real_t, order_t[objs],
                                 torch.full_like(objs, -1))
            pool = vecs_t[objs_t.clamp_min(0)] * real_t[..., None]
            cnt = torch.as_tensor(count[chunk], device=dev)
            row_pos = torch.arange(C, device=dev).expand(len(chunk), C)
            kept = _node_block(pool, pool, row_pos, cnt, K, M_eff, dist)
            lvl_t = torch.as_tensor(level[chunk], device=dev)[:, None] \
                .expand(len(chunk), C)
            write(lvl_t, objs_t, kept, real_t, M_eff)
        if verbose:
            print(f"[build_device] class C={C}: {len(members)} nodes "
                  f"(K={K}, M_eff={M_eff}) {time.perf_counter() - t0:.1f}s",
                  flush=True)

    # large nodes: row blocks against the node's real columns
    per_level: dict = {}
    for p in nodes[cls > large_node]:
        t0 = time.perf_counter()
        c = int(count[p])
        K = min(ef_b + 1, _next_pow2(c))
        M_eff = min(M, K - 1)
        objs_t = order_t[start[p]:start[p] + c]
        pool = vecs_t[objs_t][None]                          # (1, c, d)
        cnt = torch.as_tensor([c], device=dev)
        lvl = int(level[p])
        for s in range(0, c, row_block):
            take = min(row_block, c - s)
            rows = pool[:, s:s + take]
            row_pos = torch.arange(s, s + take, device=dev)[None]
            kept = _node_block(pool, rows, row_pos, cnt, K, M_eff, dist)[0]
            gid = torch.where(kept >= 0, objs_t[kept.clamp_min(0)],
                              torch.full_like(kept, -1))
            nbrs[lvl, objs_t[s:s + take], :M_eff] = gid.to(torch.int32)
        if verbose:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            n_l, rows_l, s_l = per_level.get(lvl, (0, 0, 0.0))
            per_level[lvl] = (n_l + 1, rows_l + c,
                              s_l + time.perf_counter() - t0)
    for lvl, (n_l, rows_l, s_l) in sorted(per_level.items()):
        print(f"[build_device] level {lvl}: {n_l} large nodes, {rows_l} "
              f"rows, {s_l:.1f}s", flush=True)
    return nbrs
