"""Single-level filtered HNSW graphs and the bottom-up merge (paper
Algorithm 5), ported from ``repro.core.hnsw`` with the graph construction
on the device.

Every tree node p carries a single-level graph G_p over its objects with
max degree M and the RNG prune; graphs are rows of the dense
``nbrs[H, n, M]`` int32 plane (-1 padded). The reference builds them one
node and one object at a time in numpy. Here the same decisions run in
batches, and the result is the reference's ``nbrs`` exactly:

  * **Nodes of one level together.** Their object sets are disjoint; a
    node's merge reads and writes only its own objects' rows of
    ``nbrs[lvl]`` and reads ``nbrs[lvl + 1]``.
  * **Chunks of one node in rounds.** Chunk j + 1 searches the graph that
    chunk j left, so round j takes the j-th chunk of every node that has
    one: one batched greedy search over all of the round's objects.
  * **Every forward prune of a round at once.** A forward prune reads its
    search results (which ran on the plane as the chunk found it) and the
    right child's rows of ``nbrs[lvl + 1]``, never the plane being
    written.
  * **Reverse edges per target row, in order.** A reverse update reads and
    writes only its target's row; each target takes its incoming objects
    in chunk order. The updates that only append (the row has room) go in
    one step, the rest in waves: wave t applies the t-th remaining update
    of every target at once.
  * **``visited`` is node-local:** indexed by an object's position inside
    its node's span of ``tree.order``, so a round needs at most about
    ``merge_chunk * n`` bits instead of ``lanes * n``.

Distances are the direct form ``sum((q - x)^2)`` of the reference's
einsums, from the blocked ``gather_l2`` kernel (``kernels/ops.py``; its
plain version on the CPU): a hop's neighbours, the right child's extras,
and the prune's candidate-to-candidate distances (each candidate as a
query over its lane's candidate ids).

The bulk builder (``build_graphs_bulk``) is the device builder program
(``core/build_device.py``) with the host builder's defaults and fp32
``torch.matmul`` distances, which the reference pins bit for bit to its
numpy bulk builder on fixed seeds.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import beam
from .build_device import build_graphs_device
from .tree import PartitionTree
from .util import resolve_device
from ..kernels import ops as _ops

__all__ = [
    "rng_prune",
    "greedy_search_batch",
    "build_graphs",
    "build_graphs_bulk",
]

# rows of one gather_l2 launch (the kernel's grid limit) and the bytes of
# gathered rows one plain-version call may hold on the CPU
_KERNEL_ROWS = 65535
_CPU_GATHER_BYTES = 64 << 20
# candidate-to-candidate blocks of one prune step: (lanes, K, K) bytes
_PRUNE_BLOCK_BYTES = 256 << 20


def _vecs_on(vecs, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(vecs).to(device=dev,
                                    dtype=torch.float32).contiguous()


def _dists(vecs_t: torch.Tensor, idx: torch.Tensor,
           q: Optional[torch.Tensor] = None,
           qid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, C) squared L2 of ``vecs_t[idx]`` to the queries: rows of ``q``
    (R, d), or the corpus rows ``qid`` (R,). -1 ids give +inf and read
    nothing. Split at the kernel's row limit, and on the CPU so that the
    plain version's gathered rows stay small."""
    R, C = idx.shape
    d = vecs_t.shape[1]
    if vecs_t.device.type == "cuda":
        step = _KERNEL_ROWS
    else:
        step = max(1, _CPU_GATHER_BYTES // (4 * d * max(C, 1)))
    outs = []
    for s in range(0, R, step):
        qs = q[s:s + step] if q is not None else vecs_t[qid[s:s + step]]
        outs.append(_ops.gather_l2(idx[s:s + step].contiguous(), vecs_t,
                                   qs.contiguous(), c_blk=128))
    if not outs:
        return torch.empty((0, C), dtype=torch.float32, device=idx.device)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _prune_lists(vecs_t: torch.Tensor, own: torch.Tensor, cand: torch.Tensor,
                 cd: torch.Tensor, max_degree: int) -> torch.Tensor:
    """The RNG prune of X candidate lists at once: own (X,) the objects,
    cand (X, K) candidate ids (-1 pad) and cd (X, K) their distances to
    ``own`` (+inf pad), in list order. Returns (X, max_degree) int32 rows,
    kept ids in scan order, -1 padded.

    The reference's rule per list: a stable ascending sort; skip e == o,
    e < 0 and an e already kept; keep e unless a kept r shields it
    (d(e, r) < d(e, o)); stop at ``max_degree``. A decision depends only on
    the decisions before it, so the kept mask is the unique fixed point of
    ``kept_j = ok_j and no kept i < j blocks j``, reached from
    ``kept = ok`` in at most K + 1 sweeps (after sweep t the first t
    positions are final); the cap at ``max_degree`` is applied after,
    since positions past the cap never change the ones before it."""
    X, K = cand.shape
    dev = cand.device
    out = torch.full((X, max_degree), -1, dtype=torch.int32, device=dev)
    if X == 0 or K == 0:
        return out
    srt = torch.argsort(cd, dim=1, stable=True)
    cand = cand.gather(1, srt)
    cd = cd.gather(1, srt)
    # valid candidates (finite) sort ahead of the -1 pad: drop the columns
    # no lane uses
    keff = int((cand >= 0).sum(1).max())
    if keff == 0:
        return out
    cand, cd = cand[:, :keff].contiguous(), cd[:, :keff].contiguous()
    K = keff
    ok = (cand >= 0) & (cand != own[:, None])
    lower = torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)
    block = torch.empty((X, K, K), dtype=torch.bool, device=dev)
    step = max(1, _PRUNE_BLOCK_BYTES // (K * K * 8))
    for s in range(0, X, step):
        c, okb = cand[s:s + step], ok[s:s + step]
        earlier = lower[None] & okb[:, None, :]          # (x, j, i): i < j
        # d(e_j, e_i) for the earlier valid i only; rows of invalid j unused
        idx = torch.where(earlier & okb[:, :, None], c[:, None, :],
                          torch.full_like(c[:, None, :], -1))
        dcc = _dists(vecs_t, idx.reshape(-1, K),
                     qid=c.clamp_min(0).reshape(-1)).reshape(-1, K, K)
        block[s:s + step] = (dcc < cd[s:s + step, :, None]) | (
            earlier & (c[:, :, None] == c[:, None, :]))
    kept = ok
    for _ in range(K + 1):
        new = ok & ~(block & kept[:, None, :]).any(2)
        if torch.equal(new, kept):
            break
        kept = new
    kept = kept & (kept.cumsum(1) <= max_degree)
    take = min(max_degree, K)
    pos = torch.argsort((~kept).to(torch.int8), dim=1, stable=True)[:, :take]
    out[:, :take] = torch.where(kept.gather(1, pos), cand.gather(1, pos),
                                torch.full_like(pos, -1)).to(torch.int32)
    return out


def rng_prune(vecs, o, cand_ids, cand_dists, max_degree: int, *,
              device=None) -> torch.Tensor:
    """HNSW neighbour selection (the RNG rule, paper §2.2), batched: for
    each object ``o[x]`` (X,), scan ``cand_ids[x]`` (X, K; -1 pad) in
    ascending ``cand_dists[x]`` (stable), skipping ``o`` itself, -1 and an
    id already kept, and keep a candidate e unless an already-kept r
    satisfies d(e, r) < d(e, o). Returns (X, max_degree) int32 rows of
    kept ids in scan order, -1 padded, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    vecs_t = _vecs_on(vecs, dev)
    own = torch.as_tensor(np.asarray(o, np.int64) if not torch.is_tensor(o)
                          else o).to(dev).long().reshape(-1)
    cand = torch.as_tensor(cand_ids).to(dev).long().reshape(own.shape[0], -1)
    cd = torch.as_tensor(cand_dists).to(device=dev, dtype=torch.float32) \
        .reshape(cand.shape)
    cd = torch.where(cand >= 0, cd, torch.full_like(cd, float("inf")))
    return _prune_lists(vecs_t, own, cand, cd, max_degree)


def _search(vecs_t: torch.Tensor, adj: torch.Tensor, q: torch.Tensor,
            entries: torch.Tensor, ef: int, local: torch.Tensor,
            span: torch.Tensor, total: int, *, max_hops: int = 10_000,
            check_every: int = 4):
    """Batched greedy best-first search on the ``beam`` pool ops; lane b
    searches from ``entries[b]`` with query ``q[b]``. Its visited set is
    ``span[b]`` bits wide (``total`` = their sum) and object x's bit is
    ``local[x]`` inside it, so every id a lane can reach must have a local
    position inside its span. Returns (ids (B, ef) int64, dists (B, ef),
    hops): the reference's pool contract (stable sorts, the tail sealed)
    and its frontier rule (the closest unexpanded beam slot: the width-1
    ``pool_top_unexpanded``). A lane with no frontier left changes
    nothing, so lanes are only checked, and the finished ones retired,
    every ``check_every`` hops."""
    dev = q.device
    B = q.shape[0]
    M = adj.shape[1]
    ids_out = torch.full((B, ef), -1, dtype=torch.int64, device=dev)
    d_out = torch.full((B, ef), float("inf"), dtype=torch.float32,
                       device=dev)
    if B == 0:
        return ids_out, d_out, 0
    span = span.long()
    off = torch.cumsum(span, 0) - span
    visited = torch.zeros(total + 1, dtype=torch.bool, device=dev)
    drop = torch.tensor(total, dtype=torch.int64, device=dev)
    e = entries.long()
    d0 = _dists(vecs_t, e[:, None], q)
    pool = beam.pool_seed(ef + M, e[:, None], d0,
                          torch.ones_like(d0, dtype=torch.bool))
    visited[off + local[e]] = True
    rows = torch.arange(B, device=dev)
    hops = 0
    while hops < max_hops:
        slots, u, valid = beam.pool_top_unexpanded(pool, ef, 1)
        pool = beam.pool_mark_expanded_many(pool, slots, valid)
        # a lane with no frontier reads some row (-1 wraps to the last):
        # its lanes are masked by ``valid``, as are the -1 pads
        nbr = adj[u[:, 0]]
        ok = (nbr >= 0) & valid
        vidx = torch.where(ok, off[:, None] + local[nbr], drop)
        fresh = ok > visited[vidx]
        visited[vidx] = True
        nd = _dists(vecs_t, torch.where(fresh, nbr, -1), q)
        pool = beam.pool_merge_tail(pool, ef, nbr, nd, fresh)
        hops += 1
        if hops % check_every and hops < max_hops:
            continue
        alive = beam.pool_frontier_alive(pool, ef)
        n_alive = int(alive.sum())
        if n_alive == alive.shape[0]:
            continue
        done = ~alive
        ids_out[rows[done]] = pool.ids[done, :ef]
        d_out[rows[done]] = pool.dists[done, :ef]
        if n_alive == 0:
            return ids_out, d_out, hops
        keep = torch.nonzero(alive).squeeze(1)
        pool = beam.Pool(pool.ids[keep], pool.dists[keep],
                         pool.expanded[keep])
        rows, off, q = rows[keep], off[keep], q[keep]
    ids_out[rows] = pool.ids[:, :ef]
    d_out[rows] = pool.dists[:, :ef]
    return ids_out, d_out, hops


def greedy_search_batch(vecs, adj, queries, entries, ef: int, *,
                        max_hops: int = 10_000, device=None):
    """Batched greedy best-first search over one graph (the reference's
    ``greedy_search_batch``), on ``device`` (default ``cuda``).

    vecs (n, d) f32; adj (n, M) int32 rows (-1 padded); queries (B, d);
    entries (B,) entry ids. Returns (ids (B, ef) int32, dists (B, ef) f32)
    tensors, ascending, -1 / +inf padded."""
    dev = resolve_device(device)
    vecs_t = _vecs_on(vecs, dev)
    adj_t = torch.as_tensor(adj).to(device=dev, dtype=torch.int32)
    q = _vecs_on(queries, dev)
    ent = torch.as_tensor(np.asarray(entries, np.int64)
                          if not torch.is_tensor(entries) else entries
                          ).to(dev).long()
    n = vecs_t.shape[0]
    B = q.shape[0]
    ids, dists, _ = _search(
        vecs_t, adj_t, q, ent, ef, torch.arange(n, device=dev),
        torch.full((B,), n, dtype=torch.int64, device=dev), B * n,
        max_hops=max_hops)
    return ids.to(torch.int32), dists


def _merge(vecs_t: torch.Tensor, plane: torch.Tensor,
           lower: Optional[torch.Tensor], jobs: dict, local: torch.Tensor,
           present: torch.Tensor, is_left: torch.Tensor, *, M: int,
           ef_b: int, merge_chunk: int) -> dict:
    """Insert every job's objects into ``plane`` (in place), the jobs side
    by side (see the module docstring). A job is one node's merge: its
    entry, the width of its visited span, its objects to insert
    (``order[off:off + len]`` of ``jobs["ins"]``), whether its reverse
    edges go only to left-child objects (``restrict``, with ``is_left``)
    and whether its objects take the right child's rows of ``lower`` as
    extra candidates (``extras``). ``present`` marks the objects already
    in the graph and is updated. Returns counts: rounds, lanes, hops,
    reverse waves."""
    dev = vecs_t.device
    mc = max(1, merge_chunk)
    ins = jobs["ins"]
    ins_off, ins_len = jobs["off"], jobs["len"]
    span_h = jobs["span"]
    tpos = torch.full((plane.shape[0],), -1, dtype=torch.int64, device=dev)
    stats = {"rounds": 0, "lanes": 0, "hops": 0, "waves": 0}
    r = 0
    while True:
        L = np.clip(ins_len - r * mc, 0, mc)
        act = np.nonzero(L)[0]
        if not len(act):
            return stats
        lj = np.repeat(act, L[act])
        first = np.cumsum(L[act]) - L[act]
        lt = np.arange(len(lj)) - np.repeat(first, L[act])
        host = np.stack([ins[ins_off[lj] + r * mc + lt], jobs["entry"][lj],
                         span_h[lj], lt, jobs["restrict"][lj],
                         jobs["extras"][lj]]).astype(np.int64)
        o, ent, sp, tt, rs, ex = torch.from_numpy(host).to(dev)
        X = len(lj)

        # the round's searches, on the plane as the round found it
        sids, sd, hops = _search(vecs_t, plane, vecs_t[o], ent, ef_b, local,
                                 sp, int(span_h[lj].sum()))
        cand, cd = sids, sd
        if lower is not None and bool(host[5].any()):
            exr = torch.where(ex[:, None] > 0, lower[o].long(),
                              torch.full((X, M), -1, dtype=torch.int64,
                                         device=dev))
            cand = torch.cat([cand, exr], 1)
            cd = torch.cat([cd, _dists(vecs_t, exr, qid=o)], 1)
        rows = _prune_lists(vecs_t, o, cand, cd, M)
        plane[o] = rows

        # reverse edges (Alg. 5 lines 12-13)
        tpos[o] = tt
        tgt = rows.long()
        ts = tgt.clamp_min(0)
        here = present[ts] | ((tpos[ts] >= 0) & (tpos[ts] < tt[:, None]))
        allow = (rs[:, None] == 0) | is_left[ts]
        ev = torch.nonzero((tgt >= 0) & here & allow)
        stats["waves"] += _reverse(vecs_t, plane, ev[:, 0], tgt[ev[:, 0],
                                   ev[:, 1]], o, X, M)
        tpos[o] = -1
        present[o] = True
        stats["rounds"] += 1
        stats["lanes"] += X
        stats["hops"] += hops
        r += 1


def _reverse(vecs_t, plane, src, tgt, o, X: int, M: int) -> int:
    """Apply the reverse updates (lane ``src`` adds its object ``o[src]``
    to row ``tgt``), each target's in lane order. For one target the
    reference skips an object already in the row, appends while the row
    has room and re-prunes ``row + [o]`` by distance to the target once it
    is full. Until a target's first full-row update its outcomes follow
    from the row as it stands (no appended object was in it), so they go
    in one step; the rest go in waves. Returns the number of waves."""
    dev = plane.device
    E = src.shape[0]
    if E == 0:
        return 0
    srt = torch.argsort(tgt * X + src)
    src, tgt = src[srt], tgt[srt]
    obj = o[src]
    is_first = torch.ones(E, dtype=torch.bool, device=dev)
    is_first[1:] = tgt[1:] != tgt[:-1]
    grp = torch.cumsum(is_first.long(), 0) - 1
    starts = torch.nonzero(is_first).squeeze(1)
    rank = torch.arange(E, device=dev) - starts[grp]
    cur = plane[tgt]
    L0 = (cur >= 0).sum(1)
    fresh = ~(cur == obj[:, None]).any(1)
    cs = torch.cumsum(fresh.long(), 0) - fresh.long()
    nd = cs - cs[starts][grp]
    full = fresh & (L0 + nd >= M)
    big = torch.full((starts.shape[0],), E, dtype=torch.int64, device=dev)
    first_full = big.scatter_reduce(0, grp, torch.where(full, rank, E),
                                    "amin")[grp]
    app = fresh & (rank < first_full)
    plane[tgt[app], (L0 + nd)[app]] = obj[app].to(plane.dtype)
    rest = rank >= first_full
    wave = (rank - first_full)[rest]
    src_r, tgt_r, obj_r = src[rest], tgt[rest], obj[rest]
    if wave.numel() == 0:
        return 0
    by = torch.argsort(wave, stable=True)
    counts = torch.bincount(wave).tolist()
    tgt_r, obj_r = tgt_r[by], obj_r[by]
    s = 0
    for c in counts:
        T, O = tgt_r[s:s + c], obj_r[s:s + c]
        s += c
        cur = plane[T]
        L = (cur >= 0).sum(1)
        new = cur.clone()
        room = torch.nonzero(~(cur == O[:, None]).any(1) & (L < M)) \
            .squeeze(1)
        new[room, L[room]] = O[room].to(plane.dtype)
        fullr = torch.nonzero(~(cur == O[:, None]).any(1) & (L >= M)) \
            .squeeze(1)
        if fullr.numel():
            Tf = T[fullr]
            allc = torch.cat([cur[fullr].long(), O[fullr, None]], 1)
            ds = _dists(vecs_t, allc, qid=Tf)
            new[fullr] = _prune_lists(vecs_t, Tf, allc, ds, M)
        plane[T] = new
    return len(counts)


def _level_jobs(tree: PartitionTree, lvl: int, symmetric_reverse: bool):
    """The jobs of one level (``_merge``) and the object sets it starts
    from: the left-child objects of its internal nodes (copied up, present,
    and the targets a restricted job's reverse edges may reach) and each
    node's entry. Leaves bootstrap: the first object is the entry and gets
    no row, the rest are inserted; so does an internal node with an empty
    left child."""
    order = np.asarray(tree.order, np.int64)
    start = np.asarray(tree.start, np.int64)
    count = np.asarray(tree.count, np.int64)
    left = np.asarray(tree.left, np.int64)
    right = np.asarray(tree.right, np.int64)
    nodes = np.nonzero((np.asarray(tree.level) == lvl) & (count > 0))[0]
    leaf = left[nodes] < 0
    lc = np.where(leaf, 0, count[np.maximum(left[nodes], 0)])
    rs = np.where(leaf, start[nodes], start[np.maximum(right[nodes], 0)])
    rc = np.where(leaf, count[nodes], count[np.maximum(right[nodes], 0)])
    ls = start[np.maximum(left[nodes], 0)]
    boot = lc == 0                       # no members: bootstrap
    entry_pos = np.where(boot, rs, ls)
    keep = ~boot | (rc > 0)
    nodes, leaf, lc, ls, rs, rc, boot, entry_pos = (
        a[keep] for a in (nodes, leaf, lc, ls, rs, rc, boot, entry_pos))
    jobs = {
        "ins": order,
        "off": rs + boot,
        "len": rc - boot,
        "entry": order[entry_pos],
        "span": count[nodes],
        "restrict": (~leaf & (not symmetric_reverse)).astype(np.int64),
        "extras": (~leaf).astype(np.int64),
    }
    # positions of the left children's objects in ``order``
    mark = np.zeros(len(order) + 1, np.int64)
    np.add.at(mark, ls[lc > 0], 1)
    np.add.at(mark, ls[lc > 0] + lc[lc > 0], -1)
    lobjs = order[np.nonzero(np.cumsum(mark[:-1]) > 0)[0]]
    return jobs, lobjs, order[entry_pos], len(nodes)


def build_graphs(tree: PartitionTree, vecs, *, M: int = 32,
                 ef_b: Optional[int] = None, merge_chunk: int = 64,
                 symmetric_reverse: bool = False, verbose: bool = False,
                 device=None, stats: Optional[list] = None) -> torch.Tensor:
    """Algorithm 5 (BuildGraph), bottom-up over the levels, on ``device``
    (default ``cuda``). Returns ``nbrs`` (H, n, M) int32, -1 padded, as a
    tensor on that device: the reference's ``build_graphs`` exactly, given
    the same distances. ``stats``, when a list, gets one dict per level
    (nodes, rounds, lanes, hops, waves, seconds)."""
    dev = resolve_device(device)
    ef_b = ef_b or M                     # paper: ef_b = M
    vecs_t = _vecs_on(vecs, dev)
    n = vecs_t.shape[0]
    H = tree.height
    nbrs = torch.full((H, n, M), -1, dtype=torch.int32, device=dev)
    order = np.asarray(tree.order, np.int64)
    start = np.asarray(tree.start, np.int64)
    path = np.asarray(tree.path, np.int64)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    for lvl in range(H - 1, -1, -1):
        t0 = time.perf_counter()
        jobs, lobjs, entries, n_nodes = _level_jobs(tree, lvl,
                                                    symmetric_reverse)
        p = path[:, lvl]
        local = torch.from_numpy(np.where(p >= 0, pos - start[np.maximum(
            p, 0)], 0)).to(dev)
        lob = torch.from_numpy(lobjs).to(dev)
        if lvl + 1 < H and len(lobjs):
            # G_p <- G_{p_l} (line 8): the left children's rows up a level
            nbrs[lvl, lob] = nbrs[lvl + 1, lob]
        present = torch.zeros(n, dtype=torch.bool, device=dev)
        present[lob] = True
        present[torch.from_numpy(entries).to(dev)] = True
        is_left = torch.zeros(n, dtype=torch.bool, device=dev)
        is_left[lob] = True
        st = _merge(vecs_t, nbrs[lvl], nbrs[lvl + 1] if lvl + 1 < H else None,
                    jobs, local, present, is_left, M=M, ef_b=ef_b,
                    merge_chunk=merge_chunk)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        st.update(level=lvl, nodes=n_nodes,
                  seconds=time.perf_counter() - t0)
        if stats is not None:
            stats.append(st)
        if verbose:
            print(f"[build_graphs] level {lvl}: {n_nodes} nodes, "
                  f"{st['rounds']} rounds, {st['lanes']} inserts, "
                  f"{st['hops']} hops, {st['waves']} reverse waves, "
                  f"{st['seconds']:.2f}s", flush=True)
    return nbrs


def _insert_incremental(vecs, plane, members, to_insert, *, M: int,
                        ef_b: int, right_plane, left_set,
                        merge_chunk: int, symmetric_reverse: bool,
                        device=None) -> None:
    """Merge ``to_insert`` into the graph rows ``plane`` (n, M), in place:
    one node's merge as the reference's ``_insert_incremental`` does it.
    ``plane`` is a tensor on ``device`` or a numpy array (updated from the
    device's result). ``members`` are the objects already in the graph
    (the first is the entry; none: the first inserted object bootstraps),
    ``right_plane`` the right child's rows (extra candidates, or None),
    ``left_set`` the boolean mask of the objects reverse edges may reach
    unless ``symmetric_reverse``."""
    dev = resolve_device(device)
    vecs_t = _vecs_on(vecs, dev)
    n = vecs_t.shape[0]
    plane_t = torch.as_tensor(plane).to(device=dev, dtype=torch.int32)
    members = np.asarray(members, np.int64)
    to_insert = np.asarray(to_insert, np.int64)
    if len(members) == 0:
        if len(to_insert) == 0:
            return
        members, to_insert = to_insert[:1], to_insert[1:]
    present = torch.zeros(n, dtype=torch.bool, device=dev)
    present[torch.from_numpy(members).to(dev)] = True
    is_left = (torch.as_tensor(left_set).to(dev).bool()
               if left_set is not None
               else torch.zeros(n, dtype=torch.bool, device=dev))
    lower = (torch.as_tensor(right_plane).to(device=dev, dtype=torch.int32)
             if right_plane is not None else None)
    restrict = (not symmetric_reverse) and left_set is not None
    jobs = {"ins": to_insert, "off": np.zeros(1, np.int64),
            "len": np.array([len(to_insert)], np.int64),
            "entry": members[:1], "span": np.array([n], np.int64),
            "restrict": np.array([int(restrict)], np.int64),
            "extras": np.array([int(lower is not None)], np.int64)}
    _merge(vecs_t, plane_t, lower, jobs, torch.arange(n, device=dev),
           present, is_left, M=M, ef_b=ef_b, merge_chunk=merge_chunk)
    if isinstance(plane, np.ndarray):
        np.copyto(plane, plane_t.cpu().numpy())
    elif plane_t.data_ptr() != plane.data_ptr():
        plane.copy_(plane_t)


def build_graphs_bulk(tree: PartitionTree, vecs, *, M: int = 32,
                      ef_b: Optional[int] = None, block: int = 2048,
                      verbose: bool = False, device=None) -> torch.Tensor:
    """The bulk builder (exact top-ef_b in-node candidates + RNG prune per
    node) on ``device`` (default ``cuda``): the device builder program with
    the host builder's defaults (``ef_b = max(M, 2M)``) and fp32
    ``torch.matmul`` distances with TF32 off, as the reference's numpy
    bulk builder computes them. ``block`` is its row block for large
    nodes. Returns (H, n, M) int32 ``nbrs`` on that device."""
    return build_graphs_device(tree, vecs, M=M, ef_b=ef_b or max(M, 2 * M),
                               row_block=block, dist="jnp", device=device,
                               verbose=verbose)
