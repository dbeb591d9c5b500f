"""Plain numpy reference for ``chip_smoke.py``'s checks at full shard size.

It shares no code with ``repro_torch`` (and imports neither it nor the
JAX package): it is a one-query-at-a-time transcription of the
reference's host twins, so ``chip_smoke.py`` can hold the port's router,
hop loop and graph builder to it on the full 1M-object index, where the
JAX reference itself cannot run.

  * ``dfs_entries`` — Algorithm 1 (RangeFilter) as the stack DFS of
    ``repro.core.query_ref.range_filter`` with the entry-found budget and
    the leaf-scan deviation.
  * ``beam_search`` — Algorithm 3 on the beam pool with the wide frontier
    (``query_ref._query_beam`` + ``_recons_nbr_fused``), plus the
    engine's hop cap.
  * ``graph_rows`` — the bulk builder's rule for one member row of one
    tree node, in float64: the exact top-K in-node candidates (ties to
    the lower node position) and the HNSW RNG prune; optionally with the
    decisions that lie within fp32's resolution (near-ties) taken the way
    a given fp32 build took them.
  * the int8 score path (DESIGN.md §12): ``quantize_rows_i8`` (the
    replica), ``dequant_rows``, ``rerank`` (the exact f32 (dist, id)
    top-k over candidates, which the graph lanes apply to the top ``rr``
    of a ``beam_search`` over the dequantized corpus) and
    ``scan_rerank`` (the scan lanes' over-fetch of ``kq`` on the
    dequantized corpus, then the same rerank).
  * the hybrid path (DESIGN.md §12): ``antichain`` (one box's routing
    antichain by the closed form of the reference's
    ``HostCardEstimator``, walked node by node from the root) and
    ``window_scan`` (the exact in-box top-k over the DFS ``order`` slices
    of a set of nodes, the rows a lane's windows cover).
  * the predicate pass (DESIGN.md §15): ``year_mask``, the row mask of
    ``a0 in (years...)`` optionally ``and a1 <= a1_max``, the two forms of
    filter expression ``chip_smoke.py`` serves, written directly in numpy
    without the predicate compiler.
  * the streaming pass (DESIGN.md §11): ``live_topk`` (the exact in-box
    top-k over rows that carry external ids, such as the live rows of a
    delta segment) and ``merge_dist_ext`` (several candidate lists merged
    by (distance, ext), lowest ext first on ties: the service's merge of
    the base engine's answer with the delta's).
  * the builders' pass: ``merge_node`` (one tree node's Algorithm 5
    merge, as the reference's ``_insert_incremental`` runs it: chunked
    greedy searches, the RNG prune over the results and the right child's
    rows, reverse edges object by object), on a given matrix of pair
    distances over the node's members.
  * the bf16-corpus pass: ``round_bf16`` (float32 values rounded to
    bfloat16, to nearest with ties to even, by bit arithmetic: the corpus
    an index stored in bf16 holds, and the query the gathers hand their
    kernel) and ``topk_f64`` (the exact top-k of a set of rows for many
    queries, in float64, by (distance, id)).
  * the sharded pass (DESIGN.md §14): ``merge_shards`` (per-shard top-k
    lists over local ids merged into global ids, local j of shard s being
    j * S + s, in (distance, shard, local) order: the order of the
    reference's merge-k over the shard-major list).

``tests/test_torch_reference.py`` pins all of them to the JAX package on
the CPU.

    from smoke_reference import dfs_entries, beam_search, graph_rows
"""

from __future__ import annotations

import numpy as np

__all__ = ["dfs_entries", "beam_search", "sq_dists_f64", "graph_rows",
           "graph_shape", "quantize_rows_i8", "dequant_rows", "rerank",
           "scan_rerank", "antichain", "window_scan", "year_mask",
           "live_topk", "merge_dist_ext", "merge_node", "round_bf16",
           "topk_f64"]


def _matches(attrs: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    return np.all((attrs >= lo) & (attrs <= hi), axis=-1)


def dfs_entries(tree, attrs, lo, hi, c_e: int, scan_budget: int,
                max_steps: int | None = None) -> list:
    """<= c_e entry ids in DFS order for the box [lo, hi]. With
    ``max_steps`` the walk stops after that many pops (every pop counts,
    a scanned node's as an internal node's)."""
    m = attrs.shape[1]
    full = (1 << m) - 1
    root = int(np.nonzero(np.asarray(tree.parent) < 0)[0][0])
    D0 = 0
    for i in range(m):
        if tree.lo[root, i] >= lo[i] and tree.hi[root, i] <= hi[i]:
            D0 |= 1 << i

    def scan_entry(p: int):
        s = int(tree.start[p])
        objs = tree.order[s:s + min(int(tree.count[p]), scan_budget)]
        hit = np.nonzero(_matches(attrs[objs], lo, hi))[0]
        return int(objs[hit[0]]) if len(hit) else None

    entries: list = []
    stack = [(root, D0)]
    pops = 0
    while stack and len(entries) < c_e and (max_steps is None
                                            or pops < max_steps):
        pops += 1
        p, D = stack.pop()
        D |= int(tree.bl[p])
        if D == full or int(tree.left[p]) < 0:
            e = scan_entry(p)
            if e is not None:
                entries.append(e)
            continue
        dsp = int(tree.dim[p])
        for pc in (int(tree.left[p]), int(tree.right[p])):
            if (D >> dsp) & 1:
                stack.append((pc, D))
                continue
            lc, rc = float(tree.lo[pc, dsp]), float(tree.hi[pc, dsp])
            if lc > hi[dsp] or rc < lo[dsp]:
                continue
            if lc >= lo[dsp] and rc <= hi[dsp]:
                stack.append((pc, D | (1 << dsp)))
            else:
                stack.append((pc, D))
    return entries


def beam_search(vecs, attrs, nbrs, entries, q, lo, hi, *, k: int, ef: int,
                c_n: int, E: int, max_hops: int, dist=None):
    """One query's graph search. ``nbrs`` is object-major (n, H, M).
    Returns the first ``k`` pool slots (ids (k,) -1 padded, dists (k,)
    f32) and the hop count; ``k`` may be up to ``ef`` (a rerank's
    ``rr``). ``dist(ids) -> (len(ids),) f32`` replaces the f32 squared
    distances to ``q`` (numpy's sum order), e.g. by another summation
    order's, so that a walk can be replayed on those distances."""
    if dist is None:
        def dist(ids):
            dv = vecs[ids] - q
            return np.einsum("vd,vd->v", dv, dv).astype(np.float32)
    n = vecs.shape[0]
    HM = nbrs.shape[1] * nbrs.shape[2]
    L = E * HM
    size = ef + E * c_n
    ids = np.full(size, -1, np.int64)
    dists = np.full(size, np.inf, np.float32)
    expanded = np.ones(size, bool)
    visited = np.zeros(n, bool)

    def resort():
        srt = np.argsort(dists, kind="stable")
        ids[:], dists[:], expanded[:] = ids[srt], dists[srt], expanded[srt]

    if len(entries):
        e = np.asarray(entries, np.int64)
        d0 = dist(e)
        ids[:len(e)], dists[:len(e)] = e, d0
        expanded[:len(e)] = ~np.isfinite(d0)
        resort()
        visited[e] = True

    base = np.repeat(np.arange(E, dtype=np.int64) * c_n, HM)
    hops = 0
    while hops < max_hops:
        frontier = ~expanded[:ef] & np.isfinite(dists[:ef])
        slots = np.argsort(~frontier, kind="stable")[:E]
        uvalid = frontier[slots]
        if not uvalid.any():
            break
        expanded[slots[uvalid]] = True
        hops += 1
        nid = np.full(L, -1, np.int64)
        for j in np.nonzero(uvalid)[0]:
            nid[j * HM:(j + 1) * HM] = nbrs[ids[slots[j]]].reshape(HM)
        valid = nid >= 0
        nid_safe = np.where(valid, nid, 0)
        # first occurrence along the fused stream
        vpos = np.nonzero(valid)[0]
        is_first = np.zeros(L, bool)
        is_first[vpos[np.unique(nid[vpos], return_index=True)[1]]] = True
        fresh = is_first & ~visited[nid_safe]
        append = fresh & valid & _matches(attrs[nid_safe], lo, hi)
        seg = append.reshape(E, HM)
        napp_excl = (np.cumsum(seg, axis=1) - seg).reshape(L)
        scanned = napp_excl < c_n
        visited[nid_safe[fresh & scanned]] = True
        keep = append & scanned
        buf = np.full(E * c_n, -1, np.int64)
        buf[base[keep] + napp_excl[keep]] = nid[keep]
        bd = np.full(E * c_n, np.inf, np.float32)
        got = buf >= 0
        bd[got] = dist(buf[got])
        ok = np.isfinite(bd)
        ids[ef:] = np.where(ok, buf, -1)
        dists[ef:] = np.where(ok, bd, np.inf)
        expanded[ef:] = ~ok
        resort()
        ids[ef:], dists[ef:], expanded[ef:] = -1, np.inf, True
    return ids[:k].copy(), dists[:k].copy(), hops


def sq_dists_f64(vecs, rows, chunk: int = 1 << 16) -> np.ndarray:
    """(R, n) float64 squared distances from the vectors ``rows`` (R, d)
    to every row of ``vecs`` (n, d)."""
    r = np.asarray(rows, np.float64)
    rn = (r * r).sum(1)
    out = np.empty((r.shape[0], vecs.shape[0]), np.float64)
    for s in range(0, vecs.shape[0], chunk):
        c = vecs[s:s + chunk].astype(np.float64)
        out[:, s:s + chunk] = ((c * c).sum(1)[None, :] + rn[:, None]
                               - 2.0 * (r @ c.T))
    return out


def graph_shape(count: int, M: int, ef_b: int):
    """(K, M_eff) of the builder's size class for a node of ``count``."""
    C = max(8, 1 << max(count - 1, 0).bit_length())
    K = min(ef_b + 1, C)
    return K, min(M, K - 1)


def graph_rows(vecs, members, pos, d_rows, *, M: int, ef_b: int,
               rel_tol: float = 0.0, guide=None):
    """Adjacency rows of the node whose members are ``members`` (its
    ``order`` slice), for the members at node positions ``pos``, given
    their float64 squared distances ``d_rows`` (len(pos), len(members)).
    Returns (len(pos), M) global ids in RNG scan order, -1 padded.

    With ``rel_tol`` > 0 and ``guide`` ((len(pos), M) global ids, -1
    padded: the rows a builder computed in lower precision), a decision
    of the rule that lies within ``rel_tol`` x 2 x (the row's squared norm
    plus its candidates' largest) of going the other way is taken the way
    ``guide`` took it: candidates whose distances lie that close (which
    of them enter the K, and in what order) go guide rows first, in the
    guide's order, and a prune comparison that close keeps the candidate
    iff the guide row holds it. A row with an exact copy of itself, or of
    a kept neighbour, among its candidates ties on every prune. Returns
    (rows, per row the near-tie decisions the guide took against the
    float64 rule (len(pos),) int64)."""
    K, M_eff = graph_shape(len(members), M, ef_b)
    K = min(K, len(members))
    guided = rel_tol > 0
    out = np.full((len(pos), M), -1, np.int64)
    n_ties = np.zeros(len(pos), np.int64)
    for r, (p, d) in enumerate(zip(pos, d_rows)):
        # the K nearest by (dist, pos); guided, a margin past them for
        # the candidates that tie with the K-th
        K2 = min(K + 64, len(d)) if guided else K
        part = np.argpartition(d, K2 - 1)[:K2] if K2 < len(d) \
            else np.arange(len(d))
        cand = part[np.lexsort((part, d[part]))]            # (dist, pos)
        cv = vecs[members[cand]].astype(np.float64)
        if guided:
            pv = vecs[members[p]].astype(np.float64)
            tol = rel_tol * 2.0 * ((pv * pv).sum() + (cv * cv).sum(1).max())
            g = {int(x): j for j, x in enumerate(guide[r]) if x >= 0}
            rank = np.asarray([g.get(int(x), M) for x in members[cand]])
            brk = np.nonzero(np.diff(d[cand]) > tol)[0] + 1
            blocks = np.split(np.arange(len(cand)), brk)
            sel = np.concatenate([blk[np.argsort(rank[blk], kind="stable")]
                                  for blk in blocks])
            # blocks where the guide reordered its own rows or brought one
            # into the K, by first position
            moved = []
            for blk in blocks:
                gm = blk[rank[blk] < M]
                if (np.diff(rank[gm]) < 0).any() or (
                        blk[0] < K and (gm >= K).any()):
                    moved.append(blk[0])
            sel = sel[:K]
            cand, cv = cand[sel], cv[sel]
        kept: list = []
        last = -1
        for j, c in enumerate(cand):
            if len(kept) >= M_eff:
                break
            last = j
            if c == p:
                continue
            if kept:
                dr = ((cv[kept] - cv[j]) ** 2).sum(1)
                if not guided:
                    if (dr < d[c]).any():
                        continue
                elif (dr < d[c] - tol).any():
                    continue
                elif (dr < d[c] + tol).any():
                    keep = int(members[c]) in g
                    n_ties[r] += keep == bool((dr < d[c]).any())
                    if not keep:
                        continue
            kept.append(j)
        if guided:
            n_ties[r] += sum(s0 <= last for s0 in moved)
        out[r, :len(kept)] = members[cand[kept]]
    return (out, n_ties) if guided else out


def quantize_rows_i8(v):
    """(n, d) float -> (int8 (n, d), scale (n, 1) f32): scale = max|row| /
    127 (1 for an all-zero row), round half to even, clip to +-127."""
    v = np.asarray(v, np.float32)
    amax = np.abs(v).max(axis=-1, keepdims=True)
    scale = np.where(amax > 0, amax / np.float32(127.0),
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
    return q, scale


def dequant_rows(qrows, scale):
    """f32 rows back from int8 rows and their scales."""
    return qrows.astype(np.float32) * scale.astype(np.float32)


def rerank(vecs, cand, q, k: int):
    """Exact f32 squared distances of the candidate ids ``cand`` (-1 =
    none) to ``q``; the k smallest by (distance, id), -1 / +inf past the
    real candidates."""
    cand = np.asarray(cand, np.int64)
    d = np.full(len(cand), np.inf, np.float32)
    ok = cand >= 0
    dv = vecs[cand[ok]] - q
    d[ok] = np.einsum("vd,vd->v", dv, dv)
    key = np.where(ok, cand, np.iinfo(np.int32).max)
    sel = np.lexsort((key, d))[:k]
    ids, dd = cand[sel], d[sel]
    return np.where(np.isinf(dd), -1, ids), dd


def scan_rerank(deq, vecs, attrs, q, lo, hi, *, k: int, kq: int):
    """One scan lane of the quantized path: the kq in-box rows nearest to
    ``q`` on the dequantized corpus ``deq`` by (distance, id), then
    ``rerank`` on the f32 corpus. NaN attrs never match."""
    rows = np.nonzero(_matches(attrs, lo, hi))[0]
    dv = deq[rows] - q
    d = np.einsum("vd,vd->v", dv, dv)
    top = rows[np.lexsort((rows, d))[:kq]]
    cand = np.full(kq, -1, np.int64)
    cand[:len(top)] = top
    return rerank(vecs, cand, q, k)


def antichain(tree, lo, hi) -> np.ndarray:
    """The nodes at which the routing sweep stops for the box [lo, hi],
    walked one tree level at a time from the root: a node stops when
    every dim is covered (``bl`` or its rectangle inside the box) or it
    is a leaf; a child is visited when its parent is visited and does not
    stop, and either the parent's split dim is covered or the child's
    extent on it meets the box. Node ids, level by level."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    m = len(lo)
    full = (1 << m) - 1
    left, right = np.asarray(tree.left), np.asarray(tree.right)
    dim, bl = np.asarray(tree.dim), np.asarray(tree.bl).astype(np.int64)
    tlo, thi = np.asarray(tree.lo), np.asarray(tree.hi)
    bit = np.int64(1) << np.arange(m, dtype=np.int64)
    out = []
    frontier = np.nonzero(np.asarray(tree.parent) < 0)[0][:1]
    while frontier.size:
        inside = (tlo[frontier] >= lo) & (thi[frontier] <= hi)   # (F, m)
        D = bl[frontier] | (inside * bit).sum(1)
        stop = (D == full) | (left[frontier] < 0)
        out.append(frontier[stop])
        go, Dg = frontier[~stop], D[~stop]
        dsp = dim[go]
        kids = []
        for child in (left[go], right[go]):
            meets = ~((tlo[child, dsp] > hi[dsp]) | (thi[child, dsp] < lo[dsp]))
            kids.append(child[((Dg >> dsp) & 1).astype(bool) | meets])
        frontier = np.concatenate(kids)
    return np.concatenate(out)


def window_scan(vecs, attrs, tree, nodes, q, lo, hi, k: int):
    """Exact in-box top-k (ids (k,) -1 padded, f32 dists) over the rows
    ``order[start:start + count]`` of ``nodes`` (disjoint extents), by
    (distance, id)."""
    order = np.asarray(tree.order, np.int64)
    nodes = np.asarray(nodes, np.int64)
    start = np.asarray(tree.start, np.int64)[nodes]
    count = np.asarray(tree.count, np.int64)[nodes]
    mark = np.zeros(len(order) + 1, np.int64)
    np.add.at(mark, start, 1)
    np.add.at(mark, start + count, -1)
    rows = order[np.cumsum(mark[:-1]) > 0]
    rows = rows[_matches(attrs[rows], lo, hi)]
    cand = np.full(max(k, len(rows)), -1, np.int64)
    cand[:len(rows)] = rows
    return rerank(vecs, cand, q, k)


def round_bf16(x):
    """float32 ``x`` rounded to the nearest bfloat16 (ties to even) and
    widened back to float32, by bit arithmetic on the float32 words: add
    0x7FFF plus the lowest kept bit, then clear the low 16 bits. NaN stays
    NaN; a value past bfloat16's range becomes +-inf, as the cast gives."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    r = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) \
        & np.uint32(0xFFFF0000)
    out = r.view(np.float32)
    return np.where(np.isnan(x), x, out)


def topk_f64(vecs, rows, Q, k: int, chunk: int = 1 << 15):
    """Exact top-k of ``rows`` of ``vecs`` for every query of ``Q`` (B,
    d), in float64: (ids (B, k) int64, -1 padded; dists (B, k) float32 of
    the float64 squared distances), by (distance, id). The rows go in
    chunks; each distance is ``|x|^2 + |q|^2 - 2 x.q`` in float64, whose
    error (~1e-16 of the norms) lies far below float32's."""
    rows = np.asarray(rows, np.int64)
    q = np.asarray(Q, np.float64)
    qn = (q * q).sum(1)
    B = len(q)
    best_d = np.full((B, 0), np.inf)
    best_i = np.full((B, 0), -1, np.int64)
    for s in range(0, len(rows), chunk):
        r = rows[s:s + chunk]
        x = np.asarray(vecs[r], np.float64)
        d = (x * x).sum(1)[None] + qn[:, None] - 2.0 * (q @ x.T)
        cand_d = np.concatenate([best_d, d], 1)
        cand_i = np.concatenate([best_i, np.broadcast_to(r, d.shape)], 1)
        o = np.lexsort((cand_i, cand_d), axis=1)[:, :k]
        best_d = np.take_along_axis(cand_d, o, 1)
        best_i = np.take_along_axis(cand_i, o, 1)
    ids = np.full((B, k), -1, np.int64)
    dd = np.full((B, k), np.inf, np.float32)
    kk = best_i.shape[1]
    ids[:, :kk], dd[:, :kk] = best_i, best_d.astype(np.float32)
    return ids, dd


def year_mask(attrs, years, a1_max=None):
    """Row mask of ``a0 in years`` (and ``a1 <= a1_max`` when given);
    NaN fails."""
    a = np.asarray(attrs, np.float32)
    ok = np.zeros(len(a), bool)
    for y in years:
        ok |= a[:, 0] == np.float32(y)
    if a1_max is not None:
        ok &= a[:, 1] <= np.float32(a1_max)
    return ok



def live_topk(vecs, attrs, exts, q, lo, hi, k: int):
    """Exact in-box top-k over rows whose external ids are ``exts``:
    (ext ids (k,) int64, -1 padded; f32 distances, +inf padded), by
    (distance, ext). NaN attrs never match."""
    exts = np.asarray(exts, np.int64)
    rows = np.nonzero(_matches(attrs, lo, hi))[0]
    dv = vecs[rows] - np.asarray(q, np.float32)
    d = np.einsum("vd,vd->v", dv, dv)
    sel = np.lexsort((exts[rows], d))[:k]
    out_e = np.full(k, -1, np.int64)
    out_d = np.full(k, np.inf, np.float32)
    out_e[:len(sel)] = exts[rows[sel]]
    out_d[:len(sel)] = d[sel]
    return out_e, out_d


def merge_dist_ext(parts, k: int):
    """Candidate lists ``parts`` = [(ext ids (B, c_i), dists (B, c_i)),
    ...], ext -1 for none, merged per row by (distance, ext): (ext ids
    (B, k) int64, -1 padded; dists (B, k) f32, +inf padded)."""
    ext = np.concatenate([np.asarray(e, np.int64) for e, _ in parts], 1)
    d = np.concatenate([np.asarray(x, np.float32) for _, x in parts], 1)
    d = np.where(ext >= 0, d, np.inf).astype(np.float32)
    key = np.where(ext >= 0, ext, np.iinfo(np.int64).max)
    out_e = np.full((ext.shape[0], k), -1, np.int64)
    out_d = np.full((ext.shape[0], k), np.inf, np.float32)
    for i in range(ext.shape[0]):
        sel = np.lexsort((key[i], d[i]))[:k]
        sel = sel[np.isfinite(d[i][sel])]
        out_e[i, :len(sel)] = ext[i][sel]
        out_d[i, :len(sel)] = d[i][sel]
    return out_e, out_d


def merge_shards(ids, dists, n_shards: int, k: int):
    """Per-shard top-k lists, local ids (S, B, k') -1 padded and their
    dists (S, B, k'), merged per lane into the global answer: local id j
    of shard s becomes j * S + s, and the k best are kept in (distance,
    shard, local) order, i.e. by distance with ties to the earlier entry
    of the shard-major list. (ids (B, k) int64, -1 padded; dists (B, k)
    f32, +inf padded)."""
    ids = np.asarray(ids, np.int64)
    d = np.asarray(dists, np.float32)
    S, B, _ = ids.shape
    shard = np.arange(S, dtype=np.int64)[:, None, None]
    g = np.where(ids >= 0, ids * n_shards + shard, -1)
    d = np.where(ids >= 0, d, np.inf).astype(np.float32)
    out_i = np.full((B, k), -1, np.int64)
    out_d = np.full((B, k), np.inf, np.float32)
    for b in range(B):
        flat_i, flat_d = g[:, b].reshape(-1), d[:, b].reshape(-1)
        sel = np.argsort(flat_d, kind="stable")[:k]
        sel = sel[np.isfinite(flat_d[sel])]
        out_i[b, :len(sel)] = flat_i[sel]
        out_d[b, :len(sel)] = flat_d[sel]
    return out_i, out_d


def _greedy(plane, dist, q, entry: int, ef: int):
    """One greedy best-first search of the reference's builder (pool of
    ``ef``: expand the closest unexpanded slot, add the fresh neighbours,
    keep the ``ef`` closest by a stable sort, the pool before the new ones
    in row order) over local ids. Returns (ids, dists) ascending."""
    pool = [[float(dist[q, entry]), entry, False]]
    seen = {entry}
    while True:
        f = next((j for j, s in enumerate(pool) if not s[2]), None)
        if f is None:
            return ([s[1] for s in pool],
                    np.asarray([s[0] for s in pool], np.float32))
        pool[f][2] = True
        new = [v for v in plane[pool[f][1]].tolist()
               if v >= 0 and v not in seen]
        seen.update(new)
        if new:
            dn = dist[q, new].tolist()
            pool = sorted(pool + [[d, v, False] for d, v in zip(dn, new)],
                          key=lambda s: s[0])[:ef]


def _prune(o: int, cand, cd, dist, M: int, tol: float, ties: list) -> list:
    """The reference's rng_prune over local ids: ascending (stable),
    skip o, -1 and an id already kept, keep e unless a kept r has
    d(e, r) < d(e, o), stop at M. Counts into ``ties[0]`` the decisions
    (neighbours in the sort, shield tests) within ``tol`` x the larger
    distance of going the other way."""
    order = np.argsort(cd, kind="stable")
    sd, sc = cd[order], cand[order]
    ties[0] += int(((np.diff(sd) <= tol * sd[1:])
                    & (sc[1:] != sc[:-1])).sum())
    kept: list = []
    for j in order:
        e = int(cand[j])
        if e == o or e < 0 or e in kept:
            continue
        if kept:
            dr = dist[e, kept]
            ties[0] += int((np.abs(dr - cd[j]) <= tol * np.maximum(
                dr, cd[j])).sum())
            if (dr < cd[j]).any():
                continue
        kept.append(e)
        if len(kept) >= M:
            break
    return kept


def merge_node(lower, n_left: int, dist, *, M: int, ef_b: int,
               merge_chunk: int = 64, symmetric_reverse: bool = False,
               rel_tol: float = 0.0):
    """One internal tree node's Algorithm 5 merge (the reference's
    ``build_graphs`` for a node: its left child's rows copied up, then
    ``_insert_incremental`` of the right child's objects), over local
    ids: members 0..n_left-1 are the left child's objects and the rest
    the right child's, both in ``tree.order``. ``lower`` (c, M) holds
    their rows one level down (local ids, -1 padded), ``dist`` (c, c) the
    pair distances every decision reads (d(a, b) = dist[a, b]). Returns
    (rows (c, M) local ids at the node's level, the number of decisions
    within ``rel_tol`` of going the other way)."""
    c = dist.shape[0]
    plane = np.full((c, M), -1, np.int64)
    plane[:n_left] = lower[:n_left]
    present = np.zeros(c, bool)
    present[:n_left] = True
    todo = list(range(n_left, c))
    if n_left == 0:
        present[todo[0]] = True
        todo = todo[1:]
    entry = 0 if n_left else n_left
    ties = [0]
    for s in range(0, len(todo), max(1, merge_chunk)):
        chunk = todo[s:s + max(1, merge_chunk)]
        found = [_greedy(plane, dist, o, entry, ef_b) for o in chunk]
        for o, (cids, cds) in zip(chunk, found):
            extra = [int(v) for v in lower[o] if v >= 0]
            cand = np.asarray(cids + extra, np.int64)
            cd = np.concatenate([cds, dist[o, extra].astype(np.float32)])
            kept = _prune(o, cand, cd, dist, M, rel_tol, ties)
            plane[o] = -1
            plane[o, :len(kept)] = kept
            for nb in kept:
                if not present[nb] or (not symmetric_reverse
                                       and nb >= n_left):
                    continue
                cur = [int(v) for v in plane[nb] if v >= 0]
                if o in cur:
                    continue
                if len(cur) < M:
                    plane[nb, len(cur)] = o
                    continue
                allc = np.asarray(cur + [o], np.int64)
                kept2 = _prune(nb, allc, dist[nb, allc], dist, M, rel_tol,
                               ties)
                plane[nb] = -1
                plane[nb, :len(kept2)] = kept2
            present[o] = True
    return plane, ties[0]
