"""The numpy oracle of the KHI query path, copied from
``repro.core.query_ref``: range predicates, the exact ground truth
(``brute_force``, ``brute_force_expr``), the paper's Algorithms 1-3 on
the host (``range_filter`` and its level-synchronous twin
``range_filter_level``, ``estimate_cardinality``, ``recons_nbr``,
``query``) and the streaming write path's ``StreamingOracle``.

This is host numpy code, as in the reference: an explicit DFS stack,
``heapq`` priority queues and the sequential early-exit neighbour
reconstruction, with the reference's deviations (DESIGN.md §6). The
batched engine in ``core.engine`` is held to it. Distances are squared
L2. Every function takes the port's ``KHIIndex`` or the reference's; a
graph that lives on a device as a tensor is read back to the host once
per call of ``query``."""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import beam

__all__ = ["Predicate", "range_filter", "range_filter_level", "recons_nbr",
           "estimate_cardinality", "query", "brute_force",
           "brute_force_expr", "StreamingOracle"]


class Predicate:
    """Range predicate B: per-attribute [lo, hi], ±inf when unconstrained."""

    def __init__(self, lo: Sequence[float], hi: Sequence[float]):
        self.lo = np.asarray(lo, dtype=np.float32)
        self.hi = np.asarray(hi, dtype=np.float32)
        assert self.lo.shape == self.hi.shape

    @classmethod
    def from_bounds(cls, m: int, bounds: dict[int, tuple[float, float]]) -> "Predicate":
        lo = np.full(m, -np.inf, dtype=np.float32)
        hi = np.full(m, np.inf, dtype=np.float32)
        for i, (l, r) in bounds.items():
            lo[i], hi[i] = l, r
        return cls(lo, hi)

    def matches(self, attrs: np.ndarray) -> np.ndarray:
        """attrs (…, m) -> bool (…)."""
        return ((attrs >= self.lo) & (attrs <= self.hi)).all(axis=-1)

    @property
    def cardinality(self) -> int:
        return int((np.isfinite(self.lo) | np.isfinite(self.hi)).sum())


def brute_force(index_vecs: np.ndarray, attrs: np.ndarray, q: np.ndarray,
                pred: Predicate, k: int) -> np.ndarray:
    """Exact ground truth over O_B (the paper's Prefiltering baseline)."""
    mask = pred.matches(attrs)
    ids = np.nonzero(mask)[0]
    if len(ids) == 0:
        return ids.astype(np.int64)
    diff = index_vecs[ids] - q
    d2 = np.einsum("nd,nd->n", diff, diff)
    k = min(k, len(ids))
    top = np.argpartition(d2, kth=k - 1)[:k]
    return ids[top[np.argsort(d2[top], kind="stable")]].astype(np.int64)


def brute_force_expr(index_vecs: np.ndarray, attrs: np.ndarray,
                     q: np.ndarray, expr, k: int) -> np.ndarray:
    """Exact ground truth under a boolean filter expression (DESIGN.md
    §15): mask-then-top-k with the engine's (distance, id) tie-break.
    Shorter than k when the match count is."""
    from .predicate import eval_expr

    mask = eval_expr(expr, np.asarray(attrs, np.float32))
    ids = np.nonzero(mask)[0].astype(np.int64)
    if not ids.size:
        return ids
    diff = np.asarray(index_vecs[ids], np.float32) - np.asarray(q, np.float32)
    d2 = np.einsum("nd,nd->n", diff, diff)
    order = np.lexsort((ids, d2))[: min(k, ids.size)]
    return ids[order]


def _on_host(index):
    """``index`` itself when its graph is a host array, else a copy whose
    ``nbrs`` is read back from its device (the port's builders leave the
    graph there as a tensor)."""
    if torch.is_tensor(index.nbrs):
        return dataclasses.replace(index, nbrs=index.nbrs.cpu().numpy())
    return index


def range_filter(index, pred: Predicate, c_e: int,
                 *, scan_budget: Optional[int] = None,
                 faithful_budget: bool = False) -> List[int]:
    """Algorithm 1 (RangeFilter): collect <= c_e entry points in O_B.

    Deviation (DESIGN.md §6): the pseudocode stops the DFS after c_e
    *candidate nodes*; when dimensions were blacklisted (BL ⊆ D) a candidate
    node's rectangle need not be contained in B, so its scan can come up
    empty and the literal algorithm may return zero entry points even though
    O_B is large (observed on skewed discrete attributes). We therefore
    budget *entries found* — scan each candidate as soon as it is collected
    and keep exploring until c_e entries exist or the stack empties.
    ``faithful_budget=True`` restores the literal pseudocode.
    """
    t = index.tree
    m = index.m
    full = (1 << m) - 1
    qlo, qhi = pred.lo, pred.hi

    root = int(np.nonzero(t.parent < 0)[0][0])
    # D's definition (paper §4.2) is "dims i with pi_i(R(p)) ⊆ b_i, plus
    # BL(p)"; the stack only maintains it incrementally on split dims, so
    # seed the root with its already-covered dims.
    D0 = 0
    for i in range(m):
        if t.lo[root, i] >= qlo[i] and t.hi[root, i] <= qhi[i]:
            D0 |= 1 << i

    def scan_entry(p: int) -> Optional[int]:
        objs = t.node_objects(p)
        if scan_budget is not None:
            objs = objs[:scan_budget]
        ok = pred.matches(index.attrs[objs])
        hit = np.nonzero(ok)[0]
        return int(objs[hit[0]]) if len(hit) else None

    entries: List[int] = []
    n_cands = 0
    stack: List[Tuple[int, int]] = [(root, D0)]
    while stack:
        if faithful_budget:
            if n_cands >= c_e:
                break
        elif len(entries) >= c_e:
            break
        p, D = stack.pop()
        D |= int(t.bl[p])
        if D == full:
            n_cands += 1
            e = scan_entry(p)
            if e is not None:
                entries.append(e)
            continue
        if t.is_leaf(p):
            # Deviation (DESIGN.md §6): the pseudocode skips leaves with
            # |D| < m, which starves entry selection when leaf cells are
            # wider than the query window (small corpora / per-shard
            # indexes). Leaves hold <= c_l objects, so an exact predicate
            # scan is O(c_l) and restores the guarantee that entries exist
            # whenever O_B intersects an explored branch.
            e = scan_entry(p)
            if e is not None:
                entries.append(e)
            continue
        dsp = int(t.dim[p])
        children = (int(t.left[p]), int(t.right[p]))
        if (D >> dsp) & 1:
            for pc in children:
                stack.append((pc, D))
            continue
        for pc in children:
            lc, rc = float(t.lo[pc, dsp]), float(t.hi[pc, dsp])
            if lc > qhi[dsp] or rc < qlo[dsp]:
                continue  # disjoint
            if lc >= qlo[dsp] and rc <= qhi[dsp]:
                stack.append((pc, D | (1 << dsp)))
            else:
                stack.append((pc, D))
    return entries


def range_filter_level(index, pred: Predicate, c_e: int,
                       *, scan_budget: Optional[int] = None) -> List[int]:
    """Numpy twin of the device level-synchronous router
    (``core.router.route_level_sync``): a breadth-first sweep over tree
    levels that collects every scannable node's entry tagged with the
    DFS-rank key ``n - (start + count)`` and returns the ``c_e`` smallest
    keys' entries, ascending. Scanned nodes form an antichain, so their
    object ranges are disjoint and descending range end IS right-first
    pre-order — the exact order ``range_filter``'s DFS collects entries
    in, with the DFS's early stop only ever dropping larger keys. The two
    routers therefore return identical entry lists (pinned by
    tests/test_router.py)."""
    t = index.tree
    m = index.m
    full = (1 << m) - 1
    qlo, qhi = pred.lo, pred.hi
    n = index.n

    root = int(np.nonzero(t.parent < 0)[0][0])
    D0 = 0
    for i in range(m):
        if t.lo[root, i] >= qlo[i] and t.hi[root, i] <= qhi[i]:
            D0 |= 1 << i

    def scan_entry(p: int) -> Optional[int]:
        objs = t.node_objects(p)
        if scan_budget is not None:
            objs = objs[:scan_budget]
        ok = pred.matches(index.attrs[objs])
        hit = np.nonzero(ok)[0]
        return int(objs[hit[0]]) if len(hit) else None

    found: List[Tuple[int, int]] = []       # (dfs key, entry id)
    frontier: List[Tuple[int, int]] = [(root, D0)]
    while frontier:
        nxt: List[Tuple[int, int]] = []
        for p, D in frontier:
            D |= int(t.bl[p])
            if D == full or t.is_leaf(p):
                e = scan_entry(p)           # leaf fallback incl. (DESIGN §6)
                if e is not None:
                    end = int(t.start[p]) + int(t.count[p])
                    found.append((n - end, e))
                continue
            dsp = int(t.dim[p])
            for pc in (int(t.left[p]), int(t.right[p])):
                if (D >> dsp) & 1:
                    nxt.append((pc, D))
                    continue
                lc, rc = float(t.lo[pc, dsp]), float(t.hi[pc, dsp])
                if lc > qhi[dsp] or rc < qlo[dsp]:
                    continue  # disjoint
                if lc >= qlo[dsp] and rc <= qhi[dsp]:
                    nxt.append((pc, D | (1 << dsp)))
                else:
                    nxt.append((pc, D))
        frontier = nxt
    found.sort()
    return [e for _, e in found[:c_e]]


def estimate_cardinality(index, pred: Predicate,
                         *, exact: bool = False) -> int:
    """Numpy twin of the device planner's selectivity estimate
    (``router.route_level_card``, DESIGN.md §10): sweep the tree exactly
    like ``range_filter_level`` and sum ``count`` over the *scanned*
    antichain (covered or leaf nodes). Every in-range object lives in
    exactly one scanned node (disjoint branches are dropped only when
    provably empty on the split dim), so the sum upper-bounds |O_B| —
    exact on genuinely contained nodes, an overcount only on leaves and
    BL-covered nodes. ``exact=True`` returns the true |O_B| instead (the
    oracle the bound is validated against)."""
    if exact:
        return int(pred.matches(index.attrs).sum())
    t = index.tree
    m = index.m
    full = (1 << m) - 1
    qlo, qhi = pred.lo, pred.hi

    root = int(np.nonzero(t.parent < 0)[0][0])
    D0 = 0
    for i in range(m):
        if t.lo[root, i] >= qlo[i] and t.hi[root, i] <= qhi[i]:
            D0 |= 1 << i

    card = 0
    frontier: List[Tuple[int, int]] = [(root, D0)]
    while frontier:
        nxt: List[Tuple[int, int]] = []
        for p, D in frontier:
            D |= int(t.bl[p])
            if D == full or t.is_leaf(p):
                card += int(t.count[p])
                continue
            dsp = int(t.dim[p])
            for pc in (int(t.left[p]), int(t.right[p])):
                if (D >> dsp) & 1:
                    nxt.append((pc, D))
                    continue
                lc, rc = float(t.lo[pc, dsp]), float(t.hi[pc, dsp])
                if lc > qhi[dsp] or rc < qlo[dsp]:
                    continue  # disjoint
                if lc >= qlo[dsp] and rc <= qhi[dsp]:
                    nxt.append((pc, D | (1 << dsp)))
                else:
                    nxt.append((pc, D))
        frontier = nxt
    return card


def recons_nbr(index, o: int, pred: Predicate, c_n: int,
               visited: np.ndarray) -> List[int]:
    """Algorithm 2 (ReconsNbr): root->leaf aggregation of in-range neighbors.

    Marks every *scanned* neighbor visited (in or out of range), stopping as
    soon as c_n in-range fresh neighbors have been appended — exactly the
    sequential early-exit semantics of the pseudocode.
    """
    index = _on_host(index)
    out: List[int] = []
    path = index.tree.path[o]
    for lvl in range(index.height):
        if path[lvl] < 0:
            break
        for v in index.nbrs[lvl, o]:
            v = int(v)
            if v < 0:
                continue
            if visited[v]:
                continue
            visited[v] = True
            if pred.matches(index.attrs[v]):
                out.append(v)
                if len(out) == c_n:
                    return out
    return out


def query(
    index,
    q: np.ndarray,
    pred: Predicate,
    k: int,
    *,
    ef: int = 64,
    c_e: Optional[int] = None,
    c_n: Optional[int] = None,
    scan_budget: Optional[int] = None,
    return_stats: bool = False,
    pool: str = "heap",
    expand_width: int = 1,
    router: str = "dfs",
    strategy: str = "graph",
    scan_threshold: Optional[int] = None,
):
    """Algorithm 3 (Query): greedy best-first search over O_B.

    ``pool`` selects the queue implementation: ``"heap"`` is the
    line-faithful two-priority-queue form of the pseudocode; ``"beam"``
    runs the same RangeFilter/ReconsNbr calls on the shared fixed-shape
    pool substrate (``core.beam``'s numpy twins of the engine's
    pool). The two are equivalent under distinct
    candidate distances because R-hat never shrinks (exact ties at the ef
    boundary may route discovery differently — core/beam.py docstring);
    a fixed-seed test pins the agreement on the tier-1 workload.

    ``expand_width`` (beam mode only) is the reference for the engine's
    wide frontier (DESIGN.md §8): each hop expands the top-E unexpanded
    pool entries at once over one fused candidate stream. ``1`` reproduces
    the single-expansion hop exactly; ``>1`` changes hop order only.

    ``router`` selects the Phase-A twin: ``"dfs"`` is the line-faithful
    stack DFS, ``"level"`` the level-synchronous sweep the device engine
    defaults to — the two return identical entry lists (DESIGN.md §9), so
    this knob exists for twin-vs-twin pinning, not behavior.

    ``strategy`` is the host twin of the device planner (DESIGN.md §10):
    ``"scan"`` answers with the exact brute scan over O_B
    (``brute_force``); ``"auto"`` estimates |O_B| via
    ``estimate_cardinality`` (the routing bound) and dispatches to scan
    when ``0 < card <= scan_threshold`` (default: the engine's
    ``DEFAULT_SCAN_FRAC`` of n), to the graph search otherwise — the
    same decision rule the device ``Planner`` applies per batch lane.
    """
    c_e = c_e if c_e is not None else k         # paper: c_e = k
    c_n = c_n if c_n is not None else index.config.M  # paper: c_n = M
    if strategy not in ("graph", "scan", "auto"):
        raise ValueError(f"strategy must be graph|scan|auto, "
                         f"got {strategy!r}")
    if strategy == "auto":
        if scan_threshold is None:
            from .engine import DEFAULT_SCAN_FRAC
            scan_threshold = max(1, int(DEFAULT_SCAN_FRAC * index.n))
        card = estimate_cardinality(index, pred)
        strategy = "scan" if 0 < card <= scan_threshold else "graph"
    if strategy == "scan":
        ids = brute_force(index.vecs, index.attrs, np.asarray(q, np.float32),
                          pred, k)
        if return_stats:
            return ids, {"hops": 0, "entries": 0, "threshold_trace": [],
                         "visited": index.n, "strategy": "scan"}
        return ids
    if expand_width < 1:
        raise ValueError(f"expand_width must be >= 1, got {expand_width}")
    if expand_width > ef:
        # keep the reference's domain identical to the engine's
        # (SearchParams rejects E > ef — the frontier never holds more
        # than ef candidates)
        raise ValueError(f"expand_width must be <= ef ({ef}), "
                         f"got {expand_width}")
    index = _on_host(index)
    visited = np.zeros(index.n, dtype=bool)
    q = np.asarray(q, dtype=np.float32)

    if router == "level":
        entries = range_filter_level(index, pred, c_e,
                                     scan_budget=scan_budget)
    elif router == "dfs":
        entries = range_filter(index, pred, c_e, scan_budget=scan_budget)
    else:
        raise ValueError(f"router must be 'dfs' or 'level', got {router!r}")
    if pool == "beam":
        return _query_beam(index, q, pred, k, entries, visited,
                           ef=ef, c_n=c_n, expand_width=expand_width,
                           return_stats=return_stats)
    if pool != "heap":
        raise ValueError(f"pool must be 'heap' or 'beam', got {pool!r}")
    if expand_width != 1:
        raise ValueError("expand_width > 1 requires pool='beam' (the heap "
                         "form is the line-faithful single-expansion "
                         "pseudocode)")
    # result queue: bounded max-heap of size ef (python: store negative dist)
    result: List[Tuple[float, int]] = []
    candq: List[Tuple[float, int]] = []
    for o in entries:
        dv = index.vecs[o] - q
        dist = float(dv @ dv)
        heapq.heappush(candq, (dist, o))
        heapq.heappush(result, (-dist, o))
        visited[o] = True
    while len(result) > ef:
        heapq.heappop(result)

    hops = 0
    threshold_trace: List[float] = []
    while candq and (len(result) < ef or candq[0][0] <= -result[0][0]):
        dist_u, u = heapq.heappop(candq)
        hops += 1
        for v in recons_nbr(index, u, pred, c_n, visited):
            dv = index.vecs[v] - q
            dist = float(dv @ dv)
            heapq.heappush(candq, (dist, v))
            heapq.heappush(result, (-dist, v))
            if len(result) > ef:
                heapq.heappop(result)
        if return_stats:
            threshold_trace.append(float(np.sqrt(-result[0][0])) if result else np.inf)

    items = sorted([(-nd, o) for nd, o in result])[:k]
    ids = np.asarray([o for _, o in items], dtype=np.int64)
    if return_stats:
        return ids, {"hops": hops, "entries": len(entries),
                     "threshold_trace": threshold_trace,
                     "visited": int(visited.sum())}
    return ids


def _recons_nbr_fused(index, us: np.ndarray, uvalid: np.ndarray,
                      pred: Predicate, c_n: int,
                      visited: np.ndarray) -> np.ndarray:
    """Wide-frontier ReconsNbr over the fused E*H*M candidate stream — the
    host twin of the engine's hop body (DESIGN.md §8 contract):

      * the stream is the E expanded candidates' neighbor rows concatenated
        expansion-major (closest expansion first), level order within each;
      * dedup is global first occurrence over the stream (mark-then-skip);
      * each expansion scans its own HM segment under its own c_n budget;
      * visited marks exactly the fresh *scanned* first occurrences, in or
        out of range.

    Returns the kept ids compacted segment-major into (E*c_n,), -1 padded.
    For E=1 this is the sequential ``recons_nbr`` scan verbatim.
    """
    E = len(us)
    H, _, M = index.nbrs.shape
    HM = H * M
    L = E * HM
    nid = np.full((L,), -1, dtype=np.int64)
    for e, (u, uv) in enumerate(zip(us, uvalid)):
        if uv:
            nid[e * HM: (e + 1) * HM] = index.nbrs[:, u, :].reshape(HM)
    valid = nid >= 0
    nid_safe = np.where(valid, nid, 0)

    # global first occurrence over the stream
    first_pos = np.full((index.n,), L, dtype=np.int64)
    np.minimum.at(first_pos, nid_safe[valid], np.nonzero(valid)[0])
    is_first = valid & (first_pos[nid_safe] == np.arange(L))

    fresh = is_first & ~visited[nid_safe]
    in_range = valid & pred.matches(index.attrs[nid_safe])
    append = fresh & in_range
    seg = append.reshape(E, HM)
    napp_excl = (np.cumsum(seg, axis=1) - seg).reshape(L)
    scanned = napp_excl < c_n
    visited[nid_safe[fresh & scanned]] = True
    keep = append & scanned
    base = np.repeat(np.arange(E, dtype=np.int64) * c_n, HM)
    buf = np.full((E * c_n,), -1, dtype=np.int64)
    buf[base[keep] + napp_excl[keep]] = nid[keep]
    return buf


def _query_beam(index, q: np.ndarray, pred: Predicate, k: int,
                entries: List[int], visited: np.ndarray, *, ef: int,
                c_n: int, expand_width: int, return_stats: bool):
    """Algorithm 3 on the shared pool substrate (single query = one row of
    the batched numpy ops; same RangeFilter entries as the heap form). Each
    hop expands the top-``expand_width`` unexpanded pool entries over one
    fused candidate stream — the reference for the engine's wide frontier."""
    E = expand_width
    pool_size = ef + E * c_n
    ids, dists, expanded = beam.np_pool_alloc(1, pool_size)
    if entries:
        e = np.asarray(entries, dtype=np.int64)
        dv = index.vecs[e] - q
        d0 = np.einsum("ed,ed->e", dv, dv).astype(np.float32)
        beam.np_pool_seed(ids, dists, expanded, e[None, :], d0[None, :])
        visited[e] = True

    hops = 0
    threshold_trace: List[float] = []
    row = np.array([0])
    while True:
        slots, uvalid = beam.np_pool_top_unexpanded(ids, dists, expanded,
                                                    ef, E)
        if not uvalid[0].any():
            break
        us = ids[0, slots[0]]
        beam.np_pool_mark_expanded_many(expanded, row, slots, uvalid)
        hops += 1
        buf1 = _recons_nbr_fused(index, us, uvalid[0], pred, c_n, visited)
        bd = np.full((1, E * c_n), np.inf, dtype=np.float32)
        got_any = buf1 >= 0
        if got_any.any():
            v = buf1[got_any]
            dv = index.vecs[v] - q
            bd[0, got_any] = np.einsum("vd,vd->v", dv, dv)
        beam.np_pool_merge_tail(ids, dists, expanded, row, buf1[None], bd,
                                np.isfinite(bd), ef)
        if return_stats:
            worst = dists[0, : ef][np.isfinite(dists[0, : ef])]
            threshold_trace.append(
                float(np.sqrt(worst[-1])) if len(worst) else np.inf)

    got = ids[0, :k]
    out_ids = got[got >= 0].astype(np.int64)
    if return_stats:
        return out_ids, {"hops": hops, "entries": len(entries),
                         "threshold_trace": threshold_trace,
                         "visited": int(visited.sum())}
    return out_ids


class StreamingOracle:
    """Rebuild-from-scratch numpy twin of the streaming write path
    (DESIGN.md §11). The live corpus is a dict keyed by stable external
    id, in ``core.delta.StreamingState``'s id space: the seed corpus has
    ``0..n-1``, every insert takes fresh ids and a re-insert a new one. A
    query brute-scans the live corpus with the scan path's ``(distance,
    ext)`` order, so it equals the service on exact (scan-served) lanes
    at every step of any insert/delete interleaving."""

    def __init__(self, vecs: np.ndarray, attrs: np.ndarray):
        self._rows = {i: (np.asarray(vecs[i], np.float32),
                          np.asarray(attrs[i], np.float32))
                      for i in range(vecs.shape[0])}
        self.next_ext = vecs.shape[0]

    def __len__(self) -> int:
        return len(self._rows)

    def insert(self, vecs: np.ndarray, attrs: np.ndarray) -> np.ndarray:
        """Append rows; returns their freshly-assigned ext ids."""
        b = vecs.shape[0]
        exts = np.arange(self.next_ext, self.next_ext + b, dtype=np.int64)
        for j, e in enumerate(exts):
            self._rows[int(e)] = (np.asarray(vecs[j], np.float32),
                                  np.asarray(attrs[j], np.float32))
        self.next_ext += b
        return exts

    def delete(self, ext_ids) -> int:
        """Drop rows by ext id; unknown ids are skipped. Returns the
        number removed."""
        n = 0
        for e in np.asarray(ext_ids, np.int64).ravel():
            n += self._rows.pop(int(e), None) is not None
        return n

    def corpus(self):
        """(exts (n,) int64 ascending, vecs (n, d), attrs (n, m)), the
        ext-sorted live corpus a compaction would rebuild from."""
        exts = np.asarray(sorted(self._rows), np.int64)
        if not exts.size:
            return (exts, np.zeros((0, 0), np.float32),
                    np.zeros((0, 0), np.float32))
        vecs = np.stack([self._rows[int(e)][0] for e in exts])
        attrs = np.stack([self._rows[int(e)][1] for e in exts])
        return exts, vecs, attrs

    def _topk(self, exts, vecs, mask, q, k: int) -> np.ndarray:
        ids = np.nonzero(mask)[0]
        if not ids.size:
            return ids.astype(np.int64)
        diff = vecs[ids] - np.asarray(q, np.float32)
        d2 = np.einsum("nd,nd->n", diff, diff)
        order = np.lexsort((exts[ids], d2))[: min(k, ids.size)]
        return exts[ids[order]]

    def query(self, q: np.ndarray, pred: Predicate, k: int) -> np.ndarray:
        """Exact top-k ext ids over the live corpus, ties to the lowest
        ext; shorter than k when fewer rows pass."""
        exts, vecs, attrs = self.corpus()
        if not exts.size:
            return exts
        return self._topk(exts, vecs, pred.matches(attrs), q, k)

    def query_expr(self, q: np.ndarray, expr, k: int) -> np.ndarray:
        """``query`` under a boolean filter expression (DESIGN.md §15)."""
        from .predicate import eval_expr

        exts, vecs, attrs = self.corpus()
        if not exts.size:
            return exts
        return self._topk(exts, vecs, eval_expr(expr, attrs), q, k)
