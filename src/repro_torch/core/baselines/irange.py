"""iRangeGraph baseline (Xu et al. 2024) with the paper's multi-attribute
probabilistic extension (paper §2.3/§3.1), ported from
``repro.core.baselines.irange``.

A segment tree over the rank space of ONE indexed attribute (a host numpy
build, shaped as a ``PartitionTree``); every node holds a filtered
single-level graph over its segment's objects, built on the device by the
ported builders (``core/hnsw.py``) with the same degree bound M and RNG
prune as KHI, so QPS comparisons isolate the index structure.

The query is the reference's host heap walk, unchanged: entry points from
the maximal segment decomposition of the indexed attribute's range; a
visited vertex's neighbours aggregated over its root->leaf path; in-range
neighbours always kept, out-of-range ones kept as stepping stones with
probability ``decay**hops`` drawn from ``np.random.default_rng(seed)`` in
the reference's order, so one seed gives the reference's ids.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import List, Optional, Tuple

import numpy as np

from .. import hnsw
from ..query_ref import Predicate
from ..tree import PartitionTree

__all__ = ["IRangeGraph"]


def _build_segment_tree(vals: np.ndarray, leaf_size: int) -> PartitionTree:
    """Dyadic segment tree over rank space, shaped as a PartitionTree so the
    graph builders apply unchanged (dim 0 = the indexed attribute)."""
    n = vals.shape[0]
    order = np.argsort(vals, kind="stable").astype(np.int32)

    left: List[int] = []
    right: List[int] = []
    parent: List[int] = []
    level: List[int] = []
    start: List[int] = []
    count: List[int] = []
    lo: List[float] = []
    hi: List[float] = []

    def new_node(par, lvl, s, c):
        pid = len(left)
        left.append(-1); right.append(-1); parent.append(par)
        level.append(lvl); start.append(s); count.append(c)
        seg = vals[order[s:s + c]]
        lo.append(float(seg.min())); hi.append(float(seg.max()))
        return pid

    root = new_node(-1, 0, 0, n)
    stack = [root]
    while stack:
        p = stack.pop()
        c = count[p]
        if c <= leaf_size:
            continue
        half = c // 2
        pl = new_node(p, level[p] + 1, start[p], half)
        pr = new_node(p, level[p] + 1, start[p] + half, c - half)
        left[p], right[p] = pl, pr
        stack.append(pl); stack.append(pr)

    num = len(left)
    levels = np.asarray(level, np.int32)
    height = int(levels.max()) + 1
    path = np.full((n, height), -1, np.int32)
    sa = np.asarray(start, np.int32)
    ca = np.asarray(count, np.int32)
    for p in range(num):
        path[order[sa[p]:sa[p] + ca[p]], levels[p]] = p

    return PartitionTree(
        left=np.asarray(left, np.int32), right=np.asarray(right, np.int32),
        parent=np.asarray(parent, np.int32),
        dim=np.where(np.asarray(left, np.int32) >= 0, 0, -1).astype(np.int32),
        split=np.zeros(num, np.float32),
        bl=np.zeros(num, np.uint32), level=levels,
        lo=np.asarray(lo, np.float32)[:, None],
        hi=np.asarray(hi, np.float32)[:, None],
        order=order, start=sa, count=ca, path=path,
        tau=np.inf, leaf_capacity=leaf_size, m=1)


@dataclasses.dataclass
class IRangeGraph:
    vecs: np.ndarray
    attrs: np.ndarray
    tree: PartitionTree
    nbrs: np.ndarray          # (H, n, M), on the host for the heap walk
    index_attr: int
    sorted_vals: np.ndarray   # attr values sorted (for rank queries)
    M: int
    build_seconds: float = 0.0

    @classmethod
    def build(cls, vecs: np.ndarray, attrs: np.ndarray, *, index_attr: int = 0,
              M: int = 32, ef_b: Optional[int] = None, leaf_size: int = 32,
              builder: str = "incremental", merge_chunk: int = 64,
              verbose: bool = False, device=None) -> "IRangeGraph":
        """Segment tree on the host, graphs on ``device`` (default
        ``cuda``) with ``builder`` "incremental" (Algorithm 5) or
        "bulk"."""
        t0 = time.perf_counter()
        vals = attrs[:, index_attr].astype(np.float32)
        tree = _build_segment_tree(vals, leaf_size)
        if builder == "bulk":
            nbrs = hnsw.build_graphs_bulk(tree, vecs, M=M, ef_b=ef_b,
                                          verbose=verbose, device=device)
        else:
            nbrs = hnsw.build_graphs(tree, vecs, M=M, ef_b=ef_b,
                                     merge_chunk=merge_chunk,
                                     verbose=verbose, device=device)
        return cls(vecs=np.asarray(vecs, np.float32),
                   attrs=np.asarray(attrs, np.float32), tree=tree,
                   nbrs=nbrs.cpu().numpy(), index_attr=index_attr,
                   sorted_vals=np.sort(vals), M=M,
                   build_seconds=time.perf_counter() - t0)

    @property
    def n(self) -> int:
        return self.vecs.shape[0]

    @property
    def height(self) -> int:
        return self.nbrs.shape[0]

    def graph_size_bytes(self) -> int:
        return int((self.nbrs >= 0).sum()) * 4 + self.tree.path.nbytes

    # ------------------------------------------------------------- query
    def _covered_nodes(self, lo_rank: int, hi_rank: int, budget: int) -> List[int]:
        """Maximal segment decomposition of [lo_rank, hi_rank] (inclusive)."""
        t = self.tree
        out: List[int] = []
        root = int(np.nonzero(t.parent < 0)[0][0])
        stack = [root]
        while stack and len(out) < budget:
            p = stack.pop()
            s, c = int(t.start[p]), int(t.count[p])
            if s > hi_rank or s + c - 1 < lo_rank:
                continue
            if s >= lo_rank and s + c - 1 <= hi_rank:
                out.append(p)
                continue
            if t.left[p] >= 0:
                stack.append(int(t.left[p]))
                stack.append(int(t.right[p]))
        return out

    def _entries(self, pred: Predicate, c_e: int) -> List[int]:
        lo = pred.lo[self.index_attr]
        hi = pred.hi[self.index_attr]
        lo_rank = int(np.searchsorted(self.sorted_vals, lo, "left"))
        hi_rank = int(np.searchsorted(self.sorted_vals, hi, "right")) - 1
        if hi_rank < lo_rank:
            return []
        nodes = self._covered_nodes(lo_rank, hi_rank, budget=4 * c_e)
        entries: List[int] = []
        for p in nodes:
            objs = self.tree.node_objects(p)
            ok = pred.matches(self.attrs[objs])
            hit = np.nonzero(ok)[0]
            if len(hit):
                entries.append(int(objs[hit[0]]))
            if len(entries) >= c_e:
                break
        return entries

    def query(self, q: np.ndarray, pred: Predicate, k: int, *, ef: int = 64,
              c_e: Optional[int] = None, decay: float = 0.9,
              seed: int = 0, return_stats: bool = False):
        c_e = c_e or k
        rng = np.random.default_rng(seed)
        q = np.asarray(q, np.float32)
        visited = np.zeros(self.n, bool)

        result: List[Tuple[float, int]] = []   # max-heap (neg dist)
        candq: List[Tuple[float, int]] = []
        for o in self._entries(pred, c_e):
            dv = self.vecs[o] - q
            dist = float(dv @ dv)
            heapq.heappush(candq, (dist, o))
            heapq.heappush(result, (-dist, o))
            visited[o] = True
        while len(result) > ef:
            heapq.heappop(result)

        hops = 0
        trace: List[float] = []
        while candq and (len(result) < ef or candq[0][0] <= -result[0][0]):
            _, u = heapq.heappop(candq)
            hops += 1
            keep_p = decay ** hops
            # aggregate neighbors along u's root->leaf path
            for lvl in range(self.height):
                if self.tree.path[u, lvl] < 0:
                    break
                for v in self.nbrs[lvl, u]:
                    v = int(v)
                    if v < 0 or visited[v]:
                        continue
                    visited[v] = True
                    in_r = bool(pred.matches(self.attrs[v]))
                    if not in_r and rng.random() >= keep_p:
                        continue
                    dv = self.vecs[v] - q
                    dist = float(dv @ dv)
                    heapq.heappush(candq, (dist, v))
                    if in_r:
                        heapq.heappush(result, (-dist, v))
                        if len(result) > ef:
                            heapq.heappop(result)
            if return_stats:
                trace.append(float(np.sqrt(-result[0][0])) if result else np.inf)

        items = sorted([(-nd, o) for nd, o in result])[:k]
        ids = np.asarray([o for _, o in items], np.int64)
        if return_stats:
            return ids, {"hops": hops, "threshold_trace": trace,
                         "visited": int(visited.sum())}
        return ids
