"""Skew-aware attribute-space partitioning tree (paper Algorithm 4).

A numpy copy of ``repro.core.tree`` (same seed, same arrays), so the
PyTorch port builds its index without importing the JAX package.

The tree is built host-side over the *attribute tuples* only (m is small,
typically 3-5), then flattened into dense arrays that the device engine
uploads as tensors. Each node carries:

  - ``dim``    splitting dimension (0-based; -1 for leaves / dead nodes)
  - ``split``  split value s(p); left gets ``t[dim] <= split``
  - ``lo/hi``  the axis-aligned rectangle R(p) in attribute space
  - ``bl``     bitmask of excluded ("blacklisted") dimensions BL(p)
  - ``left/right/parent`` child/parent ids (-1 when absent)
  - ``level``  depth (root = 0)

Every object belongs to exactly one node per level along its root->leaf path;
``path[n, H]`` materializes that (padded with -1 past the leaf), which is what
both graph construction (Algorithm 5 ordering) and on-the-fly neighbor
reconstruction (Algorithm 2) consume.

Lemma 1 (height bound): an accepted split satisfies max/min < tau, hence the
larger side has < tau/(tau+1) * N objects, giving height O(log_{1/rho} n/c_l)
with rho = tau/(tau+1). ``PartitionTree.height_bound()`` exposes the bound so
tests can assert it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["PartitionTree", "build_tree"]


@dataclasses.dataclass
class PartitionTree:
    """Flattened skew-aware KD tree over attribute tuples."""

    # --- per-node arrays (size = num_nodes) ---
    left: np.ndarray        # int32, -1 if leaf
    right: np.ndarray       # int32, -1 if leaf
    parent: np.ndarray      # int32, -1 for root
    dim: np.ndarray         # int32 splitting dimension, -1 if leaf
    split: np.ndarray       # float32 split value (undefined for leaves)
    bl: np.ndarray          # uint32 bitmask of excluded dims at this node
    level: np.ndarray       # int32 depth of the node (root = 0)
    lo: np.ndarray          # float32 (num_nodes, m) rectangle lower corner
    hi: np.ndarray          # float32 (num_nodes, m) rectangle upper corner
    # --- object layout ---
    # Objects of node p occupy order[start[p] : start[p]+count[p]] — a single
    # global permutation works because children partition their parent.
    order: np.ndarray       # int32 (n,) object ids
    start: np.ndarray       # int32 (num_nodes,)
    count: np.ndarray       # int32 (num_nodes,)
    # path[o, l] = node containing object o at level l, -1 past o's leaf.
    path: np.ndarray        # int32 (n, height)
    # --- config echo ---
    tau: float
    leaf_capacity: int
    m: int

    @property
    def num_nodes(self) -> int:
        return int(self.left.shape[0])

    @property
    def n(self) -> int:
        return int(self.order.shape[0])

    @property
    def height(self) -> int:
        """Number of levels (root level included)."""
        return int(self.path.shape[1])

    def height_bound(self) -> float:
        """Lemma 1 upper bound on the number of *splits* along any path."""
        rho = self.tau / (self.tau + 1.0)
        return float(np.log(self.n / max(self.leaf_capacity, 1)) / np.log(1.0 / rho))

    def is_leaf(self, p: int) -> bool:
        return self.left[p] < 0

    def node_objects(self, p: int) -> np.ndarray:
        s, c = int(self.start[p]), int(self.count[p])
        return self.order[s : s + c]

    def validate(self) -> None:
        """Structural invariants (used by property tests)."""
        n, m = self.n, self.m
        root_mask = self.parent < 0
        assert root_mask.sum() == 1, "exactly one root"
        # children partition the parent's objects
        for p in range(self.num_nodes):
            l, r = int(self.left[p]), int(self.right[p])
            if l >= 0:
                assert r >= 0
                assert self.count[p] == self.count[l] + self.count[r]
                assert self.start[l] == self.start[p]
                assert self.start[r] == self.start[l] + self.count[l]
                # BL inheritance: children exclude at least what parent excluded
                assert (int(self.bl[l]) & int(self.bl[p])) == int(self.bl[p])
        # every level assignment is consistent
        assert self.path.shape == (n, self.height)
        assert (self.path[:, 0] == int(np.nonzero(root_mask)[0][0])).all()


def _rect_of_root(attrs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return attrs.min(axis=0).astype(np.float32), attrs.max(axis=0).astype(np.float32)


def build_tree(
    attrs: np.ndarray,
    *,
    tau: float = 3.0,
    leaf_capacity: int = 2,
    seed: Optional[int] = None,
) -> PartitionTree:
    """Algorithm 4 (BuildTree). ``attrs``: float (n, m) attribute tuples.

    Stack-based top-down construction with round-robin dimension choice,
    lower-median split, and the skew check
    ``tau * min(nL, nR) <= max(nL, nR)``  =>  exclude dim, retry next dim.
    """
    attrs = np.asarray(attrs, dtype=np.float32)
    n, m = attrs.shape
    if n == 0:
        raise ValueError("empty object set")
    if tau <= 1.0:
        raise ValueError("tau must be > 1")

    # Node storage (lists, flattened at the end).
    left: List[int] = []
    right: List[int] = []
    parent: List[int] = []
    dim: List[int] = []
    split: List[float] = []
    bl: List[int] = []
    level: List[int] = []
    lo: List[np.ndarray] = []
    hi: List[np.ndarray] = []
    start: List[int] = []
    count: List[int] = []

    order = np.arange(n, dtype=np.int32)

    def new_node(par: int, lvl: int, s: int, c: int, nd: int, blmask: int,
                 rlo: np.ndarray, rhi: np.ndarray) -> int:
        pid = len(left)
        left.append(-1); right.append(-1); parent.append(par)
        dim.append(nd); split.append(np.nan); bl.append(blmask)
        level.append(lvl); lo.append(rlo); hi.append(rhi)
        start.append(s); count.append(c)
        return pid

    rlo, rhi = _rect_of_root(attrs)
    root = new_node(-1, 0, 0, n, 0, 0, rlo, rhi)
    stack = [root]
    full_mask = (1 << m) - 1

    while stack:
        p = stack.pop()
        c = count[p]
        if c <= leaf_capacity or bl[p] == full_mask:
            dim[p] = -1
            continue
        # advance Dim(p) round-robin past excluded dims (Alg.4 lines 7-8)
        d = dim[p]
        while (bl[p] >> d) & 1:
            d = (d + 1) % m
        dim[p] = d

        s0 = start[p]
        objs = order[s0 : s0 + c]
        vals = attrs[objs, d]
        srt = np.argsort(vals, kind="stable")
        mid = (c - 1) // 2
        sv = float(vals[srt[mid]])
        go_left = vals <= sv
        n_l = int(go_left.sum())
        n_r = c - n_l
        if n_r == 0 or tau * min(n_l, n_r) <= max(n_l, n_r):
            # skewed split: blacklist this dimension at p, retry (lines 13-15)
            bl[p] |= 1 << d
            dim[p] = (d + 1) % m
            stack.append(p)
            continue
        # accept: stable partition of the node's object slice (lines 16-20)
        order[s0 : s0 + c] = np.concatenate([objs[go_left], objs[~go_left]])
        split[p] = sv
        next_d = (d + 1) % m
        llo, lhi = lo[p].copy(), hi[p].copy()
        lhi[d] = sv
        rlo2, rhi2 = lo[p].copy(), hi[p].copy()
        rlo2[d] = sv
        pl = new_node(p, level[p] + 1, s0, n_l, next_d, bl[p], llo, lhi)
        pr = new_node(p, level[p] + 1, s0 + n_l, n_r, next_d, bl[p], rlo2, rhi2)
        left[p], right[p] = pl, pr
        stack.append(pl)
        stack.append(pr)

    num_nodes = len(left)
    levels = np.asarray(level, dtype=np.int32)
    height = int(levels.max()) + 1

    # Build the path matrix: descend from root following splits.
    path = np.full((n, height), -1, dtype=np.int32)
    la = np.asarray(left, dtype=np.int32)
    sa = np.asarray(start, dtype=np.int32)
    ca = np.asarray(count, dtype=np.int32)
    for p in range(num_nodes):
        objs = order[sa[p] : sa[p] + ca[p]]
        path[objs, levels[p]] = p

    tree = PartitionTree(
        left=la,
        right=np.asarray(right, dtype=np.int32),
        parent=np.asarray(parent, dtype=np.int32),
        dim=np.asarray(dim, dtype=np.int32),
        split=np.asarray(split, dtype=np.float32),
        bl=np.asarray(bl, dtype=np.uint32),
        level=levels,
        lo=np.stack(lo).astype(np.float32),
        hi=np.stack(hi).astype(np.float32),
        order=order,
        start=sa,
        count=ca,
        path=path,
        tau=tau,
        leaf_capacity=leaf_capacity,
        m=m,
    )
    return tree
