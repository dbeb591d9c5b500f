"""Tree routing (Algorithm 1) — Phase A of the query pipeline — and the
planner's cardinality estimator, ported from ``repro.core.router``.

``route_level_sync`` returns the same ``(entries, card)`` as the
reference's level-synchronous sweep: up to ``c_e`` entry ids per lane,
-1 padded, in DFS order (ascending key ``n - (start + count)`` over the
scanned antichain), and the in-range cardinality bound (the sum of
``count`` over scanned nodes).

The reference holds a dense ``(F,)`` frontier per lane and gathers an
``(F, scan_budget)`` entry window per lane per level. At a real shard
(the khi-serve corpus at n = 1M: F = 431,876 nodes on the widest level,
scan_budget = 54,165) that is far beyond any card's memory. The port computes the same values from a
**compacted** frontier: a flat, lane-major list of ``(lane, node, D)``
triples holding only live nodes. Children keep the reference's order
(left then right, in parent order) and its per-lane overflow clamp:
a child whose per-lane exclusive position is ``>= frontier_cap`` is
dropped, exactly as the dense scatter with ``mode="drop"`` drops it.
Entry scans run only for scanned nodes, in growing window chunks that
stop per node at its first in-range object, its ``count`` or
``scan_budget``, whichever comes first — the dense window's
``argmax`` of the first hit. Keys of hits are unique (scanned ranges
are disjoint), so the reference's per-level stable merge of the
``c_e`` smallest keys equals one final per-lane selection.

``route_dfs`` is the reference's legacy per-query stack DFS (one node
pop per step, right child popped first, early stop after ``c_e``
entries, ``max_steps`` pops or an empty stack), batched: every lane
holds a ``(stack_cap,)`` stack of ``(node, D)`` pairs, the live lanes
pop together, and the entry scan of a covered node or a leaf goes
through the same first-hit window scan as the level router, so no dense
``(B, scan_budget)`` window is gathered. Its count sum covers only the
visited prefix of the antichain, so it is no cardinality bound: the
planner's ``auto`` and ``hybrid`` need the level router.

``route_level_card`` and ``route_level_windows`` are the collective
sharded search's device-side planner (DESIGN.md §14): the same sweep
without entry scans, giving each lane's cardinality bound and, for
``hybrid``, its small nodes' windows, so every rank of a model group
can sum its shard's numbers and take the same branch.

``HostCardEstimator`` keeps the reference's closed-form node-parallel
computation, with torch tensors on a chosen device and lanes processed
in chunks, so no ``(B, P)`` plane is built whole at a 1M-object shard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .util import pow2_at_least

__all__ = ["ROUTERS", "resolve_router", "route_dfs", "route_level_sync",
           "route_level_card", "route_level_windows", "HostCardEstimator",
           "deleted_per_node", "required_frontier_cap"]

ROUTERS = ("level", "dfs")


def _require_frontier(F: int) -> None:
    if F <= 0:
        raise ValueError(
            "SearchParams.frontier_cap is unset (0 = derive from the "
            "index): resolve it with derive_search_params / "
            "validate_search_params, or build the search via search_batch "
            "or a Planner, which do. An arbitrary fixed width would "
            "silently drop router branches.")


def _root_D0(di, qlo: torch.Tensor, qhi: torch.Tensor) -> torch.Tensor:
    """(B,) int64: D seeded with the dims the root rectangle covers."""
    root = int(di.root)
    m = qlo.shape[1]
    cov = (di.lo[root][None] >= qlo) & (di.hi[root][None] <= qhi)
    bits = 1 << torch.arange(m, device=qlo.device, dtype=torch.int64)
    return (cov.to(torch.int64) * bits).sum(1)


def _frontier_step(di, qlo, qhi, full: int, F: int, lane, node, fD):
    """One level of the sweep over a flat lane-major frontier. Returns
    (do_scan, next lane, next node, next D) with the next frontier in
    the reference's slot order, clamped per lane at ``F``."""
    D = fD | di.bl[node]
    is_full = D == full
    is_leaf = di.left[node] < 0
    do_scan = is_full | is_leaf
    expand = ~do_scan
    dsp = di.dim[node].clamp_min(0)
    covered = ((D >> dsp) & 1) == 1
    qlod = qlo[lane, dsp]
    qhid = qhi[lane, dsp]
    bit = torch.ones_like(D) << dsp

    def child(pc):
        csafe = pc.clamp_min(0)
        lc = di.lo[csafe, dsp]
        rc = di.hi[csafe, dsp]
        disjoint = (lc > qhid) | (rc < qlod)
        contained = (lc >= qlod) & (rc <= qhid)
        newD = torch.where(covered | ~contained, D, D | bit)
        return expand & (covered | ~disjoint), newD

    cl, cr = di.left[node], di.right[node]
    vl, Dl = child(cl)
    vr, Dr = child(cr)
    c_node = torch.stack([cl, cr], 1).reshape(-1)
    c_D = torch.stack([Dl, Dr], 1).reshape(-1)
    c_valid = torch.stack([vl, vr], 1).reshape(-1)
    c_lane = lane.repeat_interleave(2)[c_valid]
    c_node, c_D = c_node[c_valid], c_D[c_valid]
    # per-lane exclusive position (the list is lane-major): overflow clamp
    B = qlo.shape[0]
    counts = torch.bincount(c_lane, minlength=B)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(c_lane.numel(), device=lane.device) - starts[c_lane]
    keep = pos < F
    return do_scan, c_lane[keep], c_node[keep], c_D[keep]


def _first_hits(di, qlo, qhi, lane, node, SB: int) -> torch.Tensor:
    """Entry scan for scanned nodes: the first object of
    ``order[start : start + min(count, SB)]`` whose attrs pass the lane's
    box, or -1. Windows grow 8, 16, 32, ... and each node leaves the
    loop at its first hit."""
    n = di.order.shape[0]
    out = torch.full_like(node, -1)
    start = di.start[node]
    cnt = torch.minimum(di.count[node], torch.full_like(node, SB))
    pending = torch.arange(node.numel(), device=node.device)
    j0, w = 0, 8
    while pending.numel() and j0 < SB:
        w = max(1, min(w, SB - j0, (1 << 24) // max(1, pending.numel())))
        jj = torch.arange(j0, j0 + w, device=node.device)
        st, ct, ln = start[pending], cnt[pending], lane[pending]
        in_node = jj[None, :] < ct[:, None]
        obj = di.order[(st[:, None] + jj[None, :]).clamp_max(n - 1)]
        a = di.attrs[obj]
        ok = in_node & ((a >= qlo[ln][:, None, :])
                        & (a <= qhi[ln][:, None, :])).all(-1)
        hit = ok.any(1)
        first = ok.to(torch.int8).argmax(1)
        out[pending[hit]] = obj[hit, first[hit]]
        pending = pending[~hit & (ct > j0 + w)]
        j0 += w
        w *= 2
    return out


def _level_sweep(di, qlo: torch.Tensor, qhi: torch.Tensor, p, on_scan
                 ) -> torch.Tensor:
    """The level-synchronous sweep shared by the three level routers: from
    the root, one ``_frontier_step`` a level over the lane-major frontier,
    each level's scanned nodes added to the lanes' in-range cardinality
    bound and handed to ``on_scan(s_lane, s_node)``. -> card (B,) int64."""
    F = p.frontier_cap
    _require_frontier(F)
    B, m = qlo.shape
    full = (1 << m) - 1
    dev = qlo.device
    lane = torch.arange(B, device=dev)
    node = torch.full((B,), int(di.root), dtype=torch.int64, device=dev)
    fD = _root_D0(di, qlo, qhi)
    card = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(di.nbrs.shape[1]):
        if not lane.numel():
            break
        do_scan, n_lane, n_node, n_D = _frontier_step(
            di, qlo, qhi, full, F, lane, node, fD)
        s_lane, s_node = lane[do_scan], node[do_scan]
        card.index_add_(0, s_lane, di.count[s_node])
        on_scan(s_lane, s_node)
        lane, node, fD = n_lane, n_node, n_D
    return card


def route_level_sync(di, qlo: torch.Tensor, qhi: torch.Tensor, p):
    """(B, m) boxes -> (entries (B, c_e) int64, -1 padded, DFS order;
    card (B,) int64 in-range cardinality bound)."""
    B = qlo.shape[0]
    n = di.order.shape[0]
    dev = qlo.device
    hit_lane, hit_key, hit_ent = [], [], []

    def entry_scans(s_lane, s_node):
        e = _first_hits(di, qlo, qhi, s_lane, s_node, p.scan_budget)
        got = e >= 0
        hit_lane.append(s_lane[got])
        hit_ent.append(e[got])
        hit_key.append(n - (di.start[s_node[got]] + di.count[s_node[got]]))

    card = _level_sweep(di, qlo, qhi, p, entry_scans)
    entries = torch.full((B, p.c_e), -1, dtype=torch.int64, device=dev)
    if hit_lane:
        hl = torch.cat(hit_lane)
        hk = torch.cat(hit_key)
        he = torch.cat(hit_ent)
        srt = torch.argsort(hl * (1 << 32) + hk)
        hl, he = hl[srt], he[srt]
        counts = torch.bincount(hl, minlength=B)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(hl.numel(), device=dev) - starts[hl]
        sel = rank < p.c_e
        entries[hl[sel], rank[sel]] = he[sel]
    return entries, card


def route_level_card(di, qlo: torch.Tensor, qhi: torch.Tensor, p
                     ) -> torch.Tensor:
    """(B, m) boxes -> card (B,) int64: ``route_level_sync``'s in-range
    cardinality bound without the entry scans (the reference's
    estimate-only sweep, which it vmaps over lanes; here one sweep for the
    batch). The collective ``auto`` dispatch sums it over the shards."""
    return _level_sweep(di, qlo, qhi, p, lambda s_lane, s_node: None)


def route_level_windows(di, qlo: torch.Tensor, qhi: torch.Tensor, p, *,
                        node_thr: int, W: int):
    """The ``route_level_card`` sweep that also splits each lane's scanned
    antichain by raw node count into small (``0 < count <= node_thr``)
    and large (``count > node_thr``) nodes and collects the small nodes'
    DFS extents as windows. -> (card, n_small, n_large (B,) int64,
    starts, counts (B, Wb) int32): each lane's windows ascending by start,
    pad slots (-1, 0).

    ``W`` is the reference's static bound: a lane keeps its first ``W``
    small nodes in sweep order (level, then frontier slot), the
    reference's overflow clamp, which the collective's W (derived from the
    shards' counts) never reaches. The reference returns all ``W``
    columns; here ``Wb`` is the smallest power of two that holds the
    widest lane's windows (at most ``W``): the columns past it are pads
    in the reference's too. (At a 1M-object shard the static W is ~2^20,
    and (B, W) planes of it would not fit a card.) ``n_small`` counts
    every small node, kept or not, as the reference's does."""
    B = qlo.shape[0]
    dev = qlo.device
    n_small = torch.zeros(B, dtype=torch.int64, device=dev)
    n_large = torch.zeros(B, dtype=torch.int64, device=dev)
    w_lane, w_start, w_count = [], [], []

    def split(s_lane, s_node):
        cnt = di.count[s_node]
        small = (cnt > 0) & (cnt <= node_thr)
        n_small.index_add_(0, s_lane, small.to(torch.int64))
        n_large.index_add_(0, s_lane, (cnt > node_thr).to(torch.int64))
        w_lane.append(s_lane[small])
        w_start.append(di.start[s_node[small]])
        w_count.append(cnt[small])

    card = _level_sweep(di, qlo, qhi, p, split)

    def ranks(lanes):
        per = torch.bincount(lanes, minlength=B)
        return torch.arange(lanes.numel(), device=dev) \
            - (torch.cumsum(per, 0) - per)[lanes], per

    if w_lane:
        wl, ws, wc = torch.cat(w_lane), torch.cat(w_start), torch.cat(w_count)
    else:
        wl = ws = wc = torch.zeros(0, dtype=torch.int64, device=dev)
    # each level's small nodes are lane-major: a stable sort by lane puts
    # every lane's in sweep order, where the clamp keeps the first W
    o = torch.argsort(wl, stable=True)
    wl, ws, wc = wl[o], ws[o], wc[o]
    keep = ranks(wl)[0] < W
    wl, ws, wc = wl[keep], ws[keep], wc[keep]
    # antichain extents are disjoint: starts are unique within a lane
    o = torch.argsort(wl * (di.order.shape[0] + 1) + ws)
    wl, ws, wc = wl[o], ws[o], wc[o]
    rank, per = ranks(wl)
    Wb = min(int(W), pow2_at_least(int(per.max()) if B else 0))
    starts = torch.full((B, Wb), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((B, Wb), dtype=torch.int32, device=dev)
    starts[wl, rank] = ws.to(torch.int32)
    counts[wl, rank] = wc.to(torch.int32)
    return card, n_small, n_large, starts, counts


def route_dfs(di, qlo: torch.Tensor, qhi: torch.Tensor, p, *,
              with_steps: bool = False):
    """(B, m) boxes -> (entries (B, c_e) int64, -1 padded, DFS order;
    card (B,) int64, the count sum of the scanned nodes the DFS visited,
    which is not an in-range bound). ``with_steps`` also returns each
    lane's pop count (B,) int64.

    Each lane runs the reference's loop: pop the top ``(node, D)``, OR in
    ``bl[node]``; a covered node (``D`` full) or a leaf is scanned for its
    first in-box object among its first ``scan_budget``; an internal node
    pushes each child that is not disjoint from the box on the split dim
    (both, with ``D`` unchanged, when the split dim is covered), left
    first so the right pops first, and ``D`` gains the split dim's bit
    for a child the box contains on it. A push past ``stack_cap`` is
    dropped and the stack pointer clamps at ``stack_cap``. A lane stops at
    ``c_e`` entries, an empty stack or ``max_steps`` pops; the batch loop
    ends when every lane has stopped.

    Every step is dense over the batch, with masked writes into a sink
    column; the entry scans of the step's scanned lanes go through
    ``_first_hits`` together."""
    B, m = qlo.shape
    S = int(p.stack_cap)
    if S < 1:
        raise ValueError(f"route_dfs needs stack_cap >= 1, got {S}")
    full = (1 << m) - 1
    dev = qlo.device
    c_e, SB = int(p.c_e), int(p.scan_budget)
    # column S of the stack and column c_e of the entries take the writes
    # of lanes that push or find nothing
    stack_node = torch.full((B, S + 1), -1, dtype=torch.int64, device=dev)
    stack_D = torch.zeros((B, S + 1), dtype=torch.int64, device=dev)
    stack_node[:, 0] = int(di.root)
    stack_D[:, 0] = _root_D0(di, qlo, qhi)
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    entries = torch.full((B, c_e + 1), -1, dtype=torch.int64, device=dev)
    n_e = torch.zeros(B, dtype=torch.int64, device=dev)
    card = torch.zeros(B, dtype=torch.int64, device=dev)
    steps = torch.zeros(B, dtype=torch.int64, device=dev)
    lanes = torch.arange(B, device=dev)
    sink_s = torch.full((B,), S, dtype=torch.int64, device=dev)
    sink_e = torch.full((B,), c_e, dtype=torch.int64, device=dev)

    while True:
        live = (sp > 0) & (n_e < c_e) & (steps < p.max_steps)
        if not bool(live.any()):
            break
        top = (sp - 1).clamp_min(0)
        node = stack_node[lanes, top].clamp_min(0)
        D = stack_D[lanes, top] | di.bl[node]
        do_scan = live & ((D == full) | (di.left[node] < 0))
        cnt = di.count[node]
        card.add_(torch.where(do_scan, cnt, torch.zeros_like(cnt)))
        e = torch.full_like(n_e, -1)
        sl = torch.nonzero(do_scan).squeeze(1)
        if sl.numel():
            e[sl] = _first_hits(di, qlo, qhi, sl, node[sl], SB)
        got = e >= 0
        entries[lanes, torch.where(got, n_e, sink_e)] = e
        n_e.add_(got.to(torch.int64))

        expand = live & ~do_scan
        dsp = di.dim[node].clamp_min(0)
        covered = ((D >> dsp) & 1) == 1
        qlod, qhid = qlo[lanes, dsp], qhi[lanes, dsp]
        bit = torch.ones_like(D) << dsp

        def push(pc, at):
            csafe = pc.clamp_min(0)
            lc, rc = di.lo[csafe, dsp], di.hi[csafe, dsp]
            disjoint = (lc > qhid) | (rc < qlod)
            contained = (lc >= qlod) & (rc <= qhid)
            newD = torch.where(covered | ~contained, D, D | bit)
            valid = expand & (covered | ~disjoint)
            col = torch.where(valid & (at < S), at, sink_s)
            stack_node[lanes, col] = pc
            stack_D[lanes, col] = newD
            return at + valid.to(torch.int64)

        at = push(di.left[node], top)
        at = push(di.right[node], at)
        sp = torch.where(live, at.clamp_max(S), sp)
        steps.add_(live.to(torch.int64))
    if with_steps:
        return entries[:, :c_e], card, steps
    return entries[:, :c_e], card


def resolve_router(name: str):
    """Router name -> route(di, qlo, qhi, p) -> (entries, card)."""
    if name == "level":
        return route_level_sync
    if name == "dfs":
        return route_dfs
    raise ValueError(f"unknown router {name!r}; expected one of {ROUTERS}")


class HostCardEstimator:
    """Node-parallel routing cardinality bound (the reference's closed
    form: ``D(p) = bl[p] | {i: proj_i(R(p)) ⊆ box_i}``, a stop mask, an
    edge mask and one level-ordered reachability pass), evaluated with
    torch on ``device`` in chunks of at most ``chunk_elems`` (lane, node)
    pairs. ``cards((B, m) qlo, (B, m) qhi) -> (B,) int64`` numpy."""

    def __init__(self, left, right, dim, bl, lo, hi, count, root: int, *,
                 device="cpu", chunk_elems: int = 1 << 24):
        left = np.asarray(left)
        right = np.asarray(right)
        dim = np.asarray(dim)
        P, m = np.asarray(lo).shape
        self.m = int(m)
        self.full = (1 << m) - 1
        self.root = int(root)
        self.chunk_elems = int(chunk_elems)
        parent = np.full(P, -1, np.int64)
        for child in (left, right):
            src = np.nonzero(child >= 0)[0]
            parent[child[src]] = src
        frontier = np.asarray([self.root])
        levels = [frontier]
        while True:
            children = np.concatenate([left[frontier], right[frontier]])
            frontier = children[children >= 0]
            if not frontier.size:
                break
            levels.append(frontier)
        ps = np.where(parent >= 0, dim[np.maximum(parent, 0)], 0).astype(
            np.int64)
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        self.device = torch.device(device)
        self.bl = t(np.asarray(bl).astype(np.int64))
        self.lo, self.hi = t(lo), t(hi)
        self.count = t(np.asarray(count).astype(np.int64))
        self.is_leaf = t(left < 0)
        self.pa = t(np.maximum(parent, 0))
        # (level nodes, their parents) below the root, top-down
        self.levels = [(t(lv.astype(np.int64)), t(parent[lv]))
                       for lv in levels[1:]]
        self.ps = t(ps)
        self.plo = t(lo[np.arange(P), ps])
        self.phi = t(hi[np.arange(P), ps])

    def antichain(self, qlo, qhi) -> torch.Tensor:
        """(B, m) boxes -> (B, P) bool scanned antichain for ONE chunk of
        lanes (callers bound B; ``cards`` does)."""
        qlo = torch.as_tensor(qlo, dtype=torch.float32, device=self.device)
        qhi = torch.as_tensor(qhi, dtype=torch.float32, device=self.device)
        B = qlo.shape[0]
        P = self.bl.shape[0]
        D = self.bl.expand(B, P).clone()
        for i in range(self.m):
            D |= ((self.lo[:, i] >= qlo[:, i, None])
                  & (self.hi[:, i] <= qhi[:, i, None])).to(torch.int64) << i
        stop = (D == self.full) | self.is_leaf
        disjoint = ((self.plo > qhi[:, self.ps])
                    | (self.phi < qlo[:, self.ps]))
        edge_ok = (((D[:, self.pa] >> self.ps) & 1) > 0) | ~disjoint
        del D, disjoint
        reached = torch.zeros((B, P), dtype=torch.bool, device=self.device)
        reached[:, self.root] = True
        for nl, pl in self.levels:
            reached[:, nl] = reached[:, pl] & ~stop[:, pl] & edge_ok[:, nl]
        return stop & reached

    def cards(self, qlo: np.ndarray, qhi: np.ndarray,
              chunk: Optional[int] = None) -> np.ndarray:
        B = qlo.shape[0]
        P = self.bl.shape[0]
        step = chunk or max(1, self.chunk_elems // max(1, P))
        out = []
        for s in range(0, B, step):
            anti = self.antichain(qlo[s:s + step], qhi[s:s + step])
            out.append((anti.to(torch.int64) * self.count).sum(1))
        if not out:
            return np.zeros(0, np.int64)
        return torch.cat(out).cpu().numpy()


def deleted_per_node(order: np.ndarray, start: np.ndarray,
                     count: np.ndarray, deleted_rows: np.ndarray
                     ) -> np.ndarray:
    """Per-node tombstone counts: how many of ``deleted_rows`` fall inside
    each node's range ``order[start : start+count]`` (a numpy copy of the
    reference; ``order`` must be the real, unpadded slice)."""
    n = order.shape[0]
    deleted_rows = np.asarray(deleted_rows, np.int64)
    if not deleted_rows.size:
        return np.zeros(start.shape[0], np.int64)
    inv = np.empty(n, np.int64)
    inv[np.asarray(order, np.int64)] = np.arange(n)
    mark = np.zeros(n + 1, np.int64)
    mark[inv[deleted_rows] + 1] = 1
    cum = np.cumsum(mark)
    s = start.astype(np.int64)
    e = np.minimum(s + count.astype(np.int64), n)
    return cum[e] - cum[np.minimum(s, n)]


def required_frontier_cap(di) -> int:
    """Smallest frontier width that can never drop a branch: the max node
    count over tree levels (of every shard of a stacked index)."""
    if di.stacked:
        return max(required_frontier_cap(di.shard(s))
                   for s in range(di.num_shards))
    left = di.left.cpu().numpy()
    right = di.right.cpu().numpy()
    frontier = np.asarray([int(di.root)], dtype=np.int64)
    cap = 1
    while frontier.size:
        cap = max(cap, int(frontier.size))
        children = np.concatenate([left[frontier], right[frontier]])
        frontier = children[children >= 0]
    return cap
