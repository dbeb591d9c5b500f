"""Batched KHI query engine and selectivity-adaptive planner, ported from
``repro.core.engine``.

The reference writes the search for one query (``_query_one``) and vmaps
it; each lane runs its own ``while_loop``. Here one batched hop loop runs
all lanes together: a lane whose frontier is exhausted, or that reached
``SearchParams.hops()``, stops counting hops and its state stops changing
(its selected slots are invalid, so nothing is expanded, marked or
merged), and the loop ends when no lane is alive. Everything else keeps
the reference's fixed-shape formulation and its tie rules:

  * Phase A — ``router.route_level_sync`` (compacted frontier), or the
    legacy per-lane stack DFS ``router.route_dfs`` (``router="dfs"``,
    graph strategy only);
  * Phase B — the wide frontier: the top-``expand_width`` unexpanded pool
    slots per hop, one fused ``E*H*M`` candidate stream per lane, a
    scatter-max first-occurrence dedup (``seen``), per-expansion ``c_n``
    budgets by a segmented exclusive cumsum, one scoring call over the
    ``E*c_n`` survivors, and the stable pool merge.

Scoring goes through the ``Scorer`` registry. ``backend=
"pallas_gather_l2_filter"`` names the predicate-fused scorer: on the port
it launches the hand-written CUDA kernel (``kernels/csrc/
gather_l2_filter.cu``) for CUDA tensors and its plain version on the CPU.
The unfused backends score the clamped ids and write +inf over the -1
lanes: ``"jnp"`` in plain PyTorch, ``"pallas_gather_l2"`` with the CUDA
gather without predicate and ``"pallas_l2"`` with the CUDA expansion
kernel ``l2dist_qc`` over a materialized ``vecs[ids]`` gather, as the
reference does; a legacy ``dist_fn(q, rows)`` override takes their
place. Only the graph strategy takes ``pallas_l2`` and
``pallas_gather_l2`` (they have no filter form for the scan). The strategies
``graph``, ``scan``, ``auto`` and ``hybrid`` are ported, with ``quant``
in {none, bf16, int8}: a quantized search walks or scans a compressed
corpus replica (``DeviceIndex.qvecs`` / ``qscale``, DESIGN.md §12) and
reranks its over-fetched candidates exactly before answering.
``hybrid`` (DESIGN.md §12) classifies each lane's routing antichain on
the device into small nodes, scanned exactly as contiguous windows of a
position-ordered copy of the corpus (``kernels/csrc/scan_topk.cu``'s
windowed form), and large ones, walked by the graph program; mixed lanes
merge both streams with ``_merge_dedup``. ``Planner.search_expr`` serves a
boolean filter expression (``core/predicate.py``, DESIGN.md §15): each
disjoint box of its cover through ``search``, or, past ``box_budget``,
one scan under a host-evaluated row mask (the bitmask kernel). Every
entry point also serves a shard-stacked index (``sharded.ShardedKHI``):
the programs fan out over its shards and merge into global ids. The
corpus may be stored in bf16 (``device_put_index(vec_dtype=)``): every
path then reads it in bf16, accumulates in f32 and rounds the query as
its reference call site does.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from . import beam
from .router import (HostCardEstimator, ROUTERS, required_frontier_cap,
                     resolve_router)
from .util import pow2_at_least, resolve_device
from ..kernels import ops as _ops
from ..kernels import ref as _ref
from ..kernels.quant import QUANTS, quant_replica

__all__ = ["DeviceIndex", "SearchParams", "BACKENDS", "ROUTERS",
           "STRATEGIES", "SCAN_BACKENDS", "DEFAULT_SCAN_FRAC", "QUANTS",
           "Scorer", "Plan", "PredicatePlan", "Planner", "device_put_index",
           "resolve_dist_ids", "resolve_scorer",
           "resolve_scorer_pair", "with_quant_replica", "search_batch",
           "make_search_fn", "required_scan_budget", "required_stack_cap",
           "required_frontier_cap", "derive_search_params",
           "validate_search_params"]

BACKENDS = ("jnp", "pallas_l2", "pallas_gather_l2", "pallas_gather_l2_filter")
STRATEGIES = ("graph", "scan", "auto", "hybrid")
SCAN_BACKENDS = ("jnp", "pallas_gather_l2_filter")
DEFAULT_SCAN_FRAC = 0.1

_INF = float("inf")


@dataclasses.dataclass
class DeviceIndex:
    """KHI flattened onto tensors of one device."""

    vecs: torch.Tensor    # (n, d) float32 or bfloat16 (vec_dtype)
    attrs: torch.Tensor   # (n, m) float32
    nbrs: torch.Tensor    # (n, H, M) int32 (object-major: one gather/row)
    left: torch.Tensor    # (P,) int64
    right: torch.Tensor   # (P,) int64
    dim: torch.Tensor     # (P,) int64
    bl: torch.Tensor      # (P,) int64 bitmask
    lo: torch.Tensor      # (P, m) float32
    hi: torch.Tensor      # (P, m) float32
    start: torch.Tensor   # (P,) int64
    count: torch.Tensor   # (P,) int64
    order: torch.Tensor   # (n,) int64
    root: Union[int, Tuple[int, ...]]
    # the compressed score replica, None unless a quantized search asked
    # for it: qvecs (n, d) bf16 or int8, qscale the int8 per-row (n, 1)
    # f32 scale plane (None for bf16)
    qvecs: Optional[torch.Tensor] = None
    qscale: Optional[torch.Tensor] = None

    # A shard-stacked index (``sharded.stack_shards``) holds every tensor
    # with a leading shard axis, (S, n, d) and so on, and one root per
    # shard as a tuple; ``shard(s)`` and ``rows()`` are its two views.

    @property
    def stacked(self) -> bool:
        return isinstance(self.root, tuple)

    @property
    def num_shards(self) -> int:
        return len(self.root) if self.stacked else 1

    @property
    def n(self) -> int:
        """Rows (per shard, padding included, on a stacked index)."""
        return self.vecs.shape[-2]

    @property
    def height(self) -> int:
        return self.nbrs.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.vecs.device

    def shard(self, s: int) -> "DeviceIndex":
        """Shard ``s`` of a stacked index as a plain one (views)."""
        return DeviceIndex(**{
            f.name: (self.root[s] if f.name == "root" else
                     None if getattr(self, f.name) is None else
                     getattr(self, f.name)[s])
            for f in dataclasses.fields(self)})

    def rows(self) -> "DeviceIndex":
        """The row planes of a stacked index as one (S * n, ...) index
        (views): row ``s * n + i`` is shard s's row i. Only ``vecs``,
        ``attrs``, ``nbrs`` and the replica are merged; the tree planes
        are shard 0's, which nothing that reads this view touches."""
        flat = {f: None if getattr(self, f) is None else
                getattr(self, f).reshape((-1,) + getattr(self, f).shape[2:])
                for f in ("vecs", "attrs", "nbrs", "qvecs", "qscale")}
        return dataclasses.replace(self.shard(0), **flat)


def device_put_index(index, *, device=None, quant: str = "none",
                     pad_n: Optional[int] = None,
                     pad_nodes: Optional[int] = None,
                     pad_height: Optional[int] = None,
                     vec_dtype=None) -> DeviceIndex:
    """Flatten a host index onto ``device`` (default ``cuda``). ``index``
    is anything with the ``KHIIndex`` fields: ``vecs``, ``attrs``,
    ``nbrs`` (H, n, M) and ``tree`` (numpy arrays or tensors), so an
    index built by the JAX package works as it is. ``quant`` ("bf16" /
    "int8") also attaches the compressed replica (``with_quant_replica``).
    ``vec_dtype=torch.bfloat16`` stores the corpus vectors in bf16
    (rounded to nearest even, as the reference's ``vec_dtype=
    jnp.bfloat16``), which halves the largest tensor on the device;
    distances still accumulate in f32, and each scorer and scan rounds
    the query as its reference call site does (``_round_q``).

    ``pad_n``, ``pad_nodes`` and ``pad_height`` pad the rows, the tree
    nodes and the graph levels to common sizes, so that shards can be
    stacked, with the reference's fills: vecs 0, attrs +inf, nbrs -1 past
    the shard's rows and levels; left, right and dim -1, lo +inf, hi -inf,
    bl, start and count 0 on pad nodes; order 0 on pad rows."""
    dev = resolve_device(device)
    vd = vec_dtype or torch.float32
    if vd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vec_dtype must be None, torch.float32 or "
                         f"torch.bfloat16, got {vec_dtype!r}")
    t = index.tree

    def up(a, dtype):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a).to(device=dev, dtype=dtype)

    def pad(x, size, fill):
        if size is None or size == x.shape[0]:
            return x.contiguous()
        out = torch.full((size,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=dev)
        out[:x.shape[0]] = x
        return out

    def rows(a, dtype, fill=0):
        return pad(up(a, dtype), pad_n, fill)

    def nodes(a, dtype, fill=0):
        return pad(up(a, dtype), pad_nodes, fill)

    nbrs = up(index.nbrs, torch.int32).permute(1, 0, 2)          # (n, H, M)
    if pad_height is not None and pad_height != nbrs.shape[1]:
        nb = torch.full((nbrs.shape[0], pad_height, nbrs.shape[2]), -1,
                        dtype=torch.int32, device=dev)
        nb[:, :nbrs.shape[1]] = nbrs
        nbrs = nb
    root = int(np.nonzero(np.asarray(t.parent) < 0)[0][0])
    di = DeviceIndex(
        vecs=rows(index.vecs, vd),
        attrs=rows(index.attrs, torch.float32, _INF),
        nbrs=pad(nbrs, pad_n, -1),
        left=nodes(t.left, torch.int64, -1),
        right=nodes(t.right, torch.int64, -1),
        dim=nodes(t.dim, torch.int64, -1),
        bl=nodes(np.asarray(t.bl).astype(np.int64), torch.int64),
        lo=nodes(t.lo, torch.float32, _INF),
        hi=nodes(t.hi, torch.float32, -_INF),
        start=nodes(t.start, torch.int64), count=nodes(t.count, torch.int64),
        order=rows(t.order, torch.int64), root=root)
    return with_quant_replica(di, quant)


def with_quant_replica(di: DeviceIndex, quant: str) -> DeviceIndex:
    """Copy of ``di`` carrying the compressed corpus replica for ``quant``
    (made on ``di``'s device in one pass over ``vecs``); ``quant="none"``
    drops any replica. The other tensors are shared, not copied. Over a
    bf16 corpus, as in the reference, the bf16 replica is the corpus
    itself and the int8 one is quantized from its f32 upcast."""
    if quant == "none":
        return dataclasses.replace(di, qvecs=None, qscale=None)
    if quant not in QUANTS:
        raise ValueError(f"unknown quant {quant!r}; expected one of {QUANTS}")
    qvecs, qscale = quant_replica(di.vecs, quant)
    return dataclasses.replace(di, qvecs=qvecs, qscale=qscale)


_REPLICA_DTYPE = {"bf16": torch.bfloat16, "int8": torch.int8}


def _with_replica_for(di: DeviceIndex, quant: str) -> DeviceIndex:
    """``di`` itself when it already carries ``quant``'s replica (or no
    replica is wanted), else a copy with that replica derived."""
    if quant == "none" or (di.qvecs is not None
                           and di.qvecs.dtype == _REPLICA_DTYPE[quant]):
        return di
    return with_quant_replica(di, quant)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static search configuration; the same fields, defaults and checks
    as ``repro.core.engine.SearchParams``, so one set of params means the
    same search in both packages."""

    k: int = 10
    ef: int = 64
    c_e: int = 10
    c_n: int = 32
    stack_cap: int = 64
    max_steps: int = 4096
    scan_budget: int = 64
    max_hops: int = 0        # 0 => ef * 4
    backend: str = "jnp"
    expand_width: int = 1
    router: str = "level"
    strategy: str = "graph"
    scan_threshold: int = 0
    frontier_cap: int = 0
    quant: str = "none"
    rerank_mult: int = 4
    node_scan_threshold: int = 0
    box_budget: int = 8

    def __post_init__(self):
        if self.expand_width < 1:
            raise ValueError(f"expand_width must be >= 1, "
                             f"got {self.expand_width}")
        if self.expand_width > self.ef:
            raise ValueError(f"expand_width must be <= ef "
                             f"({self.ef}), got {self.expand_width}")
        if self.c_e > self.ef:
            raise ValueError(f"c_e must be <= ef ({self.ef}), got "
                             f"{self.c_e}: the entry seed writes the first "
                             f"c_e pool slots and the beam holds only ef")
        if self.router not in ROUTERS:
            raise ValueError(f"unknown router {self.router!r}; expected "
                             f"one of {ROUTERS}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; expected "
                             f"one of {STRATEGIES}")
        if self.scan_threshold < 0:
            raise ValueError(f"scan_threshold must be >= 0, "
                             f"got {self.scan_threshold}")
        if self.frontier_cap < 0:
            raise ValueError(f"frontier_cap must be >= 0, "
                             f"got {self.frontier_cap}")
        if self.quant not in QUANTS:
            raise ValueError(f"unknown quant {self.quant!r}; expected one "
                             f"of {QUANTS}")
        if self.rerank_mult < 1:
            raise ValueError(f"rerank_mult must be >= 1, "
                             f"got {self.rerank_mult}")
        if self.node_scan_threshold < 0:
            raise ValueError(f"node_scan_threshold must be >= 0, "
                             f"got {self.node_scan_threshold}")
        if self.box_budget < 1:
            raise ValueError(f"box_budget must be >= 1, "
                             f"got {self.box_budget}")

    def hops(self) -> int:
        return self.max_hops or self.ef * 4


# --------------------------------------------------------------------------
# Parameter validation against a concrete index
# --------------------------------------------------------------------------

def required_stack_cap(di: DeviceIndex) -> int:
    """DFS depth bound: one pending sibling per level plus the current node."""
    return int(di.nbrs.shape[-2]) + 1


def required_scan_budget(di: DeviceIndex) -> int:
    """Smallest entry-scan window that never misses an entry: the max
    count over scannable nodes that are not provably contained (leaves
    and nodes with blacklisted dims)."""
    left = di.left.cpu().numpy()
    bl = di.bl.cpu().numpy()
    count = di.count.cpu().numpy()
    scannable = (left < 0) | (bl != 0)
    return int(count[scannable].max()) if scannable.any() else 1


def derive_search_params(p: SearchParams, di: DeviceIndex) -> SearchParams:
    """Copy of ``p`` with scan_budget/stack_cap/frontier_cap raised (never
    lowered) to the sufficient values for ``di``."""
    return dataclasses.replace(
        p,
        scan_budget=max(p.scan_budget, required_scan_budget(di)),
        stack_cap=max(p.stack_cap, required_stack_cap(di)),
        frontier_cap=(max(p.frontier_cap, required_frontier_cap(di))
                      if p.router == "level" else p.frontier_cap),
    )


def _check_strategy_combo(p: SearchParams) -> None:
    """Reject strategy combinations that cannot execute (the reference's
    rules, word for word in substance)."""
    unfused = [b for b in BACKENDS if b not in SCAN_BACKENDS]
    if p.strategy in ("scan", "auto", "hybrid") \
            and p.backend not in SCAN_BACKENDS:
        raise ValueError(
            f"strategy={p.strategy!r} is incompatible with backend "
            f"{p.backend!r}: the brute-scan path masks the pass with the "
            f"range predicate, which needs the fused filter kernel "
            f"('pallas_gather_l2_filter') or the plain mask path ('jnp'); "
            f"the unfused pallas backends {unfused} have no filter form. "
            f"Switch backend, or force strategy='graph'.")
    if p.strategy in ("auto", "hybrid") and p.router != "level":
        raise ValueError(
            f"strategy={p.strategy!r} requires router='level' (got "
            f"{p.router!r}): the DFS router early-stops after c_e entries "
            f"and never sweeps the full scannable antichain, so its count "
            f"sum is not an in-range cardinality bound and its visited "
            f"node set is not the full antichain. Use router='level', or "
            f"pick the strategy explicitly.")
    if p.quant != "none" and p.backend not in SCAN_BACKENDS:
        raise ValueError(
            f"quant={p.quant!r} is incompatible with backend "
            f"{p.backend!r}: the quantized score path needs the fused "
            f"filter kernel ('pallas_gather_l2_filter', which has bf16 and "
            f"int8 replica forms) or the plain path ('jnp'); the unfused "
            f"pallas backends {unfused} have no replica form. Switch "
            f"backend, or set quant='none'.")


def validate_search_params(p: SearchParams, di: DeviceIndex, *,
                           on_undersized: str = "raise",
                           expr=None) -> SearchParams:
    """Check ``p``'s index-dependent buffer bounds against ``di`` and the
    strategy/backend/router rules; ``on_undersized`` is raise | adjust |
    ignore, as in the reference. ``expr``, a predicate expression
    (``core/predicate.py``), is validated against this index's attribute
    count."""
    _check_strategy_combo(p)
    if expr is not None:
        from .predicate import validate_expr
        validate_expr(expr, int(di.attrs.shape[-1]))
    if on_undersized == "ignore":
        return p
    if on_undersized not in ("raise", "adjust"):
        raise ValueError(f"on_undersized must be raise|adjust|ignore, "
                         f"got {on_undersized!r}")
    need_scan = required_scan_budget(di)
    need_stack = required_stack_cap(di)
    need_front = required_frontier_cap(di) if p.router == "level" else 0
    if (p.scan_budget >= need_scan and p.stack_cap >= need_stack
            and p.frontier_cap >= need_front):
        return p
    if on_undersized == "adjust":
        return dataclasses.replace(
            p, scan_budget=max(p.scan_budget, need_scan),
            stack_cap=max(p.stack_cap, need_stack),
            frontier_cap=max(p.frontier_cap, need_front))
    raise ValueError(
        f"SearchParams undersized for this index: need scan_budget >= "
        f"{need_scan} (got {p.scan_budget}), stack_cap >= {need_stack} "
        f"(got {p.stack_cap}) and frontier_cap >= {need_front} (got "
        f"{p.frontier_cap}). Use derive_search_params() or pass "
        f"on_undersized='adjust'.")


# --------------------------------------------------------------------------
# Scorer registry
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scorer:
    """``score(di, q (B, d), qlo, qhi (B, m), ids (B, C)) -> (B, C) f32``:
    exact squared L2 on valid lanes, +inf on -1 lanes (fused scorers also
    on lanes outside the box). ``in_range`` is the stream-side predicate
    the hop budget counts."""

    name: str
    fused_filter: bool
    score: Callable

    def in_range(self, di: DeviceIndex, qlo: torch.Tensor,
                 qhi: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        a = di.attrs[ids]                                   # (B, C, m)
        return ((a >= qlo[:, None, :]) & (a <= qhi[:, None, :])).all(-1)


def _dist_jnp(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """q (..., d), cand (..., C, d) -> (..., C) f32: subtract and square in
    the corpus dtype, sum in f32 (the reference's ``_dist_jnp``, batched).
    Also a legacy ``dist_fn(q, rows)`` that any batch shape can call."""
    diff = cand - q.to(cand.dtype)[..., None, :]
    return (diff * diff).sum(-1, dtype=torch.float32)


# Every unfused backend is fn(vecs (n, d), q (B, d), safe_ids (B, C)) ->
# (B, C) f32; ids are pre-clamped into range by the caller, which writes
# +inf over the invalid lanes (garbage rows are fine).

def _dist_ids_jnp(vecs, q, ids):
    return _dist_jnp(q, vecs[ids])


def _round_q(q: torch.Tensor, dtype) -> torch.Tensor:
    """``q`` (f32) rounded to ``dtype`` and back: what the reference's
    ``q.astype(vecs.dtype)`` hands its kernel at the call sites that cast
    the query (the gathers and ``pallas_l2``); the identity for f32."""
    if dtype == torch.float32:
        return q
    return q.to(dtype).to(torch.float32)


def _dist_ids_pallas_l2(vecs, q, ids):
    # the reference materializes the gather outside its kernel too: a
    # (B, C, d) PyTorch index, then the expansion kernel over it
    rows = vecs[ids]
    return _ops.l2dist_qc(_round_q(q, rows.dtype), rows)


def _dist_ids_gather_l2(vecs, q, ids):
    # the blocked form, bitwise equal to the row-per-step one
    return _ops.gather_l2(ids, vecs, _round_q(q, vecs.dtype), c_blk=128)


def resolve_dist_ids(backend: Optional[str] = None, *,
                     dist_fn: Optional[Callable] = None) -> Callable:
    """An *unfused* distance backend as ``fn(vecs, q, ids)``. A legacy
    ``dist_fn(q, rows)`` wins if given: here ``q`` is (B, d) and ``rows``
    (B, C, d), and it returns (B, C). The predicate-fused backend has no
    dist-only form: resolve it with ``resolve_scorer``."""
    if dist_fn is not None:
        return lambda vecs, q, ids: dist_fn(q, vecs[ids])
    backend = backend or "jnp"
    if backend == "jnp":
        return _dist_ids_jnp
    if backend == "pallas_l2":
        return _dist_ids_pallas_l2
    if backend == "pallas_gather_l2":
        return _dist_ids_gather_l2
    if backend == "pallas_gather_l2_filter":
        raise ValueError(
            f"{backend!r} is predicate-fused and has no dist-only form; "
            f"resolve it with resolve_scorer()")
    raise ValueError(f"unknown distance backend {backend!r}; "
                     f"expected one of {BACKENDS}")


def _unfused_scorer(name: str, dist_ids: Callable) -> Scorer:
    def score(di, q, qlo, qhi, ids):
        d = dist_ids(di.vecs, q, ids.clamp_min(0))
        return torch.where(ids >= 0, d, torch.full_like(d, _INF))
    return Scorer(name=name, fused_filter=False, score=score)


def _filter_score(di, q, qlo, qhi, ids):
    # the kernel consumes -1 lanes itself (emits +inf)
    return _ops.gather_l2_filter(ids, di.vecs, di.attrs,
                                 _round_q(q, di.vecs.dtype), qlo, qhi)


def _quant_scorer(backend: str, quant: str) -> Scorer:
    """Scorer over the compressed replica: distances from ``di.qvecs``
    (dequantized in the kernel or its plain version), the predicate from
    the exact f32 ``di.attrs``. Each branch copies the reference's: only
    the kernel backend's bf16 form rounds the query to bf16."""
    if backend == "pallas_gather_l2_filter":
        if quant == "bf16":
            def score(di, q, qlo, qhi, ids):
                return _ops.gather_l2_filter(ids, di.qvecs, di.attrs,
                                             _round_q(q, di.qvecs.dtype),
                                             qlo, qhi)
        else:
            def score(di, q, qlo, qhi, ids):
                return _ops.gather_l2_filter_q8(ids, di.qvecs, di.qscale,
                                                di.attrs, q, qlo, qhi)
    elif quant == "bf16":                           # plain forms
        def score(di, q, qlo, qhi, ids):
            return _ref.gather_l2_filter_ref(ids, di.qvecs, di.attrs, q,
                                             qlo, qhi)
    else:
        def score(di, q, qlo, qhi, ids):
            return _ref.gather_l2_filter_q8_ref(ids, di.qvecs, di.qscale,
                                                di.attrs, q, qlo, qhi)
    return Scorer(name=f"{backend}+{quant}", fused_filter=True, score=score)


def resolve_scorer(backend: Optional[str] = None, *,
                   dist_fn: Optional[Callable] = None,
                   quant: str = "none") -> Scorer:
    """``SearchParams.backend`` as a ``Scorer``. A legacy ``dist_fn(q,
    rows)`` override wins if given (an unfused scorer). With ``quant`` !=
    "none" the scorer streams the compressed replica and its distances are
    approximate: pair it with the exact scorer (``resolve_scorer_pair``).
    """
    if dist_fn is not None:
        if quant != "none":
            raise ValueError("dist_fn overrides cannot run on the "
                             "quantized replica; set quant='none'")
        return _unfused_scorer("dist_fn", resolve_dist_ids(dist_fn=dist_fn))
    backend = backend or "jnp"
    if backend not in BACKENDS:
        raise ValueError(f"unknown scoring backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if quant not in QUANTS:
        raise ValueError(f"unknown quant {quant!r}; expected one of {QUANTS}")
    if quant != "none":
        if backend not in SCAN_BACKENDS:
            raise ValueError(f"quant={quant!r} requires a backend in "
                             f"{SCAN_BACKENDS}, got {backend!r}")
        return _quant_scorer(backend, quant)
    if backend == "pallas_gather_l2_filter":
        return Scorer(name=backend, fused_filter=True, score=_filter_score)
    return _unfused_scorer(backend, resolve_dist_ids(backend))


def resolve_scorer_pair(p: SearchParams, *,
                        dist_fn: Optional[Callable] = None):
    """(loop scorer, exact rerank scorer or None) for ``p``: with a quant
    the loop scores on the replica and the second scorer rescores the
    over-fetched candidates in f32."""
    if p.quant == "none":
        return resolve_scorer(p.backend, dist_fn=dist_fn), None
    return (resolve_scorer(p.backend, dist_fn=dist_fn, quant=p.quant),
            resolve_scorer(p.backend))


_ID_LAST = np.iinfo(np.int32).max


def _lexsort2(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Row-wise stable order by ``major``, ties by ``minor`` (numpy's
    ``lexsort((minor, major), axis=-1)``)."""
    o = torch.argsort(minor, dim=-1, stable=True)
    return o.gather(-1, torch.argsort(major.gather(-1, o), dim=-1,
                                      stable=True))


def _lex_topk(ids: torch.Tensor, dists: torch.Tensor, k: int):
    """Top-k of (dists, ids) under the (dist, id) order: ascending
    distance, ties to the lowest id, -1 lanes last; ids become -1
    wherever the kept distance is +inf. (..., C) with C >= k."""
    key_id = torch.where(ids >= 0, ids, torch.full_like(ids, _ID_LAST))
    o = _lexsort2(key_id, dists)[..., :k]
    d = dists.gather(-1, o)
    i = ids.gather(-1, o)
    return torch.where(torch.isinf(d), torch.full_like(i, -1), i), d


# --------------------------------------------------------------------------
# Phase B: the batched wide-frontier hop loop
# --------------------------------------------------------------------------

def _query_batch(di: DeviceIndex, q: torch.Tensor, qlo: torch.Tensor,
                 qhi: torch.Tensor, p: SearchParams, scorer: Scorer,
                 exact_scorer: Optional[Scorer] = None):
    """(B, d) x (B, m) x (B, m) -> (ids (B, k) int64, dists (B, k) f32,
    hops (B,) int64); the reference's ``_query_one`` for every lane. With
    an ``exact_scorer`` (a quantized search) the top ``rr`` pool entries
    are rescored by it and the answer is their (dist, id) top-k."""
    entries, _ = resolve_router(p.router)(di, qlo, qhi, p)
    return _walk(di, q, qlo, qhi, entries, p, scorer, exact_scorer, di.n)


def _query_batch_sharded(di: DeviceIndex, q: torch.Tensor,
                         qlo: torch.Tensor, qhi: torch.Tensor,
                         p: SearchParams, scorer: Scorer,
                         exact_scorer: Optional[Scorer] = None):
    """``_query_batch`` on every shard of a stacked index: -> local ids
    (S, B, k) int64, dists (S, B, k) f32, hops (S, B) int64, each shard's
    lanes exactly its own walk. Phase A runs per shard; the S * B (shard,
    lane) pairs then walk as one batch over the ``rows()`` view, each lane
    holding local ids in its pool, ``seen`` and ``visited`` and adding its
    shard's row offset only where it addresses a row."""
    S, n, B = di.num_shards, di.n, q.shape[0]
    route = resolve_router(p.router)
    entries = torch.cat([route(di.shard(s), qlo, qhi, p)[0]
                         for s in range(S)])
    roff = torch.arange(S, device=q.device).repeat_interleave(B) * n
    ids, dists, hops = _walk(di.rows(), q.repeat(S, 1), qlo.repeat(S, 1),
                             qhi.repeat(S, 1), entries, p, scorer,
                             exact_scorer, n, roff)
    return ids.view(S, B, -1), dists.view(S, B, -1), hops.view(S, B)


def _walk(di: DeviceIndex, q: torch.Tensor, qlo: torch.Tensor,
          qhi: torch.Tensor, entries: torch.Tensor, p: SearchParams,
          scorer: Scorer, exact_scorer: Optional[Scorer], n: int,
          roff: Optional[torch.Tensor] = None):
    """Phase B from Phase A's ``entries`` (B, c_e): the wide-frontier hop
    loop over ids in ``[0, n)``. ``roff`` (B,), when given, is each lane's
    row offset into ``di``'s planes (a shard's rows in the ``rows()``
    view); ids in the pool and the answer stay lane-local."""
    B = q.shape[0]
    H, M = di.nbrs.shape[1], di.nbrs.shape[2]
    HM = H * M
    E = p.expand_width
    L = E * HM
    cap = E * p.c_n
    dev = q.device

    def at(ids):                        # lane-local ids -> rows of di
        if roff is None:
            return ids
        return torch.where(ids >= 0, ids + roff[:, None], ids)

    e_valid = entries >= 0
    e_dist = scorer.score(di, q, qlo, qhi, at(entries))
    visited = beam.visited_init(B, n, dev)
    beam.visited_mark(visited, entries, e_valid)
    pool = beam.pool_seed(p.ef + cap, entries, e_dist, e_valid)
    # seen[b, i]: hop-tagged stream position of id i's latest occurrence
    seen = torch.full((B, n + 1), -1, dtype=torch.int32, device=dev)
    hops = torch.zeros(B, dtype=torch.int64, device=dev)
    rev = torch.arange(L - 1, -1, -1, device=dev, dtype=torch.int64)
    base = (torch.arange(E, device=dev) * p.c_n).repeat_interleave(HM)
    nbrs = di.nbrs.view(-1, HM)
    drop = torch.full((B, L), n, dtype=torch.int64, device=dev)
    max_hops = p.hops()

    for _ in range(max_hops):
        alive = beam.pool_frontier_alive(pool, p.ef) & (hops < max_hops)
        if not bool(alive.any()):
            break
        u_slots, us, uvalid = beam.pool_top_unexpanded(pool, p.ef, E)
        uvalid = uvalid & alive[:, None]
        pool = beam.pool_mark_expanded_many(pool, u_slots, uvalid)

        # ReconsNbr over the fused E*H*M stream of each lane
        u_safe = torch.where(uvalid, us, torch.zeros_like(us))
        rows = nbrs[at(u_safe)].to(torch.int64)              # (B, E, HM)
        nid = rows.view(B, L)
        valid = ((rows >= 0) & uvalid[:, :, None]).view(B, L)
        nid_safe = torch.where(valid, nid, torch.zeros_like(nid))

        # first-occurrence dedup: scatter-max of a tag that decreases
        # along the stream and grows by L per hop
        tag = (hops[:, None] * L + rev[None, :]).to(torch.int32)
        seen.scatter_reduce_(1, torch.where(valid, nid, drop), tag, "amax")
        is_first = valid & (seen.gather(1, nid_safe) == tag)

        fresh = is_first & ~visited.gather(1, nid_safe)
        in_range = valid & scorer.in_range(di, qlo, qhi, at(nid_safe))
        append = fresh & in_range
        seg = append.view(B, E, HM).to(torch.int64)
        napp_excl = (torch.cumsum(seg, 2) - seg).view(B, L)
        scanned = napp_excl < p.c_n
        beam.visited_mark(visited, nid, fresh & scanned)
        keep = append & scanned
        slots = torch.where(keep, base[None, :] + napp_excl,
                            torch.full_like(napp_excl, cap))
        buf = torch.full((B, cap + 1), -1, dtype=torch.int64, device=dev)
        buf.scatter_(1, slots, nid)
        buf = buf[:, :cap].contiguous()

        bvalid = buf >= 0
        bd = scorer.score(di, q, qlo, qhi, at(buf))
        pool = beam.pool_merge_tail(pool, p.ef, buf, bd, bvalid)
        hops = hops + alive.to(torch.int64)
    if exact_scorer is None:
        return pool.ids[:, :p.k], pool.dists[:, :p.k], hops
    # the loop ranked the pool on replica distances, whose order near the
    # k boundary may invert against f32: rescore the top rr exactly
    rr = max(p.k, min(p.ef, p.k * p.rerank_mult))
    cand = pool.ids[:, :rr].contiguous()
    ids_k, dists_k = _lex_topk(cand, exact_scorer.score(
        di, q, qlo, qhi, at(cand)), p.k)
    return ids_k, dists_k, hops


def _local_to_global(local_ids: torch.Tensor, shard,
                     n_shards: int) -> torch.Tensor:
    """Round-robin inverse: global = local * S + shard; -1 stays -1.
    ``shard`` is an int or a tensor broadcasting against the ids."""
    return torch.where(local_ids >= 0, local_ids * n_shards + shard,
                       torch.full_like(local_ids, -1))


def _merge_topk(gids: torch.Tensor, dists: torch.Tensor, k: int):
    """gids / dists (S, B, k') -> the global (B, k) by merge-k over the
    shard-major (S * k') list of each lane, as the reference's
    ``lax.top_k``: ascending distance, ties to the lower flat position,
    i.e. (dist, shard, rank in that shard). Pads stay (-1, +inf)."""
    S, B, kk = gids.shape
    flat_i = gids.permute(1, 0, 2).reshape(B, S * kk)
    flat_d = dists.permute(1, 0, 2).reshape(B, S * kk)
    sel = torch.argsort(flat_d, dim=1, stable=True)[:, :k]
    return flat_i.gather(1, sel), flat_d.gather(1, sel)


def _shard_search(di: DeviceIndex, q, qlo, qhi, p: SearchParams,
                  scorer: Scorer, exact_scorer: Optional[Scorer] = None, *,
                  shard: Optional[int] = None,
                  n_shards: Optional[int] = None):
    """Every shard's graph walk over a stacked index: -> global ids (S,
    B, k) int64 (-1 kept), dists (S, B, k) with +inf on -1 lanes, hops
    (S, B). Over one shard as a plain index (a collective rank's, as the
    reference's ``_shard_search`` takes it) pass its ``shard`` id and
    ``n_shards``: -> ids and dists (B, k), hops (B,)."""
    if not di.stacked:
        ids, dists, hops = _query_batch(di, q, qlo, qhi, p, scorer,
                                        exact_scorer)
        gids = _local_to_global(ids, shard, n_shards)
        return gids, torch.where(gids >= 0, dists,
                                 torch.full_like(dists, _INF)), hops
    ids, dists, hops = _query_batch_sharded(di, q, qlo, qhi, p, scorer,
                                            exact_scorer)
    shard = torch.arange(di.num_shards, device=ids.device)[:, None, None]
    gids = _local_to_global(ids, shard, di.num_shards)
    return gids, torch.where(gids >= 0, dists,
                             torch.full_like(dists, _INF)), hops


def _fan_in(per_shard, S: int, k: int):
    """Merge a list of S per-shard (local ids, dists) top-k lists: ids to
    global (int64), distances of -1 lanes to +inf, then ``_merge_topk``."""
    gi, gd = [], []
    for s, (ids, dd) in enumerate(per_shard):
        g = _local_to_global(ids.to(torch.int64), s, S)
        gi.append(g)
        gd.append(torch.where(g >= 0, dd, torch.full_like(dd, _INF)))
    return _merge_topk(torch.stack(gi), torch.stack(gd), k)


def make_search_fn(p: SearchParams, *, dist_fn=None,
                   di: Optional[DeviceIndex] = None,
                   on_undersized: str = "raise"):
    """Graph search over tensors: fn(di, q (B, d), qlo, qhi (B, m)) ->
    (ids (B, k) int64, dists (B, k) f32, hops (B,) int64). The scorer
    comes from ``p.backend`` unless a legacy ``dist_fn(q, rows)`` override
    is given. Pass ``di`` to validate the index-dependent bounds up
    front."""
    if p.strategy != "graph":
        raise ValueError(
            f"make_search_fn builds the graph program only; strategy="
            f"{p.strategy!r} dispatches per query on the host — build a "
            f"Planner (or call search_batch, which does).")
    if di is not None:
        p = validate_search_params(p, di, on_undersized=on_undersized)
    scorer, exact = resolve_scorer_pair(p, dist_fn=dist_fn)

    def search(di: DeviceIndex, q, qlo, qhi):
        if p.quant != "none" and di.qvecs is None:
            raise ValueError(f"quant={p.quant!r} needs an index carrying "
                             f"its replica: see with_quant_replica")
        return _query_batch(di, q, qlo, qhi, p, scorer, exact)

    return search


def _is_sharded(index) -> bool:
    """Duck-typed ``sharded.ShardedKHI`` check (sharded.py imports this
    module)."""
    return hasattr(index, "offsets") and hasattr(index, "di")


def _as_device_index(index, device):
    """A ``DeviceIndex`` or a ``ShardedKHI`` as it is; a host index
    flattened onto ``device``."""
    if isinstance(index, DeviceIndex) or _is_sharded(index):
        return index
    return device_put_index(index, device=device)


def _shard_counts(di: DeviceIndex) -> np.ndarray:
    """(S,) int64 real rows per shard, each its tree root's count: the
    rows past it are padding (S = 1 for a plain index)."""
    if not di.stacked:
        return np.asarray([int(di.count[di.root])], np.int64)
    root = torch.as_tensor(di.root, device=di.count.device)
    return di.count[torch.arange(len(di.root), device=root.device),
                    root].cpu().numpy().astype(np.int64)


def search_batch(index_or_di, queries: np.ndarray, preds,
                 params: SearchParams, *, dist_fn=None, device=None,
                 on_undersized: str = "adjust"):
    """Host API: a host index, a DeviceIndex or a ShardedKHI plus a list
    of ``Predicate``s -> numpy (ids int32, dists, hops int32). A legacy
    ``dist_fn(q, rows)`` overrides the graph path's scorer."""
    di = _as_device_index(index_or_di, device)
    qlo = np.stack([pr.lo for pr in preds]).astype(np.float32)
    qhi = np.stack([pr.hi for pr in preds]).astype(np.float32)
    planner = Planner(di, params, dist_fn=dist_fn,
                      on_undersized=on_undersized)
    ids, dists, hops, _ = planner.search(queries, qlo, qhi)
    return ids, dists, hops


# --------------------------------------------------------------------------
# Selectivity-adaptive planner
# --------------------------------------------------------------------------

def _scan_exact(vecs, attrs_nan, q, qlo, qhi, k: int, *, use_kernel: bool):
    """One index's exact predicate-fused brute scan: the CUDA kernel
    (plain version on the CPU) or, on backend 'jnp', the plain version."""
    if use_kernel:
        return _ops.scan_topk(vecs, attrs_nan, q, qlo, qhi, k=k)
    return _ref.scan_topk_ref(vecs, attrs_nan, q, qlo, qhi, k)


def _scan_shard_topk(di: DeviceIndex, attrs_nan, q, qlo, qhi,
                     p: SearchParams, *, use_kernel: bool):
    """One index's scan-path top-k under every quant tier. A quantized
    scan over-fetches ``kq = k * rerank_mult`` candidates from the
    replica, rescores them on the corpus through the gather path and
    takes the (dist, id) top-k: exact whenever the true top-k survives
    the over-fetch. The scans and this rerank pass the query unrounded
    over a bf16 corpus, as the reference's do."""
    if p.quant == "none":
        return _scan_exact(di.vecs, attrs_nan, q, qlo, qhi, p.k,
                           use_kernel=use_kernel)
    kq = min(max(p.k, p.k * p.rerank_mult), di.vecs.shape[0])
    if p.quant == "bf16":
        cids, _ = _scan_exact(di.qvecs, attrs_nan, q, qlo, qhi, kq,
                              use_kernel=use_kernel)
    elif use_kernel:
        cids, _ = _ops.scan_topk_q8(di.qvecs, di.qscale, attrs_nan, q, qlo,
                                    qhi, k=kq)
    else:
        cids, _ = _ref.scan_topk_q8_ref(di.qvecs, di.qscale, attrs_nan, q,
                                        qlo, qhi, kq)
    gather = _ops.gather_l2_filter if use_kernel else _ref.gather_l2_filter_ref
    exact_d = gather(cids, di.vecs, attrs_nan, q, qlo, qhi)
    return _lex_topk(cids, exact_d, p.k)


def _windows_one(pos_vecs, pos_attrs, order, q, qlo, qhi, starts, counts,
                 k: int, *, use_kernel: bool):
    """One index's windowed scan (DESIGN.md §12) over the corpus's dtype
    (f32 or bf16, the query unrounded): positions from the CUDA kernel
    (plain version on the CPU) or, on backend 'jnp', the plain version,
    mapped back through the DFS ``order`` to row ids (int64)."""
    if use_kernel:
        pos, dd = _ops.scan_topk_windows(pos_vecs, pos_attrs, q, qlo, qhi,
                                         starts, counts, k=k)
    else:
        pos, dd = _ref.scan_topk_windows_ref(pos_vecs, pos_attrs, q, qlo,
                                             qhi, starts, counts, k)
    pos = pos.to(torch.int64)
    ids = torch.where(pos >= 0, order[pos.clamp_min(0)],
                      torch.full_like(pos, -1))
    return ids, dd


def _mask_scan_one(vecs, mask, q, k: int, *, use_kernel: bool):
    """One index's bitmask-fused exact scan (DESIGN.md §15), the predicate
    compiler's dense fallback: the CUDA kernel (plain version on the CPU)
    or its plain version, on the corpus itself in its dtype (f32 or bf16,
    the query unrounded), never on a quantized replica."""
    if use_kernel:
        return _ops.scan_topk_mask(vecs, mask, q, k=k)
    return _ref.scan_topk_mask_ref(vecs, mask, q, k)


def _merge_dedup(ids_a: np.ndarray, d_a: np.ndarray, ids_b: np.ndarray,
                 d_b: np.ndarray, k: int,
                 out_dtype=np.int32) -> tuple[np.ndarray, np.ndarray]:
    """Merge two partial top-k streams under the (dist, id) contract with
    id-level dedup (a numpy copy of the reference's): a row found by both
    streams keeps its lowest distance. Two lexsort passes: group by id
    keeping the best occurrence first, mask the rest to (+inf, -1), then
    rank by (dist, id) and take k. All comparisons run in int64;
    ``out_dtype`` is the ids' output type."""
    ids = np.concatenate([ids_a, ids_b], axis=1).astype(np.int64)
    d = np.concatenate([d_a, d_b], axis=1).astype(np.float32)
    sentinel = np.iinfo(np.int64).max
    key = np.where(ids >= 0, ids, sentinel)
    o1 = np.lexsort((d, key), axis=-1)            # id-major, best dist first
    key = np.take_along_axis(key, o1, axis=1)
    d = np.take_along_axis(d, o1, axis=1)
    dup = np.zeros_like(key, bool)
    dup[:, 1:] = (key[:, 1:] == key[:, :-1]) & (key[:, 1:] != sentinel)
    d = np.where(dup, np.inf, d)
    key = np.where(dup, sentinel, key)
    o2 = np.lexsort((key, d), axis=-1)[:, :k]     # (dist, id) rank, take k
    out_d = np.take_along_axis(d, o2, axis=1).astype(np.float32)
    out_i = np.take_along_axis(key, o2, axis=1)
    out_i = np.where(np.isinf(out_d), -1, out_i).astype(out_dtype)
    return out_i, out_d


def _merge_dedup_jnp(ids_a: torch.Tensor, d_a: torch.Tensor,
                     ids_b: torch.Tensor, d_b: torch.Tensor, k: int):
    """The device twin of ``_merge_dedup`` that the collective hybrid
    program runs (DESIGN.md §14): the same two stable lexsort passes on
    tensors, ids int32 out. Global ids fit int32, so the pad key is
    i32max (the numpy form's int64 changes no comparison)."""
    ids = torch.cat([ids_a, ids_b], 1).to(torch.int64)
    d = torch.cat([d_a, d_b], 1).to(torch.float32)
    key = torch.where(ids >= 0, ids, torch.full_like(ids, _ID_LAST))
    o1 = _lexsort2(d, key)                  # id-major, best dist first
    key = key.gather(1, o1)
    d = d.gather(1, o1)
    dup = torch.zeros_like(key, dtype=torch.bool)
    dup[:, 1:] = (key[:, 1:] == key[:, :-1]) & (key[:, 1:] != _ID_LAST)
    d = torch.where(dup, torch.full_like(d, _INF), d)
    key = torch.where(dup, torch.full_like(key, _ID_LAST), key)
    o2 = _lexsort2(key, d)[:, :k]           # (dist, id) rank, take k
    out_d = d.gather(1, o2)
    out_i = key.gather(1, o2)
    return (torch.where(torch.isinf(out_d), torch.full_like(out_i, -1),
                        out_i).to(torch.int32), out_d)


@dataclasses.dataclass
class Plan:
    """Host-side record of one batch's dispatch: the routing bound per
    query (-1 when the strategy was forced), the per-query scan decision
    and the resolved absolute threshold.

    ``strategy="hybrid"`` adds the per-node decision: ``mode`` is 0 =
    graph lane, 1 = pure-window lane (every antichain node small; these
    lanes also set ``use_scan``), 2 = mixed lane (graph walk + windows
    over the small nodes); ``n_windows`` counts each lane's small nodes.
    The reference keeps a dense (B, P) host mask per shard in
    ``small_nodes``; here each shard's entry is the pair of device
    tensors ``(lane, node)`` (int64, by lane then node) of the small
    antichain nodes, which ``Planner._build_windows`` turns into the
    window arrays."""

    card: np.ndarray
    use_scan: np.ndarray
    threshold: int
    node_threshold: int = 0
    mode: Optional[np.ndarray] = None         # (B,) int8, hybrid only
    n_windows: Optional[np.ndarray] = None    # (B,) int64, hybrid only
    small_nodes: Optional[list] = None        # per shard (lane, node)


@dataclasses.dataclass
class PredicatePlan:
    """Host-side record of one compiled-predicate batch (DESIGN.md §15):
    ``mode`` "boxes" ran each disjoint box through ``search`` (one
    ``Plan`` each in ``box_plans``), "bitmask" ran the dense fallback
    scan. ``lanes`` counts dispatched (query x disjunct) lanes per
    strategy, {"graph", "scan", "window"}; mixed hybrid lanes count under
    both graph and window."""

    mode: str
    n_boxes: int
    lanes: dict
    box_plans: list
    program: Any = None    # the compiled PredicateProgram


class Planner:
    """Per-query strategy dispatch over one index: ``graph``, ``scan``,
    ``auto`` (scan iff ``0 < card <= threshold``; zero-card lanes, such as
    the serving layer's empty-box pad lanes, go to the graph program,
    which exits at once) or ``hybrid`` (per antichain node: nodes of at
    most ``node_scan_threshold`` rows are scanned as windows, larger ones
    walked). Mixed batches split into sub-batches, each padded to a power
    of two with empty-box lanes; results scatter back by lane. The
    routing bound comes from ``HostCardEstimator`` through a plan cache
    keyed on the box bytes plus ``plan_salt``. ``search_expr`` serves a
    predicate expression. A legacy ``dist_fn(q, rows)`` override
    changes the graph path's scoring only (the scan is exact).

    Over a ``ShardedKHI`` every program fans out over the shards and
    merges by ``_merge_topk`` into global ids: the graph lanes walk all
    shards in one batch (hops the max over shards), the scan, window and
    bitmask programs run once per shard on its NaN-masked rows, and the
    routing bound sums one estimator per shard, each with its own
    tombstones."""

    def __init__(self, index, params: SearchParams, *, dist_fn=None,
                 device=None, on_undersized: str = "adjust",
                 plan_cache: Optional["collections.OrderedDict"] = None,
                 plan_salt: bytes = b""):
        index = _as_device_index(index, device)
        self._sharded = _is_sharded(index)
        di = index.di if self._sharded else index
        self.params = p = validate_search_params(params, di,
                                                 on_undersized=on_undersized)
        # a quantized search streams the replica: derive it here when the
        # caller handed a bare f32 index
        self._bind(index, _with_replica_for(di, p.quant))
        self.device = di.device
        self._n_shard = _shard_counts(di)
        self.n_total = int(self._n_shard.sum())
        self.scan_threshold = int(p.scan_threshold) or max(
            1, int(DEFAULT_SCAN_FRAC * self.n_total))
        self._build_scan_attrs()
        self._scorer, self._exact = resolve_scorer_pair(p, dist_fn=dist_fn)
        self._use_kernel = p.backend == "pallas_gather_l2_filter"
        self._estimators = (self._build_estimators()
                            if p.strategy in ("auto", "hybrid") else None)
        # hybrid per-node state: the node threshold and the
        # position-ordered corpus replica the windowed scan reads
        self.node_scan_threshold = (int(p.node_scan_threshold)
                                    or self.scan_threshold)
        if p.strategy == "hybrid":
            self._build_pos_replica()
        self._plan_cache: "collections.OrderedDict[bytes, int]" = (
            collections.OrderedDict() if plan_cache is None else plan_cache)
        self._plan_salt = plan_salt
        self.plan_cache_size = 65536
        # the host copy of the NaN-masked scan attrs that the bitmask
        # fallback's mask is evaluated over, fetched on first use
        self._host_scan_attrs: Optional[np.ndarray] = None

    def _bind(self, index, di: DeviceIndex) -> None:
        """Install ``index`` with ``di`` (its replica attached) as its
        DeviceIndex: ``self.index`` is what the caller handed (a
        ShardedKHI stays one), ``self._di`` the (stacked) tensors."""
        self._di = di
        self.index = (dataclasses.replace(index, di=di) if self._sharded
                      else di)

    def _shards(self):
        """The per-shard DeviceIndex views (one for a plain index)."""
        di = self._di
        return ([di.shard(s) for s in range(di.num_shards)] if di.stacked
                else [di])

    def _by_order(self, x: torch.Tensor) -> torch.Tensor:
        """Rows of ``x`` ((S,) n, c) in each shard's DFS order."""
        di = self._di
        if not di.stacked:
            return x[di.order].contiguous()
        return torch.stack([x[s][di.order[s]]
                            for s in range(di.num_shards)])

    def _build_pos_replica(self) -> None:
        """Position-ordered copies of the scan corpus: row i is the object
        at DFS rank i (``order[i]``), so an antichain node's objects are
        the contiguous slice ``[start, start + count)``. The attrs come
        from ``_scan_attrs``, so padded rows and tombstones stay NaN. The
        vectors keep the corpus's dtype (f32 or bf16): window lanes scan
        the corpus itself, never a quantized replica."""
        self._pos_vecs = self._by_order(self._di.vecs)
        self._pos_attrs = self._by_order(self._scan_attrs)

    def _build_scan_attrs(self) -> None:
        """The scan's attrs: padded rows (shard stacking pads every shard
        to the largest) get NaN, which fails every box, so a scan never
        returns them."""
        di = self._di
        n_real = torch.as_tensor(self._n_shard, device=self.device)
        valid = torch.arange(di.n, device=self.device) < n_real[:, None]
        if not di.stacked:
            valid = valid[0]
        self._scan_attrs = torch.where(valid[..., None], di.attrs,
                                       torch.full_like(di.attrs, np.nan))

    def _build_estimators(self, deleted_rows=None):
        """One routing-bound estimator per shard from host copies of its
        tree. ``deleted_rows``, the row ids of streaming tombstones
        (DESIGN.md §11; a list of per-shard local ids on a sharded index),
        subtracts the dead rows from each node's count, so the bound
        covers live rows only."""
        from .router import deleted_per_node

        if deleted_rows is not None and not self._sharded:
            deleted_rows = [deleted_rows]
        ests = []
        for s, di in enumerate(self._shards()):
            host = {f: getattr(di, f).cpu().numpy()
                    for f in ("left", "right", "dim", "bl", "lo", "hi",
                              "count")}
            count = host["count"].astype(np.int64)
            if deleted_rows is not None and np.asarray(
                    deleted_rows[s]).size:
                count = count - deleted_per_node(
                    di.order[:int(self._n_shard[s])].cpu().numpy(),
                    di.start.cpu().numpy(), count, deleted_rows[s])
            ests.append(HostCardEstimator(
                host["left"], host["right"], host["dim"], host["bl"],
                host["lo"], host["hi"], count, di.root, device=self.device))
        return ests

    def refresh_index(self, index, *, deleted_rows=None) -> None:
        """Rebind to a copy of the installed index with the same shapes,
        the streaming tombstone path (DESIGN.md §11): a delete NaNs attr
        rows and touches no other tensor. Re-derives the replica if the
        copy lacks it, rebuilds the scan attrs, the estimators (with
        ``deleted_rows``' tombstone-adjusted counts) and, under hybrid,
        the position-ordered attrs alone (the vectors did not change),
        and clears the plan cache. A new epoch needs a new Planner.
        ``deleted_rows`` is a list of per-shard local row ids on a sharded
        index, as ``StreamingState.deleted_locals`` gives it."""
        if not isinstance(index, DeviceIndex) and not _is_sharded(index):
            raise TypeError("refresh_index takes a DeviceIndex or a "
                            "ShardedKHI of the same shapes as the installed "
                            "one")
        di = index.di if _is_sharded(index) else index
        if _is_sharded(index) != self._sharded \
                or di.attrs.shape != self._di.attrs.shape \
                or di.vecs.shape != self._di.vecs.shape \
                or di.vecs.dtype != self._di.vecs.dtype:
            raise ValueError("refresh_index requires identical index shapes"
                             " and corpus dtype (use a new Planner for a "
                             "new epoch)")
        self._bind(index, _with_replica_for(di, self.params.quant))
        self._build_scan_attrs()
        self._host_scan_attrs = None
        if self.params.strategy in ("auto", "hybrid"):
            self._estimators = self._build_estimators(deleted_rows)
        if self.params.strategy == "hybrid":
            self._pos_attrs = self._by_order(self._scan_attrs)
        self._plan_cache.clear()

    def _cards(self, qlo: np.ndarray, qhi: np.ndarray) -> np.ndarray:
        """Per-query routing bound through the plan cache."""
        B = qlo.shape[0]
        out = np.zeros(B, np.int64)
        keys, miss = [], []
        for i in range(B):
            h = hashlib.blake2b(digest_size=16)
            h.update(self._plan_salt)
            h.update(qlo[i].tobytes())
            h.update(qhi[i].tobytes())
            key = h.digest()
            keys.append(key)
            hit = self._plan_cache.get(key)
            if hit is None:
                miss.append(i)
            else:
                self._plan_cache.move_to_end(key)
                out[i] = hit
        if miss:
            mi = np.asarray(miss)
            card = sum(est.cards(qlo[mi], qhi[mi])
                       for est in self._estimators)
            for j, i in enumerate(miss):
                out[i] = card[j]
                self._plan_cache[keys[i]] = int(card[j])
            while len(self._plan_cache) > self.plan_cache_size:
                self._plan_cache.popitem(last=False)
        return out

    def plan(self, qlo: np.ndarray, qhi: np.ndarray) -> Plan:
        qlo = np.ascontiguousarray(qlo, np.float32)
        qhi = np.ascontiguousarray(qhi, np.float32)
        B = qlo.shape[0]
        p = self.params
        if p.strategy in ("graph", "scan"):
            return Plan(card=np.full(B, -1, np.int64),
                        use_scan=np.full(B, p.strategy == "scan"),
                        threshold=self.scan_threshold)
        card = self._cards(qlo, qhi)
        if p.strategy != "hybrid":
            return Plan(card=card,
                        use_scan=(card > 0) & (card <= self.scan_threshold),
                        threshold=self.scan_threshold)
        # hybrid: classify each lane by its antichain's node sizes, on the
        # raw node counts (the rows a window scan reads)
        thr = self.node_scan_threshold
        n_small, n_large, pairs = self._classify_nodes(qlo, qhi, thr)
        mode = np.zeros(B, np.int8)
        mode[(n_large == 0) & (card > 0)] = 1          # pure-window: exact
        mode[(n_large > 0) & (n_small > 0)] = 2        # mixed
        return Plan(card=card, use_scan=(mode == 1),
                    threshold=self.scan_threshold, node_threshold=thr,
                    mode=mode, n_windows=n_small, small_nodes=pairs)

    def _classify_nodes(self, qlo: np.ndarray, qhi: np.ndarray, thr: int):
        """Per lane, the antichain's small (0 < count <= thr) and large
        (count > thr) node counts over every shard as numpy int64 (B,),
        and per shard the small nodes as device (lane, node) int64 pairs,
        by lane then node."""
        n_small, n_large, pairs = 0, 0, []
        for est, di in zip(self._estimators, self._shards()):
            a, b, pr = self._classify_shard(est, di, qlo, qhi, thr)
            n_small, n_large = n_small + a, n_large + b
            pairs.append(pr)
        return n_small, n_large, pairs

    def _classify_shard(self, est, di, qlo, qhi, thr: int):
        """``_classify_nodes`` for one shard's estimator. The antichain is
        evaluated on the device one chunk of lanes at a time (the
        estimator's ``chunk_elems`` bound), and only the pairs leave each
        chunk."""
        cnt = di.count.to(est.device)
        small_node = (cnt > 0) & (cnt <= thr)
        large_node = cnt > thr
        P = cnt.shape[0]
        B = qlo.shape[0]
        step = max(1, est.chunk_elems // max(1, P))
        n_small, n_large, lanes, nodes = [], [], [], []
        for s in range(0, B, step):
            anti = est.antichain(qlo[s:s + step], qhi[s:s + step])
            small = anti & small_node
            n_small.append(small.sum(1))
            n_large.append((anti & large_node).sum(1))
            nz = torch.nonzero(small)                  # row-major order
            lanes.append(nz[:, 0] + s)
            nodes.append(nz[:, 1])
        if not n_small:
            z = np.zeros(0, np.int64)
            e = torch.zeros(0, dtype=torch.int64, device=self.device)
            return z, z, (e, e)
        return (torch.cat(n_small).cpu().numpy().astype(np.int64),
                torch.cat(n_large).cpu().numpy().astype(np.int64),
                (torch.cat(lanes).to(self.device),
                 torch.cat(nodes).to(self.device)))

    def _build_windows(self, small_nodes: list, idx: np.ndarray, bp: int):
        """Window arrays for the (non-empty) lanes ``idx``, padded to
        ``bp`` rows:
        (starts (S, bp, W) int32, counts (S, bp, W) int32 device tensors,
        w_cap). Each lane's windows are its small antichain nodes' raw
        ``[start, count)`` DFS extents, ascending by start; W and w_cap
        (the largest count) round up to powers of two, as in the
        reference. Pad windows are (-1, 0). Built on the device from the
        plan's (lane, node) pairs."""
        dev = self.device
        idx_t = torch.as_tensor(np.asarray(idx, np.int64), device=dev)
        srt = torch.argsort(idx_t)
        idx_s = idx_t[srt]
        n_pos = self._di.n + 1
        per_shard = []
        max_w, max_c = 1, 1
        for (lane, node), di in zip(small_nodes, self._shards()):
            at = torch.searchsorted(idx_s, lane).clamp_max(idx_s.numel() - 1)
            hit = idx_s[at] == lane
            row = srt[at[hit]]
            st = di.start[node[hit]]
            ct = di.count[node[hit]]
            keep = ct > 0
            row, st, ct = row[keep], st[keep], ct[keep]
            o = torch.argsort(row * n_pos + st)        # (row, start)
            row, st, ct = row[o], st[o], ct[o]
            nw = torch.bincount(row, minlength=bp)
            rank = torch.arange(row.numel(), device=dev) \
                - (torch.cumsum(nw, 0) - nw)[row]
            if row.numel():
                max_w = max(max_w, int(nw.max()))
                max_c = max(max_c, int(ct.max()))
            per_shard.append((row, rank, st, ct))
        W = pow2_at_least(max_w)
        w_cap = pow2_at_least(max_c)
        S = len(small_nodes)
        starts = torch.full((S, bp, W), -1, dtype=torch.int32, device=dev)
        counts = torch.zeros((S, bp, W), dtype=torch.int32, device=dev)
        for s, (row, rank, st, ct) in enumerate(per_shard):
            starts[s, row, rank] = st.to(torch.int32)
            counts[s, row, rank] = ct.to(torch.int32)
        return starts, counts, w_cap

    def _run_windows(self, qs, lo, hi, starts, counts):
        """Exact windowed scan over the position-ordered replica: the
        kernel's positions map through ``order`` to ids. Window lanes
        report hops = 0. The port's kernel reads only the rows inside
        each window, so it needs no ``w_cap`` padding of the corpus."""
        q, ql, qh = self._tensors(qs, lo, hi)
        k = self.params.k
        if not self._sharded:
            ids, dd = _windows_one(self._pos_vecs, self._pos_attrs,
                                   self._di.order, q, ql, qh,
                                   starts[0].contiguous(),
                                   counts[0].contiguous(), k,
                                   use_kernel=self._use_kernel)
        else:
            ids, dd = _fan_in(
                [_windows_one(self._pos_vecs[s], self._pos_attrs[s],
                              self._di.order[s], q, ql, qh,
                              starts[s].contiguous(), counts[s].contiguous(),
                              k, use_kernel=self._use_kernel)
                 for s in range(self._di.num_shards)],
                self._di.num_shards, k)
        return (ids.to(torch.int32).cpu().numpy(), dd.cpu().numpy(),
                np.zeros(qs.shape[0], np.int32))

    @staticmethod
    def _pad_pow2(qs, lo, hi):
        """Pad a sub-batch to the next power of two with empty-box lanes
        (lo=+inf > hi=-inf: no entries and no in-range rows)."""
        b = qs.shape[0]
        pad = pow2_at_least(b) - b
        if pad:
            qs = np.concatenate([qs, np.zeros((pad,) + qs.shape[1:],
                                              np.float32)])
            lo = np.concatenate([lo, np.full((pad,) + lo.shape[1:],
                                             np.inf, np.float32)])
            hi = np.concatenate([hi, np.full((pad,) + hi.shape[1:],
                                             -np.inf, np.float32)])
        return qs, lo, hi

    def _tensors(self, *arrays):
        return [torch.as_tensor(a, dtype=torch.float32).to(self.device)
                for a in arrays]

    def _run_graph(self, qs, lo, hi):
        """The graph program; on a sharded index every shard's walk,
        merged, with each lane's hops the max over shards."""
        q, ql, qh = self._tensors(qs, lo, hi)
        p = self.params
        if not self._sharded:
            ids, dists, hops = _query_batch(self._di, q, ql, qh, p,
                                            self._scorer, self._exact)
        else:
            gids, dists, hops = _shard_search(self._di, q, ql, qh, p,
                                              self._scorer, self._exact)
            ids, dists = _merge_topk(gids, dists, p.k)
            hops = hops.amax(0)
        return (ids.to(torch.int32).cpu().numpy(), dists.cpu().numpy(),
                hops.to(torch.int32).cpu().numpy())

    def _run_scan(self, qs, lo, hi):
        """The exact scan program, once per shard on a sharded index."""
        q, ql, qh = self._tensors(qs, lo, hi)
        p, S = self.params, self._di.num_shards
        if not self._sharded:
            ids, dists = _scan_shard_topk(self._di, self._scan_attrs, q, ql,
                                          qh, p, use_kernel=self._use_kernel)
        else:
            ids, dists = _fan_in(
                [_scan_shard_topk(di, self._scan_attrs[s], q, ql, qh, p,
                                  use_kernel=self._use_kernel)
                 for s, di in enumerate(self._shards())], S, p.k)
        return (ids.to(torch.int32).cpu().numpy(), dists.cpu().numpy(),
                np.zeros(qs.shape[0], np.int32))

    def search(self, queries, qlo, qhi):
        """(B, d) x (B, m) x (B, m) -> (ids (B, k) int32, dists (B, k)
        f32, hops (B,) int32, Plan); scan lanes carry hops = 0."""
        queries = np.ascontiguousarray(queries, np.float32)
        qlo = np.ascontiguousarray(qlo, np.float32)
        qhi = np.ascontiguousarray(qhi, np.float32)
        plan = self.plan(qlo, qhi)
        B, k = queries.shape[0], self.params.k
        if plan.mode is not None:
            return self._search_hybrid(queries, qlo, qhi, plan)
        scan_idx = np.nonzero(plan.use_scan)[0]
        graph_idx = np.nonzero(~plan.use_scan)[0]
        if not len(graph_idx):
            ids, dists, hops = self._run_scan(queries, qlo, qhi)
            return ids, dists, hops, plan
        if not len(scan_idx):
            ids, dists, hops = self._run_graph(queries, qlo, qhi)
            return ids, dists, hops, plan
        out_ids = np.full((B, k), -1, np.int32)
        out_d = np.full((B, k), np.inf, np.float32)
        out_h = np.zeros((B,), np.int32)
        for idx, run in ((graph_idx, self._run_graph),
                         (scan_idx, self._run_scan)):
            qs, lo, hi = self._pad_pow2(queries[idx], qlo[idx], qhi[idx])
            ids, dists, hops = run(qs, lo, hi)
            out_ids[idx] = ids[: len(idx)]
            out_d[idx] = dists[: len(idx)]
            out_h[idx] = hops[: len(idx)]
        return out_ids, out_d, out_h, plan

    def _search_hybrid(self, queries, qlo, qhi, plan: Plan):
        """Three-way lane split: mode 0 = graph walk, mode 1 = pure-window
        (exact, hops = 0), mode 2 = mixed: the unrestricted graph walk
        plus the small-node windows, merged on the host with id-level
        dedup (the walk may find window rows again)."""
        B, k = queries.shape[0], self.params.k
        out_ids = np.full((B, k), -1, np.int32)
        out_d = np.full((B, k), np.inf, np.float32)
        out_h = np.zeros((B,), np.int32)
        for m in (0, 1, 2):
            idx = np.nonzero(plan.mode == m)[0]
            if not len(idx):
                continue
            qs, lo, hi = self._pad_pow2(queries[idx], qlo[idx], qhi[idx])
            if m == 0:
                ids, dists, hops = self._run_graph(qs, lo, hi)
            else:
                starts, counts, _w_cap = self._build_windows(
                    plan.small_nodes, idx, qs.shape[0])
                ids, dists, hops = self._run_windows(qs, lo, hi, starts,
                                                     counts)
                if m == 2:
                    gids, gd, hops = self._run_graph(qs, lo, hi)
                    ids, dists = _merge_dedup(
                        gids[: len(idx)], gd[: len(idx)],
                        ids[: len(idx)], dists[: len(idx)], k)
            out_ids[idx] = ids[: len(idx)]
            out_d[idx] = dists[: len(idx)]
            out_h[idx] = hops[: len(idx)]
        return out_ids, out_d, out_h, plan

    def _run_mask(self, queries: np.ndarray, prog):
        """Dense-fallback execution (DESIGN.md §15): evaluate the
        normalized expression on the host over the NaN-masked scan attrs
        into a per-row f32 plane, then one exact bitmask scan of the
        corpus. The batch pads to a power of two with zero queries."""
        from .predicate import eval_expr

        if self._host_scan_attrs is None:
            self._host_scan_attrs = self._scan_attrs.cpu().numpy()
        mask = eval_expr(prog.expr, self._host_scan_attrs).astype(np.float32)
        B = queries.shape[0]
        bp = pow2_at_least(B)
        qs = queries if bp == B else np.concatenate(
            [queries, np.zeros((bp - B,) + queries.shape[1:], np.float32)])
        q, = self._tensors(qs)
        mask = torch.as_tensor(mask).to(self.device)
        k = self.params.k
        if not self._sharded:
            ids, dd = _mask_scan_one(self._di.vecs, mask, q, k,
                                     use_kernel=self._use_kernel)
        else:
            ids, dd = _fan_in(
                [_mask_scan_one(self._di.vecs[s], mask[s], q, k,
                                use_kernel=self._use_kernel)
                 for s in range(self._di.num_shards)],
                self._di.num_shards, k)
        return (ids.to(torch.int32).cpu().numpy()[:B], dd.cpu().numpy()[:B],
                np.zeros(B, np.int32))

    @staticmethod
    def _count_lanes(plan: Plan, lanes: dict, B: int) -> None:
        """Fold one box's dispatch into the per-strategy lane counters
        (``PredicatePlan.lanes``; mixed hybrid lanes count under both)."""
        if plan.mode is not None:
            lanes["graph"] += int(((plan.mode == 0) | (plan.mode == 2)).sum())
            lanes["window"] += int(((plan.mode == 1) | (plan.mode == 2)).sum())
        else:
            ns = int(plan.use_scan.sum())
            lanes["scan"] += ns
            lanes["graph"] += B - ns

    def search_expr(self, queries, expr):
        """Compiled-predicate search (DESIGN.md §15): (B, d) queries x one
        boolean filter expression -> (ids (B, k) int32, dists (B, k) f32,
        hops (B,) int32, PredicatePlan).

        "boxes" programs run each disjoint box through ``search`` (any
        strategy, plan cache shared) and merge the per-box streams with
        ``_merge_dedup``; the cover is disjoint, so dedup only collapses
        the (+inf, -1) pads. ``hops`` sums over boxes. "bitmask" programs
        run one exact fallback scan of the corpus (hops 0)."""
        from .predicate import compile_expr

        queries = np.ascontiguousarray(queries, np.float32)
        p = self.params
        m = int(self._di.attrs.shape[-1])
        prog = compile_expr(expr, m, box_budget=p.box_budget)
        B, k = queries.shape[0], p.k
        lanes = {"graph": 0, "scan": 0, "window": 0}
        if prog.mode == "bitmask":
            ids, dists, hops = self._run_mask(queries, prog)
            lanes["scan"] = B
            return ids, dists, hops, PredicatePlan(
                mode="bitmask", n_boxes=0, lanes=lanes, box_plans=[],
                program=prog)
        out_ids = out_d = None
        out_h = np.zeros(B, np.int32)
        box_plans = []
        for b in range(prog.n_boxes):
            qlo = np.ascontiguousarray(
                np.broadcast_to(prog.lo[b], (B, m)), np.float32)
            qhi = np.ascontiguousarray(
                np.broadcast_to(prog.hi[b], (B, m)), np.float32)
            ids, dists, hops, plan = self.search(queries, qlo, qhi)
            box_plans.append(plan)
            self._count_lanes(plan, lanes, B)
            out_h += hops
            if out_ids is None:
                out_ids, out_d = ids, dists
            else:
                out_ids, out_d = _merge_dedup(out_ids, out_d, ids, dists, k)
        return out_ids, out_d, out_h, PredicatePlan(
            mode="boxes", n_boxes=prog.n_boxes, lanes=lanes,
            box_plans=box_plans, program=prog)
