"""Batched RFANNS serving layer, ported from ``repro.serve.khi_service``.

``KHIService`` turns the engine into a service: shape-bucket micro-batching
(pad lanes carry the empty box lo=+inf, hi=-inf, so the planner's bound
is 0 and they take the graph program, which exits at once), an LRU
result cache keyed on (query, box, params, epoch) bytes, epoch
hot-swap, and ``search`` / ``submit`` + ``flush`` / ``serve_stream``
entry points. Every micro-batch runs through an ``engine.Planner``
(``strategy="graph"`` makes every lane a graph lane). With
``SearchParams.quant`` set, the service attaches the compressed corpus
replica to each epoch's index before its planner is built.
``search_expr`` and ``Request(expr=...)`` serve boolean filter
expressions (``core/predicate.py``): each disjoint box of the compiled
cover through the cached, bucketed ``search`` path, merged with
``_merge_dedup``, or one bitmask scan past ``box_budget``.

Streaming writes (DESIGN.md §11, ``core/delta.py``): after
``enable_streaming`` the service takes ``insert``, ``delete`` and
``compact``, answers with stable int64 external ids, and folds the delta
segment's exact scan into every bucket-padded batch before unpadding.
Every mutation bumps ``_mutation_seq``, which is part of the result
cache key. ``compact`` rebuilds the live corpus with the device builder
on the service's device and publishes it through ``swap_index``, which
refuses any other caller while streaming.

Degradation tiers (DESIGN.md §13): the service carries a ladder of
``SearchParams`` (``tiers=`` / ``set_tiers``) and every entry point takes
``tier=``; tier 0 is the full-quality default. Each tier has its own
validated params and a planner built on first use against the same index,
all planners share one plan cache (the routing bound is tier-invariant),
one compressed replica serves every quantized tier, and the result cache
key carries the tier. ``serve/scheduler.py`` steps batches down the
ladder under load.

Sharded corpora (``core/sharded.py``): a ``ShardedKHI`` is served by the
same planners, which fan every program out over its shards and merge
into global ids; streaming keeps one delta per shard and ``compact``
rebuilds through ``build_sharded``.

Mesh serving (DESIGN.md §14): with ``mesh=`` (``launch.mesh.
make_query_mesh``) every tier's micro-batches run through its own
collective program (``sharded.make_sharded_search_fn``), whose dispatch
runs inside the collective, so there is no host ``Plan`` and
``scan_lanes`` is not tracked. The service runs as one program on every
rank (SPMD, as ``torchrun`` runs it): each rank must drive the same
requests in the same order, so that every rank forms the same batches
from the same cache; each batch's agreement check turns a rank out of
step into an error. ``search_expr`` and streaming refuse a mesh, as in
the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.delta import StreamingState
from ..core.engine import (DeviceIndex, Planner, SearchParams, _is_sharded,
                           _merge_dedup, _with_replica_for,
                           device_put_index, validate_search_params)
from ..core.khi import KHIConfig, KHIIndex
from ..core.predicate import canonical_key, compile_expr, validate_expr
from ..core.sharded import build_sharded
from ..core.util import resolve_device

__all__ = ["ServeConfig", "Request", "Result", "KHIService"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service-level knobs (index/search knobs live in SearchParams)."""

    buckets: Tuple[int, ...] = (1, 8, 32, 128)
    cache_size: int = 4096

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)) \
                or self.buckets[0] <= 0:
            raise ValueError("buckets must be a sorted tuple of distinct "
                             f"positive sizes, got {self.buckets!r}")
        if self.cache_size < 0:
            raise ValueError(f"cache_size must be >= 0 (0 disables), got "
                             f"{self.cache_size}")

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]


@dataclasses.dataclass
class Request:
    """One RFANNS query: a vector and exactly one filter form, a
    per-attribute [lo, hi] box (``lo``/``hi``) or a boolean predicate
    expression (``expr=``) compiled at serve time."""

    query: np.ndarray
    lo: Optional[np.ndarray] = None
    hi: Optional[np.ndarray] = None
    expr: Optional[object] = None

    def __post_init__(self):
        if self.expr is None:
            if self.lo is None or self.hi is None:
                raise ValueError(
                    "Request needs a filter: pass both lo= and hi= (range "
                    "box) or expr= (predicate expression, DESIGN.md §15)")
        elif self.lo is not None or self.hi is not None:
            raise ValueError(
                "Request mixes expr= with lo/hi — a compiled predicate "
                "already encodes its boxes; pass exactly one filter form")


@dataclasses.dataclass
class Result:
    ids: np.ndarray    # (k,) int32 object ids, -1 padded
    dists: np.ndarray  # (k,) float32 squared L2, inf padded
    cached: bool = False
    # with streaming enabled, ids are (k,) int64 stable external ids,
    # which survive compaction


class KHIService:
    """Micro-batching, caching front-end over one KHI index (a host
    ``KHIIndex``, a ``DeviceIndex`` or a ``ShardedKHI``) on ``device``
    (default ``cuda``); with ``mesh=`` a ``ShardedKHI`` served by the
    collective program on every rank of the mesh.
    A legacy ``dist_fn(q, rows)`` overrides the graph path's scorer of
    every planner or collective program the service builds."""

    def __init__(self, index, params: Optional[SearchParams] = None, *,
                 config: Optional[ServeConfig] = None, mesh=None,
                 device=None, dist_fn=None, on_undersized: str = "adjust",
                 tiers: Sequence[SearchParams] = ()):
        if on_undersized not in ("raise", "adjust", "ignore"):
            raise ValueError(f"on_undersized must be raise|adjust|ignore, "
                             f"got {on_undersized!r}")
        self._mesh = mesh
        self._tier_user: Tuple[SearchParams, ...] = (
            params or SearchParams(),) + tuple(tiers)
        self._check_tiers(self._tier_user)
        self._legacy_dist_fn = dist_fn
        self._on_undersized = on_undersized
        self._device = device
        self.config = config or ServeConfig()
        self.epoch = 0
        self._cache: "collections.OrderedDict[bytes, Tuple[np.ndarray, np.ndarray]]" = (
            collections.OrderedDict())
        self._pending: List[Tuple[int, Request]] = []
        self._next_ticket = 0
        self.stats = {
            "requests": 0, "cache_hits": 0, "batches": 0, "pad_lanes": 0,
            "device_queries": 0, "traced_buckets": set(),
            "device_seconds": 0.0, "epoch_swaps": 0, "scan_lanes": 0,
            "inserts": 0, "deletes": 0, "compactions": 0,
            "ingest_seconds": 0.0, "compact_seconds": 0.0,
            "tier_lanes": collections.Counter(),
            "predicate_lanes": collections.Counter(),
        }
        # stats["predicate_lanes"] while a compiled predicate runs, so the
        # dispatch attributes its device lanes to it; None otherwise
        self._pred_lanes: Optional[collections.Counter] = None
        self._stream: Optional[StreamingState] = None
        self._mutation_seq = 0
        self._compacting = False
        self._install_index(index)

    @staticmethod
    def _check_tiers(tier_user: Tuple[SearchParams, ...]) -> None:
        """Ladder rules (DESIGN.md §13): a degraded tier trades recall,
        never the result contract of tier 0: the same k (results, cache
        entries and the streaming merge are k-shaped) and one replica
        dtype across the quantized tiers (the index carries one)."""
        base = tier_user[0]
        for t, p in enumerate(tier_user[1:], start=1):
            if p.k != base.k:
                raise ValueError(
                    f"degradation tier {t} changes k ({p.k} != {base.k}): "
                    f"tiers degrade recall, never the result shape")
        quants = {p.quant for p in tier_user if p.quant != "none"}
        if len(quants) > 1:
            raise ValueError(
                f"degradation tiers mix quantized replicas {sorted(quants)}; "
                f"the index carries one compressed replica — use a single "
                f"quant across the ladder")

    def set_tiers(self, tiers: Sequence[SearchParams]) -> None:
        """(Re)install the degradation ladder: tier 0 stays the
        construction-time params, ``tiers[i]`` becomes step ``i+1``. The
        planners are rebuilt against the live index; the result cache
        stays valid (its keys carry the tier's params)."""
        new = (self._tier_user[0],) + tuple(tiers)
        self._check_tiers(new)
        self._tier_user = new
        self._install_index(self.index)

    @property
    def n_tiers(self) -> int:
        return len(self._tier_user)

    def _install_index(self, index) -> None:
        """Bind an index: validate every tier's params against it, attach
        the one compressed replica any tier wants (once per epoch), and
        reset the per-tier planners, which share one plan cache. Tier 0's
        planner is built here, the others on first use."""
        self._sharded = _is_sharded(index)
        if self._mesh is not None and not self._sharded:
            raise ValueError(
                "mesh= serving needs a ShardedKHI (the collective program "
                "serves shard s of the stacked index on model rank s — "
                "DESIGN.md §14)")
        if not self._sharded and not isinstance(index, DeviceIndex):
            index = device_put_index(index, device=resolve_device(
                self._device))
        di = index.di if self._sharded else index
        self._tier_params: Tuple[SearchParams, ...] = tuple(
            validate_search_params(up, di,
                                   on_undersized=self._on_undersized)
            for up in self._tier_user)
        self.params = self._tier_params[0]
        quants = {p.quant for p in self._tier_params if p.quant != "none"}
        if quants:
            di = _with_replica_for(di, quants.pop())
            index = (dataclasses.replace(index, di=di) if self._sharded
                     else di)
        self.index = index
        self._plan_cache: "collections.OrderedDict[bytes, int]" = (
            collections.OrderedDict())
        self._planners: dict = {}
        self._search_fns: dict = {}
        if self._mesh is not None:
            self._get_search_fn(0)
        else:
            self._get_planner(0)

    def swap_index(self, index, *, params: Optional[SearchParams] = None,
                   drain: bool = True) -> dict:
        """Epoch hot-swap: flush queued requests against the old index
        (unless ``drain=False``), install the new one, bump the epoch and
        clear the result cache. Returns the drained {ticket: Result}.
        While streaming, only ``compact`` may publish an epoch: a bare
        swap would drop the delta and the ext-id mapping."""
        if self._stream is not None and not self._compacting:
            raise RuntimeError(
                "swap_index while streaming is enabled would drop the delta "
                "segment and the ext-id mapping; publish new epochs through "
                "compact() (DESIGN.md §11)")
        drained = self.flush() if drain else {}
        if params is not None:
            new = (params,) + self._tier_user[1:]
            self._check_tiers(new)
            self._tier_user = new
        self._install_index(index)
        self.epoch += 1
        self._cache.clear()
        self.stats["epoch_swaps"] += 1
        return drained

    @property
    def _planner(self) -> Planner:
        """Tier 0's planner."""
        return self._planners[0]

    @property
    def _di(self) -> DeviceIndex:
        """The installed index's tensors (stacked over a sharded one)."""
        return self.index.di if self._sharded else self.index

    @property
    def d(self) -> int:
        return self._di.vecs.shape[-1]

    @property
    def m(self) -> int:
        return self._di.attrs.shape[-1]

    def _get_planner(self, tier: int) -> Planner:
        """``tier``'s planner, built on first use: an unused ladder step
        costs nothing. Every planner reads the service's plan cache. One
        first built after streaming deletes gets the tombstone-adjusted
        counts; a new epoch's (built while ``compact`` publishes it)
        gets none, since the old epoch's tombstones are not its rows."""
        planner = self._planners.get(tier)
        if planner is None:
            planner = Planner(self.index, self._tier_params[tier],
                              dist_fn=self._legacy_dist_fn,
                              on_undersized=self._on_undersized,
                              plan_cache=self._plan_cache,
                              plan_salt=self.epoch.to_bytes(8, "little"))
            if self._stream is not None and not self._compacting:
                planner.refresh_index(
                    self.index, deleted_rows=self._stream.deleted_locals())
            self._planners[tier] = planner
        return planner

    def _get_search_fn(self, tier: int):
        """``tier``'s collective program (mesh serving), built on first
        use against the installed index."""
        fn = self._search_fns.get(tier)
        if fn is None:
            from ..core.sharded import make_sharded_search_fn
            fn = self._search_fns[tier] = make_sharded_search_fn(
                self._tier_params[tier], self._mesh,
                dist_fn=self._legacy_dist_fn, skhi=self.index,
                on_undersized=self._on_undersized, tier=tier)
        return fn

    def _check_tier(self, tier: int) -> None:
        if not 0 <= tier < len(self._tier_params):
            raise ValueError(f"tier must be in [0, {len(self._tier_params)})"
                             f", got {tier} (install ladders via tiers= / "
                             f"set_tiers)")

    def _bucket(self, b: int) -> int:
        for size in self.config.buckets:
            if b <= size:
                return size
        return self.config.max_batch

    def _key(self, q: np.ndarray, lo: np.ndarray, hi: np.ndarray,
             tier: int = 0) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(q.tobytes())
        h.update(lo.tobytes())
        h.update(hi.tobytes())
        # the tier keys apart even where two tiers' params are equal: an
        # answer degraded under load is never served as a tier-0 hit
        h.update(tier.to_bytes(2, "little"))
        h.update(repr(self._tier_params[tier]).encode())
        h.update(self.epoch.to_bytes(8, "little"))
        # every insert, delete and compact bumps the sequence, so no
        # answer from before a mutation is served after it
        h.update(self._mutation_seq.to_bytes(8, "little"))
        return h.digest()

    def _cache_get(self, key: bytes):
        if not self.config.cache_size:
            return None
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
        return hit

    def _cache_put(self, key: bytes, ids: np.ndarray, dists: np.ndarray):
        if not self.config.cache_size:
            return
        self._cache[key] = (ids, dists)
        self._cache.move_to_end(key)
        while len(self._cache) > self.config.cache_size:
            self._cache.popitem(last=False)

    def _run_device(self, qs: np.ndarray, los: np.ndarray,
                    his: np.ndarray, tier: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad one micro-batch to its bucket, search at ``tier``, unpad.
        Under streaming the delta is merged on the padded batch (pad lanes
        carry the empty box and add nothing) and ids become ext ids."""
        b = qs.shape[0]
        bucket = self._bucket(b)
        pad = bucket - b
        if pad:
            qs = np.concatenate([qs, np.zeros((pad, self.d), np.float32)])
            los = np.concatenate(
                [los, np.full((pad, self.m), np.inf, np.float32)])
            his = np.concatenate(
                [his, np.full((pad, self.m), -np.inf, np.float32)])
        t0 = time.perf_counter()
        if self._mesh is not None:
            # the dispatch runs inside the collective: no host Plan
            ids, dists = self._get_search_fn(tier)(self.index, qs, los, his)
            ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
            plan = None
        else:
            # results come back as numpy, so the device work has finished
            ids, dists, _hops, plan = self._get_planner(tier).search(
                qs, los, his)
            self.stats["scan_lanes"] += int(plan.use_scan.sum())
        if self._pred_lanes is not None:
            # every device lane of a predicate box, pads included (a
            # graph strategy's plan makes them all graph lanes)
            Planner._count_lanes(plan, self._pred_lanes, bucket)
        if self._stream is not None:
            ids, dists = self._stream.merge(ids, dists, qs, los, his,
                                            self.params.k)
        self.stats["device_seconds"] += time.perf_counter() - t0
        self.stats["batches"] += 1
        self.stats["pad_lanes"] += pad
        self.stats["device_queries"] += bucket
        self.stats["traced_buckets"].add(bucket)
        self.stats["tier_lanes"][tier] += b
        return ids[:b], dists[:b]

    def _answer(self, queries: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                tier: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Cache-aware core: -> (ids (B, k), dists (B, k), hit (B,) bool)
        at degradation tier ``tier`` (the scheduler's entry). Batches
        larger than the top bucket are chunked."""
        queries = np.ascontiguousarray(queries, np.float32)
        lo = np.ascontiguousarray(lo, np.float32)
        hi = np.ascontiguousarray(hi, np.float32)
        B = queries.shape[0]
        self.stats["requests"] += B
        k = self.params.k
        out_ids = np.full((B, k), -1, self._id_dtype)
        out_d = np.full((B, k), np.inf, np.float32)
        hit_mask = np.zeros((B,), bool)
        caching = self.config.cache_size > 0
        keys = [self._key(queries[i], lo[i], hi[i], tier) if caching else None
                for i in range(B)]
        miss: List[int] = []
        for i, key in enumerate(keys):
            hit = self._cache_get(key) if caching else None
            if hit is not None:
                out_ids[i], out_d[i] = hit
                hit_mask[i] = True
                self.stats["cache_hits"] += 1
            else:
                miss.append(i)
        for c0 in range(0, len(miss), self.config.max_batch):
            chunk = miss[c0:c0 + self.config.max_batch]
            ids, dists = self._run_device(queries[chunk], lo[chunk],
                                          hi[chunk], tier)
            for j, i in enumerate(chunk):
                out_ids[i], out_d[i] = ids[j], dists[j]
                if caching:
                    self._cache_put(keys[i], ids[j], dists[j])
        return out_ids, out_d, hit_mask

    def search(self, queries: np.ndarray, lo: np.ndarray, hi: np.ndarray,
               *, tier: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Batch front door: (B, d) x (B, m) x (B, m) -> ids/dists (B, k)
        at degradation tier ``tier`` (0, full quality, by default)."""
        self._check_tier(tier)
        ids, dists, _ = self._answer(queries, lo, hi, tier)
        return ids, dists

    def search_expr(self, queries: np.ndarray, expr, *, tier: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Predicate front door: (B, d) queries x one boolean filter
        expression -> ids/dists (B, k). Box-mode programs serve each
        disjoint box through the cached, bucketed ``_answer`` path and
        merge the per-box streams with ``_merge_dedup``; bitmask programs
        run one exact f32 scan through the planner.
        ``stats["predicate_lanes"]`` counts the lanes either way.
        ``tier`` selects the degradation tier, as in ``search``."""
        self._check_tier(tier)
        if self._mesh is not None:
            raise ValueError(
                "search_expr with mesh=: compiled predicates do not lower "
                "through the collective program yet — the per-disjunct "
                "dispatch and the dedup merge run host-side. Serve "
                "predicates without a mesh (the one-process fan-out answers "
                "a ShardedKHI with the same semantics), or pre-lower the "
                "expression with core.predicate.compile_expr and issue its "
                "boxes as plain search() calls (DESIGN.md §15)")
        validate_expr(expr, self.m)
        queries = np.ascontiguousarray(queries, np.float32)
        B, k = queries.shape[0], self.params.k
        p = self._tier_params[tier]
        prog = compile_expr(expr, self.m, box_budget=p.box_budget)
        if prog.mode == "bitmask":
            if self._stream is not None:
                raise ValueError(
                    f"predicate compiled to the bitmask fallback (cover "
                    f"exceeds box_budget={p.box_budget}) while "
                    f"streaming is enabled: the host mask plane cannot see "
                    f"delta rows (DESIGN.md §11/§15). Raise "
                    f"SearchParams.box_budget so the cover fits, simplify "
                    f"the expression, or compact() first")
            self.stats["requests"] += B
            self.stats["predicate_lanes"]["bitmask"] += B
            ids, dists, _hops = self._get_planner(tier)._run_mask(queries,
                                                                  prog)
            return ids, dists
        out_ids = np.full((B, k), -1, self._id_dtype)
        out_d = np.full((B, k), np.inf, np.float32)
        m = self.m
        self._pred_lanes = self.stats["predicate_lanes"]
        try:
            for b in range(prog.n_boxes):
                lo = np.ascontiguousarray(
                    np.broadcast_to(prog.lo[b], (B, m)), np.float32)
                hi = np.ascontiguousarray(
                    np.broadcast_to(prog.hi[b], (B, m)), np.float32)
                ids, dists, _hit = self._answer(queries, lo, hi, tier)
                if b == 0:
                    out_ids, out_d = ids, dists
                else:
                    # disjoint cover: dedup only collapses (-1, inf) pads
                    out_ids, out_d = _merge_dedup(out_ids, out_d, ids,
                                                  dists, k,
                                                  out_dtype=self._id_dtype)
        finally:
            self._pred_lanes = None
        return out_ids, out_d

    def submit(self, req: Request) -> int:
        """Enqueue one request; returns a ticket for flush()'s result dict."""
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, req))
        return ticket

    def _run_batch(self, batch: Sequence[Request]) -> List[Result]:
        """Answer one mixed batch: the box requests as one micro-batch
        through ``_answer``, the predicate requests grouped by their
        expression's ``canonical_key``, each group one ``search_expr``
        batch. Predicate Results report ``cached=False``: a merged
        multi-box answer is not one cache entry."""
        results: List[Optional[Result]] = [None] * len(batch)
        box_idx = [j for j, r in enumerate(batch) if r.expr is None]
        if box_idx:
            qs = np.stack([batch[j].query for j in box_idx]).astype(np.float32)
            los = np.stack([batch[j].lo for j in box_idx]).astype(np.float32)
            his = np.stack([batch[j].hi for j in box_idx]).astype(np.float32)
            ids, dists, hit = self._answer(qs, los, his)
            for i, j in enumerate(box_idx):
                results[j] = Result(ids=ids[i], dists=dists[i],
                                    cached=bool(hit[i]))
        groups: "collections.OrderedDict[bytes, List[int]]" = (
            collections.OrderedDict())
        for j, r in enumerate(batch):
            if r.expr is not None:
                groups.setdefault(canonical_key(r.expr), []).append(j)
        for idx in groups.values():
            qs = np.stack([batch[j].query for j in idx]).astype(np.float32)
            ids, dists = self.search_expr(qs, batch[idx[0]].expr)
            for i, j in enumerate(idx):
                results[j] = Result(ids=ids[i], dists=dists[i])
        return results

    def flush(self) -> dict:
        """Run all pending requests (micro-batched); {ticket: Result}."""
        if not self._pending:
            return {}
        pending, self._pending = self._pending, []
        results = self._run_batch([r for _, r in pending])
        return {ticket: results[j] for j, (ticket, _) in enumerate(pending)}

    def serve_stream(self, requests: Iterable[Request]) -> Iterator[Result]:
        """Consume an iterator of requests, yield Results in order,
        micro-batching up to ``config.max_batch`` at a time."""
        batch: List[Request] = []
        for req in requests:
            batch.append(req)
            if len(batch) >= self.config.max_batch:
                yield from self._run_batch(batch)
                batch = []
        if batch:
            yield from self._run_batch(batch)

    @property
    def _id_dtype(self):
        """int64 ext ids under streaming, int32 row ids otherwise."""
        return np.int64 if self._stream is not None else np.int32

    # ---------------------------------------------------------- streaming
    def enable_streaming(self, *, capacity: int = 4096,
                         build_config: Optional[KHIConfig] = None
                         ) -> StreamingState:
        """Turn on the streaming write path (DESIGN.md §11): a delta
        segment of ``capacity`` rows per shard on the index's device,
        tombstoned deletes and ``compact()`` epoch publishing. Answers
        switch to stable int64 external ids (the seed corpus keeps
        ``0..n-1``). ``build_config`` is what compaction rebuilds with, by
        default the device builder."""
        if self._stream is not None:
            raise RuntimeError("streaming is already enabled")
        if self._mesh is not None:
            raise ValueError(
                "streaming with mesh=: the delta merge runs on the host "
                "after the collective fan-out returns — serve without a "
                "mesh (the one-process fan-out) to stream (DESIGN.md §11)")
        # the delta is scanned by the box-scan kernel whatever kernel
        # scores the graph (the graph-only backends have no scan form;
        # on a CPU tensor its wrapper computes the plain version), unless
        # the caller chose the plain backend
        backend = ("jnp" if self.params.backend == "jnp"
                   else "pallas_gather_l2_filter")
        self._stream = StreamingState(
            self.index, capacity=capacity,
            build_config=build_config or KHIConfig(builder="device"),
            backend=backend, quant=self.params.quant,
            rerank_mult=self.params.rerank_mult)
        self._note_mutation()
        return self._stream

    def _require_stream(self) -> StreamingState:
        if self._stream is None:
            raise RuntimeError("call enable_streaming() first")
        return self._stream

    def _note_mutation(self) -> None:
        """Bump the cache-key sequence; the eager clear keeps the store
        from holding unreachable entries."""
        self._mutation_seq += 1
        self._cache.clear()

    def insert(self, vecs: np.ndarray, attrs: np.ndarray) -> np.ndarray:
        """Append rows to the delta; returns their int64 ext ids.
        Compacts first when the batch would not fit."""
        st = self._require_stream()
        vecs = np.ascontiguousarray(np.atleast_2d(vecs), np.float32)
        attrs = np.ascontiguousarray(np.atleast_2d(attrs), np.float32)
        b = vecs.shape[0]
        t0 = time.perf_counter()
        if not st.fits(b):
            self.compact()
            if not st.fits(b):
                raise ValueError(
                    f"insert batch of {b} rows cannot fit the per-shard "
                    f"delta capacity {st.deltas[0].capacity} even after "
                    f"compaction")
        exts = st.insert(vecs, attrs)
        self.stats["inserts"] += b
        self.stats["ingest_seconds"] += time.perf_counter() - t0
        self._note_mutation()
        return exts

    def delete(self, ext_ids) -> int:
        """Tombstone rows by ext id (unknown and dead ids are skipped).
        Delta rows NaN their slots; base rows NaN their attr row in a
        copy of the index, which is installed and handed to every tier's
        planner with the tombstone-adjusted counts. Returns the rows
        deleted."""
        st = self._require_stream()
        t0 = time.perf_counter()
        new_index, n_del = st.delete(np.asarray(ext_ids), self.index)
        if new_index is not None:
            self.index = new_index
            dead = st.deleted_locals()
            for planner in self._planners.values():
                planner.refresh_index(new_index, deleted_rows=dead)
        self.stats["deletes"] += n_del
        self.stats["ingest_seconds"] += time.perf_counter() - t0
        if n_del:
            self._note_mutation()
        return n_del

    def compact(self) -> dict:
        """Fold the deltas and the tombstones into a fresh epoch: gather
        the live corpus, rebuild it with the stored build config on the
        service's device (through ``build_sharded`` over as many shards
        as before, when sharded), publish it through ``swap_index`` (queued
        requests flush against the old, delta-merged view first), then
        rebind the ext mapping. Returns the drained {ticket: Result}."""
        st = self._require_stream()
        t0 = time.perf_counter()
        vecs, attrs, exts = st.live_corpus(self.index)
        if not vecs.shape[0]:
            raise ValueError("cannot compact an index down to zero live "
                             "rows (delete less or rebuild explicitly)")
        dev = self._di.device
        if st.S > 1:
            new_index = build_sharded(vecs, attrs, st.S, st.build_config,
                                      device=dev)
        else:
            new_index = device_put_index(
                KHIIndex.build(vecs, attrs, st.build_config, device=dev),
                device=dev)
        self._compacting = True
        try:
            drained = self.swap_index(new_index)
        finally:
            self._compacting = False
        st.reset(self.index, exts)
        self.stats["compactions"] += 1
        self.stats["compact_seconds"] += time.perf_counter() - t0
        self._note_mutation()
        return drained

    def snapshot(self) -> dict:
        """JSON-able stats snapshot (the reference's keys)."""
        s = dict(self.stats)
        s["traced_buckets"] = sorted(s["traced_buckets"])
        s["tier_lanes"] = {str(t): int(n)
                           for t, n in sorted(s["tier_lanes"].items())}
        s["predicate_lanes"] = {str(strat): int(n) for strat, n
                                in sorted(s["predicate_lanes"].items())}
        s["cache_entries"] = len(self._cache)
        s["epoch"] = self.epoch
        dq, ds = s["device_queries"], s["device_seconds"]
        s["device_qps"] = (dq / ds) if ds > 0 else None
        if self._stream is not None:
            s["streaming"] = True
            s["n_live"] = self._stream.n_live
            s["delta_fill"] = [seg.size for seg in self._stream.deltas]
            s["tombstones"] = int(self._stream.base_deleted.sum())
        return s
