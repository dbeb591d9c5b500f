"""Streaming write path, ported from ``repro.core.delta``: a device delta
segment, base tombstones and the compaction bookkeeping (DESIGN.md §11).

The KHI index is immutable per epoch (tree ranges and graph rows are
position-encoded), so writes never touch the graph:

  * **DeltaSegment** — a fixed-capacity append buffer of ``(vecs,
    attrs)`` rows on the index's device, served exactly by the planner's
    scan path (``engine._scan_shard_topk``: the box-scan kernel on the
    fused-filter backend, its plain version on ``jnp``). Unwritten and
    deleted slots hold NaN attrs, so they fail every box and never enter
    a top-k. A write is plain slice assignment of exactly the new rows;
    the rows past ``size`` stay zero / NaN, the buffer the reference's
    padded writes leave, so answers are the same.
  * **Tombstones** — deleting a base row NaNs its attr row in a *copy*
    of the attrs (``dataclasses.replace``): every ``DeviceIndex`` that
    ``with_quant_replica`` derived shares its tensors, and so does the
    old epoch an epoch swap drains against, so an in-place write would
    change them too. The planner's cardinality bound subtracts the dead
    rows through ``router.deleted_per_node``.
  * **StreamingState** — the host coordinator: stable *external* ids
    (``ext``) that survive compaction, the base<->ext translation used
    when merging, and ``live_corpus()``, the rows a compaction rebuilds
    from, sorted by ext so that internal id order is ext order.

Merge contract: per query, the base engine's top-k and the delta's are
concatenated on the host and ranked by ``(dist, ext)``, lowest ext first
on ties, which is what makes the merged answer equal to a rebuild from
scratch on exact (scan-served) lanes.

Over a ``ShardedKHI`` of S shards there is one delta segment per shard,
each of ``capacity`` rows; an insert goes to shard ``ext % S``, a base
row's internal id is its global id (local * S + shard), its tombstone
NaNs the stacked attrs at (shard, local), and the merge folds every
segment's scan in.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .engine import (SCAN_BACKENDS, SearchParams, _is_sharded,
                     _scan_shard_topk, _shard_counts)
from .khi import KHIConfig
from .util import resolve_device
from ..kernels.quant import QUANTS, quantize_rows_i8

__all__ = ["DeltaSegment", "StreamingState"]

_EXT_SENTINEL = np.iinfo(np.int64).max


class DeltaSegment:
    """Fixed-capacity append buffer on ``device``, served by the exact
    scan. ``vecs`` (capacity, d) f32, ``attrs`` (capacity, m) f32 and the
    quant replica (bf16 ``qvecs``, or int8 ``qvecs`` plus a (capacity, 1)
    f32 ``qscale``) are tensors; the slot metadata (``ext_ids``, ``live``,
    the append high-water mark ``size``) is numpy. The scan always runs
    over the whole buffer: an empty tile costs the kernel its attrs only.
    """

    def __init__(self, capacity: int, d: int, m: int, *,
                 backend: str = "jnp", device=None, quant: str = "none",
                 rerank_mult: int = 4):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if backend not in SCAN_BACKENDS:
            raise ValueError(
                f"delta scans need a scan-capable backend {SCAN_BACKENDS}, "
                f"got {backend!r}")
        if quant not in QUANTS:
            raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
        self.capacity = int(capacity)
        self.d, self.m = int(d), int(m)
        self.quant = quant
        self.rerank_mult = int(rerank_mult)
        self.device = resolve_device(device)
        self._use_kernel = backend == "pallas_gather_l2_filter"
        self.clear()

    def clear(self) -> None:
        dev, cap = self.device, self.capacity
        self.vecs = torch.zeros((cap, self.d), dtype=torch.float32,
                                device=dev)
        self.attrs = torch.full((cap, self.m), float("nan"),
                                dtype=torch.float32, device=dev)
        # the replica is kept coherent on every insert; a delete NaNs only
        # the attrs, which mask the slot on every path
        if self.quant == "bf16":
            self.qvecs = torch.zeros((cap, self.d), dtype=torch.bfloat16,
                                     device=dev)
            self.qscale = None
        elif self.quant == "int8":
            self.qvecs = torch.zeros((cap, self.d), dtype=torch.int8,
                                     device=dev)
            self.qscale = torch.ones((cap, 1), dtype=torch.float32,
                                     device=dev)
        else:
            self.qvecs = self.qscale = None
        self.ext_ids = np.full(cap, -1, np.int64)
        self.live = np.zeros(cap, bool)
        self.size = 0

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    def room(self) -> int:
        return self.capacity - self.size

    def insert(self, vecs: np.ndarray, attrs: np.ndarray,
               ext_ids: np.ndarray) -> np.ndarray:
        """Append rows; returns the slot indices written."""
        b = vecs.shape[0]
        if b > self.room():
            raise ValueError(
                f"delta segment full: {b} rows > {self.room()} free slots "
                f"(capacity {self.capacity}); compact first")
        s, e = self.size, self.size + b
        v = torch.as_tensor(np.ascontiguousarray(vecs, np.float32)).to(
            self.device)
        self.vecs[s:e] = v
        self.attrs[s:e] = torch.as_tensor(
            np.ascontiguousarray(attrs, np.float32)).to(self.device)
        if self.quant == "bf16":
            self.qvecs[s:e] = v.to(torch.bfloat16)
        elif self.quant == "int8":
            qv, qs = quantize_rows_i8(v)
            self.qvecs[s:e] = qv
            self.qscale[s:e] = qs
        slots = np.arange(s, e)
        self.ext_ids[slots] = ext_ids
        self.live[slots] = True
        self.size = e
        return slots

    def delete(self, slots: np.ndarray) -> None:
        """Tombstone slots: NaN their attr rows (live mask on the host)."""
        slots = np.asarray(slots, np.int64)
        if not slots.size:
            return
        self.live[slots] = False
        self.attrs[torch.as_tensor(slots).to(self.device)] = float("nan")

    def scan(self, q, qlo, qhi, k: int
             ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Exact top-k over the live rows: (slots (B, k'), dists (B, k'))
        numpy with k' = min(k, capacity); None before the first append.
        The planner's scan path over the whole buffer (the segment has
        the ``DeviceIndex`` fields it reads): a quantized segment
        over-fetches ``min(max(k', k' * rerank_mult), capacity)`` from
        its replica and reranks through the f32 gather."""
        if self.size == 0:
            return None
        t = [torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(
            self.device) for a in (q, qlo, qhi)]
        p = SearchParams(k=min(k, self.capacity), quant=self.quant,
                         rerank_mult=self.rerank_mult)
        ids, dd = _scan_shard_topk(self, self.attrs, *t, p,
                                   use_kernel=self._use_kernel)
        return ids.cpu().numpy(), dd.cpu().numpy()

    def live_rows(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host copies of the live rows: (vecs, attrs, ext_ids)."""
        slots = np.nonzero(self.live)[0]
        sel = torch.as_tensor(slots).to(self.device)
        return (self.vecs[sel].cpu().numpy(), self.attrs[sel].cpu().numpy(),
                self.ext_ids[slots].copy())


class StreamingState:
    """Host coordinator of one service's streaming writes (DESIGN.md §11):
    the ext-id space, one delta segment per shard, the base tombstone
    bitmap and the merge. ``delete`` returns a copy of the index (a
    ``DeviceIndex`` or a ``ShardedKHI``) with NaN'd attr rows; installing
    it is the caller's job (``serve.KHIService``)."""

    def __init__(self, index, *, capacity: int,
                 build_config: Optional[KHIConfig] = None,
                 backend: str = "jnp", quant: str = "none",
                 rerank_mult: int = 4):
        self._sharded = _is_sharded(index)
        di = index.di if self._sharded else index
        self.S = index.num_shards if self._sharded else 1
        self.build_config = build_config or KHIConfig(builder="device")
        self.deltas: List[DeltaSegment] = [
            DeltaSegment(capacity, di.vecs.shape[-1], di.attrs.shape[-1],
                         backend=backend, device=di.vecs.device,
                         quant=quant, rerank_mult=rerank_mult)
            for _ in range(self.S)]
        self._bind_base(index, ext_of_base=None)
        self.next_ext = self.n_total

    @property
    def delta(self) -> DeltaSegment:
        """Shard 0's segment: the only one over a single index."""
        return self.deltas[0]

    # ------------------------------------------------------------ base view
    def _bind_base(self, index, ext_of_base: Optional[np.ndarray]) -> None:
        self.n_shard = _shard_counts(index.di if self._sharded else index)
        self.n_total = int(self.n_shard.sum())
        if ext_of_base is None:
            ext_of_base = np.arange(self.n_total, dtype=np.int64)
        if ext_of_base.shape[0] != self.n_total:
            raise ValueError(
                f"ext map has {ext_of_base.shape[0]} entries for a corpus "
                f"of {self.n_total} rows")
        self.ext_of_base = np.asarray(ext_of_base, np.int64)
        self.base_slot = {int(e): g for g, e in enumerate(self.ext_of_base)}
        self.base_deleted = np.zeros(self.n_total, bool)
        self.delta_loc: dict = {}            # ext -> (shard, slot)

    @property
    def n_live(self) -> int:
        return (self.n_total - int(self.base_deleted.sum())
                + sum(seg.n_live for seg in self.deltas))

    # -------------------------------------------------------------- inserts
    def _route(self, exts: np.ndarray) -> np.ndarray:
        return exts % self.S

    def fits(self, b: int) -> bool:
        """Would a b-row insert fit the per-shard deltas right now?"""
        exts = np.arange(self.next_ext, self.next_ext + b, dtype=np.int64)
        shard = self._route(exts)
        return all(int((shard == s).sum()) <= self.deltas[s].room()
                   for s in range(self.S))

    def insert(self, vecs: np.ndarray, attrs: np.ndarray) -> np.ndarray:
        """Append rows to the per-shard deltas; returns their ext ids."""
        b = vecs.shape[0]
        exts = np.arange(self.next_ext, self.next_ext + b, dtype=np.int64)
        shard = self._route(exts)
        for s in range(self.S):
            sel = np.nonzero(shard == s)[0]
            if not sel.size:
                continue
            slots = self.deltas[s].insert(vecs[sel], attrs[sel], exts[sel])
            self.delta_loc.update(zip(exts[sel].tolist(),
                                      zip([s] * sel.size, slots.tolist())))
        self.next_ext += b
        return exts

    # -------------------------------------------------------------- deletes
    def delete(self, ext_ids: np.ndarray, index):
        """Tombstone rows by ext id. Returns ``(new_index_or_None,
        n_deleted)``: a copy of ``index`` with NaN'd base attr rows when a
        base row died, None when only delta rows (or nothing) did.
        Unknown and already-deleted ids are skipped."""
        base_rows: List[int] = []
        per_seg: dict = {}
        for e in np.asarray(ext_ids, np.int64).ravel().tolist():
            loc = self.delta_loc.get(e)
            if loc is not None:
                s, slot = loc
                if self.deltas[s].live[slot]:
                    per_seg.setdefault(s, []).append(slot)
                continue
            g = self.base_slot.get(e)
            if g is not None and not self.base_deleted[g]:
                self.base_deleted[g] = True
                base_rows.append(g)
        for s, slots in per_seg.items():
            self.deltas[s].delete(np.asarray(slots, np.int64))
        n_del = len(base_rows) + sum(len(v) for v in per_seg.values())
        if not base_rows:
            return None, n_del
        return self._nan_base(index, np.asarray(base_rows)), n_del

    def _nan_base(self, index, rows: np.ndarray):
        """Functional tombstone write: a copy of ``index`` whose attr rows
        at ``rows`` (global internal ids) are NaN, on a fresh attrs tensor
        (the other tensors, the replica included, stay shared)."""
        di = index.di if self._sharded else index
        attrs = di.attrs.clone()
        rows = torch.as_tensor(rows, dtype=torch.int64).to(attrs.device)
        if self._sharded:
            attrs[rows % self.S, rows // self.S] = float("nan")
        else:
            attrs[rows] = float("nan")
        di = dataclasses.replace(di, attrs=attrs)
        return dataclasses.replace(index, di=di) if self._sharded else di

    def deleted_locals(self):
        """The tombstoned base rows, the planner's cardinality adjustment
        (``Planner.refresh_index``): their row ids over a single index, a
        list of each shard's local row ids over a sharded one."""
        g = np.nonzero(self.base_deleted)[0]
        if not self._sharded:
            return g
        return [g[g % self.S == s] // self.S for s in range(self.S)]

    # ---------------------------------------------------------------- merge
    def merge(self, ids: np.ndarray, dists: np.ndarray, qs: np.ndarray,
              qlo: np.ndarray, qhi: np.ndarray, k: int
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Fold the delta into one batch of base-engine results: ``ids``
        (B, k) internal base ids -> (ext ids (B, k) int64, dists (B, k)
        f32) ranked by (dist, ext)."""
        ids = np.asarray(ids)
        safe = np.clip(ids, 0, max(self.n_total - 1, 0))
        parts_i = [np.where(ids >= 0, self.ext_of_base[safe], -1)]
        parts_d = [np.asarray(dists, np.float32)]
        for seg in self.deltas:
            res = seg.scan(qs, qlo, qhi, k)
            if res is None:
                continue
            slots, dd = res
            parts_i.append(np.where(
                slots >= 0, seg.ext_ids[np.maximum(slots, 0)], -1))
            parts_d.append(np.where(slots >= 0, dd, np.inf))
        cand_i = np.concatenate(parts_i, axis=1).astype(np.int64)
        cand_d = np.concatenate(parts_d, axis=1)
        cand_d = np.where(cand_i >= 0, cand_d, np.inf).astype(np.float32)
        key_ext = np.where(cand_i >= 0, cand_i, _EXT_SENTINEL)
        order = np.lexsort((key_ext, cand_d), axis=-1)[:, :k]
        out_i = np.take_along_axis(cand_i, order, axis=1)
        out_d = np.take_along_axis(cand_d, order, axis=1)
        out_i = np.where(np.isfinite(out_d), out_i, -1)
        out_d = np.where(out_i >= 0, out_d, np.inf).astype(np.float32)
        return out_i, out_d

    # ----------------------------------------------------------- compaction
    def live_corpus(self, index) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every live row (base minus tombstones, plus the delta) on the
        host, sorted by ext: (vecs (n', d), attrs (n', m), exts (n',)),
        the corpus a compaction rebuilds from. The base rows are gathered
        on the device, at (shard, local) over a sharded index, before the
        copy; a bf16 corpus comes back upcast to f32, as the reference
        reads it, so the rebuilt epoch is stored in f32."""
        di = index.di if self._sharded else index
        alive = np.nonzero(~self.base_deleted)[0]
        sel = torch.as_tensor(alive).to(di.vecs.device)
        at = (sel % self.S, sel // self.S) if self._sharded else (sel,)
        parts = [(di.vecs[at].to(torch.float32).cpu().numpy(),
                  di.attrs[at].cpu().numpy(),
                  self.ext_of_base[alive])]
        parts += [seg.live_rows() for seg in self.deltas]
        vecs, attrs, exts = (np.concatenate(c) for c in zip(*parts))
        order = np.argsort(exts, kind="stable")
        return vecs[order], attrs[order], exts[order]

    def reset(self, index, exts: np.ndarray) -> None:
        """Rebind to a freshly compacted epoch whose internal row i has
        ext ``exts[i]``. The deltas and the tombstones clear; the ext
        counter keeps counting (ids are never reused)."""
        for seg in self.deltas:
            seg.clear()
        self._bind_base(index, ext_of_base=exts)
