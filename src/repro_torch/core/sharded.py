"""Corpus-sharded KHI in one process, ported from ``repro.core.sharded``
(DESIGN.md §2 "Distribution", §14).

S independent KHI shards, shard s holding the objects whose global id is
``≡ s (mod S)`` (round-robin), each built over its own n/S objects.
Every shard answers top-k over its local ids; ``_local_to_global`` maps
local id j of shard s to ``j * S + s`` and ``_merge_topk`` merges the S
lists into the global answer. The per-shard indexes are padded to common
shapes (``device_put_index``'s ``pad_n`` / ``pad_nodes`` / ``pad_height``)
and stacked on a leading shard axis into one ``DeviceIndex``;
``ShardedKHI.pad_waste`` records what the padding costs.

``search_sharded_emulated`` is the reference's single-device fan-out: the
graph strategy returns per-shard hops (S, B); any other strategy goes
through an ``engine.Planner``, which fans every program out the same way
and returns per-query hops (B,), the max over shards for graph lanes and
0 for exact lanes. The collective form (``make_sharded_search_fn`` over
``torch.distributed``) is ROADMAP.md Queue 1 item 13's next step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .engine import (DeviceIndex, Planner, SearchParams, _local_to_global,
                     _merge_topk, _shard_search, _with_replica_for,
                     device_put_index, resolve_scorer_pair,
                     validate_search_params)
from .khi import KHIConfig, KHIIndex
from .util import resolve_device

# ``_local_to_global``, ``_merge_topk`` and ``_shard_search`` live in
# engine.py, whose Planner runs them, and are this module's names too, as
# in the reference.

__all__ = ["ShardedKHI", "build_sharded", "stack_shards",
           "sharded_from_stacked", "search_sharded_emulated"]


@dataclasses.dataclass
class ShardedKHI:
    """A shard-stacked ``DeviceIndex`` (every tensor with a leading shard
    axis, one root per shard) and the shard ids. ``pad_waste`` is the
    fraction of the stacked slots that are padding, per plane: (rows,
    nodes, levels)."""

    di: DeviceIndex
    offsets: torch.Tensor    # (S,) int64: shard s's id, s
    pad_waste: tuple = ()

    @property
    def num_shards(self) -> int:
        return int(self.offsets.shape[0])


def _pad_waste(ns, ps, hs) -> tuple:
    S = len(ns)
    return (1.0 - sum(ns) / (S * max(ns)), 1.0 - sum(ps) / (S * max(ps)),
            1.0 - sum(hs) / (S * max(hs)))


def stack_shards(shards: Sequence, *, device=None) -> ShardedKHI:
    """Pad per-shard host indexes (``KHIIndex`` of either package) to
    common shapes and stack them into one ShardedKHI on ``device``
    (default ``cuda``); shard s holds the objects with global id ≡ s mod
    S, the contract ``_local_to_global`` inverts."""
    dev = resolve_device(device)
    ns = [int(ix.vecs.shape[0]) for ix in shards]
    ps = [int(ix.tree.num_nodes) for ix in shards]
    hs = [int(ix.nbrs.shape[0]) for ix in shards]
    dis = [device_put_index(ix, device=dev, pad_n=max(ns),
                            pad_nodes=max(ps), pad_height=max(hs))
           for ix in shards]
    fields = {f.name: None if getattr(dis[0], f.name) is None else
              torch.stack([getattr(d, f.name) for d in dis])
              for f in dataclasses.fields(DeviceIndex) if f.name != "root"}
    di = DeviceIndex(**fields, root=tuple(d.root for d in dis))
    return ShardedKHI(di=di, offsets=torch.arange(len(shards), device=dev),
                      pad_waste=_pad_waste(ns, ps, hs))


_DTYPES = {"vecs": torch.float32, "attrs": torch.float32,
           "nbrs": torch.int32, "lo": torch.float32, "hi": torch.float32,
           "qscale": torch.float32}


def sharded_from_stacked(leaves: dict, offsets, pad_waste=(), *,
                         device=None) -> ShardedKHI:
    """A ShardedKHI from stacked host arrays, as the JAX package's
    ``ShardedKHI`` holds them: ``leaves`` maps each ``DeviceIndex`` field
    to its (S, ...) numpy array (``nbrs`` (S, n, H, M), ``root`` (S,);
    ``qvecs`` / ``qscale`` optional, a bf16 replica as any float array),
    with the shard ids ``offsets`` and the reference's ``pad_waste``."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(DeviceIndex):
        a = leaves.get(f.name)
        if f.name == "root":
            kw["root"] = tuple(int(r) for r in np.asarray(a).ravel())
        elif a is None:
            kw[f.name] = None
        elif f.name == "qvecs":
            a = np.array(a)
            dt = torch.int8 if a.dtype == np.int8 else torch.bfloat16
            kw[f.name] = torch.as_tensor(
                a if dt == torch.int8 else a.astype(np.float32)).to(
                    device=dev, dtype=dt)
        else:
            kw[f.name] = torch.as_tensor(np.array(a)).to(
                device=dev, dtype=_DTYPES.get(f.name, torch.int64))
    return ShardedKHI(di=DeviceIndex(**kw),
                      offsets=torch.as_tensor(np.array(offsets)).to(
                          device=dev, dtype=torch.int64),
                      pad_waste=tuple(float(w) for w in pad_waste))


def build_sharded(vecs: np.ndarray, attrs: np.ndarray, n_shards: int,
                  config: Optional[KHIConfig] = None, *,
                  device=None) -> ShardedKHI:
    """Round-robin partition, one build per shard on ``device`` (default
    ``cuda``; ``KHIConfig(builder="device")`` unless a config is given),
    then ``stack_shards``."""
    config = config or KHIConfig(builder="device")
    dev = resolve_device(device)
    shard_of = np.arange(vecs.shape[0]) % n_shards
    shards = []
    for s in range(n_shards):
        ids = np.nonzero(shard_of == s)[0]
        shards.append(KHIIndex.build(vecs[ids], attrs[ids], config,
                                     device=dev))
    return stack_shards(shards, device=dev)


def search_sharded_emulated(skhi: ShardedKHI, queries, qlo, qhi,
                            params: SearchParams, *, dist_fn=None,
                            on_undersized: str = "adjust"):
    """The whole sharded search in one process -> numpy (ids (B, k)
    int32, dists (B, k) f32, hops). Under ``strategy="graph"`` ``hops``
    is per shard, (S, B); any other strategy goes through a ``Planner``
    and ``hops`` is (B,). Index-dependent buffer bounds are raised to
    what the index needs by default."""
    if params.strategy != "graph":
        planner = Planner(skhi, params, dist_fn=dist_fn,
                          on_undersized=on_undersized)
        ids, dists, hops, _ = planner.search(np.asarray(queries),
                                             np.asarray(qlo),
                                             np.asarray(qhi))
        return ids, dists, hops
    params = validate_search_params(params, skhi.di,
                                    on_undersized=on_undersized)
    di = _with_replica_for(skhi.di, params.quant)
    scorer, exact = resolve_scorer_pair(params, dist_fn=dist_fn)
    q, lo, hi = [torch.as_tensor(np.asarray(a, np.float32)).to(di.device)
                 for a in (queries, qlo, qhi)]
    gids, dists, hops = _shard_search(di, q, lo, hi, params, scorer, exact)
    mi, md = _merge_topk(gids, dists, params.k)
    return (mi.to(torch.int32).cpu().numpy(), md.cpu().numpy(),
            hops.to(torch.int32).cpu().numpy())
