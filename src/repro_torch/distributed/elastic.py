"""Elastic rescaling of the sharded index, ported from the index side of
``repro.distributed.elastic`` (DESIGN.md §2).

The sharded KHI is S independent shards under round-robin object
assignment. Rescaling S -> S' rebuilds only the shards whose object sets
change: with S' == S every existing shard is reused as it is, otherwise
every new shard is built over its new object set. ``sharded.stack_shards``
restacks the result for serving. ``reshard_checkpoint`` restores a
checkpoint's leaves onto a template laid out for the new placement (other
devices, another shard count) through ``repro_torch.checkpoint``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..checkpoint import restore_into
from ..core.khi import KHIConfig, KHIIndex

__all__ = ["shard_assignments", "elastic_reshard", "reshard_checkpoint"]


def shard_assignments(n: int, n_shards: int) -> np.ndarray:
    """Round-robin object -> shard assignment (the build_sharded policy)."""
    return np.arange(n) % n_shards


def elastic_reshard(
    vecs: np.ndarray,
    attrs: np.ndarray,
    old_shards: Dict[int, KHIIndex],
    n_old: int,
    n_new: int,
    config: Optional[KHIConfig] = None,
    *,
    build_fn: Optional[Callable[[np.ndarray, np.ndarray], KHIIndex]] = None,
    device=None,
) -> Dict[int, KHIIndex]:
    """Rescale S -> S' rebuilding only the shards whose object sets
    changed; returns the new {shard_id: index}. A shard is reused when
    ``n_new == n_old`` and it is in ``old_shards``; every other new shard
    is built over its objects with ``build_fn(vecs, attrs)``, by default
    ``KHIIndex.build`` with ``config`` (the device builder unless given)
    on ``device`` (default ``cuda``)."""
    config = config or KHIConfig(builder="device")
    build_fn = build_fn or (lambda v, a: KHIIndex.build(v, a, config,
                                                        device=device))
    new_assign = shard_assignments(len(vecs), n_new)
    out: Dict[int, KHIIndex] = {}
    for s in range(n_new):
        if n_new == n_old and s in old_shards:
            out[s] = old_shards[s]
            continue
        ids = np.nonzero(new_assign == s)[0]
        out[s] = build_fn(vecs[ids], attrs[ids])
    return out


def reshard_checkpoint(arrays: dict, template_fn: Callable[[], object]):
    """Restore checkpointed leaves (``load_checkpoint``'s arrays) onto the
    tree that ``template_fn()`` builds for the new placement: each leaf
    lands on its template leaf's device and dtype."""
    template = template_fn()
    return restore_into(template, arrays)
