"""Batched sorted-pool and visited-set ops for the greedy search.

The port of ``repro.core.beam``'s jax ops. The reference writes them for
one query and vmaps them; here every op takes a batch of pools as
``(B, pool)`` tensors, which is the shape the engine's hop loop runs.
The pool contract is unchanged:

  * physical size ``ef + tail``: slots ``[0:ef]`` are the beam, slots
    ``[ef:]`` a scratch tail that is only filled inside a merge;
  * ``ids`` (int64, -1 = empty), ``dists`` (float32, +inf = empty),
    ``expanded`` (bool, empty slots count as expanded);
  * between steps every row is ascending by ``dists``, with the tail
    sealed to (-1, +inf, True).

Every sort is stable (``stable=True``), as ``jnp.argsort`` is: tie order
is insertion order, and it decides ids and hop counts. Scatters that the
reference drops with ``mode="drop"`` go to one spare column that is
sliced off (the visited plane carries it permanently as column ``n``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["Pool", "pool_seed", "pool_frontier_alive", "pool_top_unexpanded",
           "pool_mark_expanded_many", "pool_merge_tail", "visited_init",
           "visited_mark"]

_INF = float("inf")


@dataclasses.dataclass
class Pool:
    """Batched sorted candidate pools (module docstring)."""

    ids: torch.Tensor       # (B, ef + tail) int64, -1 = empty
    dists: torch.Tensor     # (B, ef + tail) float32, +inf = empty
    expanded: torch.Tensor  # (B, ef + tail) bool, empty slots are True

    def _gather(self, srt: torch.Tensor) -> "Pool":
        return Pool(self.ids.gather(1, srt), self.dists.gather(1, srt),
                    self.expanded.gather(1, srt))


def pool_seed(pool_size: int, ids: torch.Tensor, dists: torch.Tensor,
              valid: torch.Tensor) -> Pool:
    """Seed (B, pool_size) pools with up to ids.shape[1] entry candidates
    per row (invalid lanes become sealed slots), then sort."""
    B, k = ids.shape
    dev = ids.device
    ids0 = torch.full((B, pool_size), -1, dtype=torch.int64, device=dev)
    ids0[:, :k] = ids
    d0 = torch.full((B, pool_size), _INF, dtype=torch.float32, device=dev)
    d0[:, :k] = torch.where(valid, dists, torch.full_like(dists, _INF))
    exp0 = torch.ones((B, pool_size), dtype=torch.bool, device=dev)
    exp0[:, :k] = ~valid
    srt = torch.argsort(d0, dim=1, stable=True)
    return Pool(ids0, d0, exp0)._gather(srt)


def pool_frontier_alive(pool: Pool, ef: int) -> torch.Tensor:
    """(B,) True while some beam slot is finite and unexpanded."""
    frontier = ~pool.expanded[:, :ef] & torch.isfinite(pool.dists[:, :ef])
    return frontier.any(dim=1)


def pool_top_unexpanded(pool: Pool, ef: int, width: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slots, ids, valid), each (B, width): the up-to-``width`` closest
    unexpanded beam slots in pool order — a stable partition of the
    frontier mask, exactly as the reference op."""
    frontier = ~pool.expanded[:, :ef] & torch.isfinite(pool.dists[:, :ef])
    slots = torch.argsort((~frontier).to(torch.int32), dim=1,
                          stable=True)[:, :width]
    return slots, pool.ids.gather(1, slots), frontier.gather(1, slots)


def pool_mark_expanded_many(pool: Pool, slots: torch.Tensor,
                            valid: torch.Tensor) -> Pool:
    """Mark ``slots[valid]`` expanded (invalid lanes change nothing)."""
    size = pool.expanded.shape[1]
    exp = torch.cat([pool.expanded,
                     torch.zeros_like(pool.expanded[:, :1])], 1)
    idx = torch.where(valid, slots, torch.full_like(slots, size))
    exp.scatter_(1, idx, True)
    return Pool(pool.ids, pool.dists, exp[:, :size])


def pool_merge_tail(pool: Pool, ef: int, new_ids: torch.Tensor,
                    new_dists: torch.Tensor, new_valid: torch.Tensor) -> Pool:
    """Write up to ``tail`` new candidates per row into the scratch tail,
    stable-sort the whole pool, re-seal the tail (Alg. 3 lines 10-13)."""
    ids = torch.cat([pool.ids[:, :ef],
                     torch.where(new_valid, new_ids,
                                 torch.full_like(new_ids, -1))], 1)
    dists = torch.cat([pool.dists[:, :ef],
                       torch.where(new_valid, new_dists,
                                   torch.full_like(new_dists, _INF))], 1)
    expanded = torch.cat([pool.expanded[:, :ef], ~new_valid], 1)
    srt = torch.argsort(dists, dim=1, stable=True)
    out = Pool(ids, dists, expanded)._gather(srt)
    out.ids[:, ef:] = -1
    out.dists[:, ef:] = _INF
    out.expanded[:, ef:] = True
    return out


def visited_init(B: int, n: int, device) -> torch.Tensor:
    """(B, n + 1) bool; column n is the drop slot for invalid lanes."""
    return torch.zeros((B, n + 1), dtype=torch.bool, device=device)


def visited_mark(visited: torch.Tensor, ids: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Mark ``ids[valid]`` visited, in place (invalid lanes hit the drop
    column)."""
    n = visited.shape[1] - 1
    visited.scatter_(1, torch.where(valid, ids, torch.full_like(ids, n)),
                     True)
    return visited
