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

The ``np_pool_*`` functions are the reference's numpy twins of the same
pool, copied with their names and semantics: ``query_ref``'s beam form
of Algorithm 3 runs on them (in place on batched ``(B, pool)`` arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["Pool", "pool_seed", "pool_frontier_alive", "pool_top_unexpanded",
           "pool_mark_expanded_many", "pool_merge_tail", "visited_init",
           "visited_mark", "np_pool_alloc", "np_pool_seed",
           "np_pool_top_unexpanded", "np_pool_mark_expanded_many",
           "np_pool_merge_tail"]

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


# numpy twins (batched (B, pool) arrays; in place on active rows)

def np_pool_alloc(B: int, pool_size: int,
                  dtype=np.float32) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Empty batched pool: all slots sealed."""
    ids = np.full((B, pool_size), -1, dtype=np.int64)
    dists = np.full((B, pool_size), np.inf, dtype=dtype)
    expanded = np.ones((B, pool_size), dtype=bool)
    return ids, dists, expanded


def np_pool_seed(ids: np.ndarray, dists: np.ndarray, expanded: np.ndarray,
                 seed_ids: np.ndarray, seed_dists: np.ndarray) -> None:
    """Seed slots [0:k) of every row and restore the sorted invariant
    (stable sort keeps insertion order on ties; sealed +inf slots sink)."""
    k = seed_ids.shape[1]
    ids[:, :k] = seed_ids
    dists[:, :k] = seed_dists
    expanded[:, :k] = ~np.isfinite(seed_dists)
    srt = np.argsort(dists, axis=1, kind="stable")
    ar = np.arange(ids.shape[0])[:, None]
    ids[:] = ids[ar, srt]
    dists[:] = dists[ar, srt]
    expanded[:] = expanded[ar, srt]


def np_pool_top_unexpanded(ids: np.ndarray, dists: np.ndarray,
                           expanded: np.ndarray, ef: int,
                           width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Batched twin of ``pool_top_unexpanded``: per-row (slots (B, width),
    valid (B, width)) of the closest unexpanded beam slots, ascending by
    distance (pool order). Same stable-partition contract as the torch op."""
    frontier = ~expanded[:, :ef] & np.isfinite(dists[:, :ef])
    slots = np.argsort(~frontier, axis=1, kind="stable")[:, :width]
    valid = np.take_along_axis(frontier, slots, axis=1)
    return slots, valid


def np_pool_mark_expanded_many(expanded: np.ndarray, rows: np.ndarray,
                               slots: np.ndarray,
                               valid: np.ndarray) -> None:
    """Mark ``slots[valid]`` of the given rows expanded, in place (twin of
    ``pool_mark_expanded_many``; invalid lanes are no-ops)."""
    expanded[rows[:, None], slots] |= valid


def np_pool_merge_tail(ids: np.ndarray, dists: np.ndarray,
                       expanded: np.ndarray, rows: np.ndarray,
                       new_ids: np.ndarray, new_dists: np.ndarray,
                       new_valid: np.ndarray, ef: int) -> None:
    """Batched merge for the ``rows`` still searching (same semantics as the
    torch ``pool_merge_tail``, in place)."""
    ids[rows, ef:] = np.where(new_valid, new_ids, -1)
    dists[rows, ef:] = np.where(new_valid, new_dists, np.inf)
    expanded[rows, ef:] = ~new_valid
    srt = np.argsort(dists[rows], axis=1, kind="stable")
    ar = np.arange(len(rows))[:, None]
    ids[rows] = ids[rows][ar, srt]
    dists[rows] = dists[rows][ar, srt]
    expanded[rows] = expanded[rows][ar, srt]
    ids[rows, ef:] = -1
    dists[rows, ef:] = np.inf
    expanded[rows, ef:] = True
