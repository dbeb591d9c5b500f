"""Range predicates and the exact ground truth, copied from
``repro.core.query_ref`` (numpy only): ``Predicate``, ``brute_force`` and
``brute_force_expr``.
The rest of the numpy oracle (DFS routing, the heap-based query) stays in
the reference package."""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["Predicate", "brute_force", "brute_force_expr"]


class Predicate:
    """Range predicate B: per-attribute [lo, hi], ±inf when unconstrained."""

    def __init__(self, lo: Sequence[float], hi: Sequence[float]):
        self.lo = np.asarray(lo, dtype=np.float32)
        self.hi = np.asarray(hi, dtype=np.float32)
        assert self.lo.shape == self.hi.shape

    @classmethod
    def from_bounds(cls, m: int, bounds: dict[int, tuple[float, float]]) -> "Predicate":
        lo = np.full(m, -np.inf, dtype=np.float32)
        hi = np.full(m, np.inf, dtype=np.float32)
        for i, (l, r) in bounds.items():
            lo[i], hi[i] = l, r
        return cls(lo, hi)

    def matches(self, attrs: np.ndarray) -> np.ndarray:
        """attrs (…, m) -> bool (…)."""
        return ((attrs >= self.lo) & (attrs <= self.hi)).all(axis=-1)

    @property
    def cardinality(self) -> int:
        return int((np.isfinite(self.lo) | np.isfinite(self.hi)).sum())


def brute_force(index_vecs: np.ndarray, attrs: np.ndarray, q: np.ndarray,
                pred: Predicate, k: int) -> np.ndarray:
    """Exact ground truth over O_B (the paper's Prefiltering baseline)."""
    mask = pred.matches(attrs)
    ids = np.nonzero(mask)[0]
    if len(ids) == 0:
        return ids.astype(np.int64)
    diff = index_vecs[ids] - q
    d2 = np.einsum("nd,nd->n", diff, diff)
    k = min(k, len(ids))
    top = np.argpartition(d2, kth=k - 1)[:k]
    return ids[top[np.argsort(d2[top], kind="stable")]].astype(np.int64)


def brute_force_expr(index_vecs: np.ndarray, attrs: np.ndarray,
                     q: np.ndarray, expr, k: int) -> np.ndarray:
    """Exact ground truth under a boolean filter expression (DESIGN.md
    §15): mask-then-top-k with the engine's (distance, id) tie-break.
    Shorter than k when the match count is."""
    from .predicate import eval_expr

    mask = eval_expr(expr, np.asarray(attrs, np.float32))
    ids = np.nonzero(mask)[0].astype(np.int64)
    if not ids.size:
        return ids
    diff = np.asarray(index_vecs[ids], np.float32) - np.asarray(q, np.float32)
    d2 = np.einsum("nd,nd->n", diff, diff)
    order = np.lexsort((ids, d2))[: min(k, ids.size)]
    return ids[order]
