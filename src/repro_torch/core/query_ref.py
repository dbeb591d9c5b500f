"""Range predicates and the exact ground truth, copied from
``repro.core.query_ref`` (numpy only): ``Predicate``, ``brute_force``,
``brute_force_expr`` and the streaming write path's ``StreamingOracle``.
The rest of the numpy oracle (DFS routing, the heap-based query) stays in
the reference package."""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["Predicate", "brute_force", "brute_force_expr", "StreamingOracle"]


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


class StreamingOracle:
    """Rebuild-from-scratch numpy twin of the streaming write path
    (DESIGN.md §11). The live corpus is a dict keyed by stable external
    id, in ``core.delta.StreamingState``'s id space: the seed corpus has
    ``0..n-1``, every insert takes fresh ids and a re-insert a new one. A
    query brute-scans the live corpus with the scan path's ``(distance,
    ext)`` order, so it equals the service on exact (scan-served) lanes
    at every step of any insert/delete interleaving."""

    def __init__(self, vecs: np.ndarray, attrs: np.ndarray):
        self._rows = {i: (np.asarray(vecs[i], np.float32),
                          np.asarray(attrs[i], np.float32))
                      for i in range(vecs.shape[0])}
        self.next_ext = vecs.shape[0]

    def __len__(self) -> int:
        return len(self._rows)

    def insert(self, vecs: np.ndarray, attrs: np.ndarray) -> np.ndarray:
        """Append rows; returns their freshly-assigned ext ids."""
        b = vecs.shape[0]
        exts = np.arange(self.next_ext, self.next_ext + b, dtype=np.int64)
        for j, e in enumerate(exts):
            self._rows[int(e)] = (np.asarray(vecs[j], np.float32),
                                  np.asarray(attrs[j], np.float32))
        self.next_ext += b
        return exts

    def delete(self, ext_ids) -> int:
        """Drop rows by ext id; unknown ids are skipped. Returns the
        number removed."""
        n = 0
        for e in np.asarray(ext_ids, np.int64).ravel():
            n += self._rows.pop(int(e), None) is not None
        return n

    def corpus(self):
        """(exts (n,) int64 ascending, vecs (n, d), attrs (n, m)), the
        ext-sorted live corpus a compaction would rebuild from."""
        exts = np.asarray(sorted(self._rows), np.int64)
        if not exts.size:
            return (exts, np.zeros((0, 0), np.float32),
                    np.zeros((0, 0), np.float32))
        vecs = np.stack([self._rows[int(e)][0] for e in exts])
        attrs = np.stack([self._rows[int(e)][1] for e in exts])
        return exts, vecs, attrs

    def _topk(self, exts, vecs, mask, q, k: int) -> np.ndarray:
        ids = np.nonzero(mask)[0]
        if not ids.size:
            return ids.astype(np.int64)
        diff = vecs[ids] - np.asarray(q, np.float32)
        d2 = np.einsum("nd,nd->n", diff, diff)
        order = np.lexsort((exts[ids], d2))[: min(k, ids.size)]
        return exts[ids[order]]

    def query(self, q: np.ndarray, pred: Predicate, k: int) -> np.ndarray:
        """Exact top-k ext ids over the live corpus, ties to the lowest
        ext; shorter than k when fewer rows pass."""
        exts, vecs, attrs = self.corpus()
        if not exts.size:
            return exts
        return self._topk(exts, vecs, pred.matches(attrs), q, k)

    def query_expr(self, q: np.ndarray, expr, k: int) -> np.ndarray:
        """``query`` under a boolean filter expression (DESIGN.md §15)."""
        from .predicate import eval_expr

        exts, vecs, attrs = self.corpus()
        if not exts.size:
            return exts
        return self._topk(exts, vecs, eval_expr(expr, attrs), q, k)
