"""Prefiltering (paper §5.1) and Postfiltering baselines, ported from
``repro.core.baselines.simple``: Prefiltering's masked distances and
top-k as plain torch, Postfiltering's graph built by the ported
Algorithm 5 merge and searched by the ported greedy search, both on the
device."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import hnsw
from ..query_ref import Predicate
from ..util import resolve_device

__all__ = ["Prefiltering", "Postfiltering"]


def _on_device(obj, names, device):
    """The arrays ``names`` of ``obj`` as tensors on ``device``, made at the
    first query and kept beside the fields."""
    dev = resolve_device(device)
    if obj._tensors is None or obj._tensors[0] != dev:
        obj._tensors = (dev, [torch.as_tensor(getattr(obj, nm)).to(dev)
                              for nm in names])
    return obj._tensors[1]


@dataclasses.dataclass
class Prefiltering:
    """Exact: materialize O_B with the predicate, then every distance and
    the top-k (ties to the lower id). This is also the ground truth."""

    vecs: np.ndarray
    attrs: np.ndarray
    build_seconds: float = 0.0
    device: Optional[str] = None
    _tensors: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def build(cls, vecs, attrs, *, device=None, **_) -> "Prefiltering":
        return cls(np.asarray(vecs, np.float32),
                   np.asarray(attrs, np.float32), device=device)

    def query(self, q, pred: Predicate, k: int, **_) -> np.ndarray:
        vecs, attrs = _on_device(self, ("vecs", "attrs"), self.device)
        lo = torch.as_tensor(pred.lo).to(attrs.device)
        hi = torch.as_tensor(pred.hi).to(attrs.device)
        ids = torch.nonzero(((attrs >= lo) & (attrs <= hi)).all(1)) \
            .squeeze(1)
        diff = vecs[ids] - torch.as_tensor(np.asarray(q, np.float32)) \
            .to(vecs.device)
        d2 = (diff * diff).sum(1)
        top = torch.argsort(d2, stable=True)[:k]
        return ids[top].cpu().numpy().astype(np.int64)


@dataclasses.dataclass
class Postfiltering:
    """One single-level HNSW graph over all objects; the search ignores B
    and the results are filtered afterwards. Recall falls as selectivity
    shrinks: the failure mode the paper contrasts against."""

    vecs: np.ndarray
    attrs: np.ndarray
    adj: np.ndarray          # (n, M)
    build_seconds: float = 0.0
    device: Optional[str] = None
    _tensors: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def build(cls, vecs, attrs, *, M: int = 32, ef_b: Optional[int] = None,
              device=None, **_) -> "Postfiltering":
        """The graph by the reference's single merge (merge_chunk 64,
        symmetric reverse edges) on ``device`` (default ``cuda``)."""
        t0 = time.perf_counter()
        dev = resolve_device(device)
        vecs = np.asarray(vecs, np.float32)
        n = vecs.shape[0]
        adj = torch.full((n, M), -1, dtype=torch.int32, device=dev)
        hnsw._insert_incremental(
            vecs, adj, np.empty(0, np.int64), np.arange(n), M=M,
            ef_b=ef_b or M, right_plane=None, left_set=None, merge_chunk=64,
            symmetric_reverse=True, device=dev)
        adj = adj.cpu().numpy()
        return cls(vecs, np.asarray(attrs, np.float32), adj,
                   time.perf_counter() - t0, device=device)

    @property
    def n(self):
        return self.vecs.shape[0]

    def query(self, q, pred: Predicate, k: int, *, ef: int = 64,
              **_) -> np.ndarray:
        vecs, adj = _on_device(self, ("vecs", "adj"), self.device)
        ids, _ = hnsw.greedy_search_batch(
            vecs, adj, np.asarray(q, np.float32)[None, :],
            np.zeros(1, np.int64), ef, device=vecs.device)
        ids = ids[0][ids[0] >= 0].cpu().numpy()
        ok = pred.matches(self.attrs[ids])
        return ids[ok][:k].astype(np.int64)
