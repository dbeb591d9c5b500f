"""KHI index container: partitioning tree + per-level graphs, ported from
``repro.core.khi``.

``KHIIndex.build`` runs Algorithm 4 (the tree, on the host) and then the
graphs on the device: Algorithm 5 (``builder="incremental"``, the
default; ``core/hnsw.py``), the bulk builder (``"bulk"``) or the device
bulk builder (``"device"``; ``core/build_device.py``). ``save``/``load``
use the reference's ``.npz`` layout, so an index saved by either package
loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from . import hnsw
from .build_device import build_graphs_device
from .tree import PartitionTree, build_tree

__all__ = ["KHIConfig", "KHIIndex"]


@dataclasses.dataclass
class KHIConfig:
    """Build-time parameters (defaults follow the paper and the
    reference)."""

    M: int = 32
    ef_b: Optional[int] = None
    tau: float = 3.0
    leaf_capacity: int = 2
    merge_chunk: int = 64
    symmetric_reverse: bool = False
    builder: str = "incremental"

    BUILDERS = ("incremental", "bulk", "device")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


@dataclasses.dataclass
class KHIIndex:
    vecs: np.ndarray     # (n, d) float32
    attrs: np.ndarray    # (n, m) float32
    tree: PartitionTree
    nbrs: object         # (H, n, M) int32, -1 padded: numpy or a tensor
    config: KHIConfig
    build_seconds: float = 0.0

    @classmethod
    def build(cls, vecs: np.ndarray, attrs: np.ndarray,
              config: Optional[KHIConfig] = None, *, device=None,
              verbose: bool = False) -> "KHIIndex":
        """Tree on the host, graphs on ``device`` (default ``cuda``); the
        graphs stay there as a tensor until ``device_put_index``."""
        config = config or KHIConfig()
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        attrs = np.ascontiguousarray(attrs, dtype=np.float32)
        if vecs.shape[0] != attrs.shape[0]:
            raise ValueError("vecs/attrs length mismatch")
        if config.builder not in KHIConfig.BUILDERS:
            raise ValueError(f"unknown builder {config.builder!r}; "
                             f"expected one of {KHIConfig.BUILDERS}")
        t0 = time.perf_counter()
        tree = build_tree(attrs, tau=config.tau,
                          leaf_capacity=config.leaf_capacity)
        if verbose:
            print(f"[khi] tree: {tree.num_nodes} nodes, height "
                  f"{tree.height}, {time.perf_counter() - t0:.1f}s",
                  flush=True)
        if config.builder == "device":
            nbrs = build_graphs_device(tree, vecs, M=config.M,
                                       ef_b=config.ef_b, device=device,
                                       verbose=verbose)
        elif config.builder == "bulk":
            nbrs = hnsw.build_graphs_bulk(tree, vecs, M=config.M,
                                          ef_b=config.ef_b, device=device,
                                          verbose=verbose)
        else:
            nbrs = hnsw.build_graphs(
                tree, vecs, M=config.M, ef_b=config.ef_b,
                merge_chunk=config.merge_chunk,
                symmetric_reverse=config.symmetric_reverse, device=device,
                verbose=verbose)
        if nbrs.device.type == "cuda":
            torch.cuda.synchronize(nbrs.device)
        dt = time.perf_counter() - t0
        return cls(vecs=vecs, attrs=attrs, tree=tree, nbrs=nbrs,
                   config=config, build_seconds=dt)

    @property
    def n(self) -> int:
        return int(self.vecs.shape[0])

    @property
    def d(self) -> int:
        return int(self.vecs.shape[1])

    @property
    def m(self) -> int:
        return int(self.attrs.shape[1])

    @property
    def height(self) -> int:
        return int(self.nbrs.shape[0])

    def graph_size_bytes(self) -> int:
        """Index size without the raw vectors: the tree's arrays and 4
        bytes per occupied neighbour slot (the -1 padding compresses away),
        as the reference counts it; ``total_size_bytes`` adds the vectors
        and attributes."""
        t = self.tree
        tree_bytes = sum(a.nbytes for a in (
            t.left, t.right, t.parent, t.dim, t.split, t.bl, t.level, t.lo,
            t.hi, t.order, t.start, t.count, t.path))
        return int((self.nbrs >= 0).sum()) * 4 + tree_bytes

    def total_size_bytes(self) -> int:
        return self.graph_size_bytes() + self.vecs.nbytes + self.attrs.nbytes

    def nbrs_numpy(self) -> np.ndarray:
        if torch.is_tensor(self.nbrs):
            return self.nbrs.cpu().numpy()
        return np.asarray(self.nbrs)

    def save(self, path: str) -> None:
        t = self.tree
        np.savez_compressed(
            path,
            vecs=self.vecs, attrs=self.attrs, nbrs=self.nbrs_numpy(),
            left=t.left, right=t.right, parent=t.parent, dim=t.dim,
            split=t.split, bl=t.bl, level=t.level, lo=t.lo, hi=t.hi,
            order=t.order, start=t.start, count=t.count, path=t.path,
            meta=np.frombuffer(json.dumps({
                "config": dataclasses.asdict(self.config),
                "tau": t.tau, "leaf_capacity": t.leaf_capacity, "m": t.m,
                "build_seconds": self.build_seconds,
            }).encode(), dtype=np.uint8),
        )

    @classmethod
    def load(cls, path: str) -> "KHIIndex":
        z = np.load(path)
        meta = json.loads(bytes(z["meta"]).decode())
        tree = PartitionTree(
            left=z["left"], right=z["right"], parent=z["parent"], dim=z["dim"],
            split=z["split"], bl=z["bl"], level=z["level"], lo=z["lo"],
            hi=z["hi"], order=z["order"], start=z["start"], count=z["count"],
            path=z["path"], tau=meta["tau"],
            leaf_capacity=meta["leaf_capacity"], m=meta["m"])
        return cls(vecs=z["vecs"], attrs=z["attrs"], tree=tree, nbrs=z["nbrs"],
                   config=KHIConfig(**meta["config"]),
                   build_seconds=meta["build_seconds"])
