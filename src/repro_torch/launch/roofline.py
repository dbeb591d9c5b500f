"""Roofline terms of a dry-run cell on NVIDIA H100 SXM5 cards: the
counterpart of ``repro.launch.roofline``, which holds TPU v5e constants.

Per-card constants, NVIDIA's H100 SXM5 datasheet figures:
    peak bf16 dense  : 989.4 TFLOP/s
    HBM3             : 3.35 TB/s
    NVLink           : 450 GB/s each way, within one node of 8 cards
    network          : one 400 Gb/s NIC a card (50 GB/s), between nodes

A collective group of ranks that lies inside one node of 8 consecutive
ranks runs over NVLink; a group that spans nodes runs at the NIC's rate
(the (16, 16) mesh's ``model`` axis spans two 8-card nodes, so one
link figure for every axis would misstate it).

Conventions. The FLOPs and bytes given are per card (the dry run divides
the global program's counts by the card count: the even split the
reference calls equivalent to its per-partition form). The ring formulas
turn one collective into bytes on the wire a card:

    all-reduce       2 * size * (g-1)/g      (reduce-scatter + all-gather)
    all-gather       size_out * (g-1)/g
    reduce-scatter   size_out * (g-1)
    all-to-all       size * (g-1)/g
    collective-permute  size

where ``size`` is the collective's result on one card (the HLO result
shape the reference parses) and g the group size. The port has no HLO:
``collective_bytes`` takes records of (kind, bytes, group size, spans
nodes) from the dry run's layout model instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989.4e12   # bf16 dense / card
HBM_BW = 3.35e12        # B/s / card
NVLINK_BW = 450e9       # B/s each way / card, inside a node
NIC_BW = 50e9           # B/s / card, between nodes (400 Gb/s)
NODE_CARDS = 8

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def ring_bytes(kind: str, size: float, g: int) -> float:
    """Bytes on the wire a card for one collective of result ``size`` over
    a group of ``g``."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2 * size * (g - 1) / g
    if kind == "all-gather":
        return size * (g - 1) / g
    if kind == "reduce-scatter":
        return size * (g - 1)
    if kind == "all-to-all":
        return size * (g - 1) / g
    if kind == "collective-permute":
        return size
    raise ValueError(f"unknown collective {kind!r}; expected one of {KINDS}")


def collective_bytes(records: Iterable[Tuple[str, float, int, bool]]
                     ) -> Dict[str, float]:
    """Per-card ring bytes on the wire, bucketed by kind (``<kind>`` and
    ``<kind>_count``), their ``total``, and the share that crosses nodes
    (``network``): one record (kind, result bytes, group size, spans
    nodes) a collective."""
    out: Dict[str, float] = {}
    net = 0.0
    for kind, size, g, spans in records:
        wire = ring_bytes(kind, size, g)
        out[kind] = out.get(kind, 0.0) + wire
        out[f"{kind}_count"] = out.get(f"{kind}_count", 0) + 1
        if spans:
            net += wire
    out["total"] = sum(v for k, v in out.items() if k in KINDS)
    out["network"] = net
    return out


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    coll_bytes: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (per card)."""
        return self.model_flops / self.flops if self.flops else 0.0

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "dominant": self.dominant, "bound_s": self.bound_s,
                "useful_fraction": self.useful_fraction}


def terms_from(*, flops: float, bytes_accessed: float, coll_bytes: float,
               n_chips: int, model_flops_global: float = 0.0,
               coll_network_bytes: float = 0.0) -> Roofline:
    """Roofline from per-card costs. ``coll_network_bytes`` is the share
    of ``coll_bytes`` that crosses nodes (at the NIC's rate); the rest
    runs over NVLink."""
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_accessed / HBM_BW,
        collective_s=((coll_bytes - coll_network_bytes) / NVLINK_BW
                      + coll_network_bytes / NIC_BW),
        flops=flops,
        bytes_accessed=bytes_accessed,
        coll_bytes=coll_bytes,
        model_flops=model_flops_global / n_chips,
    )


def model_flops(kind: str, n_params: int, n_active: int, batch: int,
                seq: int, n_micro: int = 1) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D for inference forward; decode D=batch
    tokens. MoE uses active params."""
    N = n_active or n_params
    if kind == "train":
        return 6.0 * N * batch * seq
    if kind == "prefill":
        return 2.0 * N * batch * seq
    if kind == "decode":
        return 2.0 * N * batch  # one token per sequence
    return 0.0
