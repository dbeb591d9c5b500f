"""What a program of the port costs, counted op by op as it dispatches:
the port's replacement for ``repro.launch.hlo_cost``, which parses XLA's
HLO text. An eager PyTorch program has no HLO, so ``CountingMode`` (a
``TorchDispatchMode``) sees every aten op the program runs, forward and
backward, and counts:

  - **FLOPs** through ``torch.utils.flop_counter``'s registry (matmuls,
    batched matmuls, convolutions, attention: 2 per multiply-add), as
    ``hlo_cost`` counts dots and convolutions and leaves elementwise ops
    out;
  - **bytes**: each tensor an op reads once and each tensor it writes
    once (an argument written in place counts once, as its write), for
    every aten op that is not a view. Eager PyTorch writes each op's
    output to memory and reads it back in the next, so this is the
    port's own traffic, not a fused program's. A tensor counts at most
    its storage's bytes (a broadcast view reads its storage once);
  - **peak**: the bytes of the storages the program allocates, live at
    once, at their most. A storage counts once however many views share
    it (keyed by storage, ``StorageWeakRef``), from the op that allocates
    it to the op after its last reference dies. Storages that existed
    before the mode (the program's inputs) are not counted.

A Python loop runs every iteration, so no trip count needs correcting,
and ``torch.utils.checkpoint``'s recomputed forward is counted as it
runs, as XLA's remat is part of ``hlo_cost``'s count.

The mode counts the same over ``FakeTensor``s (no memory; shapes only)
as over real tensors, on the CPU and on the card. Ops outside the
``aten`` namespace (``prim.device``, which only fake tensors dispatch)
are not counted.

The hand kernels run through ``ctypes`` (``kernels/ops.py``), where no
dispatch mode sees them: a counted program that reaches one adds its
work from its shapes with ``add_kernel`` (``gather_l2_filter_work``
counts the fused gather as ``chip_smoke.py``'s bound column does), never
the plain version's ops. Collectives come from the dry run's layout
model (``launch.dryrun``) and the ring formulas of ``launch.roofline``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCost", "CountingMode", "count", "gather_l2_filter_work"]


@dataclasses.dataclass
class OpCost:
    """The fields of ``hlo_cost.HloCost`` (``max_trip_product`` aside: a
    Python loop needs none) plus the tracker's ``peak_bytes`` and
    ``end_bytes`` (its storages still live when the program returned:
    its outputs), the ops counted and the hand kernels' launches."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0
    end_bytes: float = 0.0
    n_ops: int = 0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op moves for ``t``: its elements, at most its storage."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (NotImplementedError, RuntimeError):
        return n


_WRITES: Dict[object, Tuple[int, ...]] = {}


def _written(func, args, kwargs):
    """The tensors ``func`` writes in place (``Tensor(a!)`` arguments)."""
    idx = _WRITES.get(func)
    if idx is None:
        idx = _WRITES[func] = tuple(
            i for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
    out = []
    for i in idx:
        a = func._schema.arguments[i]
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
    return out


class CountingMode(TorchDispatchMode):
    """Counts FLOPs, bytes and the peak of live bytes of every aten op run
    under it (``with CountingMode() as m: ...; m.cost``).

    ``scale``, given, maps a new storage's tensor to the share of its
    bytes the tracker holds (the dry run holds a tensor of a parameter's
    shape at that parameter's shard of one device)."""

    def __init__(self, *, scale: Optional[Callable[[torch.Tensor], float]]
                 = None):
        super().__init__()
        self.cost = OpCost()
        self._scale = scale
        self._live: Dict[int, Tuple[StorageWeakRef, float]] = {}
        self._upper = 0.0          # live bytes, the dead not yet swept
        self._since_sweep = 0

    # ------------------------------------------------------------ tracker
    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._upper -= self._live.pop(k)[1]
        self._since_sweep = 0

    def live_bytes(self) -> float:
        """The tracked storages alive now."""
        self._sweep()
        return self._upper

    def _track(self, inputs, out) -> None:
        seen = {t.untyped_storage()._cdata for t in inputs}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen:
                continue
            seen.add(key)
            old = self._live.get(key)
            if old is not None:
                if not old[0].expired():
                    continue
                self._upper -= old[1]          # a freed storage's address
            nb = float(st.nbytes())
            if self._scale is not None:
                nb *= self._scale(t)
            self._live[key] = (StorageWeakRef(st), nb)
            self._upper += nb
        self._since_sweep += 1
        # the bytes not yet swept bound the live ones from above: only a
        # bound past the peak can make a new peak
        if self._upper > self.cost.peak_bytes or self._since_sweep > 4096:
            self._sweep()
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._upper)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        c = self.cost
        c.n_ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        inputs = [t for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        written = {id(t) for t in _written(func, args, kwargs)}
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        counted = set()
        for t in inputs:
            if id(t) not in written and id(t) not in counted:
                counted.add(id(t))
                c.bytes_accessed += _nbytes(t)
        for t in outs + [t for t in inputs if id(t) in written]:
            if ("w", id(t)) not in counted:
                counted.add(("w", id(t)))
                c.bytes_accessed += _nbytes(t)
        self._track(inputs, out)
        return out

    # ------------------------------------------------------------ additions
    def add_kernel(self, name: str, flops: float, nbytes: float,
                   launches: int = 1) -> None:
        """A hand kernel's work, counted from its shapes: ``launches``
        calls of ``flops`` and ``nbytes`` each."""
        self.cost.flops += launches * flops
        self.cost.bytes_accessed += launches * nbytes
        self.cost.kernels[name] = self.cost.kernels.get(name, 0) + launches


def count(fn: Callable, *args, scale=None, **kwargs):
    """(fn(*args, **kwargs), its ``OpCost``)."""
    with CountingMode(scale=scale) as mode:
        out = fn(*args, **kwargs)
        mode.cost.end_bytes = mode.live_bytes()
    return out, mode.cost


def gather_l2_filter_work(B: int, C: int, d: int, m: int, *,
                          vec_bytes: int = 4, idx_bytes: int = 4
                          ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one fused gather call (``ops.gather_l2_filter``)
    at B queries of C candidates each, every candidate valid and passing
    (a hop's most): read the ids, the queries and their boxes, each
    candidate's attribute row (m f32) and vector row (d of ``vec_bytes``),
    write the (B, C) f32 distances; 3 FLOPs an element of a row (sub,
    mul, add)."""
    nbytes = (B * C * idx_bytes + B * C * 4 + B * d * 4 + 2 * B * m * 4
              + B * C * (m * 4 + d * vec_bytes))
    return 3.0 * B * C * d, float(nbytes)
