"""Logical-axis sharding: the counterpart of ``repro.models.sharding``.

Parameters, moments, caches and batches name a logical axis per dim
(``model.param_logical_axes``, ``optim.opt_logical_axes``); under
``axis_rules`` those names resolve to mesh axes, giving a spec: a tuple
with one entry a dim, ``None`` (replicated), a mesh axis name or a tuple
of names (the reference's ``PartitionSpec`` as a tuple).

Logical axes (the reference's rules, ``launch.mesh.sharding_rules``):
  batch    -> ("pod", "data") on the multi-pod mesh, ("data",) single-pod
  heads    -> "model" when divisible (Megatron TP), else replicated
  ffn      -> "model"
  vocab    -> "model"
  experts  -> "model" when divisible, else expert-FFN dim gets "model"
  seq_kv   -> "model" (long-context decode caches when batch can't cover)

``to_placements`` turns a spec into DTensor placements over a
``DeviceMesh`` and ``local_shape`` gives one device's shard of a leaf.
``constrain`` stays the identity: the port runs a model's step on one
device, and the dry run (``launch.dryrun``) counts a sharded layout from
the specs instead of constraining activations. A spec entry is
normalized as ``PartitionSpec`` normalizes it: an empty tuple is
``None``, a one-axis tuple its axis name.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

__all__ = ["axis_rules", "constrain", "local_shape", "logical_to_spec",
           "maybe_axis", "to_placements"]

_state = threading.local()


def _rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: dict, mesh=None):
    """rules: logical name -> mesh axis (str | tuple | None).
    ``mesh``: mesh axis sizes for divisibility checks (dict name->size)."""
    prev = _rules(), getattr(_state, "mesh_sizes", None)
    _state.rules = dict(rules)
    _state.mesh_sizes = dict(mesh or {})
    try:
        yield
    finally:
        _state.rules, _state.mesh_sizes = prev


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def maybe_axis(logical: Optional[str], dim_size: int):
    """Resolve a logical axis to mesh axes, dropping it when the dimension
    isn't divisible by the mesh-axis extent (e.g. kv_heads=4 on model=16)."""
    rules = _rules()
    if rules is None or logical is None:
        return None
    ax = rules.get(logical)
    if ax is None:
        return None
    sizes = getattr(_state, "mesh_sizes", None) or {}
    total = 1
    for a in _axes(ax):
        total *= sizes.get(a, 1)
    if total > 1 and dim_size % total != 0:
        return None
    return ax


def logical_to_spec(logical: Sequence[Optional[str]],
                    shape: Sequence[int]) -> tuple:
    """Resolve logical names; a mesh axis may appear only once per spec, so
    later duplicates are dropped (e.g. MoE weights where both `experts` and
    `expert_ffn` map to `model`: EP wins when E divides the axis, otherwise
    expert-internal TP takes over)."""
    out, used = [], set()
    for name, size in zip(logical, shape):
        ax = maybe_axis(name, size)
        if ax is not None and any(a in used for a in _axes(ax)):
            ax = None
        used.update(_axes(ax))
        # as PartitionSpec normalizes: () is None, (a,) is a
        if isinstance(ax, tuple) and len(ax) <= 1:
            ax = ax[0] if ax else None
        out.append(ax)
    return tuple(out)


def local_shape(spec: Sequence, shape: Sequence[int], sizes: dict
                ) -> Tuple[int, ...]:
    """One device's shard of a ``shape`` leaf laid out by ``spec`` over a
    mesh of axis ``sizes``: each dim divided by the extent of its axes.
    The spec's axes must divide their dims, as ``logical_to_spec``
    leaves them."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for entry, dim in zip(spec, shape):
        n = 1
        for a in _axes(entry):
            n *= sizes.get(a, 1)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry!r} "
                             f"({n} ways)")
        out.append(dim // n)
    return tuple(out)


def to_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh`` (a ``DeviceMesh`` with
    ``mesh_dim_names``): ``Shard(d)`` on each mesh dim that tensor dim d's
    entry names, ``Replicate()`` on the others. A dim split over several
    mesh axes must name them in the mesh's order, the order in which
    DTensor splits them (pod before data)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names its mesh axes out "
                             f"of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def constrain(x, *logical: Optional[str]):
    """The identity: a model's step runs on one device."""
    return x
