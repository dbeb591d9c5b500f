"""The query mesh of the collective sharded search over
``torch.distributed``, ported from ``repro.launch.mesh.make_query_mesh``
(DESIGN.md §14).

The reference lays its devices out as a ``(data, model)`` array: the
``model`` axis holds the S index shards, the ``data`` axis splits the
query batch. Here every rank is one process with one device, and rank
``r`` sits at ``(r // n_model, r % n_model)``, the reference's
``reshape(n_data, n_model)``. ``make_query_mesh`` builds that layout over
the default process group: one ``model`` group a data row (the ranks that
hold the S shards and merge one slice of the batch) and one ``data``
group a model column (the ranks that hold the same shard and gather the
slices back). Every rank creates every group, in the same order, as
``dist.new_group`` requires.

On cards the backend is NCCL, one rank a card (``cuda:LOCAL_RANK``); on
the CPU it is gloo, and only when the caller asks for ``device="cpu"``.
``init_query_process_group`` starts the process group that way.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..core.util import resolve_device

__all__ = ["QueryMesh", "init_query_process_group", "make_query_mesh"]


@dataclasses.dataclass(frozen=True)
class QueryMesh:
    """One rank's view of the ``(data, model)`` query mesh: its position,
    the process groups of its data row (``model_group``, over which the
    shards' answers merge) and of its model column (``data_group``, over
    which the batch slices gather), and the device its tensors live on."""

    n_data: int
    n_model: int
    rank: int
    data_index: int
    model_index: int
    model_group: Any
    data_group: Any
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}


def init_query_process_group(device=None, *, init_method: str = "env://",
                             rank: Optional[int] = None,
                             world_size: Optional[int] = None,
                             timeout_s: float = 600.0) -> torch.device:
    """Start the default process group for the query mesh and return this
    rank's device: NCCL on ``cuda:LOCAL_RANK`` (``device`` None or a CUDA
    device; ``LOCAL_RANK`` from ``torchrun``, else the rank modulo the
    card count), gloo on ``device="cpu"``. ``rank`` and ``world_size``
    default to what ``init_method`` provides (``env://`` under
    ``torchrun``). There is no fallback: NCCL that fails to start
    raises."""
    dev = resolve_device(device)
    kw = {}
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            r = rank if rank is not None else int(os.environ.get("RANK", 0))
            local = r % torch.cuda.device_count()
        dev = torch.device("cuda", int(local))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"the query mesh runs on cuda (NCCL) or cpu "
                         f"(gloo), got device {dev}")
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return dev


def make_query_mesh(n_model: int, n_data: int = 1, *,
                    device=None) -> QueryMesh:
    """The ``(n_data, n_model)`` query mesh over the default process
    group, which must hold exactly ``n_data * n_model`` ranks. Its device
    follows the backend: ``cuda:<current>`` under NCCL, the CPU under
    gloo; a ``device`` given must agree (a CUDA tensor never goes through
    gloo, nor a CPU one through NCCL)."""
    if n_model < 1 or n_data < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({n_data}, "
                         f"{n_model})")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "the query mesh runs over torch.distributed: start the process "
            "group first (init_query_process_group, or "
            "torch.distributed.init_process_group)")
    need = n_model * n_data
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"query mesh ({n_data}, {n_model}) needs {need} ranks, the "
            f"process group has {world}: launch one rank per shard and "
            f"data slice (torchrun --nproc-per-node {need})")
    backend = dist.get_backend()
    if backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    elif backend == "gloo":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"the query mesh runs on NCCL or gloo, got "
                         f"{backend!r}")
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} cannot go through the "
                         f"{backend} backend (NCCL on cards, gloo on the "
                         f"CPU)")
    rank = dist.get_rank()
    model_group = data_group = None
    for i in range(n_data):                      # the data rows
        g = dist.new_group([i * n_model + j for j in range(n_model)])
        if i == rank // n_model:
            model_group = g
    for j in range(n_model):                     # the model columns
        g = dist.new_group([i * n_model + j for i in range(n_data)])
        if j == rank % n_model:
            data_group = g
    return QueryMesh(n_data=n_data, n_model=n_model, rank=rank,
                     data_index=rank // n_model,
                     model_index=rank % n_model, model_group=model_group,
                     data_group=data_group, device=dev, backend=backend)
