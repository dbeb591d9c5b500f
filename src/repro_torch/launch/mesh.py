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

The production meshes of the dry run (``launch.dryrun``), ported from
``repro.launch.mesh``: ``make_production_mesh`` lays the default group's
256 or 512 ranks out as a ``DeviceMesh`` of shape (16, 16) with axes
("data", "model") or (2, 16, 16) with ("pod", "data", "model"), row-major
as the reference reshapes its devices. ``init_dryrun_process_group``
starts torch's ``fake`` backend, whose ranks are one process and move no
data: the counterpart of the reference's 512 fake XLA host devices.
``mesh_axis_sizes`` and ``sharding_rules`` feed ``models.sharding``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.util import resolve_device

__all__ = ["QueryMesh", "init_dryrun_process_group",
           "init_query_process_group", "make_production_mesh",
           "make_query_mesh", "mesh_axis_sizes", "sharding_rules"]


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


PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def init_dryrun_process_group(world_size: int) -> None:
    """Start the default process group on torch's ``fake`` backend at
    ``world_size`` ranks, all in this process (rank 0): a group that
    builds meshes and moves no data. The backend lives in a private module
    of torch; without it this raises."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process-group backend "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} does not have") from e
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group is already running (backend "
            f"{dist.get_backend()!r}, {dist.get_world_size()} ranks): the "
            "fake group of the dry run needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") mesh, over the default process
    group, which must hold exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    need = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {need} ranks, have "
            f"{have}: the dry run starts one with "
            f"init_dryrun_process_group({need})")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: extent} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def sharding_rules(mesh) -> dict:
    """Logical-axis -> mesh-axis rules (models/sharding.py consumes)."""
    names = tuple(mesh.mesh_dim_names)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    return {
        "batch": batch_axes,
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "expert_ffn": "model",
        "seq_kv": "model",
        "zero": "data",
        "fsdp": "data",
    }
