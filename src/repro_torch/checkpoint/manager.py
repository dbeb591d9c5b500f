"""Checkpoints of trees of tensors, ported from ``repro.checkpoint.manager``
(DESIGN.md §2).

A checkpoint is a directory ``step_<N>/`` holding one ``arrays.npz``, the
leaves keyed by their path in the tree, and ``meta.json``. It is written
into a tmp dir that is then renamed, so a process that dies while saving
never leaves a broken latest checkpoint, and ``latest_step`` names the
one to resume from.

A tree is a dict, list, tuple, NamedTuple or dataclass of tensors (numpy
arrays and Python numbers are leaves too; ``None`` holds no leaf). The
keys are the reference's: dict keys in sorted order, list and tuple
positions, and ``.name`` for a NamedTuple's or a dataclass's field
(``jax.tree_util``'s path strings for the same structure, a dataclass as
``register_dataclass`` flattens it), joined by ``/``. So a directory
written by either package loads in the other. A bf16 leaf is written as
the reference writes it, its raw 2-byte words as numpy's void ``V2``;
``restore_into`` reinterprets such a leaf's bytes as bf16 (the reference
cannot cast it back, ROADMAP F7).

``restore_into`` puts each leaf on its template leaf's device and dtype,
so a checkpoint taken on one device restores onto another.
``AsyncCheckpointer`` snapshots the tensors to the host synchronously and
writes on a background thread; ``keep`` bounds the checkpoints kept.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "restore_into",
           "latest_step", "AsyncCheckpointer"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _children(x) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a tree node in the reference's order, or None
    for a leaf."""
    if isinstance(x, dict):
        return [(str(k), x[k]) for k in sorted(x)]
    if _is_namedtuple(x):
        return [("." + f, getattr(x, f)) for f in x._fields]
    if isinstance(x, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(x)]
    if _is_dataclass(x):
        return [("." + f.name, getattr(x, f.name))
                for f in dataclasses.fields(x)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the reference's order; ``None`` holds no leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, c in kids:
        out += _flatten(c, f"{prefix}/{k}" if prefix else k)
    return out


def _rebuild(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """A copy of ``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None

    def sub(k, c):
        return _rebuild(c, fn, f"{prefix}/{k}" if prefix else k)

    if isinstance(tree, dict):
        return type(tree)((k, sub(str(k), c)) for k, c in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(sub("." + f, getattr(tree, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(str(i), c) for i, c in enumerate(tree))
    if _is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: sub("." + f.name, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return fn(prefix, tree)


def _snapshot(leaf):
    """A host copy of a leaf that later writes to the original cannot
    change: tensors are copied to the CPU (synchronously)."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        return t.cpu() if t.device.type != "cpu" else t.clone()
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def _to_numpy(leaf) -> np.ndarray:
    """The array the reference would write for this leaf: a bf16 tensor as
    its raw 2-byte words (void ``V2``)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _from_saved(v: np.ndarray) -> torch.Tensor:
    """A saved leaf as a tensor; a 2-byte void leaf is bf16 bytes."""
    if v.dtype.kind == "V" and v.dtype.itemsize == 2:
        return torch.from_numpy(
            np.ascontiguousarray(v).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(v))


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    meta: Optional[dict] = None) -> pathlib.Path:
    """Write ``tree`` as ``ckpt_dir/step_<step>`` through a tmp dir and a
    rename; ``meta`` goes into ``meta.json`` beside ``step``."""
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f".tmp_step_{step}"
    final = base / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree)}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "meta.json").write_text(json.dumps(
        {"step": step, **(meta or {})}, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_*")]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None):
    """(arrays {path: numpy array}, meta dict) of ``step`` (the latest by
    default); bf16 leaves come back as void ``V2`` arrays."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step}"
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads((d / "meta.json").read_text())
    return arrays, meta


def restore_into(template: Any, arrays: dict) -> Any:
    """The tree of ``template`` rebuilt from saved leaves: each leaf takes
    its template leaf's dtype and, for a tensor, its device (a numpy
    template leaf gives a numpy array). Raises ``KeyError`` for a leaf
    the checkpoint lacks and ``ValueError`` for a shape that differs."""
    def leaf(key, t):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        v = arrays[key]
        if hasattr(t, "shape") and tuple(t.shape) != tuple(v.shape):
            raise ValueError(f"{key}: shape {v.shape} != template "
                             f"{tuple(t.shape)}")
        x = _from_saved(v)
        if torch.is_tensor(t):
            return x.to(device=t.device, dtype=t.dtype)
        if isinstance(t, np.ndarray):
            if x.dtype == torch.bfloat16:
                x = x.to(torch.float32)
            return x.numpy().astype(t.dtype)
        return x
    return _rebuild(template, leaf)


class AsyncCheckpointer:
    """Non-blocking checkpointer that keeps the newest ``keep``."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def wait(self):
        """Join the outstanding write; a write that failed raises here,
        once, on the caller's thread."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        """Snapshot ``tree`` to the host now (a device tensor by a
        synchronous ``.cpu()``), then write it on a thread. One write is
        outstanding at a time: this waits for the previous one."""
        self.wait()
        host_tree = _rebuild(tree, lambda _k, v: _snapshot(v))

        def work():
            try:
                save_checkpoint(str(self.dir), step, host_tree, meta)
                self._gc()
            except Exception as e:
                # raised by the next wait(); KeyboardInterrupt and
                # SystemExit are not save errors and are not kept
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
