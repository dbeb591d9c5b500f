"""AdamW, the counterpart of ``repro.optim.adamw``: f32 moments,
global-norm clip, linear warmup + cosine decay, decoupled weight decay,
in the reference's f32 arithmetic.

Trees are the model's nested dicts and lists of tensors. The step is a
0-d int32 tensor on the parameters' device. The update builds new
tensors (the reference's functions are pure); nothing is written in
place. ``opt_logical_axes`` names the ZeRO-1 layout as annotations only,
as ``models/sharding.py`` does: the port runs on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List

import torch

__all__ = ["AdamWConfig", "schedule", "init_opt_state", "global_norm",
           "adamw_update", "opt_logical_axes"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` (dicts, lists, tuples) and the
    matching leaves of ``rest``, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in the reference's order (``jax.tree.leaves``: dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_pick(tree, i: int):
    """Element i of the tuple at each leaf of ``tree`` (a ``tree_map``
    whose function returned tuples), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_pick(v, i) for v in tree]
    return tree[i]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup, then a
    cosine from peak_lr down to min_lr_ratio x peak_lr."""
    step = step.to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves, in the reference's order, of each
    leaf's sum of squares in f32."""
    total = None
    for g in tree_leaves(tree):
        s = torch.sum(torch.square(g.to(F32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics {"lr", "grad_norm"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32,
                                       device=stepf.device), stepf)

    def upd(p, g, mu, nu):
        g = g.to(F32) * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / b1c
        nhat = nu / b2c
        step_t = mhat / (torch.sqrt(nhat) + cfg.eps)
        p32 = p.to(F32)
        newp = p32 - lr * (step_t + cfg.weight_decay * p32)
        return newp.to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_state = {"mu": tree_pick(out, 1), "nu": tree_pick(out, 2),
                 "step": step}
    return tree_pick(out, 0), new_state, {"lr": lr, "grad_norm": gnorm}


def opt_logical_axes(param_axes) -> dict:
    """ZeRO-1 as names: the ``zero`` logical axis (the reference maps it to
    ``data``) on the first un-sharded dim of each moment leaf."""
    def zeroify(ax):
        ax = tuple(ax)
        for i, a in enumerate(ax):
            if a is None:
                return ax[:i] + ("zero",) + ax[i + 1:]
        return ax

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return zeroify(t)

    mom = walk(param_axes)
    return {"mu": mom, "nu": mom, "step": ()}
