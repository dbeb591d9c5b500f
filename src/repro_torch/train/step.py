"""The training step, the counterpart of ``repro.train.step``: gradients
by autograd, accumulated in f32 over ``n_micro`` equal slices of the
batch, then one AdamW update.

The reference runs the microbatches as a ``lax.scan`` inside one jitted
program; here they run one after another, each slice's backward freeing
its activations before the next (the config's remat policy applies inside
each). A slice's gradients are added to the f32 sums as ``g / n_micro``,
as the reference adds them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import tree_leaves, tree_map

__all__ = ["make_train_step"]

F32 = torch.float32


def _split_micro(batch: Dict[str, Any], n: int):
    """The batch as n equal slices of its leading (batch) axis."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k} of {v.shape[0]} rows does not "
                             f"split into {n} microbatches")
    return [{k: v.chunk(n, dim=0)[i] for k, v in batch.items()}
            for i in range(n)]


def _grads_of(params, cfg: ModelConfig, batch):
    """(loss + aux, metrics, grads of every parameter leaf: its dtype; 0
    for a leaf the loss does not read, as ``jax.grad`` gives)."""
    leaves = tree_leaves(params)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        total, metrics = M.loss_fn(live, cfg, batch)
        grads = torch.autograd.grad(total, tree_leaves(live),
                                    allow_unused=True,
                                    materialize_grads=True)
    by_id = dict(zip(map(id, leaves), grads))
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_id[id(p)], params))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    n_micro: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): metrics {"loss", "aux", "lr", "grad_norm"} as 0-d tensors
    (with n_micro > 1 "loss" is the mean of the slices' loss + aux and
    "aux" 0, as the reference's)."""
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            _, metrics, grads = _grads_of(params, cfg, batch)
        else:
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                params)
            loss = torch.zeros((), dtype=F32,
                               device=tree_leaves(params)[0].device)
            for mb in _split_micro(batch, n_micro):
                total, _, g = _grads_of(params, cfg, mb)
                grads = tree_map(lambda a, x: a + x.to(F32) / n_micro,
                                 grads, g)
                loss = loss + total / n_micro
                del g
            metrics = {"loss": loss, "aux": torch.zeros_like(loss)}
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
