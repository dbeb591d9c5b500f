"""Gradient compression for the data-parallel all-reduce, the counterpart
of ``repro.train.compressed``: int8 quantization with error feedback.

Each replica keeps a residual; gradient + residual is quantized per
tensor to int8 (scale max|v| / 127, rounding half to even as
``jnp.round``), dequantized, and the dequantized f32 is summed over the
process group and divided by its size; the quantization error feeds
back into the next step's residual, so the long-run update is unbiased.
The reference sums with ``psum`` inside ``shard_map`` over its data
axis; here the sum is one ``torch.distributed.all_reduce`` a leaf over a
process group the caller initialized (NCCL on cards, gloo on the CPU).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..optim.adamw import tree_map, tree_pick

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "init_residual"]

F32 = torch.float32


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 tensor, its f32 0-d scale max(max|x|, 1e-12) / 127)."""
    x = x.to(F32)
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def init_residual(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def compressed_psum(grads, residual, group: Optional[Any] = None):
    """Per leaf: (grad + residual) -> int8 -> dequantized, summed over
    ``group`` (the default process group when None) and divided by its
    size. Returns (mean grads, new residuals), f32."""
    n = dist.get_world_size(group)

    def one(g, r):
        v = g.to(F32) + r
        local = dequantize_int8(*quantize_int8(v))
        new_r = v - local                          # error feedback
        total = local.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total / n, new_r

    out = tree_map(one, grads, residual)
    return tree_pick(out, 0), tree_pick(out, 1)
