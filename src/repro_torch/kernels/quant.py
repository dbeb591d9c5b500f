"""Corpus quantization for the compressed score path, ported from
``repro.kernels.quant`` (DESIGN.md §12).

The replica halves (bf16) or quarters (int8) the bytes each gather or
scan kernel streams per corpus row; the engine restores exactness with
an f32 rerank of the over-fetched top ``k * rerank_mult`` through the
unquantized ``gather_l2_filter`` path.

Layout, as in the reference:

  * ``bf16``: ``qvecs = vecs.to(bfloat16)`` (round to nearest even), no
    scale plane.
  * ``int8``: symmetric per-row scaling, ``scale = max(|row|) / 127``
    (1 for an all-zero row), ``qvecs = clip(round(row / scale), -127,
    127)`` as int8, the scale kept as an ``(n, 1)`` f32 plane.

``torch.round`` rounds half to even like ``jnp.round``, and both
divisions are IEEE divisions on both devices, so the int8 replica is
bit-equal to the reference's. ``dequant_rows`` is the one
dequantization: the plain versions call it, and the CUDA kernels compute
the same expression (``float(row) * scale`` rounded on its own, then
``q - row``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["QUANTS", "quantize_rows_i8", "quant_replica", "dequant_rows",
           "quant_bytes_per_row"]

QUANTS = ("none", "bf16", "int8")


def quantize_rows_i8(vecs: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(..., n, d) float -> (qvecs (..., n, d) int8, scale (..., n, 1)
    f32)."""
    v = vecs.to(torch.float32)
    amax = v.abs().amax(-1, keepdim=True)
    # a tensor divisor, not a Python number: PyTorch's CUDA division by a
    # host scalar multiplies by its reciprocal, which is not IEEE division
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0),
                        torch.ones_like(amax))
    q = torch.round(v / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quant_replica(vecs: torch.Tensor, quant: str
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The compressed replica for ``quant`` in ("bf16", "int8"), over the
    last two axes: a single (n, d) corpus or a stacked (S, n, d) one."""
    if quant == "bf16":
        return vecs.to(torch.bfloat16).contiguous(), None
    if quant == "int8":
        q, s = quantize_rows_i8(vecs)
        return q.contiguous(), s.contiguous()
    raise ValueError(f"quant must be 'bf16' or 'int8', got {quant!r}")


def dequant_rows(rows: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 rows from a replica slice (and its scale rows)."""
    r = rows.to(torch.float32)
    if scale is not None:
        r = r * scale.to(torch.float32)
    return r


def quant_bytes_per_row(d: int, quant: str) -> int:
    """Bytes one corpus row costs a streaming kernel under ``quant``
    (int8 counts its 4-byte scale)."""
    if quant == "none":
        return 4 * d
    if quant == "bf16":
        return 2 * d
    if quant == "int8":
        return d + 4
    raise ValueError(f"unknown quant {quant!r}")
