"""Peaks of one NVIDIA H100 SXM5 card and the operations and bytes of the
port's hand kernels, frozen for the benchmark.

The peaks are the data sheet's dense rates at the 700 W power limit (the
figures of ``repro_torch.launch.roofline`` and ``chip_smoke.py``); a
share of them is stated beside the card's power limit. The formulas are
those of the port's kernel table (rows 1, 2 and 3 of ``chip_smoke.py``'s
``kernel_checks``): every input byte read once, every output byte written
once, and work that depends on the data counted as these inputs need it.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS", "TF32_FLOPS", "bound_s",
           "gather_l2_filter_cost", "box_scan_cost", "l2dist_qn_cost"]

HBM_BYTES_PER_S = 3.35e12      # H100 SXM5 HBM3
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
TF32_FLOPS = 495e12            # TF32 tensor cores, dense


def bound_s(n_bytes: float, n_ops: float, flops: float = FP32_FLOPS):
    """-> (least seconds the card could take, "bytes" or "operations")."""
    tb = n_bytes / HBM_BYTES_PER_S
    to = n_ops / flops
    return (tb, "bytes") if tb >= to else (to, "operations")


def gather_l2_filter_cost(B: int, C: int, d: int, m: int, idx_itemsize: int,
                          row_bytes: int, n_valid: int, n_pass: int):
    """Row 1, the fused gather: ids (B, C), the query and its box read
    once, the attributes of each in-range id, the row of each id that
    passes its box, one f32 distance written per slot; a subtract and a
    multiply-add per (passing id, dimension). -> (bytes, operations)."""
    n_bytes = (B * C * idx_itemsize + B * C * 4 + B * d * 4 + 2 * B * m * 4
               + n_valid * m * 4 + n_pass * row_bytes)
    return n_bytes, 3.0 * n_pass * d


def box_scan_cost(B: int, N: int, d: int, m: int, k: int, row_bytes: int,
                  n_pairs: int):
    """Row 2, the box scan: every corpus row and its attributes read once,
    the queries and boxes read once, (id, distance) top-k written; three
    operations per (passing pair, dimension). -> (bytes, operations)."""
    n_bytes = (N * row_bytes + N * m * 4 + B * d * 4 + 2 * B * m * 4
               + B * k * 8)
    return n_bytes, 3.0 * n_pairs * d


def l2dist_qn_cost(G: int, B: int, N: int, d: int):
    """Row 3, all-pairs distances by the expansion, each product as three
    TF32 products: inputs read once and the (G, B, N) f32 output written
    once. -> (bytes, TF32 operations, fp32 operations of the norms)."""
    n_bytes = G * (B * d + N * d + B * N) * 4
    return n_bytes, 3 * 2.0 * G * B * N * d, 2.0 * G * (B + N) * d
