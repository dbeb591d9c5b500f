"""Wrappers around the hand-written CUDA kernels.

Each wrapper takes tensors that all lie on one device and checks their
dtypes, shapes and contiguity. On the CPU it then calls the plain
version in ``ref.py``. On CUDA it allocates the outputs with
``torch.empty``, launches the kernel on the current stream and raises if
the launch reported an error; there is no fallback. ``LAUNCHES`` counts
kernel launches, one per wrapper call that reached the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build
from . import ref as _ref

__all__ = ["LAUNCHES", "reset_launches", "gather_l2_filter", "scan_topk",
           "l2dist_qn"]

LAUNCHES = {"gather_l2_filter": 0, "scan_topk": 0, "l2dist_qn": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _device_of(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"all tensors must lie on one device, got "
                             f"{dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fn(lib: str, sym: str, argtypes):
    f = getattr(_build.library(lib), sym)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def gather_l2_filter(idx: torch.Tensor, corpus: torch.Tensor,
                     attrs: torch.Tensor, q: torch.Tensor, qlo: torch.Tensor,
                     qhi: torch.Tensor) -> torch.Tensor:
    """idx (B, C) int32/int64, -1 = pad, into corpus (N, d) f32 and
    attrs (N, m) f32; q (B, d), qlo/qhi (B, m) f32 -> (B, C) f32 squared
    L2, +inf on pad, out-of-range-id or failed-predicate lanes."""
    dev = _device_of(idx, corpus, attrs, q, qlo, qhi)
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    _check(idx, "idx", idx.dtype, 2)
    for t, nm in ((corpus, "corpus"), (attrs, "attrs"), (q, "q"),
                  (qlo, "qlo"), (qhi, "qhi")):
        _check(t, nm, torch.float32, 2)
    B, C = idx.shape
    N, d = corpus.shape
    m = attrs.shape[1]
    if attrs.shape[0] != N or q.shape != (B, d) or qlo.shape != (B, m) \
            or qhi.shape != (B, m):
        raise ValueError("gather_l2_filter shape mismatch: idx "
                         f"{tuple(idx.shape)}, corpus {tuple(corpus.shape)}, "
                         f"attrs {tuple(attrs.shape)}, q {tuple(q.shape)}, "
                         f"qlo {tuple(qlo.shape)}, qhi {tuple(qhi.shape)}")
    if dev.type == "cpu":
        return _ref.gather_l2_filter_ref(idx, corpus, attrs, q, qlo, qhi)
    if B > 65535:
        raise ValueError(f"gather_l2_filter takes at most 65535 rows, got {B}")
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    sym = "gather_l2_filter_i64" if idx.dtype == torch.int64 \
        else "gather_l2_filter_i32"
    f = _fn("gather_l2_filter", sym, [_P] * 7 + [_I] * 5 + [_P])
    rc = f(idx.data_ptr(), corpus.data_ptr(), attrs.data_ptr(), q.data_ptr(),
           qlo.data_ptr(), qhi.data_ptr(), out.data_ptr(), B, C, N, d, m,
           _stream(dev))
    _raise_on(rc, "gather_l2_filter")
    LAUNCHES["gather_l2_filter"] += 1
    return out


def _scan_chunking(B: int, N: int, sms: int) -> Tuple[int, int]:
    """(chunk_rows, nchunks) for the scan's first pass: about four blocks
    per SM across all 64-query tiles, each chunk a multiple of 64 rows."""
    qtiles = -(-B // 64)
    want = max(1, min(-(-N // 64), -(-4 * sms // qtiles)))
    rows = -(-N // want)
    rows = -(-rows // 64) * 64
    return rows, -(-N // rows)


def scan_topk(corpus: torch.Tensor, attrs: torch.Tensor, q: torch.Tensor,
              qlo: torch.Tensor, qhi: torch.Tensor, *, k: int):
    """Exact masked top-k over every row: corpus (N, d), attrs (N, m),
    q (B, d), qlo/qhi (B, m), all f32 -> (ids (B, k) int32, dists (B, k)
    f32), ascending by (distance, id), (-1, +inf) past the in-range count.
    The kernel takes k <= 64 and m <= 8."""
    dev = _device_of(corpus, attrs, q, qlo, qhi)
    N, d = corpus.shape
    if not 1 <= k <= N:
        raise ValueError(f"k must be in [1, N={N}], got {k}")
    for t, nm in ((corpus, "corpus"), (attrs, "attrs"), (q, "q"),
                  (qlo, "qlo"), (qhi, "qhi")):
        _check(t, nm, torch.float32, 2)
    B = q.shape[0]
    m = attrs.shape[1]
    if attrs.shape[0] != N or q.shape[1] != d or qlo.shape != (B, m) \
            or qhi.shape != (B, m):
        raise ValueError("scan_topk shape mismatch")
    if dev.type == "cpu":
        return _ref.scan_topk_ref(corpus, attrs, q, qlo, qhi, k)
    if k > 64:
        raise ValueError(f"the scan kernel takes k <= 64, got {k}")
    if m > 8:
        raise ValueError(f"the scan kernel takes m <= 8 attributes, got {m}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, nchunks = _scan_chunking(B, N, sms)
    part_d = torch.empty((B, nchunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, nchunks, k), dtype=torch.int32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    dists = torch.empty((B, k), dtype=torch.float32, device=dev)
    f = _fn("scan_topk", "scan_topk_f32", [_P] * 9 + [_I] * 7 + [_P])
    rc = f(corpus.data_ptr(), attrs.data_ptr(), q.data_ptr(), qlo.data_ptr(),
           qhi.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
           ids.data_ptr(), dists.data_ptr(), B, N, d, m, k, rows, nchunks,
           _stream(dev))
    _raise_on(rc, "scan_topk")
    LAUNCHES["scan_topk"] += 1
    return ids, dists


def l2dist_qn(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """All-pairs squared L2 by the expansion: q (B, d), c (N, d) ->
    (B, N), or batched q (G, B, d), c (G, N, d) -> (G, B, N); f32."""
    dev = _device_of(q, c)
    if q.dim() != c.dim() or q.dim() not in (2, 3):
        raise ValueError(f"l2dist_qn takes (B, d) x (N, d) or batched "
                         f"(G, B, d) x (G, N, d), got {tuple(q.shape)} x "
                         f"{tuple(c.shape)}")
    _check(q, "q", torch.float32, q.dim())
    _check(c, "c", torch.float32, c.dim())
    batched = q.dim() == 3
    qb = q if batched else q[None]
    cb = c if batched else c[None]
    G, B, d = qb.shape
    if cb.shape[0] != G or cb.shape[2] != d:
        raise ValueError("l2dist_qn shape mismatch")
    N = cb.shape[1]
    if dev.type == "cpu":
        return _ref.l2dist_qn_ref(q, c)
    if G > 65535 or math.ceil(B / 64) > 65535:
        raise ValueError("l2dist_qn grid too large: split the batch")
    out = torch.empty((G, B, N), dtype=torch.float32, device=dev)
    f = _fn("l2dist", "l2dist_qn_f32", [_P] * 3 + [_I] * 4 + [_L] * 3 + [_P])
    rc = f(qb.data_ptr(), cb.data_ptr(), out.data_ptr(), G, B, N, d,
           B * d, N * d, B * N, _stream(dev))
    _raise_on(rc, "l2dist_qn")
    LAUNCHES["l2dist_qn"] += 1
    return out if batched else out[0]
