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
from typing import NamedTuple, Optional

import torch

from . import _build
from . import ref as _ref

__all__ = ["LAUNCHES", "reset_launches", "gather_l2_filter",
           "gather_l2_filter_q8", "gather_l2", "scan_topk", "scan_topk_q8",
           "scan_topk_mask", "scan_topk_windows", "l2dist", "l2dist_qn",
           "l2dist_qc", "SCAN_TILES", "SCAN_KMAX", "SCAN_MMAX",
           "WIDE_STATS"]

# one count per kernel form (the scan family's wide forms, which take a k
# or m the narrow kernels do not, count apart): the bf16 forms of
# gather_l2_filter and scan_topk are the same sources instantiated for a
# bf16 corpus, counted apart because the bf16 replica's path and a
# bf16-stored index run them, as are the bitmask and windowed scans' bf16
# forms (a bf16-stored index);
# the unfused gathers and l2dist_qc count their bf16 instances with their
# f32 ones
LAUNCHES = {"gather_l2_filter": 0, "gather_l2_filter_bf16": 0,
            "gather_l2_filter_q8": 0, "gather_l2": 0, "gather_l2_rows": 0,
            "scan_topk": 0, "scan_topk_bf16": 0, "scan_topk_q8": 0,
            "scan_topk_mask": 0, "scan_topk_mask_bf16": 0,
            "scan_topk_windows": 0, "scan_topk_windows_bf16": 0,
            "scan_topk_wide": 0, "scan_topk_wide_bf16": 0,
            "scan_topk_wide_q8": 0, "scan_topk_windows_wide": 0,
            "scan_topk_windows_wide_bf16": 0, "scan_topk_mask_wide": 0,
            "scan_topk_mask_wide_bf16": 0,
            "l2dist_qn": 0, "l2dist_qc": 0}

# the box scan's last launch per form: a device tensor of its (empty,
# sparse, dense) tile counts, summed over query blocks; the windowed form's
# leads with the tiles no lane of a query block covers
SCAN_TILES = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

_KIND = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def _corpus_kind(corpus: torch.Tensor) -> str:
    kind = _KIND.get(corpus.dtype)
    if kind is None:
        raise TypeError(f"corpus must be float32 or bfloat16, got "
                        f"{corpus.dtype}")
    _check(corpus, "corpus", corpus.dtype, 2)
    return kind


def _check_qscale(qcorpus: torch.Tensor, qscale: torch.Tensor) -> None:
    _device_of(qcorpus, qscale)
    _check(qcorpus, "qcorpus", torch.int8, 2)
    _check(qscale, "qscale", torch.float32, 2)
    if qscale.shape != (qcorpus.shape[0], 1):
        raise ValueError(f"qscale must be ({qcorpus.shape[0]}, 1), got "
                         f"{tuple(qscale.shape)}")


def _form(name: str, kind: str) -> str:
    """The ``LAUNCHES`` key of a kernel form: the f32 form keeps the
    wrapper's name, the others add their corpus kind."""
    return name if kind == "f32" else f"{name}_{kind}"


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


def _check_gather(idx, corpus, attrs, q, qlo, qhi) -> torch.device:
    dev = _device_of(idx, corpus, attrs, q, qlo, qhi)
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    _check(idx, "idx", idx.dtype, 2)
    for t, nm in ((attrs, "attrs"), (q, "q"), (qlo, "qlo"), (qhi, "qhi")):
        _check(t, nm, torch.float32, 2)
    B = idx.shape[0]
    N, d = corpus.shape
    m = attrs.shape[1]
    if attrs.shape[0] != N or q.shape != (B, d) or qlo.shape != (B, m) \
            or qhi.shape != (B, m):
        raise ValueError("gather_l2_filter shape mismatch: idx "
                         f"{tuple(idx.shape)}, corpus {tuple(corpus.shape)}, "
                         f"attrs {tuple(attrs.shape)}, q {tuple(q.shape)}, "
                         f"qlo {tuple(qlo.shape)}, qhi {tuple(qhi.shape)}")
    return dev


def _launch_gather(kind: str, idx, corpus, scale, attrs, q, qlo, qhi):
    B, C = idx.shape
    N, d = corpus.shape
    if B > 65535:
        raise ValueError(f"gather_l2_filter takes at most 65535 rows, got {B}")
    dev = idx.device
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    ib = "i64" if idx.dtype == torch.int64 else "i32"
    f = _fn("gather_l2_filter", f"gather_l2_filter_{kind}_{ib}",
            [_P] * 8 + [_I] * 5 + [_P])
    rc = f(idx.data_ptr(), corpus.data_ptr(),
           None if scale is None else scale.data_ptr(), attrs.data_ptr(),
           q.data_ptr(), qlo.data_ptr(), qhi.data_ptr(), out.data_ptr(),
           B, C, N, d, attrs.shape[1], _stream(dev))
    name = _form("gather_l2_filter", kind)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def gather_l2_filter(idx: torch.Tensor, corpus: torch.Tensor,
                     attrs: torch.Tensor, q: torch.Tensor, qlo: torch.Tensor,
                     qhi: torch.Tensor) -> torch.Tensor:
    """idx (B, C) int32/int64, -1 = pad, into corpus (N, d) f32 or bf16
    and attrs (N, m) f32; q (B, d), qlo/qhi (B, m) f32 -> (B, C) f32
    squared L2 (accumulated in f32), +inf on pad, out-of-range-id or
    failed-predicate lanes."""
    kind = _corpus_kind(corpus)
    dev = _check_gather(idx, corpus, attrs, q, qlo, qhi)
    if dev.type == "cpu":
        return _ref.gather_l2_filter_ref(idx, corpus, attrs, q, qlo, qhi)
    return _launch_gather(kind, idx, corpus, None, attrs, q, qlo, qhi)


def gather_l2_filter_q8(idx: torch.Tensor, qcorpus: torch.Tensor,
                        qscale: torch.Tensor, attrs: torch.Tensor,
                        q: torch.Tensor, qlo: torch.Tensor,
                        qhi: torch.Tensor) -> torch.Tensor:
    """``gather_l2_filter`` over an int8 replica: qcorpus (N, d) int8 and
    its per-row scale qscale (N, 1) f32; each gathered row is dequantized
    (``float(row) * scale``) before it is scored."""
    _check_qscale(qcorpus, qscale)
    dev = _check_gather(idx, qcorpus, attrs, q, qlo, qhi)
    if dev.type == "cpu":
        return _ref.gather_l2_filter_q8_ref(idx, qcorpus, qscale, attrs, q,
                                            qlo, qhi)
    return _launch_gather("q8", idx, qcorpus, qscale, attrs, q, qlo, qhi)


def gather_l2(idx: torch.Tensor, corpus: torch.Tensor, q: torch.Tensor, *,
              c_blk: Optional[int] = None) -> torch.Tensor:
    """Fused gather + squared L2 with no predicate: idx (B, C) int32/int64
    into corpus (N, d) f32 or bf16, q (B, d) f32 -> (B, C) f32
    ``sum((q - corpus[idx])^2)``, accumulated in f32. Ids must be in range
    (clamp upstream); one outside [0, N) gives +inf and reads nothing.
    ``c_blk=None`` runs the row-per-step kernel (one candidate row per
    block, the reference's validation form); an int runs the blocked
    kernel (8 rows a block, one query staged per block; the int selects
    the form, the block shape is the kernel's). Both forms, and
    ``gather_l2_filter``'s finite lanes on the same ids, are bitwise
    equal."""
    kind = _corpus_kind(corpus)
    dev = _device_of(idx, corpus, q)
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    _check(idx, "idx", idx.dtype, 2)
    _check(q, "q", torch.float32, 2)
    B, C = idx.shape
    N, d = corpus.shape
    if q.shape != (B, d):
        raise ValueError(f"gather_l2 shape mismatch: idx {tuple(idx.shape)}, "
                         f"corpus {tuple(corpus.shape)}, q {tuple(q.shape)}")
    if c_blk is not None and c_blk < 1:
        raise ValueError(f"c_blk must be None or >= 1, got {c_blk}")
    if dev.type == "cpu":
        return _ref.gather_l2_ref(idx, corpus, q)
    if B > 65535:
        raise ValueError(f"gather_l2 takes at most 65535 rows, got {B}")
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    ib = "i64" if idx.dtype == torch.int64 else "i32"
    name = "gather_l2" if c_blk is not None else "gather_l2_rows"
    f = _fn("gather_l2_filter", f"{name}_{kind}_{ib}",
            [_P] * 4 + [_I] * 4 + [_P])
    rc = f(idx.data_ptr(), corpus.data_ptr(), q.data_ptr(), out.data_ptr(),
           B, C, N, d, _stream(dev))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# the box scan's pass 1 (scan_topk.cu box_scan_kernel): queries a block
# owns, row tiles it may take, and the shared memory a block may have
SCAN_QUERY_BLOCK = 256
SCAN_TILE_ROWS = (256, 128, 64)
SMEM_LIMIT = 232_448


class ScanPlan(NamedTuple):
    tile_rows: int       # rows of a tile, the unit a block takes at a time
    tiles: int           # tiles covering [0, N)
    blocks: int          # blocks a query block runs (grid x): one an SM
    query_blocks: int    # grid y, one per SCAN_QUERY_BLOCK queries
    smem: int            # dynamic shared memory of a block, in bytes


def _scan_smem_bytes(tile_rows: int, k: int) -> int:
    """scan_topk.cu box_scan_smem_words * 4: two 16-wide slab stages of
    256 queries + tile_rows rows (stride 20 floats), the top-k (k x 256
    dists and ids), a round's slots, then distances (max(8192, 256 x 33)),
    the pass bits, the tile's attrs (rows of 8 floats) and int8 scales,
    the class counts (8 x 256 bytes), 33 group slot bases, 16 ints, and
    each query's k-th entry and buffered pair count (3 x 256)."""
    bq = SCAN_QUERY_BLOCK
    words = (2 * (bq + tile_rows) * 20 + 2 * k * bq + max(8192, bq * 33)
             + (tile_rows // 32) * bq + tile_rows * 8 + tile_rows + 2 * bq
             + bq // 8 + 1 + 16 + 3 * bq)
    return 4 * words


def _scan_plan(B: int, N: int, k: int, sms: int) -> ScanPlan:
    """The box scan's launch: the tallest row tile whose shared memory fits
    a block (the queries are staged once per tile, so a taller tile reads
    them fewer times), and one block an SM per 256-query block, each
    pulling tiles until none is left. Neither d (streamed in slabs) nor m
    (attrs padded to 8) changes it. Raises where the grid cannot hold the
    batch."""
    for tr in SCAN_TILE_ROWS:
        smem = _scan_smem_bytes(tr, k)
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"the scan kernel has no tile for k={k}")
    tiles = -(-N // tr)
    qblocks = -(-B // SCAN_QUERY_BLOCK)
    if qblocks > 65535:
        raise ValueError(f"the scan kernel takes at most "
                         f"{65535 * SCAN_QUERY_BLOCK} queries, got {B}")
    return ScanPlan(tr, tiles, max(1, min(tiles, sms)), qblocks, smem)


# the bitmask scan's first pass: queries and rows a block owns per tile
# (scan_topk.cu MQ, MR); they set only how many chunks the grid has
MASK_QUERY_TILE = 128
MASK_ROW_TILE = 64


def _mask_chunking(B: int, N: int, sms: int) -> int:
    """Chunks of the bitmask scan's first pass: about eight blocks per SM
    across all 128-query tiles, and no chunk without a row when all N rows
    pass. The kernel splits the real passing count evenly over them, in
    64-row tiles."""
    qtiles = -(-B // MASK_QUERY_TILE)
    want = max(1, min(-(-N // MASK_ROW_TILE), -(-8 * sms // qtiles)))
    rows = -(-N // want)
    rows = -(-rows // MASK_ROW_TILE) * MASK_ROW_TILE
    return -(-N // rows)             # <= 8 * sms: grid y <= 65535


def _check_scan(corpus, attrs, q, qlo, qhi, k) -> torch.device:
    dev = _device_of(corpus, attrs, q, qlo, qhi)
    N, d = corpus.shape
    if not 1 <= k <= N:
        raise ValueError(f"k must be in [1, N={N}], got {k}")
    for t, nm in ((attrs, "attrs"), (q, "q"), (qlo, "qlo"), (qhi, "qhi")):
        _check(t, nm, torch.float32, 2)
    B = q.shape[0]
    m = attrs.shape[1]
    if attrs.shape[0] != N or q.shape[1] != d or qlo.shape != (B, m) \
            or qhi.shape != (B, m):
        raise ValueError("scan_topk shape mismatch")
    return dev


def _scan_buffers(B: int, nchunks: int, k: int, dev):
    part_d = torch.empty((B, nchunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, nchunks, k), dtype=torch.int32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    dists = torch.empty((B, k), dtype=torch.float32, device=dev)
    return part_d, part_i, ids, dists


# the narrow scan kernels' limits (scan_topk.cu KMAX, MMAX: each query's
# running top-k lives in shared memory, the attrs in rows of 8): a larger
# k or m takes the wide form (scan_topk_wide.cu), which takes any k and m
SCAN_KMAX = 64
SCAN_MMAX = 8
# the wide forms' scratch a call, at most (one query chunk at a time)
WIDE_SCRATCH_BYTES = 1 << 30
# the wide forms: a sample pass over 1 in
# WIDE_SAMPLE_STRIDE row tiles (of the bitmask's compacted rows: 64-row
# tiles) gives each query a threshold, then each query's candidate list holds up to `cap`
# keys (WIDE_CAND_MIN at least, or N); WIDE_CAPACITY forces a capacity
# (at least k), so a test can make lists overflow
WIDE_SAMPLE_STRIDE = 16
WIDE_CAND_MIN = 1 << 16
WIDE_CAPACITY: Optional[int] = None
# the bitmask compaction's segment (scan_topk.cu SEG)
MASK_SEGMENT = 8192
# per wide form, its last call's device tensor (B + 1,)
# int32: each query's listed candidates (pairs within its threshold),
# then the queries whose lists overflowed (finished by the exact re-pass)
WIDE_STATS = {}
# a list to time their phases by: each such call appends (phase,
# torch.cuda.Event) at its start and after each phase (sample, score,
# select; per query chunk)
WIDE_MARKS: Optional[list] = None


class WidePlan(NamedTuple):
    chunk: int     # queries a pass takes
    cap: int       # keys a query's candidate list holds
    scratch: int   # bytes a call allocates besides its outputs


def _wide_plan(B: int, N: int, k: int, mask: bool = False,
               windows: bool = False) -> WidePlan:
    """A wide form's scratch: per query chunk a list of cap u64 keys a
    query and the select's 2 x k keys (and, windowed, the chunk's
    coverage: a bitmap row of ceil(N / 32) words a query, a byte per
    (256-query block, row tile of at least 64 rows)); per call the count,
    tau and stats of every query, the box pass's tile counters (one more,
    windowed) and, for the bitmask, its compacted rows. The list holds
    about k x the sample's inverse (16) where every row passes, 4x that
    room (at least WIDE_CAND_MIN, at most N); the chunk keeps the scratch
    within ``WIDE_SCRATCH_BYTES``, at least one query."""
    if WIDE_CAPACITY is not None:
        cap = max(k, WIDE_CAPACITY)
    else:
        cap = max(k, min(N, max(WIDE_CAND_MIN,
                                4 * WIDE_SAMPLE_STRIDE * k)))
    fixed = 12 * B + 4
    if mask:
        fixed += 4 * (N + -(-N // MASK_SEGMENT) + 1)
    per = 8 * cap + 16 * k + (4 * -(-N // 32) if windows else 0)
    chunk = max(1, min(B, (WIDE_SCRATCH_BYTES - fixed) // per))
    qblocks = -(-chunk // SCAN_QUERY_BLOCK)
    sched = 0 if mask else 4 * (qblocks + 3 + windows)
    if windows:                      # the tile flags, in int32 words
        sched += 4 * -(-qblocks * -(-N // SCAN_TILE_ROWS[-1]) // 4)
    return WidePlan(chunk, cap, fixed + sched + chunk * per)


def _launch_list_wide(kind: str, corpus, side, attrs, q, qlo, qhi, k: int,
                      windows=None):
    """The box (``qlo`` given; ``side`` the int8 scale), windowed (``qlo``
    and ``windows`` = (starts, counts) given) or bitmask (``side`` the
    mask) wide form: per query chunk (the windowed form's coverage of the
    chunk first, by scan_topk.cu's pre-pass at the score passes' tile
    height) a sample pass and the thresholds, the score pass into the
    candidate lists, the exact re-pass of the queries whose lists
    overflowed, and the select (scan_topk_wide.cu). No host sync."""
    N, d = corpus.shape
    B = q.shape[0]
    mask = qlo is None
    m = 0 if mask else qlo.shape[1]
    dev = corpus.device
    name = _form("scan_topk_mask_wide" if mask else "scan_topk_windows_wide"
                 if windows is not None else "scan_topk_wide", kind)
    plan = _wide_plan(B, N, k, mask, windows is not None)
    marks = WIDE_MARKS

    def mark(phase):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((phase, ev))

    def ptr(t, row=0):
        return None if t is None else t[row:].data_ptr()

    mark("start")
    stream = _stream(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    dists = torch.empty((B, k), dtype=torch.float32, device=dev)
    lists = torch.empty(plan.chunk * plan.cap, dtype=torch.int64, device=dev)
    keys = torch.empty(2 * plan.chunk * k, dtype=torch.int64, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    tau = torch.empty(B, dtype=torch.float32, device=dev)
    stats = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    if mask:
        rows = torch.empty(N + -(-N // MASK_SEGMENT) + 1, dtype=torch.int32,
                           device=dev)
        rc = _fn("scan_topk_wide", "wide_mask_compact", [_P, _I, _P, _P])(
            side.data_ptr(), N, rows.data_ptr(), stream)
        _raise_on(rc, name)
        score = _fn("scan_topk_wide", f"wide_mask_list_{kind}",
                    [_P] * 6 + [_I] * 6 + [_P])
        over = _fn("scan_topk_wide", f"wide_mask_overflow_{kind}",
                   [_P] * 8 + [_I] * 5 + [_P])
    else:
        sp = _scan_plan(plan.chunk, N, 0, sms)
        sched = torch.empty(sp.query_blocks + 3 + (windows is not None),
                            dtype=torch.int32, device=dev)
        score = _fn("scan_topk_wide", f"wide_box_list_{kind}",
                    [_P] * 11 + [_I] * 9 + [_P])
        over = _fn("scan_topk_wide", f"wide_box_overflow_{kind}",
                   [_P] * 12 + [_I] * 6 + [_P])
    tau_fn = _fn("scan_topk_wide", "wide_list_tau",
                 [_P] * 2 + [_I] * 3 + [_P] * 2)
    select = _fn("scan_topk_wide", "wide_list_select",
                 [_P] * 2 + [_I] * 3 + [_P] * 4)
    cov = None
    for b0 in range(0, B, plan.chunk):
        nb = min(plan.chunk, B - b0)
        if windows is not None:        # the chunk's lanes, as its own batch
            cov = _window_cover(windows[0][b0:b0 + nb],
                                windows[1][b0:b0 + nb], N, sp)
        for sample in (True, False):
            # the sample: tau +inf over 1 in WIDE_SAMPLE_STRIDE tiles
            t = None if sample else ptr(tau, b0)
            stride = WIDE_SAMPLE_STRIDE if sample else 1
            if mask:
                rc = score(corpus.data_ptr(), rows.data_ptr(), ptr(q, b0), t,
                           lists.data_ptr(), ptr(count, b0), nb, N, d,
                           plan.cap, stride, _mask_chunking(nb, N, sms),
                           stream)
            else:
                tiles = -(-sp.tiles // stride)
                rc = score(corpus.data_ptr(), ptr(side), ptr(cov),
                           attrs.data_ptr(), ptr(q, b0), ptr(qlo, b0),
                           ptr(qhi, b0), t,
                           lists.data_ptr(), ptr(count, b0),
                           sched.data_ptr(), nb, N, d, m, plan.cap, stride,
                           sp.tile_rows, min(tiles, sms), sp.smem, stream)
            _raise_on(rc, name)
            if sample:
                rc = tau_fn(lists.data_ptr(), ptr(count, b0), nb, plan.cap,
                            k, ptr(tau, b0), stream)
                _raise_on(rc, name)
                mark("sample")
        if mask:
            rc = over(corpus.data_ptr(), rows.data_ptr(), ptr(q, b0),
                      ptr(tau, b0), lists.data_ptr(), ptr(count, b0),
                      ptr(stats, b0), ptr(stats, B), nb, N, d, plan.cap, k,
                      stream)
        else:
            rc = over(corpus.data_ptr(), ptr(side), ptr(cov),
                      attrs.data_ptr(), ptr(q, b0), ptr(qlo, b0),
                      ptr(qhi, b0), ptr(tau, b0),
                      lists.data_ptr(), ptr(count, b0), ptr(stats, b0),
                      ptr(stats, B), nb, N, d, m, plan.cap, k, stream)
        _raise_on(rc, name)
        mark("score")
        rc = select(lists.data_ptr(), ptr(count, b0), nb, plan.cap, k,
                    keys.data_ptr(), ptr(ids, b0), ptr(dists, b0), stream)
        _raise_on(rc, name)
        mark("select")
    LAUNCHES[name] += 1
    WIDE_STATS[name] = stats
    return ids, dists


def _launch_scan(kind: str, corpus, scale, attrs, q, qlo, qhi, k: int,
                 windows=None):
    """The box scan's launch; with ``windows`` = (starts, counts) its
    windowed form, which takes the coverage in the scale's place. A k or
    m past the narrow kernel's limits launches the wide form."""
    N, d = corpus.shape
    B, m = qlo.shape
    if k > SCAN_KMAX or m > SCAN_MMAX:
        return _launch_list_wide(kind, corpus, scale, attrs, q, qlo, qhi, k,
                                 windows)
    dev = corpus.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = _scan_plan(B, N, k, sms)
    base = "scan_topk" if windows is None else "scan_topk_windows"
    name, sym = _form(base, kind), f"{base}_{kind}"
    if windows is not None:
        scale = _window_cover(*windows, N, plan)
    part_d, part_i, ids, dists = _scan_buffers(B, plan.blocks, k, dev)
    # the tile counters, the windowed form's uncovered count, then the
    # (empty, sparse, dense) tile counts
    sched = torch.empty(plan.query_blocks + 3 + (windows is not None),
                        dtype=torch.int32, device=dev)
    f = _fn("scan_topk", sym, [_P] * 11 + [_I] * 8 + [_P])
    rc = f(corpus.data_ptr(), None if scale is None else scale.data_ptr(),
           attrs.data_ptr(), q.data_ptr(), qlo.data_ptr(), qhi.data_ptr(),
           part_d.data_ptr(), part_i.data_ptr(), sched.data_ptr(),
           ids.data_ptr(), dists.data_ptr(), B, N, d, m, k, plan.tile_rows,
           plan.blocks, plan.smem, _stream(dev))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    SCAN_TILES[name] = sched[plan.query_blocks:]
    return ids, dists


def scan_topk(corpus: torch.Tensor, attrs: torch.Tensor, q: torch.Tensor,
              qlo: torch.Tensor, qhi: torch.Tensor, *, k: int):
    """Exact masked top-k over every row: corpus (N, d) f32 or bf16,
    attrs (N, m), q (B, d), qlo/qhi (B, m) f32 -> (ids (B, k) int32,
    dists (B, k) f32, accumulated in f32), ascending by (distance, id),
    (-1, +inf) past the in-range count. Any 1 <= k <= N and m >= 1:
    k <= ``SCAN_KMAX`` with m <= ``SCAN_MMAX`` runs the narrow kernel
    (scan_topk.cu), any other k or m the wide form
    (scan_topk_wide.cu)."""
    kind = _corpus_kind(corpus)
    dev = _check_scan(corpus, attrs, q, qlo, qhi, k)
    if dev.type == "cpu":
        return _ref.scan_topk_ref(corpus, attrs, q, qlo, qhi, k)
    return _launch_scan(kind, corpus, None, attrs, q, qlo, qhi, k)


def scan_topk_q8(qcorpus: torch.Tensor, qscale: torch.Tensor,
                 attrs: torch.Tensor, q: torch.Tensor, qlo: torch.Tensor,
                 qhi: torch.Tensor, *, k: int):
    """``scan_topk`` over an int8 replica (qcorpus (N, d) int8, qscale
    (N, 1) f32): the exact masked top-k of the dequantized distances."""
    _check_qscale(qcorpus, qscale)
    dev = _check_scan(qcorpus, attrs, q, qlo, qhi, k)
    if dev.type == "cpu":
        return _ref.scan_topk_q8_ref(qcorpus, qscale, attrs, q, qlo, qhi, k)
    return _launch_scan("q8", qcorpus, qscale, attrs, q, qlo, qhi, k)


def scan_topk_mask(corpus: torch.Tensor, mask: torch.Tensor,
                   q: torch.Tensor, *, k: int):
    """Exact top-k under one row mask shared by the batch: corpus (N, d)
    f32 or bf16 (upcast), mask (N,) or (N, 1) f32 (a row passes iff its
    value is > 0; NaN fails), q (B, d) f32 -> (ids (B, k) int32, dists
    (B, k) f32, accumulated in f32), ascending by (distance, id), (-1,
    +inf) past the passing count. Any 1 <= k <= N: k <= ``SCAN_KMAX``
    runs the narrow kernel (scan_topk.cu), a larger k the wide form
    (scan_topk_wide.cu)."""
    kind = _corpus_kind(corpus)
    dev = _device_of(corpus, mask, q)
    _check(q, "q", torch.float32, 2)
    N, d = corpus.shape
    if mask.dtype != torch.float32 or tuple(mask.shape) not in ((N,), (N, 1)) \
            or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous float32 ({N},) or "
                         f"({N}, 1), got {mask.dtype} {tuple(mask.shape)}")
    if q.shape[1] != d:
        raise ValueError(f"q must be (B, {d}), got {tuple(q.shape)}")
    if not 1 <= k <= N:
        raise ValueError(f"k must be in [1, N={N}], got {k}")
    if dev.type == "cpu":
        return _ref.scan_topk_mask_ref(corpus, mask, q, k)
    if k > SCAN_KMAX:
        return _launch_list_wide(kind, corpus, mask, None, q, None, None, k)
    B = q.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nchunks = _mask_chunking(B, N, sms)
    part_d, part_i, ids, dists = _scan_buffers(B, nchunks, k, dev)
    # the compacted row list, the per-segment counts and the list's length
    scratch = torch.empty(2 * N + 1, dtype=torch.int32, device=dev)
    name = _form("scan_topk_mask", kind)
    f = _fn("scan_topk", f"scan_topk_mask_{kind}",
            [_P] * 8 + [_I] * 5 + [_P])
    rc = f(corpus.data_ptr(), mask.data_ptr(), q.data_ptr(),
           scratch.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
           ids.data_ptr(), dists.data_ptr(), B, N, d, k, nchunks,
           _stream(dev))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return ids, dists


def _window_cover(starts: torch.Tensor, counts: torch.Tensor, N: int,
                  plan: ScanPlan) -> torch.Tensor:
    """The windowed scan's pre-pass on the card: starts/counts (B, W) int32
    -> an int32 buffer holding the (B, ceil(N / 32)) coverage bitmap (bit
    r % 32 of word r // 32 set iff row r lies in one of the lane's windows,
    as ``ref.window_cover_ref``), then one byte per (query block, row tile
    of ``plan``), 1 where some lane of the block covers the tile."""
    B, W = starts.shape
    nwords = -(-N // 32)
    flag_words = -(-plan.query_blocks * plan.tiles // 4)
    cover = torch.empty(B * nwords + flag_words, dtype=torch.int32,
                        device=starts.device)
    f = _fn("scan_topk", "window_cover", [_P] * 3 + [_I] * 4 + [_P])
    rc = f(starts.data_ptr(), counts.data_ptr(), cover.data_ptr(), B, W, N,
           plan.tile_rows, _stream(starts.device))
    _raise_on(rc, "window_cover")
    return cover


def scan_topk_windows(corpus: torch.Tensor, attrs: torch.Tensor,
                      q: torch.Tensor, qlo: torch.Tensor, qhi: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor, *, k: int):
    """Exact masked top-k over each query's windows of a position-ordered
    corpus: corpus (N, d) f32 or bf16 (upcast) and attrs (N, m) f32 in
    position order, q (B, d), qlo/qhi (B, m) f32, starts/counts (B, W)
    int32 (start < 0 pads a window) -> (positions (B, k) int32, dists
    (B, k) f32),
    ascending by (distance, position), (-1, +inf) past the passing count.
    The kernel is the box scan of the corpus's dtype over the rows the
    windows cover (a (B, ceil(N / 32)) bitmap, B * N / 8 bytes of
    scratch). Any 1 <= k <= N and m >= 1: past ``SCAN_KMAX`` or
    ``SCAN_MMAX`` it is the wide form (scan_topk_wide.cu): the box scan's
    windowed instance into candidate lists, over the same bitmap."""
    kind = _corpus_kind(corpus)
    dev = _device_of(corpus, attrs, q, qlo, qhi, starts, counts)
    for t, nm in ((attrs, "attrs"), (q, "q"), (qlo, "qlo"), (qhi, "qhi")):
        _check(t, nm, torch.float32, 2)
    _check(starts, "starts", torch.int32, 2)
    _check(counts, "counts", torch.int32, 2)
    N, d = corpus.shape
    B, m = qlo.shape
    if attrs.shape[0] != N or q.shape != (B, d) or qhi.shape != (B, m) \
            or attrs.shape[1] != m or starts.shape[0] != B \
            or counts.shape != starts.shape:
        raise ValueError("scan_topk_windows shape mismatch")
    if not 1 <= k <= N:
        raise ValueError(f"k must be in [1, N={N}], got {k}")
    if dev.type == "cpu":
        return _ref.scan_topk_windows_ref(corpus, attrs, q, qlo, qhi,
                                          starts, counts, k)
    if B == 0 or starts.shape[1] == 0:
        ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
        return ids, torch.full((B, k), _ref._INF, device=dev)
    return _launch_scan(kind, corpus, None, attrs, q, qlo, qhi, k,
                        windows=(starts, counts))


def l2dist_qn(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """All-pairs squared L2 by the expansion: q (B, d), c (N, d) ->
    (B, N), or batched q (G, B, d), c (G, N, d) -> (G, B, N); f32. The
    kernel runs each product as three TF32 tensor-core products (hi/lo
    split), within rtol 1e-4, atol 1e-3 of the plain fp32 version."""
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
    if G > 65535 or -(-B // 128) * -(-N // 128) > 2**31 - 1:
        raise ValueError(f"l2dist_qn grid too large (G={G} batches of "
                         f"{B} x {N}, at most 65535 batches of 2^31 - 1 "
                         f"128 x 128 tiles): split the batch")
    out = torch.empty((G, B, N), dtype=torch.float32, device=dev)
    f = _fn("l2dist", "l2dist_qn_f32", [_P] * 3 + [_I] * 4 + [_L] * 3 + [_P])
    rc = f(qb.data_ptr(), cb.data_ptr(), out.data_ptr(), G, B, N, d,
           B * d, N * d, B * N, _stream(dev))
    _raise_on(rc, "l2dist_qn")
    LAUNCHES["l2dist_qn"] += 1
    return out if batched else out[0]


def l2dist_qc(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per-query candidates by the expansion: q (B, d) f32, c (B, C, d)
    f32 or bf16 (upcast) -> (B, C) f32, the sum over d-tiles of width
    ``ref.qc_tile_width(d)`` (the reference engine's) of
    ``|q_t|^2 + |c_t|^2 - 2 q_t.c_t``. Full fp32: no tensor cores."""
    dev = _device_of(q, c)
    _check(q, "q", torch.float32, 2)
    kind = _KIND.get(c.dtype)
    if kind is None:
        raise TypeError(f"c must be float32 or bfloat16, got {c.dtype}")
    _check(c, "c", c.dtype, 3)
    B, d = q.shape
    if c.shape[0] != B or c.shape[2] != d:
        raise ValueError(f"l2dist_qc takes q (B, d) and c (B, C, d), got "
                         f"{tuple(q.shape)} and {tuple(c.shape)}")
    if dev.type == "cpu":
        return _ref.l2dist_qc_ref(q, c)
    if B > 65535:
        raise ValueError(f"l2dist_qc takes at most 65535 rows, got {B}")
    C = c.shape[1]
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    f = _fn("l2dist", f"l2dist_qc_{kind}", [_P] * 3 + [_I] * 4 + [_P])
    rc = f(q.data_ptr(), c.data_ptr(), out.data_ptr(), B, C, d,
           _ref.qc_tile_width(d), _stream(dev))
    _raise_on(rc, "l2dist_qc")
    LAUNCHES["l2dist_qc"] += 1
    return out


def l2dist(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, dispatched on the rank of ``c`` as the
    reference's ``ops.l2dist``: q (B, d) with c (N, d) -> (B, N) all pairs
    (``l2dist_qn``); q (B, d) with c (B, C, d) -> (B, C) per-query
    candidates (``l2dist_qc``)."""
    if c.dim() == 2:
        return l2dist_qn(q, c)
    if c.dim() == 3:
        return l2dist_qc(q, c)
    raise ValueError(f"bad candidate rank {c.dim()}")
