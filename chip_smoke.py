"""Chip smoke for the PyTorch/CUDA port: builds the hand-written kernels,
holds each against its plain PyTorch version on the card (the gather and
scan kernels in their f32, bf16 and int8 forms, the unfused gathers in
both forms, l2dist_qc, the bitmask scan, and the windowed scan at the
windows of the served 1/64 boxes and of every served lane, its
coverage pre-pass timed apart; the scan family's wide forms, which take
any k and m, at k = 100 and the over-fetch kq = 400 and on a 1/32-grid
corpus at k in {65, 100, 400} and m in {4, 9, 12}), then builds a KHI
index at the khi-serve shard's widths on the card and serves
mixed-selectivity bursts through the auto planner, checking the answers;
then serves the same bursts again on the quantized score path,
quant="int8" and then quant="bf16", from a replica attached to the same
index; then 64 of the requests at k = 100 under auto and under int8
(``large_k_pass``: the wide box forms, scan lanes held to the float64
truth); then a 65,536-row index with 12 attributes (``m12_pass``: auto,
hybrid and a bitmask expression at k = 100, stored in f32 and in bf16,
every wide form on a served path); then the same
index stored in bf16 (``bf16_corpus_pass``: auto, the graph walk on the
unfused backends, hybrid on the bf16 windowed scan, the bitmask scan of
the bf16 corpus, int8 over it, held to smoke_reference.py's bf16
rounding, float64 top-k and beam search) and a checkpoint of its planes
saved while it serves (``checkpoint_phase``); then with
strategy="hybrid" (per-node windows + graph walk); then the collective
sharded search (``mesh_pass``): NCCL at world size 1 over the same index
as one shard, serving the same bursts under auto, hybrid and int8 through
KHIService(mesh=), each held bit for bit to the single service's answers,
its device-side routing held to the planner's; then two filter
expressions through Request(expr=...) under "auto" and "hybrid" (one
lowers to 3 disjoint boxes, one to the bitmask scan); then with
strategy="graph" under every scoring backend it takes (the fused filter
gather, the unfused gather, pallas_l2) and both routers (level, dfs);
then the builders' pass (``builders_pass``): Algorithm 5
(``builder="incremental"``) over every 40th row of the corpus, timed per
level, its graphs held to the graph invariants and 32 of its nodes to a
numpy replay of their merge (``smoke_reference.merge_node``), the same
bursts served over it and held to the numpy beam search beside a
``builder="device"`` index of the same rows, then the iRangeGraph,
Postfiltering and Prefiltering baselines on those rows against the boxes
and the brute force, and the index sizes, after the card's Algorithm 5
and bulk builds of small grid corpora are held bit for bit to the plain
versions'; then the sharded index (``shard_pass``): the first quarter
of the corpus as 4 round-robin shards through ``build_sharded``, the
same bursts served
through a KHIService over it and held to per-shard numpy and brute
forces merged in (dist, shard, local) order, its int8, hybrid, bitmask
and streaming paths and one compaction; then degradation tiers and the
SLO scheduler (``slo_pass``) at the
config's policy: each tier's direct answers, a backlog down the ladder,
an open-loop replay with faults armed on the scheduler's worker thread,
and an int8-bottom ladder; last, the streaming write path
(``stream_pass``), on shard 0 of the sharded index: a 131,072-row delta
(the config's ``delta_capacity``) takes 65,536 inserts and 20,000-odd
deletes of base and delta rows, the same bursts are served and checked
against the live corpus on an f32 and an int8 service, the delta scan is
timed at the served, a full and an empty delta, and one compaction
rebuilds the live corpus, timed by phase. After the KHI passes, the LM
substrate's decode serving (``lm_pass``): the six archs that fit one
card at full width and depth, jamba, phi3.5-moe and qwen2-vl at full
width with their depth cut, from random weights in bf16, 4 prompts of 32
tokens + 16 greedy tokens each through ``generate`` (tok/s and peak
memory printed beside the card), each first checked in f32 (decode
against forward, prefill + decode against the all-decode path); hubert
runs its forward once and must refuse ``generate``. Last, training of the
LM substrate (``train_pass``): qwen1.5-4b at full width, its depth cut
to 4 layers, 16 steps through the training launcher in bf16 with f32
moments and gradient sums over 2 microbatches (loss finite and falling;
step ms, tokens/s, peak memory), then at the smoke width a step on the
card against the CPU's, a resume through a checkpoint and the int8
all-reduce at one rank. Then the dry run (``dryrun_pass``): the training
step's count over fake CUDA tensors equal to the card's own step's
FLOPs and bytes, its predicted peak within 15% of the training pass's,
its H100 roofline beside the step's time, and the dry-run CLI on the
production mesh for qwen1.5-4b train_4k and khi-serve serve_b256.

    python3 chip_smoke.py                 # full run, one GPU
    python3 chip_smoke.py --n 200000      # a smaller corpus (widths kept)
    python3 chip_smoke.py --phases kernels
    python3 chip_smoke.py --phases lm     # the LM pass alone
    python3 chip_smoke.py --phases train  # the training and dry-run passes

The graph lanes are held to ``smoke_reference.py``, a plain numpy router,
beam search and graph-row rule that shares no code with the port. Their
recall@10 is printed against the 0.85 bar at the cell's ef and at 4x and
16x that ef; the check requires the bar at 16x. The int8 pass is held to
the same file's numpy quantization, int8 beam search + f32 rerank and
int8 scan over-fetch + f32 rerank. The hybrid pass's pure-window lanes are
held to the f32 brute force and to the same file's numpy antichain and
windowed scan over the DFS order; its mixed lanes' recall to that of the
graph strategy's own walk on the same lanes. The predicate pass's truth is a masked brute
force whose mask comes from the same file's numpy year evaluator. The
graph pass holds the unfused gather's walk to the fused one's bit for
bit, pallas_l2's to it on ids and recall, and the DFS router to the same
file's numpy DFS. Launch counts are reset before each served path (the
f32 build + serve, the int8 pass, the bf16 pass, the hybrid pass, the
predicate pass, each graph configuration, each of the mesh pass's
served runs, the SLO pass's open loop and its int8 tier) and read after
it; the public
wrappers' rescoring of the graph pass's answers is counted apart, and
so is each streaming service's served run.

l2dist_qn (3xTF32 on the tensor cores) is also held to float64 on 64
sampled rows (its error at most twice the plain fp32 version's) and timed
at the builder's level-0 block; its SASS must hold TF32 HGMMA; the build
times each of its calls by CUDA events. The bitmask scan must also equal
the f32 box scan bit for bit on the mask as a one-attribute box.

Prints one line per phase, a {"kernels": [...]} line, the card's name and
power limit, and as its last line {"ok": true, "device": {...}}. Exits
non-zero, with no result line, on any failed check or without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import faulthandler
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM TF32 tensor cores, dense
# a decision of the builder's rule this close, relative to the squared
# norms involved, may go either way in fp32: the fp32 expanded-form
# distance's error at d = 768 stays under 6e-7 of them on the CPU, and
# 3xTF32's is of fp32's order
NEAR_TIE = 4e-6


T_START = time.perf_counter()


def mark(what: str) -> None:
    """One line of the script's timeline: seconds since it started."""
    print(f"[time] {what} done at {time.perf_counter() - T_START:.1f}s",
          flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(n_bytes: float, n_ops: float, flops: float = FP32_FLOPS):
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(fn, reps: int = 5, warmup: int = 1, queued: bool = False):
    """Mean ms of ``fn`` over ``reps`` calls back to back, by CUDA events.
    A call's host work (the wrapper's checks, allocation and launch) runs
    while the card runs the previous call, so a kernel shorter than its
    wrapper's host time reads as the host's time. ``queued`` keeps the
    card asleep (``torch.cuda._sleep``) until every call is enqueued, so
    the events time the card alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(40_000_000)           # ~20 ms at 1.98 GHz
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_cold_ms(fns, rounds: int = 6) -> float:
    """Mean ms a launch on the card alone (``time_ms(queued=True)``) over
    ``rounds`` passes through ``fns``, closures whose inputs together
    exceed the 50 MB L2, so each launch finds its rows in device memory,
    as the hop loop does (its ids are fresh every hop)."""
    def rotation():
        for fn in fns:
            fn()
    return time_ms(rotation, reps=rounds, queued=True) / len(fns)


def host_ms(fn, reps: int = 50) -> float:
    """Mean ms of host time a call of ``fn`` takes to return (the
    wrapper's checks, allocation and launch), the card kept asleep so no
    call waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def probe_fn(lib: str, sym: str, argtypes):
    """The probe entry ``sym`` of the kernel library ``lib``, or None
    (said on a line) where the library has none, as a tree from before
    the probes."""
    from repro_torch.kernels import _build, ops

    if not hasattr(_build.library(lib), sym):
        print(f"[kernels] {lib} has no {sym}: no clock64 split", flush=True)
        return None
    return ops._fn(lib, sym, argtypes)


def probe_split(name: str, launch, blocks: int, dev, phases) -> None:
    """A kernel's probe instance (``launch(probe_ptr)``, the same kernel
    with clock64() stamps: per block [entry, staged, listed, cycles thread
    0 waited on row loads, cycles of its row arithmetic, exit]) run once;
    prints the mean cycles of each phase a block and its share."""
    probe = torch.zeros(6 * blocks, dtype=torch.int64, device=dev)
    launch(probe.data_ptr())
    torch.cuda.synchronize()
    p = probe.view(blocks, 6).double()
    total = max((p[:, 5] - p[:, 0]).mean().item(), 1.0)
    parts = [("staging", (p[:, 1] - p[:, 0]).mean().item()),
             ("predicate and list", (p[:, 2] - p[:, 1]).mean().item()),
             ("rows", (p[:, 5] - p[:, 2]).mean().item())]
    print(f"[kernels] {name} clock64 split, mean of {blocks} blocks: "
          + ", ".join(f"{nm} {c:.0f} cycles ({100 * c / total:.1f}%)"
                      for nm, c in parts if nm in phases)
          + f"; of the rows, thread 0 waiting on its row loads "
          f"{p[:, 3].mean().item():.0f} and in row arithmetic and reduction "
          f"{p[:, 4].mean().item():.0f}; a block {total:.0f} cycles",
          flush=True)


def topk_agree(name, ids, dd, rids, rdd):
    """A top-k kernel against its plain version: the same +inf lanes,
    distances within rtol 1e-5, atol 1e-3 (the two sum in other orders),
    and ids equal on every slot except near-ties, whose two distances lie
    within 1e-5 relative (the sum orders may break them differently).
    Returns (slots with equal ids, near-tie slots, max abs err)."""
    same = ids == rids
    fin = torch.isfinite(rdd)
    err = float((dd[fin] - rdd[fin]).abs().max()) if fin.any() else 0.0
    check(torch.equal(torch.isinf(dd), torch.isinf(rdd)),
          f"{name}: empty lanes differ from the plain version")
    check(torch.allclose(dd[fin], rdd[fin], rtol=1e-5, atol=1e-3),
          f"{name} dists disagree: max abs err {err}")
    close = (dd - rdd).abs() <= 1e-5 * rdd.abs().clamp_min(1.0)
    check(bool((same | close).all()),
          f"{name} ids disagree on {int((~same).sum())} slots")
    return int(same.sum()), int((~same).sum()), err


# ---------------------------------------------------------------- phase 2

GATHER_TPU = "src/repro/kernels/gather_l2_filter.py"
SCAN_TPU = "src/repro/kernels/scan_topk.py"
GATHER_CU = "src/repro_torch/kernels/csrc/gather_l2_filter.cu"
SCAN_CU = "src/repro_torch/kernels/csrc/scan_topk.cu"


def kernel_checks(n: int, d: int, m: int, k: int, kq: int, dev, *,
                  synthetic_windows: bool) -> dict:
    """Each kernel against its plain version at the main path's shapes:
    the f32 forms of the gather and scan, their bf16 forms (bf16 corpus
    replica) and int8 forms (q8: int8 replica + per-row scale), the
    bitmask scan, and l2dist. Tolerance for every gather and scan form:
    rtol 1e-5, atol 1e-3 on distances (the kernel and the plain version
    sum in other orders); scan ids equal wherever the two distances are
    not within that noise. The windowed scan is checked at the served
    windows in the hybrid pass, or here on synthetic windows when
    ``synthetic_windows`` (no index is built)."""
    from repro_torch.kernels import ops, quant, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 yardsticks
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((n, d), generator=g, device=dev)
    attrs = torch.rand((n, m), generator=g, device=dev)
    attrs[7::97, 1] = float("nan")                  # tombstone-style rows
    qv, qs = quant.quant_replica(corpus, "int8")
    cb, _ = quant.quant_replica(corpus, "bf16")
    rows = {}

    # -- gather_l2_filter at B=256, C=E*c_n=128. On the main path the hop
    # loop sends only fresh in-range ids, so nearly every lane passes:
    # most boxes here hold every row, a few lanes are narrow boxes
    B, C = 256, 128
    q = torch.randn((B, d), generator=g, device=dev)
    qlo = torch.zeros((B, m), device=dev)
    qhi = torch.ones((B, m), device=dev)
    qlo[:8], qhi[:8] = 0.4, 0.6                      # lanes that mostly fail
    idx = torch.randint(0, n, (B, C), generator=g, device=dev)
    idx[:, ::29] = -1                                # pad lanes
    idx[:, 5::37] = n + 3                            # ids past the corpus
    idx[3, :] = -1                                   # an all-pad lane
    valid = (idx >= 0) & (idx < n)
    ops.reset_launches()
    gathers = (
        ("gather_l2_filter", ":48", 4 * d, 3,
         lambda: ops.gather_l2_filter(idx, corpus, attrs, q, qlo, qhi),
         lambda: ref.gather_l2_filter_ref(idx, corpus, attrs, q, qlo, qhi)),
        ("gather_l2_filter_bf16", ":48", 2 * d, 3,
         lambda: ops.gather_l2_filter(idx, cb, attrs, q, qlo, qhi),
         lambda: ref.gather_l2_filter_ref(idx, cb, attrs, q, qlo, qhi)),
        ("gather_l2_filter_q8", ":133", d + 4, 4,
         lambda: ops.gather_l2_filter_q8(idx, qv, qs, attrs, q, qlo, qhi),
         lambda: ref.gather_l2_filter_q8_ref(idx, qv, qs, attrs, q, qlo,
                                             qhi)),
    )
    for name, line, row_bytes, ops_per, kern, plain in gathers:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(got), torch.isinf(want)),
              f"{name}: +inf lanes differ from the plain version")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
        check(torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-3),
              f"{name} disagrees: max abs err {err}")
        n_pass = int(fin.sum())
        nbytes = (idx.numel() * 8 + got.numel() * 4 + q.numel() * 4
                  + 2 * qlo.numel() * 4 + int(valid.sum()) * m * 4
                  + n_pass * row_bytes)
        bms, by = bound_ms(nbytes, n_pass * d * ops_per)
        r = rows[name] = dict(
            name=name, route="cuda", launches=0, source=GATHER_CU,
            replaces=GATHER_TPU + line, max_abs_err=err,
            ms=time_ms(kern, reps=50), plain_ms=time_ms(plain, reps=20),
            bound_ms=bms, bound_by=by, library_ms=None,
            device_ms=time_ms(kern, reps=50, queued=True))
        print(f"[kernels] {name} B={B} C={C} d={d}: {r['ms']:.4f} ms "
              f"(the card alone {r['device_ms']:.4f}; "
              f"plain {r['plain_ms']:.4f}, bound {bms:.4f} by {by}, "
              f"{n_pass} of {B * C} lanes pass, {nbytes / 1e6:.1f} MB), "
              f"max abs err {err:.3g}", flush=True)
    q8_gather_phases(idx, qv, qs, attrs, q, qlo, qhi,
                     rows["gather_l2_filter_q8"])
    del idx, valid
    unfused_checks(corpus, cb, q, rows)

    # -- scan_topk at B=256, N=n: k for the f32 form, the over-fetch kq
    # of a quantized scan (k * rerank_mult) for the replica forms
    qlo_s = torch.rand((B, m), generator=g, device=dev) * 0.6
    qhi_s = qlo_s + torch.rand((B, m), generator=g, device=dev) * 0.4 + 0.3
    qhi_s[0] = -1.0                                  # an empty box
    okm = ((attrs[None] >= qlo_s[:, None]) & (attrs[None] <= qhi_s[:, None])
           ).all(-1)
    n_pairs = int(okm.sum())
    del okm

    def lib_scan(rows_f32, kk):
        def run():
            dist = torch.cdist(q, rows_f32())
            ok = ((attrs[None] >= qlo_s[:, None])
                  & (attrs[None] <= qhi_s[:, None])).all(-1)
            return torch.topk(torch.where(ok, dist, float("inf")), kk,
                              largest=False)
        return run

    scans = (
        ("scan_topk", ":60", k, 4 * d, 3,
         lambda: ops.scan_topk(corpus, attrs, q, qlo_s, qhi_s, k=k),
         lambda: ref.scan_topk_ref(corpus, attrs, q, qlo_s, qhi_s, k),
         lib_scan(lambda: corpus, k)),
        ("scan_topk_bf16", ":60", kq, 2 * d, 3,
         lambda: ops.scan_topk(cb, attrs, q, qlo_s, qhi_s, k=kq),
         lambda: ref.scan_topk_ref(cb, attrs, q, qlo_s, qhi_s, kq),
         lib_scan(lambda: cb.float(), kq)),
        ("scan_topk_q8", ":172", kq, d + 4, 3,
         lambda: ops.scan_topk_q8(qv, qs, attrs, q, qlo_s, qhi_s, k=kq),
         lambda: ref.scan_topk_q8_ref(qv, qs, attrs, q, qlo_s, qhi_s, kq),
         lib_scan(lambda: quant.dequant_rows(qv, qs), kq)),
    )
    for name, line, kk, row_bytes, ops_per, kern, plain, lib in scans:
        ids, dd = kern()
        rids, rdd = plain()
        torch.cuda.synchronize()
        check(bool((ids[0] == -1).all()) and bool(torch.isinf(dd[0]).all()),
              f"{name}: an empty box must give (-1, +inf) lanes")
        same, ties, err = topk_agree(name, ids, dd, rids, rdd)
        nbytes = (n * row_bytes + attrs.numel() * 4 + q.numel() * 4
                  + 2 * qlo_s.numel() * 4 + B * kk * 8)
        # the int8 form also scales each row element once
        bms, by = bound_ms(nbytes, n_pairs * d * ops_per
                           + (n * d if name.endswith("q8") else 0))
        empty, sparse, dense = ops.SCAN_TILES[name].tolist()
        # the direct form runs a sub and an fma per (passing pair,
        # dimension), the int8 form also a multiply per row element
        instr_ms = (2.0 * n_pairs * d + (n * d if name.endswith("q8") else 0)
                    ) / (FP32_FLOPS / 2) * 1e3
        r = rows[name] = dict(
            name=name, route="cuda", launches=0, source=SCAN_CU,
            replaces=SCAN_TPU + line, max_abs_err=err,
            ms=time_ms(kern, reps=5),
            plain_ms=time_ms(plain, reps=1, warmup=0),
            bound_ms=bms, bound_by=by, library_ms=time_ms(lib, reps=3))
        print(f"[kernels] {name} B={B} N={n} d={d} k={kk}: {r['ms']:.3f} ms "
              f"(plain {r['plain_ms']:.3f}, dequantize+cdist+mask+topk "
              f"{r['library_ms']:.3f}, bound {bms:.3f} by {by}, fp32 "
              f"instruction ceiling {instr_ms:.3f}, {n_pairs} passing "
              f"pairs; tiles: {dense / (empty + sparse + dense):.4f} dense, "
              f"{sparse} sparse, {empty} empty), ids equal on {same} of "
              f"{ids.numel()} slots ({ties} near-ties), max abs err "
              f"{err:.3g}", flush=True)
    allpass_check(corpus, attrs, q, k, dev)
    # -- scan_topk_mask at B=256, N=n: one shared row mask (a filter
    # expression's rows: > 0 passes, NaN and 0 fail), k as the served path
    mask = torch.where(attrs[:, 0] < 0.55, 1.0, -1.0)[:, None].contiguous()
    mask[11::101] = float("nan")
    mask[13::103] = 0.0
    okr = (mask[:, 0] > 0).contiguous()
    n_rows = int(okr.sum())

    def kern_mask():
        return ops.scan_topk_mask(corpus, mask, q, k=k)

    def plain_mask():
        return ref.scan_topk_mask_ref(corpus, mask, q, k)

    def lib_mask():
        dist = torch.cdist(q, corpus)
        return torch.topk(torch.where(okr[None], dist, float("inf")), k,
                          largest=False)

    ids, dd = kern_mask()
    rids, rdd = plain_mask()
    # the unchanged f32 box scan with the mask as its one attribute: the box
    # [1e-30, +inf] passes exactly the rows whose mask is > 0 (+1 here; -1,
    # 0 and NaN fail), and both kernels sum each distance in the same order
    bids, bdd = ops.scan_topk(corpus, mask, q,
                              torch.full((B, 1), 1e-30, device=dev),
                              torch.full((B, 1), float("inf"), device=dev),
                              k=k)
    torch.cuda.synchronize()
    check(torch.equal(ids, bids) and torch.equal(dd, bdd),
          f"scan_topk_mask differs from the box scan on the mask as an "
          f"attribute: ids on {int((ids != bids).sum())} slots, dists on "
          f"{int((dd != bdd).sum())}")
    same, ties, err = topk_agree("scan_topk_mask", ids, dd, rids, rdd)
    # the mask is read for every row, a vector only for a passing row
    nbytes = n * 4 + n_rows * d * 4 + q.numel() * 4 + B * k * 8
    bms, by = bound_ms(nbytes, n_rows * B * d * 3)
    # the direct form runs a sub and an fma per (pair, dimension)
    instr_ms = 2.0 * n_rows * B * d / (FP32_FLOPS / 2) * 1e3
    r = rows["scan_topk_mask"] = dict(
        name="scan_topk_mask", route="cuda", launches=0, source=SCAN_CU,
        replaces=SCAN_TPU + ":241", max_abs_err=err,
        ms=time_ms(kern_mask, reps=5),
        plain_ms=time_ms(plain_mask, reps=1, warmup=0),
        bound_ms=bms, bound_by=by, library_ms=time_ms(lib_mask, reps=3))
    print(f"[kernels] scan_topk_mask B={B} N={n} d={d} k={k}: "
          f"{r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, cdist+mask+topk "
          f"{r['library_ms']:.3f}, bound {bms:.3f} by {by}, fp32 "
          f"instruction ceiling {instr_ms:.3f}, {n_rows} rows pass), ids "
          f"equal on {same} of {ids.numel()} slots ({ties} near-ties), max "
          f"abs err {err:.3g}; ids and dists equal to the box scan's on the "
          f"mask as an attribute", flush=True)

    # the same mask over a bf16 corpus (an index stored in bf16): against
    # its plain version, and bit for bit against the bf16 box scan on the
    # mask as a one-attribute box (both widen each row, then run one fmaf
    # chain)
    def kern_mask_b():
        return ops.scan_topk_mask(cb, mask, q, k=k)

    def plain_mask_b():
        return ref.scan_topk_mask_ref(cb, mask, q, k)

    def lib_mask_b():
        dist = torch.cdist(q, cb.float())
        return torch.topk(torch.where(okr[None], dist, float("inf")), k,
                          largest=False)

    ids, dd = kern_mask_b()
    rids, rdd = plain_mask_b()
    bids, bdd = ops.scan_topk(cb, mask, q,
                              torch.full((B, 1), 1e-30, device=dev),
                              torch.full((B, 1), float("inf"), device=dev),
                              k=k)
    torch.cuda.synchronize()
    check(torch.equal(ids, bids) and torch.equal(dd, bdd),
          f"scan_topk_mask_bf16 differs from the bf16 box scan on the mask "
          f"as an attribute: ids on {int((ids != bids).sum())} slots, dists "
          f"on {int((dd != bdd).sum())}")
    same, ties, err = topk_agree("scan_topk_mask_bf16", ids, dd, rids, rdd)
    nbytes = n * 4 + n_rows * d * 2 + q.numel() * 4 + B * k * 8
    bms, by = bound_ms(nbytes, n_rows * B * d * 3)
    r = rows["scan_topk_mask_bf16"] = dict(
        name="scan_topk_mask_bf16", route="cuda", launches=0,
        source=SCAN_CU, replaces=SCAN_TPU + ":241", max_abs_err=err,
        ms=time_ms(kern_mask_b, reps=5),
        plain_ms=time_ms(plain_mask_b, reps=1, warmup=0),
        bound_ms=bms, bound_by=by, library_ms=time_ms(lib_mask_b, reps=3))
    print(f"[kernels] scan_topk_mask_bf16 B={B} N={n} d={d} k={k}: "
          f"{r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, cdist+mask+topk "
          f"{r['library_ms']:.3f}, bound {bms:.3f} by {by}, fp32 "
          f"instruction ceiling {instr_ms:.3f}, {n_rows} rows pass), ids "
          f"equal on {same} of {ids.numel()} slots ({ties} near-ties), max "
          f"abs err {err:.3g}; ids and dists equal to the bf16 box scan's on "
          f"the mask as an attribute", flush=True)
    del okr, bids, bdd

    # -- the wide forms (any k, any m) at the served shape, k = 100 and
    # the int8 / bf16 over-fetch kq = 400
    wide_kernel_rows(corpus, cb, qv, qs, attrs, mask, q, qlo_s, qhi_s,
                     n_pairs, WIDE_K, 4 * WIDE_K, dev, rows)
    del mask
    if synthetic_windows:
        st, ct = make_windows(B, n, dev)
        rows["scan_topk_windows"] = windows_check(
            corpus, attrs, q, qlo_s, qhi_s, st, ct, k, "synthetic windows")
        rows["scan_topk_windows_bf16"] = windows_check(
            cb, attrs, q, qlo_s, qhi_s, st, ct, k, "synthetic windows")
    del corpus, attrs, qv, qs, cb

    # -- l2dist_qn at (2048, d) x (65536, d): against the plain version
    # (rtol 1e-4, atol 1e-3: the expansion cancels) and, on 64 sampled
    # rows against every column, against float64 on the card, where the
    # kernel's 3xTF32 error must be at most twice the plain fp32 version's
    qa = torch.randn((2048, d), generator=g, device=dev)
    ca = torch.randn((65536, d), generator=g, device=dev)
    got = ops.l2dist_qn(qa, ca)
    want = ref.l2dist_qn_ref(qa, ca)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-3),
          f"l2dist_qn disagrees: max abs err {err}")
    pick = torch.randperm(2048, generator=g, device=dev)[:64]
    q64, c64 = qa[pick].double(), ca.double()
    t64 = ((q64 * q64).sum(-1, keepdim=True) + (c64 * c64).sum(-1)[None]
           - 2.0 * (q64 @ c64.T))
    e64 = float((got[pick].double() - t64).abs().max())
    p64 = float((want[pick].double() - t64).abs().max())
    del got, want, q64, c64, t64
    check(e64 <= 2.0 * p64, f"l2dist_qn's error against float64 {e64:.3g} "
          f"exceeds twice the plain version's {p64:.3g}")
    nbytes = (qa.numel() + ca.numel() + 2048 * 65536) * 4
    mm = 2.0 * 2048 * 65536 * d
    norms = 2.0 * (2048 + 65536) * d
    # each product as three TF32 tensor-core products; the norms in fp32
    bms, by = bound_ms(nbytes, 3 * mm, TF32_FLOPS)
    bms += norms / FP32_FLOPS * 1e3
    simt_ms = bound_ms(nbytes, mm + norms)[0]
    r = rows["l2dist_qn"] = dict(
        name="l2dist_qn", route="cuda", launches=0,
        source="src/repro_torch/kernels/csrc/l2dist.cu",
        replaces="src/repro/kernels/l2dist.py:33",
        max_abs_err=err, f64_err=e64, plain_f64_err=p64,
        ms=time_ms(lambda: ops.l2dist_qn(qa, ca), reps=10),
        plain_ms=time_ms(lambda: ref.l2dist_qn_ref(qa, ca), reps=10),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.cdist(qa, ca), reps=10))
    print(f"[kernels] l2dist_qn (2048, {d}) x (65536, {d}): {r['ms']:.3f} ms "
          f"(plain {r['plain_ms']:.3f}, cdist {r['library_ms']:.3f}, bound "
          f"{bms:.3f} by {by} as 3xTF32, {simt_ms:.3f} in fp32 SIMT; "
          f"{3 * mm / r['ms'] / 1e9:.1f} TFLOP/s of TF32 products), max abs "
          f"err {err:.3g}; against float64 on 64 rows: {e64:.3g} (plain "
          f"{p64:.3g})", flush=True)
    del qa, ca
    # the builder's level-0 block: (1, 2048, d) rows against the root's n
    torch.cuda.empty_cache()
    cl = torch.randn((1, n, d), generator=g, device=dev)
    ql = cl[:, :2048].contiguous()
    l0 = time_ms(lambda: ops.l2dist_qn(ql, cl), reps=3)
    l0_lib = time_ms(lambda: torch.cdist(ql[0], cl[0]), reps=3)
    l0_bms, l0_by = bound_ms((ql.numel() + cl.numel() + 2048 * n) * 4,
                             3 * 2.0 * 2048 * n * d, TF32_FLOPS)
    print(f"[kernels] l2dist_qn level-0 block (1, 2048, {d}) x (1, {n}, {d}):"
          f" {l0:.3f} ms (cdist {l0_lib:.3f}, bound {l0_bms:.3f} by {l0_by} "
          f"as 3xTF32)", flush=True)
    del cl, ql
    torch.cuda.empty_cache()
    return rows


def make_windows(B: int, n: int, dev, W: int = 16):
    """(B, W) int32 starts/counts as a hybrid planner builds them: per lane
    a few disjoint extents, ascending by start, some longer than a block's
    chunk; lane 0 has none, the last lane's first window ends at N."""
    slot = max(1, min(8192, n // (2 * W)))
    gen = np.random.default_rng(5)
    st = np.full((B, W), -1, np.int32)
    ct = np.zeros((B, W), np.int32)
    for b in range(1, B):
        nw = int(gen.integers(1, W + 1))
        cut = np.sort(gen.choice(n // slot, size=nw, replace=False))
        st[b, :nw] = cut * slot
        ct[b, :nw] = gen.integers(1, slot + 1, size=nw)
    st[-1, 0], ct[-1, 0] = n - 100, 100
    return torch.as_tensor(st).to(dev), torch.as_tensor(ct).to(dev)


def allpass_check(corpus, attrs, q, k: int, dev) -> None:
    """The f32 box scan where every pair passes (the attrs' NaNs replaced,
    one box holding them all): every tile takes the dense path. Timed
    beside cdist + topk, and held to the plain version on 16 sampled
    lanes with topk_agree's tolerance."""
    from repro_torch.kernels import ops, ref

    B, n, d = q.shape[0], corpus.shape[0], corpus.shape[1]
    a_all = torch.nan_to_num(attrs, nan=0.5)
    lo = torch.full((B, a_all.shape[1]), -1.0, device=dev)
    hi = torch.full((B, a_all.shape[1]), 2.0, device=dev)

    def kern():
        return ops.scan_topk(corpus, a_all, q, lo, hi, k=k)

    ids, dd = kern()
    lanes = torch.arange(0, B, B // 16, device=dev)
    rids, rdd = ref.scan_topk_ref(corpus, a_all, q[lanes], lo[lanes],
                                  hi[lanes], k)
    torch.cuda.synchronize()
    empty, sparse, dense = ops.SCAN_TILES["scan_topk"].tolist()
    check(dense == empty + sparse + dense,
          f"all-pass scan: {sparse} tiles sparse, {empty} empty")
    same, ties, err = topk_agree("scan_topk all-pass", ids[lanes], dd[lanes],
                                 rids, rdd)
    ms = time_ms(kern, reps=3)
    lib = time_ms(lambda: torch.topk(torch.cdist(q, corpus), k,
                                     largest=False), reps=3)
    bms, by = bound_ms(n * 4 * d + a_all.numel() * 4 + q.numel() * 4,
                       B * n * d * 3.0)
    instr_ms = 2.0 * B * n * d / (FP32_FLOPS / 2) * 1e3
    print(f"[kernels] scan_topk all-pass B={B} N={n} d={d} k={k}: {ms:.3f} "
          f"ms (cdist+topk {lib:.3f}, bound {bms:.3f} by {by}, fp32 "
          f"instruction ceiling {instr_ms:.3f}; tiles: {dense} dense), ids "
          f"equal on {same} of {ids[lanes].numel()} sampled slots ({ties} "
          f"near-ties), max abs err {err:.3g}", flush=True)
    del a_all


def q8_gather_phases(idx, qv, qs, attrs, q, qlo, qhi, row) -> None:
    """The int8 fused gather beyond the table's timing (the same ids back
    to back, so its ~23 MB of rows can stay in the 50 MB L2): cold,
    rotating over 8 id sets made as the table's (from a generator of
    their own, so the later phases' inputs do not change), with its ratio
    to the table's bound; with every lane failing the predicate (ids and
    attrs only); and the clock64() split of its probe instance at the
    table's inputs, whose output must equal the kernel's."""
    from repro_torch.kernels import ops

    dev = idx.device
    g = torch.Generator(device=dev).manual_seed(19)
    n, d = qv.shape
    B, C = idx.shape
    m = attrs.shape[1]
    sets = []
    for _ in range(8):
        ids = torch.randint(0, n, (B, C), generator=g, device=dev)
        ids[:, ::29], ids[:, 5::37], ids[3, :] = -1, n + 3, -1
        sets.append(ids)
    in_range = sum(int(((s >= 0) & (s < n)).sum()) for s in sets)
    row["cold_ms"] = cold = time_cold_ms(
        [lambda s=s: ops.gather_l2_filter_q8(s, qv, qs, attrs, q, qlo, qhi)
         for s in sets])
    none_lo, none_hi = torch.ones_like(qlo), torch.zeros_like(qhi)
    fail = ops.gather_l2_filter_q8(idx, qv, qs, attrs, q, none_lo, none_hi)
    check(bool(torch.isinf(fail).all()),
          "gather_l2_filter_q8: an empty box let a lane pass")
    fail_ms = time_ms(lambda: ops.gather_l2_filter_q8(
        idx, qv, qs, attrs, q, none_lo, none_hi), reps=50, queued=True)
    hms = host_ms(lambda: ops.gather_l2_filter_q8(idx, qv, qs, attrs, q,
                                                  qlo, qhi))
    bms, dms = row["bound_ms"], row["device_ms"]
    print(f"[kernels] gather_l2_filter_q8 on the card alone: cold (8 id "
          f"sets, {in_range * (d + 4) / 1e6:.0f} MB of in-range rows) "
          f"{cold:.4f} ms, {cold / bms:.2f}x its bound {bms:.4f}; warm "
          f"{dms:.4f} ms, {dms / bms:.2f}x; every lane failing the "
          f"predicate (ids + attrs only) {fail_ms:.4f} ms. Back to back "
          f"with the host (the table's way) {row['ms']:.4f} ms; the "
          f"wrapper's host time {hms:.4f} ms a call", flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    f = probe_fn("gather_l2_filter", "gather_l2_filter_q8_i64_probe",
                 [P] * 8 + [I] * 5 + [P] * 2)
    if f is None:
        return
    out = torch.empty((B, C), device=dev)

    def launch(probe):
        check(f(idx.data_ptr(), qv.data_ptr(), qs.data_ptr(),
                attrs.data_ptr(), q.data_ptr(), qlo.data_ptr(),
                qhi.data_ptr(), out.data_ptr(), B, C, n, d, m, probe,
                ops._stream(dev)) == 0, "gather_l2_filter_q8 probe launch")

    # the kernel's grid: a block per 32 lanes of a query
    probe_split("gather_l2_filter_q8", launch, min(-(-C // 32), 65535) * B,
                dev, ("staging", "predicate and list", "rows"))
    check(torch.equal(out, ops.gather_l2_filter_q8(idx, qv, qs, attrs, q,
                                                   qlo, qhi)),
          "gather_l2_filter_q8: the probe instance differs from the kernel")


def l2dist_qc_phases(q, cand, cand2, row) -> None:
    """l2dist_qc beyond the table's timing: cold, rotating over two
    (B, C, d) blocks (200 MB, each already past the 50 MB L2), with its
    ratio to the table's bound, and the clock64() split of its probe
    instance, whose output must equal the kernel's."""
    from repro_torch.kernels import ops, ref

    dev = q.device
    B, C, d = cand.shape
    row["cold_ms"] = cold = time_cold_ms(
        [lambda: ops.l2dist_qc(q, cand), lambda: ops.l2dist_qc(q, cand2)])
    hms = host_ms(lambda: ops.l2dist_qc(q, cand))
    bms, dms = row["bound_ms"], row["device_ms"]
    print(f"[kernels] l2dist_qc on the card alone: cold (two blocks, "
          f"{2 * cand.numel() * 4 / 1e6:.0f} MB) {cold:.4f} ms, "
          f"{cold / bms:.2f}x its bound {bms:.4f}; warm {dms:.4f} ms, "
          f"{dms / bms:.2f}x. Back to back with the host (the table's way) "
          f"{row['ms']:.4f} ms; the wrapper's host time {hms:.4f} ms a "
          f"call", flush=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    f = probe_fn("l2dist", "l2dist_qc_f32_probe",
                 [P] * 3 + [I] * 4 + [P] * 2)
    if f is None:
        return
    out = torch.empty((B, C), device=dev)

    def launch(probe):
        check(f(q.data_ptr(), cand.data_ptr(), out.data_ptr(), B, C, d,
                ref.qc_tile_width(d), probe, ops._stream(dev)) == 0,
              "l2dist_qc probe launch")

    # the vector path's grid: 8 warps of 8 rows a block
    probe_split("l2dist_qc", launch, min(-(-C // 64), 65535) * B, dev,
                ("staging", "rows"))
    check(torch.equal(out, ops.l2dist_qc(q, cand)),
          "l2dist_qc: the probe instance differs from the kernel")


GATHER_L2_TPU = "src/repro/kernels/gather_l2.py"
L2DIST_CU = "src/repro_torch/kernels/csrc/l2dist.cu"


def unfused_checks(corpus, cb, q, rows) -> None:
    """The graph strategy's unfused kernels at its shapes (B=256 lanes of
    C=E*c_n=128 in-range ids, repeated ids included): the gather without
    predicate in both forms, f32 and bf16, against gather_l2_ref (rtol
    1e-5, atol 1e-3: other sum orders), the two forms bitwise equal, and
    the f32 forms bitwise equal to gather_l2_filter's lanes under a box
    every row passes; l2dist_qc on the materialized (B, C, d) gather
    against its plain version (rtol 1e-4, atol 1e-3: the expansion
    cancels, as for l2dist_qn). Every eighth id repeats its neighbour's.
    Gather bounds count each distinct row once (a repeated id needs no
    second read); l2dist_qc's counts the whole (B, C, d) block, which is
    its input. Its library yardstick is one batched cdist, squared."""
    from repro_torch.kernels import ops, ref

    dev = corpus.device
    n, d = corpus.shape
    B, C = q.shape[0], 128
    g = torch.Generator(device=dev).manual_seed(7)
    idx = torch.randint(0, n, (B, C), generator=g, device=dev)
    idx[:, 7::8] = idx[:, 6::8]                      # repeated ids
    n_rows = int(torch.unique(idx).numel())
    allpass = torch.zeros((n, 1), device=dev)
    lo = torch.full((B, 1), -1.0, device=dev)
    hi = torch.ones((B, 1), device=dev)
    for name, c_blk in (("gather_l2", 128), ("gather_l2_rows", None)):
        for corp, kind in ((corpus, "f32"), (cb, "bf16")):
            def kern(corp=corp, c_blk=c_blk):
                return ops.gather_l2(idx, corp, q, c_blk=c_blk)

            def plain(corp=corp):
                return ref.gather_l2_ref(idx, corp, q)

            got, want = kern(), plain()
            other = ops.gather_l2(idx, corp, q,
                                  c_blk=None if c_blk else 128)
            filt = ops.gather_l2_filter(idx, corp, allpass, q, lo, hi)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
                  f"{name} ({kind}) disagrees: max abs err {err}")
            check(torch.equal(got, other),
                  f"{name} ({kind}): the two gather forms differ")
            check(torch.equal(got, filt),
                  f"{name} ({kind}) differs from gather_l2_filter's lanes")
            row_bytes = corp.element_size() * d
            nbytes = idx.numel() * 8 + q.numel() * 4 + got.numel() * 4 \
                + n_rows * row_bytes
            bms, by = bound_ms(nbytes, idx.numel() * d * 3)
            ms = time_ms(kern, reps=50)
            dms = time_ms(kern, reps=50, queued=True)
            print(f"[kernels] {name} ({kind}) B={B} C={C} d={d}: {ms:.4f} "
                  f"ms (the card alone {dms:.4f}; "
                  f"bound {bms:.4f} by {by}, {n_rows} distinct rows, "
                  f"{nbytes / 1e6:.1f} MB), "
                  f"max abs err {err:.3g}; bitwise equal to the other form "
                  f"and to gather_l2_filter's lanes", flush=True)
            if kind == "f32":
                rows[name] = dict(
                    name=name, route="cuda", launches=0, source=GATHER_CU,
                    replaces=GATHER_L2_TPU + (":67" if c_blk else ":36"),
                    max_abs_err=err, ms=ms,
                    plain_ms=time_ms(plain, reps=20), bound_ms=bms,
                    bound_by=by, library_ms=None, device_ms=dms)

    cand = corpus[idx]                               # the (B, C, d) gather
    got, want = ops.l2dist_qc(q, cand), ref.l2dist_qc_ref(q, cand)
    exact = ((cand.double() - q.double()[:, None]) ** 2).sum(-1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-3),
          f"l2dist_qc disagrees: max abs err {err}")
    nbytes = (cand.numel() + q.numel() + got.numel()) * 4
    bms, by = bound_ms(nbytes, 4.0 * cand.numel())
    r = rows["l2dist_qc"] = dict(
        name="l2dist_qc", route="cuda", launches=0, source=L2DIST_CU,
        replaces="src/repro/kernels/l2dist.py:50", max_abs_err=err,
        ms=time_ms(lambda: ops.l2dist_qc(q, cand), reps=50),
        plain_ms=time_ms(lambda: ref.l2dist_qc_ref(q, cand), reps=20),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.cdist(q[:, None], cand)
                           .square(), reps=50),
        device_ms=time_ms(lambda: ops.l2dist_qc(q, cand), reps=50,
                          queued=True))
    gms = time_ms(lambda: corpus[idx], reps=50)
    print(f"[kernels] l2dist_qc B={B} C={C} d={d}: {r['ms']:.4f} ms (the "
          f"card alone {r['device_ms']:.4f}; plain "
          f"{r['plain_ms']:.4f}, cdist squared {r['library_ms']:.4f}, bound "
          f"{bms:.4f} by {by}, {nbytes / 1e6:.1f} MB); the materialized "
          f"gather before it {gms:.4f} ms; max abs err {err:.3g} against "
          f"the plain version, {float((got.double() - exact).abs().max()):.3g}"
          f" against float64", flush=True)
    idx2 = torch.randint(0, n, (B, C), generator=g, device=dev)
    l2dist_qc_phases(q, cand, corpus[idx2], r)


def window_pairs(pos_attrs, qlo, qhi, starts, counts):
    """The windows' rows per lane (a device tensor each, in window order),
    the passing (lane, row) pairs, and the distinct rows some lane covers
    and some covering lane's box passes (windows of different lanes
    overlap: a bound counts each row once)."""
    dev = pos_attrs.device
    N = pos_attrs.shape[0]
    st, ct = starts.cpu().numpy(), counts.cpu().numpy()
    lane_rows, n_pass = [], 0
    cov_any = torch.zeros(N, dtype=torch.bool, device=dev)
    pass_any = torch.zeros(N, dtype=torch.bool, device=dev)
    for b in range(st.shape[0]):
        # the rows of lane b's windows in order: [s, min(s + c, N)) each
        live = (st[b] >= 0) & (ct[b] > 0)
        s0 = st[b][live].astype(np.int64)
        c0 = np.clip(np.minimum(s0 + ct[b][live], N) - s0, 0, None)
        first = np.cumsum(c0) - c0
        r = torch.as_tensor(np.repeat(s0 - first, c0)
                            + np.arange(int(c0.sum()))).to(dev)
        a = pos_attrs.index_select(0, r)
        ok = ((a >= qlo[b]) & (a <= qhi[b])).all(-1)
        n_pass += int(ok.sum())
        cov_any[r] = True
        pass_any[r[ok]] = True
        lane_rows.append(r)
    return lane_rows, n_pass, int(cov_any.sum()), int(pass_any.sum())


def windows_check(pos_vecs, pos_attrs, q, qlo, qhi, starts, counts, k,
                  what: str) -> dict:
    """The windowed scan against its plain version at (B, W) windows of a
    position-ordered corpus, with the rule of ``topk_agree``; its bound
    (the attrs of every row some lane's windows cover and the vector of
    every row that passes the box of some lane covering it, each read
    once, and 3 flops per dimension of each passing (lane, row) pair),
    a library yardstick (per lane: ``index_select`` of the window rows,
    then ``cdist`` + mask + ``topk``), its tiles (``ops.SCAN_TILES``:
    uncovered, empty, sparse, dense), its coverage pre-pass alone and the
    whole call with every box empty. Returns the kernels-line row."""
    from repro_torch.kernels import ops, ref

    dev = pos_vecs.device
    B, W = starts.shape
    N, d = pos_vecs.shape
    bf16 = pos_vecs.dtype == torch.bfloat16
    name = "scan_topk_windows_bf16" if bf16 else "scan_topk_windows"
    m = pos_attrs.shape[1]
    lane_rows, n_pass, rows_cov, rows_pass = window_pairs(
        pos_attrs, qlo, qhi, starts, counts)
    covered = sum(int(r.numel()) for r in lane_rows)

    def kern():
        return ops.scan_topk_windows(pos_vecs, pos_attrs, q, qlo, qhi,
                                     starts, counts, k=k)

    def plain():
        return ref.scan_topk_windows_ref(pos_vecs, pos_attrs, q, qlo, qhi,
                                         starts, counts, k)

    def lib():
        out = []
        for b, r in enumerate(lane_rows):
            if r.numel():
                dist = torch.cdist(q[b:b + 1],
                                   pos_vecs.index_select(0, r).float())
                a = pos_attrs.index_select(0, r)
                ok = ((a >= qlo[b]) & (a <= qhi[b])).all(-1)
                out.append(torch.topk(torch.where(ok, dist[0], float("inf")),
                                      min(k, r.numel()), largest=False))
        return out

    ids, dd = kern()
    tiles = ops.SCAN_TILES[name].tolist()
    rids, rdd = plain()
    torch.cuda.synchronize()
    same, ties, err = topk_agree(name, ids, dd, rids, rdd)
    # where the time goes: the pre-pass alone (the bitmap's memset and
    # the cover kernel), and the same windows with every box empty, where
    # no pair passes and a covered tile costs only its attrs and box test
    plan = ops._scan_plan(B, N, k, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    cover_ms = time_ms(lambda: ops._window_cover(starts, counts, N, plan),
                       reps=5)
    inf = torch.full_like(qlo, float("inf"))
    empty_ms = time_ms(lambda: ops.scan_topk_windows(
        pos_vecs, pos_attrs, q, inf, -inf, starts, counts, k=k), reps=5)
    nbytes = (rows_cov * m * 4 + rows_pass * d * pos_vecs.element_size()
              + q.numel() * 4 + 2 * qlo.numel() * 4 + 2 * starts.numel() * 4
              + B * k * 8)
    bms, by = bound_ms(nbytes, n_pass * d * 3)
    r = dict(
        name=name, route="cuda", launches=0, source=SCAN_CU,
        replaces=SCAN_TPU + ":305", max_abs_err=err,
        ms=time_ms(kern, reps=5),
        plain_ms=time_ms(plain, reps=1, warmup=0),
        bound_ms=bms, bound_by=by, library_ms=time_ms(lib, reps=2),
        tiles=dict(zip(("uncovered", "empty", "sparse", "dense"), tiles)),
        pre_pass_ms=cover_ms, empty_boxes_ms=empty_ms)
    print(f"[kernels] {name} at {what}: B={B} W={W} k={k}, "
          f"{covered} covered (lane, row) pairs ({n_pass} pass) over "
          f"{rows_cov} distinct rows ({rows_pass} pass some lane), d={d}: "
          f"{r['ms']:.3f} ms "
          f"(plain {r['plain_ms']:.3f}, per-lane index_select+cdist+mask+"
          f"topk {r['library_ms']:.3f}, bound {bms:.3f} by {by}; tiles: "
          f"{tiles[0]} uncovered, {tiles[1]} empty, {tiles[2]} sparse, "
          f"{tiles[3]} dense; coverage bitmap {B * -(-N // 32) * 4 / 1e6:.1f}"
          f" MB, its pre-pass {cover_ms:.3f} ms; every box empty "
          f"{empty_ms:.3f} ms), ids equal on {same} of {ids.numel()} slots "
          f"({ties} near-ties), max abs err {err:.3g}", flush=True)
    return r


def lane_sample(lanes, n: int = 64, seed: int = 0):
    """A seeded sample of ``n`` of ``lanes`` (all of them when fewer),
    ascending: the lanes a numpy check over the whole corpus runs on where
    running it on every lane would not fit the script's time limit."""
    lanes = np.asarray(lanes)
    if len(lanes) <= n:
        return lanes
    return np.sort(np.random.default_rng(seed).choice(lanes, n,
                                                      replace=False))


def pmap(fn, items, workers: int = 8) -> list:
    """``[fn(x) for x in items]`` on a pool of host threads: numpy lets go
    of the GIL in its array loops, so a check over the whole corpus runs
    on several cores."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(workers, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


def lanes_exact(ids, dists, t_ids, t_d):
    """Per lane: every slot holds the truth's id, or a distance within
    1e-5 relative of the truth's (a near-tie), with the same -1 slots."""
    ok = (ids == t_ids) | np.isclose(dists, t_d, rtol=1e-5, atol=1e-4)
    return ok.all(1) & ((ids < 0) == (t_ids < 0)).all(1)


def box_truth_f64(vecs, attrs, Q, lo, hi, lanes, k: int) -> dict:
    """{lane: float64 top-k (ids, dists)} of the rows in the lane's box, on
    8 host threads (smoke_reference.topk_f64)."""
    import smoke_reference as sref

    def one(i):
        rows_i = np.nonzero(((attrs >= lo[i]) & (attrs <= hi[i])).all(1))[0]
        a, b = sref.topk_f64(vecs, rows_i, Q[i][None], k)
        return int(i), (a[0], b[0])
    return dict(pmap(one, lanes))


def exact_lanes(lanes, ids, dists, truth):
    """``lanes_exact`` of the served ``lanes`` against ``truth``'s
    {lane: (ids, dists)}."""
    if len(lanes) == 0:
        return np.zeros(0, bool)
    t_i = np.stack([truth[int(i)][0] for i in lanes])
    t_d = np.stack([truth[int(i)][1] for i in lanes])
    return lanes_exact(ids[lanes], dists[lanes], t_i, t_d)


def launch_us(dev, n: int = 4000) -> float:
    """Host microseconds per small PyTorch launch (a one-element add, back
    to back): the host cost the hop loop pays for each of its operations."""
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


# -------------------------------------------------------------- phases 3-4

def bursts(total: int, sizes=(256, 37, 8, 1, 64, 19, 3)):
    """Burst sizes a frontend might send, cycled until ``total``."""
    out, i = [], 0
    while total > 0:
        s = min(sizes[i % len(sizes)], total)
        out.append(s)
        total -= s
        i += 1
    return out


def l2dist_events(calls: list):
    """(``ops.l2dist_qn``, a stand-in that records each call between two
    CUDA events with its (G, B, N) into ``calls``); one sync at the end
    reads them. The caller installs the stand-in and restores the
    original."""
    from repro_torch.kernels import ops

    l2dist_qn = ops.l2dist_qn

    def timed_l2dist_qn(q, c):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = l2dist_qn(q, c)
        b.record()
        calls.append((q.shape[0] if q.dim() == 3 else 1, q.shape[-2],
                      c.shape[-2], a, b))
        return out

    return l2dist_qn, timed_l2dist_qn


def main_data(n: int, nq: int = 192):
    """The main path's corpus and its two query sets (1/4 and 1/64), made
    on the host: -> (vecs, attrs, (Qg, Pg), (Qs, Ps))."""
    from repro_torch.configs.khi_serve import config
    from repro_torch.data import DatasetSpec, make_dataset, make_queries

    cfg = config()
    t0 = time.perf_counter()
    spec = DatasetSpec("khi-serve", n=n, d=cfg.d, m=cfg.m,
                       attr_kinds=("year", "lognormal", "lognormal",
                                   "lognormal"),
                       attr_corr=0.85, n_clusters=64, seed=0)
    vecs, attrs = make_dataset(spec)
    g = make_queries(vecs, attrs, n_queries=nq, sigma=1 / 4, seed=1)
    s = make_queries(vecs, attrs, n_queries=nq, sigma=1 / 64, seed=2)
    print(f"[data] corpus ({n}, {cfg.d}) + {2 * nq} queries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return vecs, attrs, g, s


def main_path(n: int, n_full: int, dev, rows: dict, data=None) -> None:
    """The main path and every later pass over its index; ``data`` is
    ``main_data(n)``'s output, made here when None."""
    from repro_torch.configs.khi_serve import config
    from repro_torch.core import KHIConfig, KHIIndex
    from repro_torch.core.engine import device_put_index
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import KHIService, Request, ServeConfig

    cfg = config()
    thr = max(1, n // 10)
    params = dataclasses.replace(cfg.search_params(), scan_threshold=thr)
    cut = "full shard" if n == n_full else f"cut from {n_full}: only n is cut"
    print(f"[config] {cfg.name}: n={n} ({cut}) d={cfg.d} m={cfg.m} "
          f"M={cfg.M} k={cfg.k} ef={cfg.ef} c_e={cfg.c_e} c_n={cfg.c_n} "
          f"E={cfg.expand_width} strategy={cfg.strategy} "
          f"backend={cfg.backend} scan_threshold={thr} (10% of n) "
          f"buckets={cfg.buckets}", flush=True)

    # ---- phase 3: data, tree on the host, graphs on the card
    vecs, attrs, (Qg, Pg), (Qs, Ps) = data or main_data(n)
    nq = len(Qg)

    ops.reset_launches()
    ref.reset_calls()
    torch.cuda.synchronize()
    l2_calls = []
    l2dist_qn, ops.l2dist_qn = l2dist_events(l2_calls)
    t0 = time.perf_counter()
    try:
        index = KHIIndex.build(vecs, attrs,
                               KHIConfig(M=cfg.M, builder="device"),
                               device=dev, verbose=True)
    finally:
        ops.l2dist_qn = l2dist_qn
    build_s = time.perf_counter() - t0
    check(ops.LAUNCHES["l2dist_qn"] > 0, "the builder never launched l2dist")
    check(len(l2_calls) == ops.LAUNCHES["l2dist_qn"],
          "the build called l2dist_qn around the timing shim")
    torch.cuda.synchronize()
    print(f"[build] {build_l2dist_split(index.tree, l2_calls, build_s)}",
          flush=True)
    del l2_calls
    di = device_put_index(index, device=dev)
    index.nbrs = None
    torch.cuda.synchronize()
    print(f"[build] KHI on the card: {index.tree.num_nodes} tree nodes, "
          f"height {di.height}, build {build_s:.1f}s, "
          f"l2dist launches {ops.LAUNCHES['l2dist_qn']}, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    builder_check(index, di, cfg.M)
    mark("the main path's build")

    # ---- phase 4: serve mixed-selectivity bursts through the planner
    svc = KHIService(di, params, config=ServeConfig(
        buckets=cfg.buckets, cache_size=cfg.cache_size))
    print(f"[serve] frontier_cap={svc.params.frontier_cap} "
          f"scan_budget={svc.params.scan_budget}", flush=True)
    Q = np.concatenate([Qg, Qs])
    lo = np.stack([p.lo for p in Pg + Ps]).astype(np.float32)
    hi = np.stack([p.hi for p in Pg + Ps]).astype(np.float32)
    perm = np.random.default_rng(3).permutation(len(Q))
    Q, lo, hi = Q[perm], lo[perm], hi[perm]
    sizes = bursts(len(Q))

    def serve_bursts(svc, qs):
        out, s = [], 0
        for b in sizes:
            tickets = [svc.submit(Request(qs[i], lo[i], hi[i]))
                       for i in range(s, s + b)]
            res = svc.flush()
            out.extend(res[t] for t in tickets)
            s += b
        return out

    t0 = time.perf_counter()
    serve_bursts(svc, Q + np.float32(1e-3))        # warm-up, other keys
    warm_s = time.perf_counter() - t0
    before = svc.snapshot()
    t0 = time.perf_counter()
    results = serve_bursts(svc, Q)
    dt = time.perf_counter() - t0
    after = svc.snapshot()
    launches = dict(ops.LAUNCHES)
    plain_cuda = {k: v["cuda"] for k, v in ref.CALLS.items()}
    delta = {k: after[k] - before[k] for k in
             ("requests", "batches", "pad_lanes", "cache_hits",
              "device_queries", "device_seconds", "scan_lanes")}
    # the same requests again on an emptied result cache, each layer timed
    # on the host (before any profiler session, as the first run), and the
    # host cost of a launch
    svc._cache.clear()
    timed_serve(svc, serve_bursts, Q, "[serve] f32 again:")
    print(f"[serve] host per PyTorch launch {launch_us(dev):.2f} us",
          flush=True)
    graph_lanes = delta["device_queries"] - delta["scan_lanes"]
    print(f"[serve] {len(results)} requests in {dt:.3f}s "
          f"({len(results) / dt:.1f} QPS end-to-end; device "
          f"{delta['device_queries'] / delta['device_seconds']:.1f} lane/s "
          f"over {delta['device_seconds']:.3f}s); warm-up {warm_s:.1f}s; "
          f"bursts {sizes}", flush=True)
    print(f"[serve] batches={delta['batches']} graph_lanes={graph_lanes} "
          f"(incl. {delta['pad_lanes']} pad lanes) "
          f"scan_lanes={delta['scan_lanes']} "
          f"cache_hits={delta['cache_hits']}", flush=True)
    print(f"[serve] launches on the main path {launches}; plain-version "
          f"CUDA calls {plain_cuda}", flush=True)
    for name in ("gather_l2_filter", "scan_topk", "l2dist_qn"):
        check(launches[name] > 0, f"{name} was never launched on the path")
        rows[name]["launches"] = launches[name]
    check(all(v == 0 for v in plain_cuda.values()),
          f"the main path fell through to a plain version: {plain_cuda}")
    check(delta["scan_lanes"] > 0 and graph_lanes > delta["pad_lanes"],
          "the burst did not exercise both graph and scan lanes")

    # ---- checks against an exact brute force on the card
    ids = np.stack([r.ids for r in results])
    dists = np.stack([r.dists for r in results])
    main_plan = svc._planner.plan(lo, hi)
    use_scan = main_plan.use_scan
    qt = torch.as_tensor(Q).to(dev)
    tl = torch.as_tensor(lo).to(dev)
    th = torch.as_tensor(hi).to(dev)
    t_ids, t_d = [], []
    for s in range(0, len(Q), 64):
        a, b = ref.scan_topk_ref(di.vecs, di.attrs, qt[s:s + 64],
                                 tl[s:s + 64], th[s:s + 64], cfg.k)
        t_ids.append(a.cpu().numpy())
        t_d.append(b.cpu().numpy())
    t_ids, t_d = np.concatenate(t_ids), np.concatenate(t_d)
    check_served(ids, dists, vecs, attrs, Q, lo, hi, "f32")
    si = np.nonzero(use_scan)[0]
    same = (ids[si] == t_ids[si]) | np.isclose(dists[si], t_d[si],
                                               rtol=1e-5, atol=1e-4)
    check(bool(same.all()) and bool(((ids[si] < 0) == (t_ids[si] < 0)).all()),
          f"scan lanes are not exact on {int((~same).sum())} slots")

    ref_ent, _ = graph_checks(index, di, svc, Q, lo, hi, ids, use_scan,
                              t_ids, t_d, cfg, dev)
    trace_programs("f32", di, svc.params, Q, lo, hi, split_lanes(use_scan))
    single = svc._planner
    del svc
    mark("the main path's serving and checks")
    served = {"auto": (ids, dists)}
    for quant in ("int8", "bf16"):
        served[quant] = quant_pass(quant, index, di, params, cfg, Q, lo, hi,
                                   serve_bursts, use_scan, t_ids, ref_ent,
                                   dev, rows)
        mark(f"the {quant} pass")
    large_k_pass(index, di, params, cfg, Q, lo, hi, dev, rows)
    mark("the large-k pass")
    m12_pass(cfg, dev, rows)
    mark("the m = 12 pass")
    db, bsvc = bf16_corpus_pass(index, di, params, cfg, Q, lo, hi,
                                perm >= nq, serve_bursts, sizes, use_scan,
                                t_ids, ref_ent, len(results) / dt, dev, rows)
    mark("the bf16 corpus pass")
    checkpoint_phase(db, bsvc, Q, serve_bursts, dev)
    del db, bsvc
    torch.cuda.empty_cache()
    mark("the checkpoint phase")
    served["hybrid"] = hybrid_pass(index, di, params, cfg, Q, lo, hi,
                                   perm >= nq, serve_bursts, ids, use_scan,
                                   t_ids, t_d, dev, rows)
    mark("the hybrid pass")
    mesh_pass(di, params, cfg, Q, lo, hi, serve_bursts, main_plan.card,
              served, single, dev, rows)
    del served, single
    mark("the mesh pass")
    predicate_pass(index, di, params, cfg, Q, sizes, dev, rows)
    mark("the predicate pass")
    graph_pass(index, di, params, cfg, Q, lo, hi, perm >= nq, serve_bursts,
               t_ids, dev, rows)
    mark("the graph pass")
    builders_pass(index, params, cfg, Q, lo, hi, perm >= nq, serve_bursts,
                  dev, rows)
    mark("the builders' pass")
    torch.cuda.empty_cache()
    s_index, s_di = shard_pass(index, di, params, cfg, Q, lo, hi,
                               serve_bursts, dev, rows)
    mark("the shard pass")
    slo_pass(index, di, params, cfg, Q, lo, hi, perm >= nq, ids, use_scan,
             t_ids, t_d, ref_ent, dev, rows)
    mark("the SLO pass")
    torch.cuda.empty_cache()
    stream_pass(s_index, s_di, params, cfg, Q, lo, hi, serve_bursts, dev)
    mark("the stream pass")


def build_l2dist_split(tree, calls, build_s: float) -> str:
    """The build's l2dist_qn seconds (CUDA events per call) against its
    wall seconds, by kind of call: the batched small nodes (every node of
    a size class padded to C <= 4096 columns) and, per tree level, the
    row blocks of the large nodes (N = the node's row count; a count that
    two levels share is reported under both)."""
    count = np.asarray(tree.count, np.int64)
    level = np.asarray(tree.level, np.int64)
    big = np.nonzero(count > 4096)[0]
    levels = {}
    for p in big:
        levels.setdefault(int(count[p]), set()).add(int(level[p]))
    by, total = {}, 0.0
    for G, B, N, a, b in calls:
        s = a.elapsed_time(b) / 1e3
        total += s
        key = "small nodes" if N <= 4096 else "L" + "/".join(
            str(v) for v in sorted(levels.get(N, {-1})))
        by[key] = by.get(key, 0.0) + s
    parts = ", ".join(f"{k} {v:.2f}s" for k, v in sorted(
        by.items(), key=lambda kv: (kv[0] != "small nodes", kv[0][1:].zfill(3))))
    return (f"l2dist_qn {total:.1f}s of the build's {build_s:.1f}s "
            f"({100 * total / build_s:.1f}%) over {len(calls)} launches; "
            f"by kind: {parts}")


RECALL_BAR = 0.85   # the bar examples/quickstart.py sets for the reference


def recall(found: np.ndarray, truth: np.ndarray) -> float:
    r = []
    for f, t in zip(found, truth):
        t = t[t >= 0]
        if len(t):
            r.append(len(set(f[f >= 0].tolist()) & set(t.tolist())) / len(t))
    return float(np.mean(r))


def graph_checks(index, di, svc, Q, lo, hi, ids, use_scan, t_ids, t_d, cfg,
                 dev) -> tuple:
    """Graph lanes: recall@10 against the brute force, held to the bar;
    the router and the hop loop against the numpy reference
    (smoke_reference.py, which shares no code with the port) on this
    index; recall as ef grows; how far the true neighbours stand out.
    Returns (the numpy DFS's entries, recall@k of the graph lanes by
    ef)."""
    import smoke_reference as sref
    from repro_torch.core.engine import Planner
    from repro_torch.core.router import route_level_sync

    p = svc.params
    gi = np.nonzero(~use_scan)[0]
    rec = recall(ids[gi], t_ids[gi])
    print(f"[check] graph lanes ({len(gi)}): recall@{cfg.k} {rec:.4f}, bar "
          f"{RECALL_BAR}: {'met' if rec >= RECALL_BAR else 'NOT MET'}",
          flush=True)

    # Phase A: the compacted level router against the stack DFS
    ent, _ = route_level_sync(di, torch.as_tensor(lo[gi]).to(dev),
                              torch.as_tensor(hi[gi]).to(dev), p)
    ent = ent.cpu().numpy()
    t0 = time.perf_counter()
    ref_ent = [sref.dfs_entries(index.tree, index.attrs, lo[i], hi[i],
                                p.c_e, p.scan_budget) for i in gi]
    same_ent = sum(ent[j][ent[j] >= 0].tolist() == e
                   for j, e in enumerate(ref_ent))
    print(f"[check] router: entries equal to the numpy DFS on {same_ent} of "
          f"{len(gi)} lanes ({time.perf_counter() - t0:.1f}s on the host)",
          flush=True)
    check(same_ent == len(gi), "the router's entries differ from the DFS")

    # Phase B: the batched hop loop (kernel scorer) against the numpy beam
    # search from the same entries, on the port's graph
    nbrs = di.nbrs.cpu().numpy()
    t0 = time.perf_counter()
    ref_out = [sref.beam_search(index.vecs, index.attrs, nbrs, e, Q[i],
                                lo[i], hi[i], k=cfg.k, ef=p.ef, c_n=p.c_n,
                                E=p.expand_width, max_hops=p.hops())
               for e, i in zip(ref_ent, gi)]
    ref_s = time.perf_counter() - t0
    del nbrs
    sweep = {}
    for ef in sorted({p.ef, 4 * p.ef, 16 * p.ef}):
        pl = Planner(di, dataclasses.replace(p, strategy="graph", ef=ef))
        t0 = time.perf_counter()
        g_ids, _, g_hops, _ = pl.search(Q[gi], lo[gi], hi[gi])
        sweep[ef] = (g_ids, g_hops, time.perf_counter() - t0)
    g_ids, g_hops, _ = sweep[p.ef]
    r_ids = np.stack([r[0] for r in ref_out])
    r_hops = np.array([r[2] for r in ref_out])
    same_ids = (g_ids == r_ids).all(1)
    print(f"[check] hop loop: ids equal to the numpy beam search on "
          f"{int(same_ids.sum())} of {len(gi)} lanes, hops on "
          f"{int((g_hops == r_hops).sum())} (mean hops {g_hops.mean():.1f}; "
          f"reference {ref_s:.1f}s on the host); served ids equal to the "
          f"graph program's on {int((ids[gi] == g_ids).all(1).sum())}",
          flush=True)
    check(same_ids.mean() >= 0.95 and (g_hops == r_hops).mean() >= 0.95,
          "the hop loop disagrees with the numpy beam search")
    check(bool((ids[gi] == g_ids).all()),
          "served graph lanes differ from the graph program's")
    rec_ef = {ef: recall(s[0], t_ids[gi]) for ef, s in sweep.items()}
    line = ", ".join(f"ef={ef}: {rec_ef[ef]:.4f} (mean hops "
                     f"{s[1].mean():.1f}, {s[2]:.2f}s)"
                     for ef, s in sweep.items())
    print(f"[check] recall@{cfg.k} of the graph lanes as ef grows: {line}",
          flush=True)
    # the cell's ef covers too little of a box on this corpus to meet the
    # bar; the same index and path must meet it once the walk covers more
    check(rec_ef[16 * p.ef] >= RECALL_BAR,
          f"recall@{cfg.k} at ef={16 * p.ef} is {rec_ef[16 * p.ef]:.4f} < "
          f"{RECALL_BAR}")
    del sweep

    # how far the true 10 nearest stand out from the rest of the box
    qg = torch.as_tensor(Q[gi]).to(dev)
    vn = (di.vecs * di.vecs).sum(1)
    ratio = []
    for s in range(0, len(gi), 16):
        qs = qg[s:s + 16]
        d2 = vn[None] + (qs * qs).sum(1)[:, None] - 2.0 * (qs @ di.vecs.T)
        inb = ((di.attrs[None] >= torch.as_tensor(lo[gi[s:s + 16]]).to(dev)
                [:, None]) & (di.attrs[None] <= torch.as_tensor(
                    hi[gi[s:s + 16]]).to(dev)[:, None])).all(-1)
        mean_in = (d2 * inb).sum(1) / inb.sum(1)
        ratio.append((torch.as_tensor(t_d[gi[s:s + 16], cfg.k - 1]).to(dev)
                      / mean_in).cpu().numpy())
    print(f"[check] graph lanes: true {cfg.k}th-nearest squared distance / "
          f"mean squared distance over the box = "
          f"{float(np.mean(np.concatenate(ratio))):.4f}", flush=True)
    return ref_ent, rec_ef


def check_served(ids, dists, vecs, attrs, Q, lo, hi, what: str,
                 atol: float = 1e-8) -> None:
    """Served lanes: in the box, distinct, ascending, exact distances
    (within rtol 1e-4 and ``atol`` of float64)."""
    check(bool(np.isfinite(dists[ids >= 0]).all()),
          f"{what}: non-finite distance on a served id")
    for i in range(len(Q)):
        got = ids[i][ids[i] >= 0]
        check(len(set(got.tolist())) == len(got),
              f"{what} lane {i}: duplicate ids")
        a = attrs[got]
        check(bool(((a >= lo[i]) & (a <= hi[i])).all()),
              f"{what} lane {i}: an id outside the box was served")
        dd = dists[i][: len(got)]
        check(bool((np.diff(dd) >= 0).all()),
              f"{what} lane {i}: not ascending")
        exact = ((vecs[got].astype(np.float64) - Q[i]) ** 2).sum(1)
        check(bool(np.allclose(dd, exact, rtol=1e-4, atol=atol)),
              f"{what} lane {i}: served distances are not the exact ones")


def split_lanes(use_scan):
    """(strategy, lanes) parts of an auto batch: its graph and scan lanes."""
    return (("graph", np.nonzero(~use_scan)[0]),
            ("scan", np.nonzero(use_scan)[0]))


# a pattern of the kernel symbol behind each count in ops.LAUNCHES (matched
# in the profiler's demangled names: the box scan's forms differ in their
# template arguments, <element, vectorized, windowed>), and the ops wrapper
# that launches it
HAND_KERNELS = {
    "gather_l2_filter": ("gather_l2_filter_kernel", "gather_l2_filter"),
    "gather_l2_filter_bf16": ("gather_l2_filter_kernel", "gather_l2_filter"),
    "gather_l2_filter_q8": ("gather_l2_filter_q8_kernel",
                            "gather_l2_filter_q8"),
    "gather_l2": ("gather_l2_filter_kernel", "gather_l2"),
    "gather_l2_rows": ("gather_l2_rows_kernel", "gather_l2"),
    "scan_topk": (r"box_scan_kernel<float, \w+, false>", "scan_topk"),
    "scan_topk_bf16": (r"box_scan_kernel<__nv_bfloat16, \w+, false>",
                       "scan_topk"),
    "scan_topk_q8": (r"box_scan_kernel<signed char, \w+, false>",
                     "scan_topk_q8"),
    "scan_topk_mask": (r"mask_partial_kernel<float, \w+>",
                       "scan_topk_mask"),
    "scan_topk_mask_bf16": (r"mask_partial_kernel<__nv_bfloat16, \w+>",
                            "scan_topk_mask"),
    "scan_topk_windows": (r"box_scan_kernel<float, \w+, true>",
                          "scan_topk_windows"),
    "scan_topk_windows_bf16": (r"box_scan_kernel<__nv_bfloat16, \w+, true>",
                               "scan_topk_windows"),
    "scan_topk_wide": (r"box_scan_list_kernel<float, \w+, false>",
                       "scan_topk"),
    "scan_topk_wide_bf16": (
        r"box_scan_list_kernel<__nv_bfloat16, \w+, false>", "scan_topk"),
    "scan_topk_wide_q8": (r"box_scan_list_kernel<signed char, \w+, false>",
                          "scan_topk_q8"),
    "scan_topk_windows_wide": (r"box_scan_list_kernel<float, \w+, true>",
                               "scan_topk_windows"),
    "scan_topk_windows_wide_bf16": (
        r"box_scan_list_kernel<__nv_bfloat16, \w+, true>",
        "scan_topk_windows"),
    "scan_topk_mask_wide": (r"mask_list_kernel<float, \w+>",
                            "scan_topk_mask"),
    "scan_topk_mask_wide_bf16": (r"mask_list_kernel<__nv_bfloat16, \w+>",
                                 "scan_topk_mask"),
    "l2dist_qn": ("l2dist_qn_kernel", "l2dist_qn"),
    "l2dist_qc": ("l2dist_qc_kernel", "l2dist_qc")}


def profile_once(fn):
    """Run ``fn`` once under torch.profiler, then synchronize. -> (wall s,
    main-thread CPU s, the device-side events as (name, ms, count), the
    device-side event names). Device-side records only (kernels, copies,
    NCCL's), so nothing counts twice; the profiler records no host
    operators, and its records are read raw: parsing a graph program's
    thousands of launches into FunctionEvents took seconds a trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0, c0 = time.perf_counter(), time.thread_time()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu = time.thread_time() - c0
    agg, dev_names = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            continue
        ms, n = agg.get(e.name(), (0.0, 0))
        agg[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        dev_names.append(e.name())
    evs = [(key, ms, n) for key, (ms, n) in agg.items() if ms > 0]
    return wall, cpu, evs, dev_names


def trace_programs(tag, di, p, Q, lo, hi, parts, planner=None) -> None:
    """Where a served batch's time goes: for each (strategy, lanes) of
    ``parts``, that strategy's program over those lanes, run once to warm
    and once under torch.profiler, on ``planner`` when given. Prints the
    wall time, the summed device time of the device-side events (kernels
    and copies, so nothing counts twice), the device's idle share over
    the wall time, the top kernels and the main thread's CPU time. The
    profiler itself slows the host, so the idle share is an upper bound
    of the untraced run's.

    The hand kernels the traced run launched (``ops.LAUNCHES``) are held
    to the profiler's kernel records: where records are missing (the
    served bf16 scan program loses its scan's), the line says so, and the
    program runs once more with CUDA events around the wrappers of the
    missing kernels, whose time is printed beside the profiler's."""
    from repro_torch.core.engine import Planner
    from repro_torch.kernels import ops

    def traced(pl, lanes):
        saved = dict(ops.LAUNCHES)
        ops.reset_launches()
        wall, cpu, evs, dev_names = profile_once(
            lambda: pl.search(Q[lanes], lo[lanes], hi[lanes]))
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        ops.LAUNCHES.update(saved)
        return wall, cpu, evs, launched, dev_names

    def timed_wrappers(pl, lanes, names):
        marks = {nm: [] for nm in names}
        saved, counts = {}, dict(ops.LAUNCHES)

        def evented(fn, sink):
            def call(*a, **kw):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                res = fn(*a, **kw)
                ev[1].record()
                sink.append(ev)
                return res
            return call

        for nm in names:
            saved[nm] = getattr(ops, nm)
            setattr(ops, nm, evented(saved[nm], marks[nm]))
        try:
            pl.search(Q[lanes], lo[lanes], hi[lanes])
            torch.cuda.synchronize()
        finally:
            for nm, fn in saved.items():
                setattr(ops, nm, fn)
            ops.LAUNCHES.update(counts)
        return {nm: (sum(e[0].elapsed_time(e[1]) for e in m), len(m))
                for nm, m in marks.items()}

    for strat, lanes in parts:
        pl = planner or Planner(di, dataclasses.replace(p, strategy=strat))
        pl.search(Q[lanes], lo[lanes], hi[lanes])
        torch.cuda.synchronize()
        wall, cpu, evs, launched, dev_names = traced(pl, lanes)
        dev_ms = sum(t for _, t, _ in evs)
        top = sorted(evs, key=lambda e: -e[1])[:5]
        print(f"[trace] {tag} {strat} program, {len(lanes)} lanes: wall "
              f"{wall * 1e3:.1f} ms, kernels {dev_ms:.1f} ms on the card "
              f"(idle {100 * max(0.0, 1 - dev_ms / (wall * 1e3)):.1f}%), "
              f"main-thread CPU {cpu * 1e3:.1f} ms; "
              f"top: " + "; ".join(f"{k[:60]} {t:.2f} ms x{c}"
                                   for k, t, c in top), flush=True)
        # launches of each hand kernel against the profiler's records
        want, seen, wrapper = {}, {}, {}
        for nm, n in launched.items():
            sym, wrapper[nm] = HAND_KERNELS[nm]
            want[sym] = want.get(sym, 0) + n
            seen[sym] = sum(bool(re.search(sym, dn)) for dn in dev_names)
        missing = [sym for sym in want if seen[sym] < want[sym]]
        if not missing:
            continue
        by_ev = timed_wrappers(pl, lanes, sorted(
            {wrapper[nm] for nm in launched if HAND_KERNELS[nm][0] in missing}))
        ev_ms = sum(t for t, _ in by_ev.values())
        print(f"[trace] {tag} {strat} program: the profiler recorded "
              + ", ".join(f"{seen[s]} of {want[s]} launches of {s}"
                          for s in missing)
              + "; by CUDA events around the wrappers of those kernels "
              + ", ".join(f"{nm} {t:.2f} ms x{n}"
                          for nm, (t, n) in by_ev.items())
              + f"; the profiler's kernels and these together "
              f"{dev_ms + ev_ms:.1f} ms (idle "
              f"{100 * max(0.0, 1 - (dev_ms + ev_ms) / (wall * 1e3)):.1f}%), "
              f"an upper bound: a wrapper's kernels the profiler did record "
              f"count twice", flush=True)


QUANT_KERNELS = {"int8": ("gather_l2_filter_q8", "scan_topk_q8"),
                 "bf16": ("gather_l2_filter_bf16", "scan_topk_bf16")}


def quant_pass(quant, index, di, params, cfg, Q, lo, hi, serve_bursts,
               use_scan, t_ids, ref_ent, dev, rows):
    """The quantized serving path on the index already built: attach the
    replica on the card, serve the same warm-up pass and requests in the
    same bursts through KHIService, check the launches and the answers
    (graph-lane recall against the f32 brute force, scan lanes against
    the f32 truth), and for int8 hold the replica, the graph lanes and
    the scan lanes to smoke_reference.py's numpy int8 path. Returns the
    served (ids, dists)."""
    import smoke_reference as sref
    from repro_torch.core.engine import Planner, with_quant_replica
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import KHIService, ServeConfig

    ops.reset_launches()
    ref.reset_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dq = with_quant_replica(di, quant)
    torch.cuda.synchronize()
    attach_s = time.perf_counter() - t0
    pq = dataclasses.replace(params, quant=quant)
    svc = KHIService(dq, pq, config=ServeConfig(buckets=cfg.buckets,
                                                cache_size=cfg.cache_size))
    check(svc.index.qvecs is dq.qvecs, f"{quant}: the service re-derived "
          f"the replica it was handed")
    t0 = time.perf_counter()
    serve_bursts(svc, Q + np.float32(1e-3))        # warm-up, other keys
    warm_s = time.perf_counter() - t0
    before = svc.snapshot()
    t0 = time.perf_counter()
    results = serve_bursts(svc, Q)
    dt = time.perf_counter() - t0
    after = svc.snapshot()
    launches = dict(ops.LAUNCHES)
    plain_cuda = {k: v["cuda"] for k, v in ref.CALLS.items()}
    delta = {k: after[k] - before[k] for k in
             ("batches", "pad_lanes", "device_queries", "device_seconds",
              "scan_lanes")}
    graph_lanes = delta["device_queries"] - delta["scan_lanes"]
    rb = dq.qvecs.numel() * dq.qvecs.element_size() + (
        0 if dq.qscale is None else dq.qscale.numel() * 4)
    print(f"[{quant}] replica ({rb / 2**30:.3f} GiB) attached on the card "
          f"in {attach_s:.3f}s; {len(results)} requests in {dt:.3f}s "
          f"({len(results) / dt:.1f} QPS end-to-end; device "
          f"{delta['device_queries'] / delta['device_seconds']:.1f} lane/s "
          f"over {delta['device_seconds']:.3f}s); warm-up {warm_s:.1f}s",
          flush=True)
    print(f"[{quant}] batches={delta['batches']} graph_lanes={graph_lanes} "
          f"(incl. {delta['pad_lanes']} pad lanes) "
          f"scan_lanes={delta['scan_lanes']}; launches on the path "
          f"{launches}; plain-version CUDA calls {plain_cuda}", flush=True)
    gname, sname = QUANT_KERNELS[quant]
    for name in (gname, sname, "gather_l2_filter"):
        check(launches[name] > 0, f"{quant}: {name} was never launched")
    for name in (gname, sname):
        rows[name]["launches"] = launches[name]
    check(all(v == 0 for v in plain_cuda.values()),
          f"{quant}: the path fell through to a plain version: {plain_cuda}")
    check(delta["scan_lanes"] == int(use_scan.sum()),
          f"{quant}: the planner split the lanes differently")

    ids = np.stack([r.ids for r in results])
    dists = np.stack([r.dists for r in results])
    check_served(ids, dists, index.vecs, index.attrs, Q, lo, hi, quant)
    gi = np.nonzero(~use_scan)[0]
    si = np.nonzero(use_scan)[0]
    rec = recall(ids[gi], t_ids[gi])
    scan_same = int((ids[si] == t_ids[si]).all(1).sum())
    print(f"[{quant}] graph lanes ({len(gi)}): recall@{cfg.k} {rec:.4f}; "
          f"scan lanes with the f32 truth's ids: {scan_same} of {len(si)}",
          flush=True)
    trace_programs(quant, dq, svc.params, Q, lo, hi, split_lanes(use_scan))
    if quant != "int8":
        return ids, dists

    # ---- the int8 path against smoke_reference.py (numpy only)
    t0 = time.perf_counter()
    qv_card, qs_card = dq.qvecs.cpu().numpy(), dq.qscale.cpu().numpy()

    def differ(s):
        a, b = sref.quantize_rows_i8(index.vecs[s:s + (1 << 17)])
        return (int((a != qv_card[s:s + (1 << 17)]).sum())
                + int((b != qs_card[s:s + (1 << 17)]).sum()))

    diff = sum(pmap(differ, range(0, len(index.vecs), 1 << 17)))
    deq = sref.dequant_rows(qv_card, qs_card)
    print(f"[int8] replica: {diff} elements differ from numpy's "
          f"quantization ({time.perf_counter() - t0:.1f}s on the host)",
          flush=True)
    check(diff == 0, "the int8 replica differs from numpy's quantization")

    p = svc.params
    pl = Planner(dq, dataclasses.replace(p, strategy="graph"))
    g_ids, _, g_hops, _ = pl.search(Q[gi], lo[gi], hi[gi])
    check(bool((ids[gi] == g_ids).all()),
          "int8: served graph lanes differ from the graph program's")
    rr = max(p.k, min(p.ef, p.k * p.rerank_mult))
    nbrs = di.nbrs.cpu().numpy()
    t0 = time.perf_counter()
    same_ids = same_hops = 0
    for j, i in enumerate(gi):
        cand, _, hops = sref.beam_search(
            deq, index.attrs, nbrs, ref_ent[j], Q[i], lo[i], hi[i], k=rr,
            ef=p.ef, c_n=p.c_n, E=p.expand_width, max_hops=p.hops())
        r_ids, _ = sref.rerank(index.vecs, cand, Q[i], p.k)
        same_ids += bool((r_ids == g_ids[j]).all())
        same_hops += int(hops == g_hops[j])
    del nbrs
    print(f"[int8] graph lanes: ids equal to the numpy int8 beam search + "
          f"f32 rerank (rr={rr}) on {same_ids} of {len(gi)} lanes, hops on "
          f"{same_hops} ({time.perf_counter() - t0:.1f}s on the host)",
          flush=True)
    check(same_ids >= 0.95 * len(gi) and same_hops >= 0.95 * len(gi),
          "int8: the graph lanes disagree with the numpy reference")
    kq = min(max(p.k, p.k * p.rerank_mult), len(index.vecs))
    t0 = time.perf_counter()
    ss = lane_sample(si)
    same_scan = sum(pmap(lambda i: bool((sref.scan_rerank(
        deq, index.vecs, index.attrs, Q[i], lo[i], hi[i], k=p.k, kq=kq)[0]
        == ids[i]).all()), ss))
    print(f"[int8] scan lanes: ids equal to the numpy int8 over-fetch "
          f"(kq={kq}) + f32 rerank on {same_scan} of {len(ss)} sampled lanes "
          f"(of {len(si)}; {time.perf_counter() - t0:.1f}s on the host)",
          flush=True)
    check(same_scan >= 0.95 * len(ss),
          "int8: the scan lanes disagree with the numpy reference")
    return ids, dists


def served_run(svc, serve, qs):
    """One served run with the launch counts set to 0 just before it and
    read just after: -> (ids, dists, seconds, launches, plain-version CUDA
    calls)."""
    from repro_torch.kernels import ops, ref

    ops.reset_launches()
    ref.reset_calls()
    t0 = time.perf_counter()
    out = serve(svc, qs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    plain = {k: v["cuda"] for k, v in ref.CALLS.items() if v["cuda"]}
    if not isinstance(out, tuple):        # a list of Results
        out = (np.stack([r.ids for r in out]),
               np.stack([r.dists for r in out]))
    return (*out, dt, launches, plain)


def bf16_corpus_pass(index, di, params, cfg, Q, lo, hi, is_s, serve_bursts,
                     sizes, use_scan, t_ids, ref_ent, f32_qps, dev, rows):
    """The index stored in bf16 (``device_put_index(vec_dtype=
    torch.bfloat16)``) beside the f32 one, from the same host index and
    graph: the 384 requests served under auto with the fused backend; the
    same requests under strategy="graph" with pallas_gather_l2 (its graph
    lanes bit-equal to auto's) and pallas_l2, and the f32 index's fused
    graph walk for its recall; hybrid at the cell's node threshold (every
    lane pure-window: the bf16 windowed form, held to its plain version at
    the served 1/64 windows and at every lane's first); expression E2 (the
    bitmask: the bf16 bitmask form); and the int8 tier over the bf16
    corpus, which the reference allows. Truths come from
    smoke_reference.py alone: the corpus rounded to bf16 by bit
    arithmetic (which the card's copy must equal), exact float64 top-k of
    it for 64 sampled lanes of each exact path (scan lanes, 1/64
    pure-window lanes, E2 lanes; the query unrounded, as those paths pass
    it), and the numpy DFS + beam search on the rounded corpus with the
    query rounded to bf16 (as the fused gather rounds it) for the graph
    lanes, >= 95% equal in ids and hops. Each served run's launches are
    counted alone. Returns the bf16 DeviceIndex."""
    import smoke_reference as sref
    from repro_torch.core.engine import (Planner, device_put_index,
                                         with_quant_replica)
    from repro_torch.core.predicate import parse_expr
    from repro_torch.serve import KHIService, Request, ServeConfig

    k = cfg.k
    t0 = time.perf_counter()
    db = device_put_index(dataclasses.replace(
        index, nbrs=di.nbrs.permute(1, 0, 2)), device=dev,
        vec_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    check(db.nbrs.data_ptr() == di.nbrs.data_ptr(),
          "bf16 corpus: the graph was copied, not shared")
    t0 = time.perf_counter()
    vb = np.concatenate(pmap(lambda s: sref.round_bf16(
        index.vecs[s:s + (1 << 17)]), range(0, len(index.vecs), 1 << 17)))
    round_s = time.perf_counter() - t0
    diff = 0
    for s in range(0, len(vb), 1 << 17):
        diff += int((db.vecs[s:s + (1 << 17)].float() != torch.as_tensor(
            vb[s:s + (1 << 17)]).to(dev)).sum())
    print(f"[bf16 corpus] index_gib f32 {index_gib(di):.3f}, bf16 "
          f"{index_gib(db):.3f} (vectors {di.vecs.numel() * 4 / 2**30:.3f} "
          f"-> {db.vecs.numel() * 2 / 2**30:.3f} GiB); put on the card in "
          f"{put_s:.2f}s; numpy's bf16 rounding in {round_s:.1f}s on the "
          f"host, {diff} elements differ from the card's", flush=True)
    check(diff == 0, "bf16 corpus: the card's rounding differs from numpy's")
    Qr = sref.round_bf16(Q)
    # the query each lane's path scores with: graph walks round it to bf16
    # (the gathers), scans and windows pass it unrounded
    Qc = np.where(use_scan[:, None], Q, Qr)
    gi = np.nonzero(~use_scan)[0]
    si = np.nonzero(use_scan)[0]
    sel = {"1/4": np.nonzero(~is_s)[0], "1/64": np.nonzero(is_s)[0]}
    svc_cfg = ServeConfig(buckets=cfg.buckets, cache_size=cfg.cache_size)

    def box_truth(lanes, q):
        return box_truth_f64(vb, index.attrs, q, lo, hi, lanes, k)

    # ---- (a) auto, the fused backend
    svc = KHIService(db, params, config=svc_cfg)
    serve_bursts(svc, Q + np.float32(1e-3))        # warm-up, other keys
    a_ids, a_d, dt, launches, plain = served_run(svc, serve_bursts, Q)
    print(f"[bf16 corpus] auto: {len(Q)} requests in {dt:.3f}s "
          f"({len(Q) / dt:.1f} QPS end-to-end, against {f32_qps:.1f} for "
          f"the f32 index in the main path; passes differ by up to 2x on "
          f"this host, PERF.md 7); launches {launches}; plain-version "
          f"CUDA calls {plain}", flush=True)
    for name in ("gather_l2_filter_bf16", "scan_topk_bf16"):
        check(launches.get(name, 0) > 0,
              f"bf16 corpus auto: {name} was never launched")
    check(not plain, f"bf16 corpus auto: fell through to {plain}")
    check(launches.get("gather_l2_filter", 0) == 0
          and launches.get("scan_topk", 0) == 0,
          "bf16 corpus auto: an f32 form ran on the bf16 index")
    check(np.array_equal(svc._planner.plan(lo, hi).use_scan, use_scan),
          "bf16 corpus auto: the planner split the lanes differently")
    check_served(a_ids, a_d, vb, index.attrs, Qc, lo, hi, "bf16 corpus auto")
    samp = lane_sample(si)
    truth = box_truth(samp, Q)
    ok = exact_lanes(samp, a_ids, a_d, truth)
    print(f"[bf16 corpus] scan lanes: {int(ok.sum())} of {len(samp)} sampled "
          f"(of {len(si)}) equal the float64 top-k of the bf16 corpus",
          flush=True)
    check(bool(ok.all()), "bf16 corpus: a scan lane is not exact")

    # graph lanes: the graph program and the numpy DFS + beam search on the
    # rounded corpus with the rounded query
    p = svc.params
    g_ids, _, g_hops, _ = Planner(db, dataclasses.replace(
        p, strategy="graph")).search(Q[gi], lo[gi], hi[gi])
    check(bool((g_ids == a_ids[gi]).all()),
          "bf16 corpus: served graph lanes differ from the graph program's")
    nbrs = di.nbrs.cpu().numpy()
    t0 = time.perf_counter()
    ref_out = [sref.beam_search(vb, index.attrs, nbrs, e, Qr[i], lo[i],
                                hi[i], k=k, ef=p.ef, c_n=p.c_n,
                                E=p.expand_width, max_hops=p.hops())
               for e, i in zip(ref_ent, gi)]
    del nbrs
    same_ids = (g_ids == np.stack([r[0] for r in ref_out])).all(1)
    same_hops = g_hops == np.array([r[2] for r in ref_out])
    print(f"[bf16 corpus] graph lanes: ids equal to the numpy beam search "
          f"on the bf16 corpus on {int(same_ids.sum())} of {len(gi)}, hops "
          f"on {int(same_hops.sum())} ({time.perf_counter() - t0:.1f}s on "
          f"the host)", flush=True)
    check(same_ids.mean() >= 0.95 and same_hops.mean() >= 0.95,
          "bf16 corpus: the hop loop disagrees with the numpy beam search")

    # ---- (b), (c): strategy="graph" on the unfused backends; the f32
    # index's fused walk for its recall
    def search_all(svc, qs):
        return svc.search(qs, lo, hi)

    out = {}
    for tag, backend, kern in (("b", "pallas_gather_l2", "gather_l2"),
                               ("c", "pallas_l2", "l2dist_qc")):
        gsvc = KHIService(db, dataclasses.replace(
            params, strategy="graph", backend=backend), config=svc_cfg)
        ids, dists, dt, launches, plain = served_run(gsvc, search_all, Q)
        out[tag] = ids, dists
        check(launches.get(kern, 0) > 0 and not plain
              and not launches.get("gather_l2_filter_bf16", 0),
              f"bf16 corpus ({tag}): launches {launches}, plain {plain}")
        check_served(ids, dists, vb, index.attrs, Qr, lo, hi,
                     f"bf16 corpus ({tag})",
                     atol=1e-3 if backend == "pallas_l2" else 1e-8)
        print(f"[bf16 corpus] ({tag}) graph, {backend}: {len(Q)} requests "
              f"in {dt:.3f}s; launches {launches}", flush=True)
        del gsvc
    b_ids, b_d = out["b"]
    check(np.array_equal(b_ids[gi], a_ids[gi])
          and np.array_equal(b_d[gi], a_d[gi]),
          "bf16 corpus: (b) differs from (a) on the graph lanes")
    c_same = (out["c"][0] == b_ids).all(1)
    f_ids = Planner(di, dataclasses.replace(p, strategy="graph")).search(
        Q, lo, hi)[0]
    rec = {tag: {s: recall(x[0][i], t_ids[i]) for s, i in sel.items()}
           for tag, x in (("bf16", out["b"]), ("pallas_l2", out["c"]),
                          ("f32", (f_ids,)))}
    print(f"[bf16 corpus] (b) equals (a) bit for bit on the {len(gi)} graph "
          f"lanes; (c) ids equal to (b) on {int(c_same.sum())} of {len(Q)}; "
          f"recall@{k} of the graph walk against the f32 truth: bf16 "
          + ", ".join(f"{s} {r:.4f}" for s, r in rec["bf16"].items())
          + "; f32 " + ", ".join(f"{s} {r:.4f}" for s, r in rec["f32"].items())
          + "; bf16 pallas_l2 " + ", ".join(
              f"{s} {r:.4f}" for s, r in rec["pallas_l2"].items()),
          flush=True)
    check(c_same.mean() >= 0.95, "bf16 corpus: (c) differs from (b)")
    del out, f_ids

    # ---- hybrid at the cell's node threshold: every lane pure-window
    hsvc = KHIService(db, dataclasses.replace(params, strategy="hybrid"),
                      config=svc_cfg)
    pl = hsvc._planner
    check(pl._pos_vecs.dtype == torch.bfloat16,
          "bf16 corpus: the windowed scan's corpus is not bf16")
    plan = pl.plan(lo, hi)
    for part, lanes in (("1/64", is_s & (plan.mode >= 1)),
                        ("all", plan.mode == 1)):
        idx = np.nonzero(lanes)[0]
        qs, ql, qh = pl._pad_pow2(Q[idx], lo[idx], hi[idx])
        starts, counts, w_cap = pl._build_windows(plan.small_nodes, idx,
                                                  qs.shape[0])
        r = windows_check(
            pl._pos_vecs, pl._pos_attrs,
            *(torch.as_tensor(a).to(dev) for a in (qs, ql, qh)),
            starts[0].contiguous(), counts[0].contiguous(), k,
            f"the windows of {len(idx)} served {part} lanes (w_cap "
            f"{w_cap}, bf16 corpus)")
        if part == "1/64":
            rows["scan_topk_windows_bf16"] = r
        else:
            rows["scan_topk_windows_bf16"]["all_lanes"] = {
                key: r[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err", "tiles", "pre_pass_ms", "empty_boxes_ms")}
        del starts, counts
    serve_bursts(hsvc, Q + np.float32(1e-3))
    h_ids, h_d, dt, launches, plain = served_run(hsvc, serve_bursts, Q)
    n_pure = int((plan.mode == 1).sum())
    print(f"[bf16 corpus] hybrid {pl.node_scan_threshold}: {len(Q)} "
          f"requests in {dt:.3f}s ({len(Q) / dt:.1f} QPS end-to-end); "
          f"pure-window lanes {n_pure}; launches {launches}", flush=True)
    check(n_pure == len(Q), "bf16 corpus hybrid: a lane was not pure-window")
    check(launches.get("scan_topk_windows_bf16", 0) > 0 and not plain
          and not launches.get("scan_topk_windows", 0),
          f"bf16 corpus hybrid: launches {launches}, plain {plain}")
    rows["scan_topk_windows_bf16"]["launches"] = launches.get(
        "scan_topk_windows_bf16", 0)
    check_served(h_ids, h_d, vb, index.attrs, Q, lo, hi, "bf16 hybrid")
    wl = lane_sample(np.nonzero(is_s)[0])
    truth.update(box_truth([i for i in wl if int(i) not in truth], Q))
    ok = exact_lanes(wl, h_ids, h_d, truth)
    print(f"[bf16 corpus] pure-window lanes: {int(ok.sum())} of {len(wl)} "
          f"sampled 1/64 ones equal the float64 top-k of the bf16 corpus",
          flush=True)
    check(bool(ok.all()), "bf16 corpus: a pure-window lane is not exact")
    del hsvc, pl

    # ---- E2: the bitmask scan of the bf16 corpus
    years = tuple(range(2005, 2024, 2))
    e2 = parse_expr("a0 in [" + ", ".join(map(str, years)) + "]", cfg.m)
    mask = sref.year_mask(index.attrs, years)

    def serve_e2(svc, qs):
        res, s = [], 0
        for b in sizes:
            tickets = [svc.submit(Request(qs[i], expr=e2))
                       for i in range(s, s + b)]
            got = svc.flush()
            res.extend(got[t] for t in tickets)
            s += b
        return res

    esvc = KHIService(db, params, config=svc_cfg)
    serve_e2(esvc, Q + np.float32(1e-3))
    e_ids, e_d, dt, launches, plain = served_run(esvc, serve_e2, Q)
    print(f"[bf16 corpus] E2 ({int(mask.sum())} rows, bitmask): {len(Q)} "
          f"requests in {dt:.3f}s; launches {launches}", flush=True)
    check(launches.get("scan_topk_mask_bf16", 0) > 0 and not plain
          and not launches.get("scan_topk_mask", 0),
          f"bf16 corpus E2: launches {launches}, plain {plain}")
    rows["scan_topk_mask_bf16"]["launches"] = launches.get(
        "scan_topk_mask_bf16", 0)
    el = lane_sample(np.arange(len(Q)))
    t0 = time.perf_counter()
    t_i, t_dd = sref.topk_f64(vb, np.nonzero(mask)[0], Q[el], k)
    ok = lanes_exact(e_ids[el], e_d[el], t_i, t_dd)
    print(f"[bf16 corpus] E2 lanes: {int(ok.sum())} of {len(el)} sampled "
          f"equal the float64 top-k of the bf16 corpus under the mask "
          f"({time.perf_counter() - t0:.1f}s on the host)", flush=True)
    check(bool(ok.all()), "bf16 corpus: a bitmask lane is not exact")
    del esvc

    # ---- the int8 tier over the bf16 corpus (its replica quantized from
    # the bf16 rows, its rerank on them)
    dq = with_quant_replica(db, "int8")
    qsvc = KHIService(dq, dataclasses.replace(params, quant="int8"),
                      config=svc_cfg)
    serve_bursts(qsvc, Q + np.float32(1e-3))
    q_ids, q_d, dt, launches, plain = served_run(qsvc, serve_bursts, Q)
    for name in ("gather_l2_filter_q8", "scan_topk_q8",
                 "gather_l2_filter_bf16"):
        check(launches.get(name, 0) > 0,
              f"bf16 corpus int8: {name} was never launched")
    check(not plain, f"bf16 corpus int8: fell through to {plain}")
    check_served(q_ids, q_d, vb, index.attrs, Qc, lo, hi, "bf16 int8")
    ok = exact_lanes(samp, q_ids, q_d, truth)
    print(f"[bf16 corpus] int8: {len(Q)} requests in {dt:.3f}s "
          f"({len(Q) / dt:.1f} QPS end-to-end); launches {launches}; graph "
          f"lanes recall@{k} {recall(q_ids[gi], t_ids[gi]):.4f} (auto over "
          f"bf16 {recall(a_ids[gi], t_ids[gi]):.4f}); scan lanes equal to "
          f"the bf16 truth on {int(ok.sum())} of {len(samp)} sampled",
          flush=True)
    del qsvc, dq, vb
    return db, svc


def checkpoint_phase(db, svc, Q, serve_bursts, dev) -> None:
    """The checkpoint manager on card tensors: a tree (a dict holding a
    NamedTuple, a list and a tuple) of the first 65,536 rows of the bf16
    index's planes, bf16 vectors included, saved by AsyncCheckpointer
    while a served burst runs on the bf16 index; then load_checkpoint +
    restore_into onto a template on the card, and reshard_checkpoint;
    every leaf must be torch.equal to the original. Prints the snapshot
    (the synchronous copy to the host), the background write and the
    restore seconds."""
    import shutil
    from typing import NamedTuple

    from repro_torch.checkpoint import (AsyncCheckpointer, load_checkpoint,
                                        manager, restore_into)
    from repro_torch.distributed import reshard_checkpoint

    class Planes(NamedTuple):
        lo: object
        hi: object
        count: object

    r = 65536

    def make(fn):
        """The checkpointed tree (a dict holding a NamedTuple, a list and a
        tuple) with ``fn`` applied to each plane, and its leaves."""
        t = {"vecs": fn(db.vecs[:r]), "attrs": fn(db.attrs[:r]),
             "nbrs": fn(db.nbrs[:r]),
             "tree": Planes(fn(db.lo), fn(db.hi), fn(db.count)),
             "order": [fn(db.order[:r])],
             "live": (fn(torch.isfinite(db.attrs[:r]).all(1)),)}
        return t, [t["vecs"], t["attrs"], t["nbrs"], *t["tree"],
                   t["order"][0], t["live"][0]]

    tree, leaves = make(lambda x: x)
    nbytes = sum(v.numel() * v.element_size() for v in leaves)
    where = os.path.join(HERE, "build", "smoke_checkpoint")
    shutil.rmtree(where, ignore_errors=True)
    writes = []
    orig = manager.save_checkpoint

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        writes.append(time.perf_counter() - t0)
        return out

    manager.save_checkpoint = timed_save
    try:
        ck = AsyncCheckpointer(where, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(7, tree, {"rows": r})
        snap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve_bursts(svc, Q + np.float32(2e-3))    # keys not cached yet
        burst_s = time.perf_counter() - t0
        ck.wait()
    finally:
        manager.save_checkpoint = orig
    t0 = time.perf_counter()
    arrays, meta = load_checkpoint(where)
    template, _ = make(torch.empty_like)
    out = restore_into(template, arrays)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    again = reshard_checkpoint(arrays, lambda: make(torch.zeros_like)[0])
    torch.cuda.synchronize()
    got = [out["vecs"], out["attrs"], out["nbrs"], *out["tree"],
           out["order"][0], out["live"][0]]
    got2 = [again["vecs"], again["attrs"], again["nbrs"], *again["tree"],
            again["order"][0], again["live"][0]]
    bad = [j for j, (a, b, c) in enumerate(zip(leaves, got, got2))
           if not (torch.equal(a, b) and torch.equal(a, c)
                   and b.device == a.device and b.dtype == a.dtype)]
    on_disk = sum(os.path.getsize(os.path.join(dp, f))
                  for dp, _, fs in os.walk(where) for f in fs)
    print(f"[checkpoint] {len(leaves)} leaves ({nbytes / 1e6:.1f} MB, bf16 "
          f"vectors included) of the bf16 index: snapshot "
          f"{snap_s:.3f}s, background write {writes[0]:.3f}s "
          f"({on_disk / 1e6:.1f} MB) while a burst of {len(Q)} requests "
          f"served in {burst_s:.3f}s, load + restore onto the card "
          f"{restore_s:.3f}s; step {meta['step']}; every leaf equal after "
          f"restore_into and reshard_checkpoint: {not bad}", flush=True)
    check(nbytes >= 100e6, "checkpoint: the tree holds under 100 MB")
    check(not bad, f"checkpoint: leaves differ after the restore: {bad}")
    shutil.rmtree(where, ignore_errors=True)


def hybrid_pass(index, di, params, cfg, Q, lo, hi, is_s, serve_bursts,
                auto_ids, auto_scan, t_ids, t_d, dev, rows):
    """strategy="hybrid" on the index already built, at the cell's node
    threshold (0: the scan threshold, 10% of n), where every served lane
    takes windows only, and at a hundredth of it, where lanes mix windows
    with a walk (the served boxes' antichains hold nodes of up to ~8k
    rows). At the cell's threshold the
    windowed kernel is first held to its plain version at the windows of
    the served 1/64 boxes, then at those of every pure-window lane (the
    traced program's one windowed call). Each threshold serves the same warm-up pass
    and bursts through KHIService. Every pure-window lane must give the
    f32 truth's ids; on the 1/64 lanes the numpy antichain + windowed
    scan over the DFS order (smoke_reference.py) must agree; every mixed
    lane must reach at least the recall of the graph strategy's own walk
    on it (the merged answer holds the walk's top-k; the windows only add
    exact rows). Mixed lanes' recall beside the auto pass's is printed.
    Launch counts are those of the cell's threshold. Returns the cell
    threshold's served (ids, dists) and its plan of the requests."""
    import smoke_reference as sref
    from repro_torch.core.engine import Planner
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import KHIService, ServeConfig

    count = np.asarray(index.tree.count)
    graph = Planner(di, dataclasses.replace(params, strategy="graph"))
    for node_thr in (0, params.scan_threshold // 100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc = KHIService(di, dataclasses.replace(
            params, strategy="hybrid", node_scan_threshold=node_thr),
            config=ServeConfig(buckets=cfg.buckets,
                               cache_size=cfg.cache_size))
        torch.cuda.synchronize()
        pl = svc._planner
        thr = pl.node_scan_threshold
        tag = f"[hybrid {thr}]"
        print(f"{tag} planner with the position-ordered f32 replica "
              f"({pl._pos_vecs.numel() * 4 / 2**30:.2f} GiB) in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        plan = pl.plan(lo, hi)
        mode = plan.mode
        if node_thr == 0:
            # the windowed kernel at the served 1/64 boxes' windows (every
            # 1/64 lane that takes windows, padded as the planner pads),
            # then at the windows of every pure-window lane (all of them
            # here), the shape of the traced hybrid program's windowed call
            for part, sel in (("1/64", is_s & (mode >= 1)),
                              ("all", mode == 1)):
                idx = np.nonzero(sel)[0]
                qs, ql, qh = pl._pad_pow2(Q[idx], lo[idx], hi[idx])
                starts, counts, w_cap = pl._build_windows(
                    plan.small_nodes, idx, qs.shape[0])
                r = windows_check(
                    pl._pos_vecs, pl._pos_attrs,
                    *(torch.as_tensor(a).to(dev) for a in (qs, ql, qh)),
                    starts[0].contiguous(), counts[0].contiguous(), cfg.k,
                    f"the windows of {len(idx)} served {part} lanes (w_cap "
                    f"{w_cap})")
                if part == "1/64":
                    rows["scan_topk_windows"] = r
                else:
                    rows["scan_topk_windows"]["all_lanes"] = {
                        key: r[key] for key in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "max_abs_err", "tiles",
                            "pre_pass_ms", "empty_boxes_ms")}
                del starts, counts

        # serve, recording each window batch's (lanes, W, w_cap)
        shapes = []
        build = pl._build_windows

        def recording(small_nodes, lanes, bp, build=build, shapes=shapes):
            out = build(small_nodes, lanes, bp)
            shapes.append((bp, out[0].shape[2], out[2]))
            return out

        pl._build_windows = recording
        t0 = time.perf_counter()
        serve_bursts(svc, Q + np.float32(1e-3))    # warm-up, other keys
        warm_s = time.perf_counter() - t0
        shapes.clear()
        ops.reset_launches()
        ref.reset_calls()
        before = svc.snapshot()
        t0 = time.perf_counter()
        results = serve_bursts(svc, Q)
        dt = time.perf_counter() - t0
        after = svc.snapshot()
        launches = dict(ops.LAUNCHES)
        plain_cuda = {k: v["cuda"] for k, v in ref.CALLS.items()}
        dq = after["device_queries"] - before["device_queries"]
        ds = after["device_seconds"] - before["device_seconds"]
        n_mode = np.bincount(mode, minlength=3)
        print(f"{tag} {len(results)} requests in {dt:.3f}s "
              f"({len(results) / dt:.1f} QPS end-to-end; device "
              f"{dq / ds:.1f} lane/s over {ds:.3f}s); warm-up {warm_s:.1f}s;"
              f" lanes by mode: graph {n_mode[0]} (incl. "
              f"{int((plan.card == 0).sum())} empty), pure-window "
              f"{n_mode[1]}, mixed {n_mode[2]}", flush=True)
        print(f"{tag} window batches (lanes, W, w_cap): {shapes}; launches "
              f"on the path { {k: v for k, v in launches.items() if v} }; "
              f"plain-version CUDA calls {plain_cuda}", flush=True)
        check(launches["scan_topk_windows"] > 0,
              f"{tag} the windowed kernel was never launched")
        if node_thr == 0:
            rows["scan_topk_windows"]["launches"] = \
                launches["scan_topk_windows"]
        check(all(v == 0 for v in plain_cuda.values()),
              f"{tag} the path fell through to a plain version: "
              f"{plain_cuda}")
        want = "pure-window" if node_thr == 0 else "mixed"
        check(n_mode[1 if node_thr == 0 else 2] > 0,
              f"{tag} the bursts gave no {want} lane")
        ids = np.stack([r.ids for r in results])
        dists = np.stack([r.dists for r in results])
        check_served(ids, dists, index.vecs, index.attrs, Q, lo, hi, tag)
        if node_thr == 0:
            cell = (ids, dists, plan)

        # pure-window lanes: the f32 truth; the numpy reference on the
        # 1/64 ones (the 1/4 lanes' windows cover ~16x more rows)
        pure = np.nonzero(mode == 1)[0]
        exact = lanes_exact(ids[pure], dists[pure], t_ids[pure], t_d[pure])
        t0 = time.perf_counter()
        sample = lane_sample(pure[is_s[pure]])
        np_same = np_small = 0
        for i in sample:
            nodes = sref.antichain(index.tree, lo[i], hi[i])
            np_small += bool((count[nodes] <= thr).all())
            w_ids, w_d = sref.window_scan(index.vecs, index.attrs,
                                          index.tree, nodes, Q[i], lo[i],
                                          hi[i], cfg.k)
            np_same += bool(lanes_exact(ids[i][None], dists[i][None],
                                        w_ids[None], w_d[None])[0])
        print(f"{tag} pure-window lanes: {int(exact.sum())} of {len(pure)} "
              f"give the f32 truth's ids; of {len(sample)} sampled 1/64 "
              f"ones (of {int(is_s[pure].sum())}), the numpy antichain is all-small on {np_small} and the "
              f"numpy windowed scan equal on {np_same} "
              f"({time.perf_counter() - t0:.1f}s on the host)", flush=True)
        check(bool(exact.all()), f"{tag} a pure-window lane is not exact")
        check(np_small == len(sample) and np_same == len(sample),
              f"{tag} pure-window lanes disagree with the numpy reference")

        # mixed lanes: the merged answer holds the walk's top-k, so on
        # every one its recall is at least that of the graph strategy's
        # own walk; beside it, the auto pass's recall on the same lanes
        mixed = np.nonzero(mode == 2)[0]
        if len(mixed):
            g_ids = graph.search(Q[mixed], lo[mixed], hi[mixed])[0]

            def per_lane(found, lanes):
                return np.array([recall(found[j][None], t_ids[i][None])
                                 for j, i in enumerate(lanes)])

            rec_h, rec_g = per_lane(ids[mixed], mixed), per_lane(g_ids, mixed)
            print(f"{tag} mixed lanes ({len(mixed)}): recall@{cfg.k} "
                  f"{rec_h.mean():.4f} against {rec_g.mean():.4f} for the "
                  f"graph strategy's walk; higher on "
                  f"{int((rec_h > rec_g).sum())}, lower on "
                  f"{int((rec_h < rec_g).sum())}", flush=True)
            check(bool((rec_h >= rec_g).all()),
                  f"{tag} a mixed lane's recall fell below the graph "
                  f"strategy's walk on it")
            for walked in (True, False):
                sel = auto_scan[mixed] != walked
                if not sel.any():
                    continue
                rec_a = per_lane(auto_ids[mixed[sel]], mixed[sel])
                print(f"{tag} mixed lanes the auto pass "
                      f"{'walked' if walked else 'scanned'} ({int(sel.sum())})"
                      f": recall@{cfg.k} {rec_h[sel].mean():.4f} against "
                      f"{rec_a.mean():.4f} in the auto pass; higher on "
                      f"{int((rec_h[sel] > rec_a).sum())}, lower on "
                      f"{int((rec_h[sel] < rec_a).sum())}", flush=True)
        pl._build_windows = build
        trace_programs(f"hybrid {thr}", di, svc.params, Q, lo, hi,
                       [("hybrid", np.arange(len(Q)))], planner=pl)
        del svc, pl
    return cell


def masked_truth(vecs, mask, Q, k: int, dev):
    """Exact top-k ids (-1 padded) and dists of the rows where ``mask``
    holds, by plain differences on the card (no port code)."""
    rows = torch.as_tensor(np.nonzero(mask)[0]).to(dev)
    sub = vecs.index_select(0, rows)
    kk = min(k, int(rows.numel()))
    ids = np.full((len(Q), k), -1, np.int64)
    dd = np.full((len(Q), k), np.inf, np.float32)
    for s in range(0, len(Q), 8):
        q = torch.as_tensor(Q[s:s + 8]).to(dev)
        dist = torch.cat([((sub[r:r + 32768][None] - q[:, None]) ** 2).sum(-1)
                          for r in range(0, sub.shape[0], 32768)], 1)
        v, i = torch.topk(dist, kk, largest=False)
        ids[s:s + 8, :kk] = rows[i].cpu().numpy()
        dd[s:s + 8, :kk] = v.cpu().numpy()
    return ids, dd


def predicate_pass(index, di, params, cfg, Q, sizes, dev, rows) -> None:
    """Two filter expressions over the cell's attrs through KHIService
    with Request(expr=...), under "auto" and under "hybrid": E1 lowers to
    3 disjoint boxes, E2 (10 non-adjacent years) exceeds box_budget and
    runs the bitmask scan. Even lanes send E1, odd lanes E2, in the
    bursts of the other passes. The truth is a masked brute force whose
    mask comes from smoke_reference.year_mask. E2 lanes must equal it on
    every lane; E1's disjuncts that dispatch to an exact path (scan, or
    pure windows) must equal the box's truth, and the merged E1 answer
    too when all of them do."""
    import smoke_reference as sref
    from repro_torch.core.predicate import compile_expr, parse_expr
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import KHIService, Request, ServeConfig

    attrs, m, k = index.attrs, cfg.m, cfg.k
    a1_max = float(np.float32(np.median(attrs[:, 1])))
    years = {"E1": (2019, 2021, 2023), "E2": tuple(range(2005, 2024, 2))}
    texts = {"E1": f"a0 in [2019, 2021, 2023] and a1 <= {a1_max!r}",
             "E2": "a0 in [" + ", ".join(map(str, years["E2"])) + "]"}
    exprs = {e: parse_expr(t, m) for e, t in texts.items()}
    progs = {e: compile_expr(x, m, box_budget=params.box_budget)
             for e, x in exprs.items()}
    check(progs["E1"].mode == "boxes" and progs["E1"].n_boxes == 3
          and progs["E2"].mode == "bitmask",
          f"predicate: E1 -> {progs['E1'].mode} ({progs['E1'].n_boxes} "
          f"boxes), E2 -> {progs['E2'].mode}")
    masks = {"E1": sref.year_mask(attrs, years["E1"], a1_max),
             "E2": sref.year_mask(attrs, years["E2"])}
    p1 = progs["E1"]
    box_masks = [((attrs >= p1.lo[b]) & (attrs <= p1.hi[b])).all(1)
                 for b in range(p1.n_boxes)]
    check(np.array_equal(np.logical_or.reduce(box_masks), masks["E1"])
          and sum(int(bm.sum()) for bm in box_masks) == int(masks["E1"]
                                                            .sum()),
          "predicate: E1's boxes are not a disjoint cover of its rows")
    lanes = {"E1": np.arange(0, len(Q), 2), "E2": np.arange(1, len(Q), 2)}
    t0 = time.perf_counter()
    truth = {e: masked_truth(di.vecs, masks[e], Q[lanes[e]], k, dev)
             for e in masks}
    box_truth = [masked_truth(di.vecs, bm, Q[lanes["E1"]], k, dev)
                 for bm in box_masks]
    print(f"[predicate] E1 = {texts['E1']!r}: 3 boxes, {int(masks['E1'].sum())}"
          f" rows; E2 = {texts['E2']!r}: bitmask, {int(masks['E2'].sum())} "
          f"rows; truth in {time.perf_counter() - t0:.1f}s", flush=True)

    def serve(svc, qs):
        out, s = [], 0
        for b in sizes:
            tickets = [svc.submit(Request(qs[i], expr=exprs[
                "E1" if i % 2 == 0 else "E2"])) for i in range(s, s + b)]
            res = svc.flush()
            out.extend(res[t] for t in tickets)
            s += b
        return out

    launches = {}
    for strategy in ("auto", "hybrid"):
        svc = KHIService(di, dataclasses.replace(params, strategy=strategy),
                         config=ServeConfig(buckets=cfg.buckets,
                                            cache_size=cfg.cache_size))
        t0 = time.perf_counter()
        serve(svc, Q + np.float32(1e-3))           # warm-up, other keys
        warm_s = time.perf_counter() - t0
        ops.reset_launches()
        ref.reset_calls()
        before = svc.snapshot()
        t0 = time.perf_counter()
        results = serve(svc, Q)
        dt = time.perf_counter() - t0
        after = svc.snapshot()
        got = dict(ops.LAUNCHES)
        for name, v in got.items():
            launches[name] = launches.get(name, 0) + v
        plain_cuda = {n: v["cuda"] for n, v in ref.CALLS.items()}
        plane = {kk: after["predicate_lanes"].get(kk, 0)
                 - before["predicate_lanes"].get(kk, 0)
                 for kk in after["predicate_lanes"]}
        print(f"[predicate] {strategy}: {len(results)} requests in "
              f"{dt:.3f}s ({len(results) / dt:.1f} QPS end-to-end); warm-up "
              f"{warm_s:.1f}s; predicate_lanes {plane}; launches "
              f"{ {n: v for n, v in got.items() if v} }", flush=True)
        check(all(v == 0 for v in plain_cuda.values()),
              f"predicate {strategy}: the path fell through to a plain "
              f"version: {plain_cuda}")
        check(got["scan_topk_mask"] > 0,
              f"predicate {strategy}: the bitmask kernel was never launched")
        ids = np.stack([r.ids for r in results])
        dists = np.stack([r.dists for r in results])
        for e in ("E1", "E2"):
            li = lanes[e]
            t_i, t_dd = truth[e]
            ok = lanes_exact(ids[li], dists[li], t_i, t_dd)
            for j, i in enumerate(li):
                got_i = ids[i][ids[i] >= 0]
                check(bool(masks[e][got_i].all()),
                      f"predicate {strategy} {e} lane {i}: an id outside "
                      f"the filter was served")
            print(f"[predicate] {strategy} {e}: recall@{k} "
                  f"{recall(ids[li], t_i):.4f}; {int(ok.sum())} of {len(li)}"
                  f" lanes equal the masked brute force", flush=True)
            if e == "E2":
                check(bool(ok.all()), f"predicate {strategy}: a bitmask "
                      f"lane differs from the masked brute force")
        # E1's disjuncts: each box dispatches alike for every lane
        pl = svc._planner
        exact_boxes = 0
        for b in range(p1.n_boxes):
            blo = np.repeat(p1.lo[b][None], len(lanes["E1"]), 0)
            bhi = np.repeat(p1.hi[b][None], len(lanes["E1"]), 0)
            bplan = pl.plan(blo[:1], bhi[:1])
            exact_b = bool(bplan.use_scan[0])   # scan, or pure windows
            exact_boxes += exact_b
            b_ids, b_d, _, _ = pl.search(Q[lanes["E1"]], blo, bhi)
            ok = lanes_exact(b_ids, b_d, *box_truth[b])
            print(f"[predicate] {strategy} E1 box {b}: card "
                  f"{int(bplan.card[0])}, "
                  f"{'exact path' if exact_b else 'graph path'}, "
                  f"{int(ok.sum())} of {len(ok)} lanes equal its truth",
                  flush=True)
            if exact_b:
                check(bool(ok.all()), f"predicate {strategy}: E1 box {b} "
                      f"dispatched to an exact path is not exact")
        if exact_boxes == p1.n_boxes:
            ok = lanes_exact(ids[lanes["E1"]], dists[lanes["E1"]],
                             *truth["E1"])
            check(bool(ok.all()), f"predicate {strategy}: E1 lanes are not "
                  f"exact though every box took an exact path")
        del svc, pl
    rows["scan_topk_mask"]["launches"] = launches["scan_topk_mask"]


# (tag, backend, router) of the graph pass, and the kernels each must launch
GRAPH_CONFIGS = (("a", "pallas_gather_l2_filter", "level"),
                 ("b", "pallas_gather_l2", "level"),
                 ("c", "pallas_l2", "level"),
                 ("d", "pallas_gather_l2", "dfs"))
GRAPH_KERNELS = {"a": ("gather_l2_filter",), "b": ("gather_l2",),
                 "c": ("l2dist_qc",), "d": ("gather_l2",)}
# the public wrapper each unfused configuration's served answers are
# rescored through afterwards, and the kernel it must launch
WRAPPER_KERNELS = {"b": "gather_l2_rows", "c": "l2dist_qc",
                   "d": "gather_l2_rows"}
# (d) serves a seeded sample of this many of the 384 requests, one DFS
# batch (cut from all 384, two batches, then from 256, for the time
# limit), and the
# uncapped DFS walks DFS_UNCAPPED of them (cut from 128)
DFS_LANES = 128
DFS_UNCAPPED = 64


def graph_pass(index, di, params, cfg, Q, lo, hi, is_s, serve_bursts, t_ids,
               dev, rows) -> None:
    """strategy="graph" on the index already built, with every scoring
    backend the graph strategy takes and both routers: (a) the fused
    filter gather, level router (the baseline); (b) the unfused gather,
    level; (c) pallas_l2 (a PyTorch gather of the candidate rows, then
    l2dist_qc), level; (d) the unfused gather with the stack DFS. Each
    serves the same warm-up pass and the 384 requests in the same bursts
    through KHIService ((d) DFS_LANES of them at once, in one batch, to
    fit the script's time limit), and its launches are counted over the served
    run alone. Then, under counts of their own, the served answers of (b),
    (c) and (d) are rescored through the public wrappers (the
    row-per-step ops.gather_l2, the rank-dispatching ops.l2dist), which
    must give the served distances bit for bit. Then the graph program
    runs the same lanes once more for hops (for (d), recording its DFS
    entries and pops). (d) warms up on one batch: a DFS batch costs its
    longest walk's pops. Checks: (b) equals (a) bit for bit (ids, dists,
    hops) and launches no gather_l2_filter; (c) equals (a)'s ids on >= 95%
    of lanes, its recall@10 lies within 0.01 of (a)'s and its distances
    within rtol 1e-4, atol 1e-3 of float64; (d), at the default
    max_steps, gives entries equal to smoke_reference.dfs_entries capped
    at the same pops on every lane (the lanes cut are counted), and it
    equals (b) wherever its entries equal the level router's. The DFS
    router alone then walks DFS_UNCAPPED sampled boxes with max_steps at the
    tree's node count: entries equal to the uncapped numpy DFS on every
    one, and no lane reaches that cap."""
    import smoke_reference as sref
    from repro_torch.core import engine as eng
    from repro_torch.core import router as rt
    from repro_torch.core.engine import Planner
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import KHIService, ServeConfig

    sel = {"1/4": np.nonzero(~is_s)[0], "1/64": np.nonzero(is_s)[0]}
    dl = lane_sample(np.arange(len(Q)), DFS_LANES, seed=7)
    out, svc_params, dfs_run = {}, {}, {}
    for tag, backend, router in GRAPH_CONFIGS:
        name = f"[graph {tag}]"
        ln = dl if router == "dfs" else np.arange(len(Q))
        Qx, lox, hix = Q[ln], lo[ln], hi[ln]
        qt = torch.as_tensor(Qx).to(dev)
        p = dataclasses.replace(params, strategy="graph", backend=backend,
                                router=router)
        svc = KHIService(di, p, config=ServeConfig(
            buckets=cfg.buckets, cache_size=cfg.cache_size))
        svc_params[tag] = svc.params
        t0 = time.perf_counter()
        if router == "dfs":
            # one batch: a batch of DFS lanes costs its longest walk's pops
            svc.search(Q[:8] + np.float32(1e-3), lo[:8], hi[:8])
        else:
            serve_bursts(svc, Q + np.float32(1e-3))    # other keys
        warm_s = time.perf_counter() - t0
        ops.reset_launches()
        ref.reset_calls()
        t0 = time.perf_counter()
        if router == "dfs":
            # the sampled requests at once (one batch of 256): a DFS
            # batch costs its longest walk's pops, ~4096 in every burst
            ids, dists = svc.search(Qx, lox, hix)
        else:
            results = serve_bursts(svc, Q)
            ids = np.stack([r.ids for r in results])
            dists = np.stack([r.dists for r in results])
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        plain_cuda = {k: v["cuda"] for k, v in ref.CALLS.items()}
        if tag in WRAPPER_KERNELS:
            # the public wrappers, a user's own call on the served ids
            safe = torch.as_tensor(np.maximum(ids, 0)).to(dev).long()
            cand = di.vecs[safe] if backend == "pallas_l2" else None
            ops.reset_launches()
            ref.reset_calls()
            if backend == "pallas_l2":
                again = ops.l2dist(qt, cand)
            else:
                again = ops.gather_l2(safe, di.vecs, qt)
            torch.cuda.synchronize()
            w_launches = {k: c for k, c in ops.LAUNCHES.items() if c}
            w_plain = sum(v["cuda"] for v in ref.CALLS.values())
            wk = WRAPPER_KERNELS[tag]
            v = ids >= 0
            same_w = np.array_equal(again.cpu().numpy()[v], dists[v])
            print(f"{name} public wrapper ops."
                  f"{'l2dist' if backend == 'pallas_l2' else 'gather_l2'}"
                  f" on the served ids: launches {w_launches}, plain-version "
                  f"CUDA calls {w_plain}, served distances bit for bit "
                  f"{same_w}", flush=True)
            check(same_w, f"{name} the public wrapper does not give the "
                  f"served distances bit for bit")
            check(w_launches.get(wk, 0) > 0 and w_plain == 0,
                  f"{name} the public wrapper did not launch {wk}")
            if tag == "b":
                rows[wk]["launches"] = w_launches.get(wk, 0)
        if router == "dfs":
            # the graph program's own DFS call, recorded with its pops
            orig_dfs = rt.route_dfs

            def recording(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ent, card, pops = orig_dfs(*a, with_steps=True)
                torch.cuda.synchronize()
                dfs_run.update(ent=ent.cpu().numpy(), pops=pops.cpu().numpy(),
                               s=time.perf_counter() - t0)
                return ent, card

            rt.route_dfs = recording
            try:
                g_ids, g_d, g_hops, _ = svc._planner.search(Qx, lox, hix)
            finally:
                rt.route_dfs = orig_dfs
        else:
            g_ids, g_d, g_hops, _ = svc._planner.search(Qx, lox, hix)
        check(np.array_equal(g_ids, ids) and np.array_equal(g_d, dists),
              f"{name} served lanes differ from the graph program's")
        out[tag] = (ids, dists, g_hops)
        rec = {k: recall(ids[np.isin(ln, i)], t_ids[ln][np.isin(ln, i)])
               for k, i in sel.items()}
        print(f"{name} backend={backend} router={router}: {len(ids)} "
              f"requests in {dt:.3f}s ({len(ids) / dt:.1f} QPS "
              f"end-to-end); warm-up {warm_s:.1f}s; recall@{cfg.k} "
              + ", ".join(f"{k} lanes {r:.4f}" for k, r in rec.items())
              + f"; mean hops {g_hops.mean():.1f}; launches "
              f"{ {k: c for k, c in launches.items() if c} }; "
              f"plain-version CUDA calls {plain_cuda}", flush=True)
        check(all(c == 0 for c in plain_cuda.values()),
              f"{name} the path fell through to a plain version: "
              f"{plain_cuda}")
        for k in GRAPH_KERNELS[tag]:
            check(launches[k] > 0, f"{name} {k} was never launched")
        if tag != "a":
            check(launches["gather_l2_filter"] == 0,
                  f"{name} launched the fused filter gather")
        check_served(ids, dists, index.vecs, index.attrs, Qx, lox, hix,
                     name, atol=1e-3 if backend == "pallas_l2" else 1e-8)
        if tag == "b":
            rows["gather_l2"]["launches"] = launches["gather_l2"]
        if tag == "c":
            rows["l2dist_qc"]["launches"] = launches["l2dist_qc"]
        del svc

    a, b, c, d = (out[t] for t in "abcd")
    same = [np.array_equal(x, y) for x, y in zip(b, a)]
    print(f"[graph] (b) against (a): ids, dists, hops bit-equal {same}",
          flush=True)
    check(all(same), "(b) the unfused gather's walk differs from (a)'s")
    c_same = (c[0] == a[0]).all(1)
    rec_a, rec_c = recall(a[0], t_ids), recall(c[0], t_ids)
    print(f"[graph] (c) against (a): ids equal on {int(c_same.sum())} of "
          f"{len(Q)} lanes, hops on {int((c[2] == a[2]).sum())}; recall@"
          f"{cfg.k} {rec_c:.4f} against {rec_a:.4f}", flush=True)
    check(c_same.sum() >= 0.95 * len(Q),
          "(c) pallas_l2's ids differ from (a)'s on more than 5% of lanes")
    check(abs(rec_c - rec_a) <= 0.01,
          "(c) pallas_l2's recall is more than 0.01 from (a)'s")

    # (d): the stack DFS against the numpy DFS capped at the same pops,
    # and where its entries equal the level router's, the walk against (b)'s
    pd, pb = svc_params["d"], svc_params["b"]
    ent, pops, dfs_s = dfs_run["ent"], dfs_run["pops"], dfs_run["s"]
    lvl = rt.route_level_sync(di, torch.as_tensor(lo).to(dev),
                              torch.as_tensor(hi).to(dev), pb)[0]
    lvl = lvl.cpu().numpy()

    def numpy_dfs(max_steps, lanes=range(len(Q))):
        return [sref.dfs_entries(index.tree, index.attrs, lo[i], hi[i],
                                 pd.c_e, pd.scan_budget, max_steps)
                for i in lanes]

    def n_same(ent, ref_ent):
        return sum(ent[i][ent[i] >= 0].tolist() == e
                   for i, e in enumerate(ref_ent))

    t0 = time.perf_counter()
    same_ref = n_same(ent, numpy_dfs(pd.max_steps, dl))
    host_s = time.perf_counter() - t0
    # lanes that max_steps stopped short of c_e entries
    cut = (pops >= pd.max_steps) & ((ent >= 0).sum(1) < pd.c_e)
    eq_lvl = (ent == lvl[dl]).all(1)
    walk = (d[0] == b[0][dl]).all(1) & (d[2] == b[2][dl])
    print(f"[graph] (d) DFS router over {len(dl)} sampled lanes (in the "
          f"graph program's run above) in {dfs_s:.3f}s: entries equal to the "
          f"numpy DFS capped at max_steps {pd.max_steps} on {same_ref} of "
          f"{len(dl)} lanes ({host_s:.1f}s on the host); {int(cut.sum())} "
          f"lanes stopped by max_steps short of {pd.c_e} entries; pops per lane max {int(pops.max())}, "
          f"mean {pops.mean():.1f} ({dfs_s / max(1, int(pops.max())) * 1e3:.2f}"
          f" ms a lockstep pop); entries equal to the level router's on "
          f"{int(eq_lvl.sum())}, and ids and hops equal to (b)'s on "
          f"{int(walk[eq_lvl].sum())} of those", flush=True)
    check(same_ref == len(dl), "(d) the DFS entries differ from numpy's")
    check(bool(walk[eq_lvl].all()),
          "(d) the walk differs from (b)'s on lanes with equal entries")
    # the router alone, uncapped (a DFS pops each node at most once), on
    # a seeded sample of lanes: its cost is the longest walk's pops
    lu = lane_sample(np.arange(len(Q)), DFS_UNCAPPED, seed=5)
    p_all = dataclasses.replace(pd, max_steps=int(di.left.numel()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ent_u, _, pops_u = rt.route_dfs(di, torch.as_tensor(lo[lu]).to(dev),
                                    torch.as_tensor(hi[lu]).to(dev), p_all,
                                    with_steps=True)
    torch.cuda.synchronize()
    u_s = time.perf_counter() - t0
    ent_u, pops_u = ent_u.cpu().numpy(), pops_u.cpu().numpy()
    same_u = n_same(ent_u, numpy_dfs(None, lu))
    print(f"[graph] (d) DFS router alone with max_steps {p_all.max_steps} "
          f"(the node count) on {len(lu)} sampled lanes in {u_s:.3f}s: "
          f"entries equal to the uncapped numpy DFS on {same_u} of "
          f"{len(lu)}, to the level router's on "
          f"{int((ent_u == lvl[lu]).all(1).sum())}; pops per lane max "
          f"{int(pops_u.max())}, mean {pops_u.mean():.1f} "
          f"({u_s / max(1, int(pops_u.max())) * 1e3:.2f} ms a lockstep pop)",
          flush=True)
    check(same_u == len(lu), "(d) the uncapped DFS entries differ from "
          "numpy's")
    check(int(pops_u.max()) < p_all.max_steps,
          "(d) a lane reached the node count in pops")

    pc = svc_params["c"]
    trace_programs("graph pallas_l2", di, pc, Q, lo, hi,
                   [("graph", np.arange(len(Q)))])
    # the (c) program's scoring split by CUDA events around the engine's
    # own scorer and around the ops.l2dist_qc call it makes, over one burst
    scorer, kern = [], []

    def evented(fn, marks):
        def call(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res = fn(*a, **kw)
            ev[1].record()
            marks.append(ev)
            return res
        return call

    orig, orig_qc = eng._dist_ids_pallas_l2, ops.l2dist_qc
    eng._dist_ids_pallas_l2 = evented(orig, scorer)
    ops.l2dist_qc = evented(orig_qc, kern)
    try:
        pl = Planner(di, pc)
        lanes = np.arange(min(256, len(Q)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_ids2 = pl.search(Q[lanes], lo[lanes], hi[lanes])[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng._dist_ids_pallas_l2, ops.l2dist_qc = orig, orig_qc
    check(np.array_equal(t_ids2, c[0][lanes]),
          "(c) the event-timed run answered differently")
    s_ms = sum(e[0].elapsed_time(e[1]) for e in scorer)
    k_ms = sum(e[0].elapsed_time(e[1]) for e in kern)
    print(f"[trace] graph pallas_l2 scoring over {len(lanes)} lanes "
          f"(CUDA events): {len(scorer)} scorer calls in {s_ms:.2f} ms, of "
          f"which {len(kern)} ops.l2dist_qc calls {k_ms:.2f} ms and the "
          f"rest (the materialized gather) {s_ms - k_ms:.2f} ms, in a "
          f"{wall * 1e3:.1f} ms wall", flush=True)
    check(len(kern) == len(scorer) > 0,
          "(c) the scorer did not call ops.l2dist_qc once a call")


# -------------------------------------------------------------- the SLO

# ------------------------------------------------------ the builders' pass

# rows 0, 80, 160, ... of the main corpus (12,500; cut from 1M, then from
# 100,000, 50,000 and 25,000, for the time limit: Algorithm 5 is n / 64
# sequential rounds of ~54 launches a hop)
BUILD_EVERY = 80
# card-vs-CPU cases on a 1/32-grid corpus at d = 768, m = 4, M = 32:
# (n, merge_chunk, symmetric_reverse), cut from 4,096 rows for the time
# limit (inc64 from 512 too): the plain versions take ~300 s on the CPU
# at 4,096 and merge_chunk 64, and merge_chunk 1 runs about n sequential
# rounds (163 s on the card at 4,096)
BUILD_GRID_CASES = {"inc64": (256, 64, False), "inc1": (128, 1, True)}
BUILD_GRID_D = 768
# the reference's fixed float seeds of its bulk-builder parity test
# (tests/test_build_device.py:27-31): (n, d, m, M, ef_b, seed)
BULK_SEEDS = ((600, 16, 2, 8, None, 1), (900, 24, 3, 8, None, 0),
              (700, 24, 3, 8, 24, 0))
REPLAY_NODES = 16   # cut from 64, then 32, for the time limit
# per selectivity, through every baseline (cut from 32 for the time limit)
BASELINE_REQUESTS = 16
# Postfiltering's one graph takes n / 64 sequential rounds: it is built
# over every 4th of the pass's rows (3,125), cut for the time limit
POST_EVERY = 4


def grid_case(n: int, seed: int = 5):
    """A 1/32-grid corpus (every squared distance exact in f32, in any
    order) at the cell's d = 768, m = 4, and its tree."""
    from repro_torch.core.tree import build_tree

    rng = np.random.default_rng(seed)
    vecs = (rng.integers(-64, 64, size=(n, BUILD_GRID_D)) / 32).astype(
        np.float32)
    attrs = rng.random((n, 4)).astype(np.float32)
    return vecs, build_tree(attrs)


def float_case(n, d, m, seed):
    from repro_torch.core.tree import build_tree

    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    return vecs, build_tree(rng.random((n, m)).astype(np.float32))


def builder_cases(device):
    """{name: (nbrs as numpy, seconds)} of every card-vs-CPU case built on
    ``device``: Algorithm 5 on the grid cases, the bulk builder on the
    first case's grid and the float seeds."""
    from repro_torch.core import hnsw

    out = {}
    for key, (n, mc, sym) in BUILD_GRID_CASES.items():
        vecs, tree = grid_case(n)
        t0 = time.perf_counter()
        nb = hnsw.build_graphs(tree, vecs, M=32, merge_chunk=mc,
                               symmetric_reverse=sym, device=device)
        out[key] = (nb.cpu().numpy(), time.perf_counter() - t0)
    vecs, tree = grid_case(BUILD_GRID_CASES["inc64"][0])
    cases = [("bulk_grid", vecs, tree, 32, None)] + [
        (f"bulk_seed{i}", *float_case(n, d, m, sd), M, ef)
        for i, (n, d, m, M, ef, sd) in enumerate(BULK_SEEDS)]
    for key, vecs, tree, M, ef in cases:
        t0 = time.perf_counter()
        nb = hnsw.build_graphs_bulk(tree, vecs, M=M, ef_b=ef, device=device)
        out[key] = (nb.cpu().numpy(), time.perf_counter() - t0)
    return out


def projected_seconds(stats, big_tree, mc: int = 64) -> float:
    """The seconds Algorithm 5 would take on ``big_tree``: each of its
    levels' rounds (the largest insert count of a node over ``mc``) at the
    measured seconds a round of the built tree's level with as many nodes
    (so as many lanes a round) or, past its depth, its deepest level's."""
    by_lvl = {s["level"]: s["seconds"] / max(1, s["rounds"]) for s in stats}
    deepest = max(by_lvl)
    count = np.asarray(big_tree.count, np.int64)
    left = np.asarray(big_tree.left, np.int64)
    right = np.asarray(big_tree.right, np.int64)
    level = np.asarray(big_tree.level, np.int64)
    ins = np.where(left < 0, count - 1, count[np.maximum(right, 0)])
    total = 0.0
    for lvl in range(int(level.max()) + 1):
        sel = level == lvl
        rounds = -(-int(ins[sel].max()) // mc) if sel.any() else 0
        total += rounds * by_lvl.get(lvl, by_lvl[deepest])
    return total


def graph_invariants(nbrs: np.ndarray, tree, M: int) -> dict:
    """The graph invariants of tests/test_hnsw.py over every level: degree
    <= M, rows empty off each object's path, neighbours inside the node,
    no self-loops, no duplicates. Returns the count of violations of
    each."""
    path = np.asarray(tree.path)
    n = nbrs.shape[1]
    bad = {"degree": 0, "off path": 0, "outside node": 0, "self loop": 0,
           "duplicate": 0}
    for lvl in range(nbrs.shape[0]):
        rows = nbrs[lvl]
        ok = rows >= 0
        bad["degree"] += int((ok.sum(1) > M).sum())
        bad["off path"] += int(ok[path[:, lvl] < 0].any(1).sum())
        src = np.broadcast_to(path[:, lvl][:, None], rows.shape)[ok]
        bad["outside node"] += int((path[rows[ok], lvl] != src).sum())
        bad["self loop"] += int((rows == np.arange(n)[:, None]).sum())
        srt = np.sort(rows, axis=1)
        bad["duplicate"] += int(((srt[:, 1:] == srt[:, :-1])
                                 & (srt[:, 1:] >= 0)).sum())
    return bad


def replay_nodes(inc, vecs_t, M: int, dev, seed: int = 0):
    """REPLAY_NODES internal nodes of 64-2,048 members, taken round-robin
    over the levels that have such nodes, each merge replayed by
    smoke_reference.merge_node from the card's rows one level down, on the
    card's own pair distances (the blocked gather_l2 over the node's
    members: the distances every decision of the build read). Returns
    (per node (level, members, rows equal, near-tie decisions), the
    largest error of those distances against float64 relative to the
    pair's squared norms, host seconds)."""
    import smoke_reference as sref
    from repro_torch.kernels import ops

    t = inc.tree
    count = np.asarray(t.count, np.int64)
    left = np.asarray(t.left, np.int64)
    level = np.asarray(t.level, np.int64)
    order = np.asarray(t.order, np.int64)
    pool = np.nonzero((left >= 0) & (count >= 64) & (count <= 2048))[0]
    rng = np.random.default_rng(seed)
    queues = [list(rng.permutation(pool[level[pool] == lv]))
              for lv in np.unique(level[pool])]
    picks = []
    while len(picks) < REPLAY_NODES and any(queues):
        for qu in queues:
            if qu and len(picks) < REPLAY_NODES:
                picks.append(int(qu.pop()))
    nb = inc.nbrs_numpy()
    loc = np.full(inc.n, -1, np.int64)
    out, worst = [], 0.0
    t0 = time.perf_counter()
    for p in picks:
        lvl = int(level[p])
        s, c = int(t.start[p]), int(count[p])
        mem = order[s:s + c]
        loc[mem] = np.arange(c)
        low = nb[lvl + 1][mem]
        low = np.where(low >= 0, loc[np.maximum(low, 0)], -1)
        want = nb[lvl][mem]
        mt = torch.as_tensor(mem, device=dev)
        d32 = ops.gather_l2(mt[None].expand(c, c).contiguous(), vecs_t,
                            vecs_t[mt], c_blk=128).cpu().numpy()
        v64 = inc.vecs[mem].astype(np.float64)
        n2 = (v64 * v64).sum(1)
        d64 = n2[:, None] + n2[None, :] - 2.0 * (v64 @ v64.T)
        worst = max(worst, float((np.abs(d32 - d64)
                                  / (n2[:, None] + n2[None, :])).max()))
        rows_l, ties = sref.merge_node(
            low, int(count[left[p]]), d32, M=M, ef_b=M, merge_chunk=64,
            symmetric_reverse=False, rel_tol=NEAR_TIE)
        got = np.where(rows_l >= 0, mem[np.maximum(rows_l, 0)], -1)
        out.append((lvl, c, int((got == want).all(1).sum()), ties))
        loc[mem] = -1
    return out, worst, time.perf_counter() - t0


def graph_recall(di, p, Q, lo, hi, gi, t_ids, efs) -> dict:
    """recall@k of the graph lanes ``gi`` walked with strategy="graph" at
    each ef."""
    from repro_torch.core.engine import Planner

    out = {}
    for ef in efs:
        pl = Planner(di, dataclasses.replace(p, strategy="graph", ef=ef))
        out[ef] = recall(pl.search(Q[gi], lo[gi], hi[gi])[0], t_ids[gi])
    return out


def builders_pass(index, params, cfg, Q, lo, hi, is_s, serve_bursts, dev,
                  rows) -> None:
    """Algorithm 5 (``builder="incremental"``, core/hnsw.py) and the bulk
    builder on the card, and the baselines: (1) the card's builds equal
    the CPU's (the plain versions) bit for bit on the grid cases and the
    bulk seeds; (2) ``KHIIndex.build`` with ``KHIConfig(M=32)`` over rows 0,
    BUILD_EVERY, 2 BUILD_EVERY, ... of the main corpus, timed per level with its gather_l2
    launches, projected to the main corpus's tree, its graphs held to
    the invariants of tests/test_hnsw.py; (3) REPLAY_NODES of its nodes
    replayed by smoke_reference.merge_node; (4) the main path's 384
    requests served over it under auto, every graph lane held to the
    numpy beam search (graph_checks), its recall beside a
    ``builder="device"`` index of the same rows; (5) IRangeGraph and
    Postfiltering built on the card and held, with Prefiltering, to the
    boxes and the brute force on 2 x BASELINE_REQUESTS requests, beside
    KHI; the indexes' sizes."""
    from repro_torch.core import KHIConfig, KHIIndex, hnsw
    from repro_torch.core.baselines import (IRangeGraph, Postfiltering,
                                            Prefiltering)
    from repro_torch.core.engine import Planner, device_put_index
    from repro_torch.core.query_ref import Predicate
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import KHIService, ServeConfig

    t_pass = time.perf_counter()
    M, k = cfg.M, cfg.k

    # ---- (1) the card's builds against the CPU's, bit for bit
    card, cpu = builder_cases(dev), builder_cases("cpu")
    for key, (nb, sec) in card.items():
        check(np.array_equal(cpu[key][0], nb),
              f"[build] {key}: the card's nbrs differ from the CPU's")
    print(f"[check] card against CPU, nbrs bit for bit: " + "; ".join(
        f"{key} equal (card {sec:.1f}s, CPU {cpu[key][1]:.1f}s)"
        for key, (_, sec) in card.items())
        + f" (grid cases {BUILD_GRID_CASES}: (n, merge_chunk, "
        f"symmetric_reverse) at d={BUILD_GRID_D}, M=32; bulk on the first "
        f"case's grid and the seeds {BULK_SEEDS})", flush=True)
    mark("[build] the card-vs-CPU builds")

    # ---- (2) Algorithm 5 over rows 0, BUILD_EVERY, ... on the card
    bv = np.ascontiguousarray(index.vecs[::BUILD_EVERY])
    ba = np.ascontiguousarray(index.attrs[::BUILD_EVERY])
    nb_rows = bv.shape[0]
    stats = []
    orig = hnsw.build_graphs
    hnsw.build_graphs = lambda *a, **kw: orig(*a, stats=stats, **kw)
    ops.reset_launches()
    ref.reset_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        inc = KHIIndex.build(bv, ba, KHIConfig(M=M), device=dev)
    finally:
        hnsw.build_graphs = orig
    build_s = time.perf_counter() - t0
    launches = ops.LAUNCHES["gather_l2"]
    plain = {kk: v["cuda"] for kk, v in ref.CALLS.items() if v["cuda"]}
    check(launches > 0 and not plain,
          f"[build] Algorithm 5 did not run on gather_l2 alone: "
          f"{launches} launches, plain-version CUDA calls {plain}")
    rows["gather_l2"]["launches_hnsw"] = launches
    graph_s = sum(st["seconds"] for st in stats)
    print(f"[build] Algorithm 5 (KHIConfig(M={M}), builder="
          f"{inc.config.builder!r}, ef_b={M}, merge_chunk 64) over "
          f"{nb_rows} rows (every {BUILD_EVERY}th of the corpus; d="
          f"{bv.shape[1]}): {build_s:.1f}s, the graphs {graph_s:.1f}s; "
          f"{inc.tree.num_nodes} tree nodes, height {inc.height}; "
          f"gather_l2 launches {launches}; "
          f"{sum(st['rounds'] for st in stats)} rounds, "
          f"{sum(st['hops'] for st in stats)} hops, "
          f"{sum(st['waves'] for st in stats)} reverse waves", flush=True)
    print("[build] per level (level: nodes, rounds, inserts, hops, waves, "
          "s): " + "; ".join(
              f"{st['level']}: {st['nodes']}, {st['rounds']}, "
              f"{st['lanes']}, {st['hops']}, {st['waves']}, "
              f"{st['seconds']:.2f}" for st in stats), flush=True)
    proj = projected_seconds(stats, index.tree)
    print(f"[build] projected Algorithm 5 over the main corpus's tree "
          f"({index.n} rows, height {index.tree.height}): {proj:.0f}s "
          f"(each level's rounds at this build's seconds a round)",
          flush=True)
    nbrs = inc.nbrs_numpy()
    bad = graph_invariants(nbrs, inc.tree, M)
    print(f"[check] Algorithm 5 graphs: invariant violations {bad}; "
          f"occupied slots {int((nbrs >= 0).sum())} <= n M H = "
          f"{nb_rows * M * inc.height}", flush=True)
    check(not any(bad.values()), "[build] the graphs break an invariant")
    del nbrs
    mark("[build] Algorithm 5")

    # ---- (3) replayed nodes
    vecs_t = torch.as_tensor(bv, device=dev)
    rep, worst, rep_s = replay_nodes(inc, vecs_t, M, dev)
    eq_nodes = sum(r[2] == r[1] for r in rep)
    by_lvl = {}
    for lvl, c, eq, ties in rep:
        by_lvl.setdefault(lvl, []).append(c)
    print(f"[check] replay: {eq_nodes} of {len(rep)} nodes "
          f"(levels: members {dict(sorted(by_lvl.items()))}) equal row for "
          f"row to smoke_reference.merge_node on the card's pair "
          f"distances, {sum(r[2] for r in rep)} of {sum(r[1] for r in rep)}"
          f" rows; {sum(r[3] for r in rep)} decisions within {NEAR_TIE:g} "
          f"of going the other way (taken the card's way); those distances"
          f" against float64: at most {worst:.2e} of the pair's squared "
          f"norms; {rep_s:.1f}s on the host", flush=True)
    check(eq_nodes == len(rep) == REPLAY_NODES,
          "[build] the card's rows differ from the numpy replay")
    check(worst <= NEAR_TIE, "[build] gather_l2's pair distances are off")
    mark("[build] the replay")

    # ---- (4) serve the main path's requests over the new index
    thr = max(1, nb_rows // 10)
    p_b = dataclasses.replace(params, scan_threshold=thr)
    di_inc = device_put_index(inc, device=dev)
    svc = KHIService(di_inc, p_b, config=ServeConfig(
        buckets=cfg.buckets, cache_size=cfg.cache_size))
    serve_bursts(svc, Q + np.float32(1e-3))        # warm-up, other keys
    ops.reset_launches()
    t0 = time.perf_counter()
    results = serve_bursts(svc, Q)
    dt = time.perf_counter() - t0
    served = {kk: v for kk, v in ops.LAUNCHES.items() if v}
    ids = np.stack([r.ids for r in results])
    dists = np.stack([r.dists for r in results])
    use_scan = svc._planner.plan(lo, hi).use_scan
    qt, tl, th_ = (torch.as_tensor(a).to(dev) for a in (Q, lo, hi))
    t_ids, t_d = [], []
    for s0 in range(0, len(Q), 64):
        a, b = ref.scan_topk_ref(di_inc.vecs, di_inc.attrs, qt[s0:s0 + 64],
                                 tl[s0:s0 + 64], th_[s0:s0 + 64], k)
        t_ids.append(a.cpu().numpy())
        t_d.append(b.cpu().numpy())
    t_ids, t_d = np.concatenate(t_ids), np.concatenate(t_d)
    print(f"[build] the incremental index served {len(Q)} requests in "
          f"{dt:.3f}s ({len(Q) / dt:.1f} QPS end-to-end) under "
          f"{p_b.strategy}, scan threshold {thr} (10% of n); graph lanes "
          f"{int((~use_scan).sum())}, scan lanes {int(use_scan.sum())}; "
          f"launches {served}", flush=True)
    check(served.get("gather_l2_filter", 0) > 0
          and served.get("scan_topk", 0) > 0 and (~use_scan).any(),
          "[build] the served run skipped the graph or the scan path")
    check_served(ids, dists, bv, ba, Q, lo, hi, "[build] incremental")
    si = np.nonzero(use_scan)[0]
    check(bool(lanes_exact(ids[si], dists[si], t_ids[si], t_d[si]).all()),
          "[build] scan lanes are not exact")
    _, rec_inc = graph_checks(inc, di_inc, svc, Q, lo, hi, ids, use_scan,
                              t_ids, t_d, cfg, dev)
    del svc
    gi = np.nonzero(~use_scan)[0]
    t0 = time.perf_counter()
    dev_ix = KHIIndex.build(bv, ba, KHIConfig(M=M, builder="device"),
                            device=dev)
    dev_s = time.perf_counter() - t0
    di_dev = device_put_index(dev_ix, device=dev)
    efs = (p_b.ef, 16 * p_b.ef)
    rec_dev = graph_recall(di_dev, p_b, Q, lo, hi, gi, t_ids, efs)
    print(f"[build] recall@{k} of the {len(gi)} graph lanes, incremental "
          f"(Algorithm 5, {build_s:.1f}s) against builder='device' "
          f"({dev_s:.1f}s) over the same rows: " + ", ".join(
              f"ef={ef}: {rec_inc[ef]:.4f} / {rec_dev[ef]:.4f}"
              for ef in efs), flush=True)
    check(rec_dev[p_b.ef] >= rec_inc[p_b.ef] - 0.05,
          "[build] the device index's recall is below the incremental's "
          "by more than 0.05")
    mark("[build] serving over the incremental index")

    # ---- (5) the baselines on the same rows
    ops.reset_launches()
    t0 = time.perf_counter()
    irg = IRangeGraph.build(bv, ba, index_attr=0, M=M, leaf_size=32,
                            builder="bulk", device=dev)
    torch.cuda.synchronize()
    irg_s = time.perf_counter() - t0
    irg_l = ops.LAUNCHES["gather_l2"]
    pv = np.ascontiguousarray(bv[::POST_EVERY])
    pa = np.ascontiguousarray(ba[::POST_EVERY])
    ops.reset_launches()
    t0 = time.perf_counter()
    post = Postfiltering.build(pv, pa, M=M, device=dev)
    post_s = time.perf_counter() - t0
    post_l = ops.LAUNCHES["gather_l2"]
    pre = Prefiltering.build(bv, ba, device=dev)
    check(post_l > 0, "[build] Postfiltering's build skipped gather_l2")
    rows["gather_l2"]["launches_irange"] = irg_l
    rows["gather_l2"]["launches_postfilter"] = post_l
    sel = np.concatenate([np.nonzero(~is_s)[0][:BASELINE_REQUESTS],
                          np.nonzero(is_s)[0][:BASELINE_REQUESTS]])
    preds = [Predicate(lo[i], hi[i]) for i in sel]
    a, _ = ref.scan_topk_ref(torch.as_tensor(pv, device=dev),
                             torch.as_tensor(pa, device=dev), qt[sel],
                             tl[sel], th_[sel], k)
    truth = {"": t_ids[sel], "post": a.cpu().numpy()}
    res = {}
    for name, fn, rows_of in (
            ("Prefiltering", lambda i, pr: pre.query(Q[i], pr, k), ""),
            ("iRangeGraph", lambda i, pr: irg.query(Q[i], pr, k,
                                                    ef=p_b.ef), ""),
            ("Postfiltering", lambda i, pr: post.query(Q[i], pr, k,
                                                       ef=p_b.ef), "post")):
        t0 = time.perf_counter()
        got = [fn(i, pr) for i, pr in zip(sel, preds)]
        torch.cuda.synchronize()
        res[name] = (got, time.perf_counter() - t0, rows_of)
    for name, (got, _, rows_of) in res.items():
        at = pa if rows_of else ba
        for i, g in zip(sel, got):
            check(bool(Predicate(lo[i], hi[i]).matches(at[g]).all())
                  and len(set(g.tolist())) == len(g),
                  f"[build] {name} returned an id outside its box")
    pre_ids = np.full((len(sel), k), -1, np.int64)
    for j, g in enumerate(res["Prefiltering"][0]):
        pre_ids[j, :len(g)] = g
    pre_d = np.where(pre_ids >= 0, ((bv[np.maximum(pre_ids, 0)]
                                     - Q[sel][:, None]) ** 2).sum(-1),
                     np.inf).astype(np.float32)
    same, ties, _ = topk_agree("[build] Prefiltering",
                               torch.as_tensor(pre_ids),
                               torch.as_tensor(pre_d),
                               torch.as_tensor(t_ids[sel]),
                               torch.as_tensor(t_d[sel]))
    khi = {}
    for name, di_x in (("KHI incremental", di_inc), ("KHI device", di_dev)):
        pl = Planner(di_x, p_b)
        pl.search(Q[sel] + np.float32(1e-3), lo[sel], hi[sel])   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kid = pl.search(Q[sel], lo[sel], hi[sel])[0]
        torch.cuda.synchronize()
        khi[name] = (kid, time.perf_counter() - t0, "")
    half = {"1/4": slice(0, BASELINE_REQUESTS),
            "1/64": slice(BASELINE_REQUESTS, None)}

    def rec_line(found, want):
        fa = np.full((len(sel), k), -1, np.int64)
        for j, g in enumerate(found):
            fa[j, :len(g)] = g[:k]
        return ", ".join(f"{h} {recall(fa[s_], want[s_]):.4f}"
                         for h, s_ in half.items())

    for name, (got, sec, rows_of) in list(res.items()) + list(khi.items()):
        print(f"[build] {name}: recall@{k} {rec_line(got, truth[rows_of])}"
              f"; {len(sel) / sec:.1f} QPS ({len(sel)} requests, "
              f"{'one batch' if name.startswith('KHI') else 'one at a time'}"
              f", ef={p_b.ef}; over {len(pv) if rows_of else nb_rows} "
              f"rows)", flush=True)
    print(f"[build] builds on the card: iRangeGraph (attribute 0, leaf 32, "
          f"builder='bulk', as the reference's method comparison builds it)"
          f" {irg_s:.1f}s, {irg.height} levels, gather_l2 launches {irg_l};"
          f" Postfiltering (one graph, Algorithm 5's merge, over every "
          f"{POST_EVERY}th of the pass's rows: {len(pv)}) {post_s:.1f}s, "
          f"gather_l2 launches {post_l}; Prefiltering equal to the brute "
          f"force on {same} slots, {ties} near-ties", flush=True)
    irg_total = irg.graph_size_bytes() + bv.nbytes + ba.nbytes
    print(f"[build] sizes (bytes): KHI incremental graph "
          f"{inc.graph_size_bytes()}, total {inc.total_size_bytes()}; KHI "
          f"device graph {dev_ix.graph_size_bytes()}, total "
          f"{dev_ix.total_size_bytes()}; iRangeGraph graph "
          f"{irg.graph_size_bytes()}, total {irg_total}", flush=True)

    del inc, dev_ix, di_inc, di_dev, irg, post, pre, vecs_t
    torch.cuda.empty_cache()
    print(f"[build] the builders' pass took {time.perf_counter() - t_pass:.1f}"
          f"s", flush=True)


MESH_HALVING = (8, 256, 10)     # the simulated halving stack (S, B, k)


def profiled(fn):
    """(wall ms, summed device-side ms) of the second of two calls of
    ``fn``, the second under ``profile_once``."""
    fn()
    torch.cuda.synchronize()
    wall, _, evs, _ = profile_once(fn)
    return wall * 1e3, sum(t for _, t, _ in evs)


def mesh_pass(di, params, cfg, Q, lo, hi, serve_bursts, card, served,
              single, dev, rows) -> None:
    """The collective sharded search (``make_sharded_search_fn``) on the
    card: NCCL at world size 1 (``file://`` rendezvous in a temporary
    directory) over ``stack_shards([index])``, a view of the main path's
    1M index as one shard, so the global ids are the local ones. Checks
    ``route_level_card`` against the main planner's bound on every lane;
    serves the same warm-up pass and bursts through ``KHIService(mesh=)``
    at the config (auto), at hybrid at the cell threshold and with
    quant="int8", each held id for id and bit for bit to the single
    service's answers of the main path, the hybrid pass and the int8 pass,
    with its launches counted over the served run alone; holds
    ``route_level_windows`` to the hybrid pass's planner on every lane;
    times one 256-lane batch through the collective and through the
    single planner; and simulates the halving rounds on the card on a
    ``MESH_HALVING`` stack with planted ties against ``_merge_topk``.
    ``single`` is the main path's planner. Destroys the process group."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.core import router
    from repro_torch.core.sharded import (_merge_topk, _pair_merge_k,
                                          merge_bytes_per_device,
                                          stack_shards)
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import (init_query_process_group,
                                         make_query_mesh)
    from repro_torch.serve import KHIService, ServeConfig

    t_pass = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mesh_")
    t0 = time.perf_counter()
    mdev = init_query_process_group(dev, init_method=f"file://{tmp}/rdv",
                                    rank=0, world_size=1, timeout_s=300)
    try:
        mesh = make_query_mesh(1, 1)
        check(mesh.backend == "nccl" and mesh.device.type == "cuda",
              f"the mesh runs on {mesh.backend} / {mesh.device}, not NCCL on "
              f"the card")
        skhi = stack_shards([di])
        check(skhi.di.vecs.data_ptr() == di.vecs.data_ptr(),
              "stack_shards copied the one shard")
        print(f"[mesh] NCCL process group of 1 rank on {mdev} in "
              f"{time.perf_counter() - t0:.2f}s; mesh {mesh.shape}; "
              f"stack_shards([index]) is a view of the main path's index; "
              f"merge bytes a row at the reference's 16 shards: halving "
              f"{merge_bytes_per_device(cfg.k, 16, 'halving')}, all-gather "
              f"{merge_bytes_per_device(cfg.k, 16, 'allgather')}",
              flush=True)
        scfg = ServeConfig(buckets=cfg.buckets, cache_size=cfg.cache_size)
        tl = torch.as_tensor(lo).to(dev)
        th = torch.as_tensor(hi).to(dev)

        def serve_checked(tag, p, want, kernels):
            t0 = time.perf_counter()
            svc = KHIService(skhi, p, config=scfg, mesh=mesh)
            fn = svc._get_search_fn(0)
            setup_s = time.perf_counter() - t0
            serve_bursts(svc, Q + np.float32(1e-3))    # warm-up, other keys
            ops.reset_launches()
            ref.reset_calls()
            before = svc.snapshot()
            t0 = time.perf_counter()
            results = serve_bursts(svc, Q)
            dt = time.perf_counter() - t0
            after = svc.snapshot()
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            plain_cuda = {k: v["cuda"] for k, v in ref.CALLS.items()}
            ids = np.stack([r.ids for r in results])
            dists = np.stack([r.dists for r in results])
            same_i = (ids == want[0]).all(1)
            same_d = (dists.view(np.uint32) == want[1].view(np.uint32)).all(1)
            ds = after["device_seconds"] - before["device_seconds"]
            print(f"[mesh {tag}] {len(results)} requests in {dt:.3f}s "
                  f"({len(results) / dt:.1f} QPS end-to-end; "
                  f"{after['batches'] - before['batches']} collective "
                  f"batches over {ds:.3f}s); setup {setup_s:.2f}s (merge "
                  f"{fn.merge}, static {fn.static}); ids equal to the single "
                  f"service's on {int(same_i.sum())} of {len(ids)} lanes, "
                  f"dists bit-equal on {int(same_d.sum())}; launches "
                  f"{launches}; plain-version CUDA calls {plain_cuda}",
                  flush=True)
            check(bool(same_i.all() and same_d.all()),
                  f"[mesh {tag}] the collective's answers differ from the "
                  f"single service's")
            check(all(v == 0 for v in plain_cuda.values()),
                  f"[mesh {tag}] fell through to a plain version")
            for name in kernels:
                check(launches.get(name, 0) > 0,
                      f"[mesh {tag}] {name} was never launched")
                rows[name].setdefault("mesh_launches", {})[tag] = \
                    launches.get(name, 0)
            return svc, fn

        # ---- the config: auto, the fused gather, level router, E = 4
        svc, fn = serve_checked("auto", params, served["auto"],
                                ("gather_l2_filter", "scan_topk"))
        p = svc.params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = router.route_level_card(skhi.di.shard(0), tl, th, p)
        torch.cuda.synchronize()
        same = int((got.cpu().numpy() == card).sum())
        print(f"[mesh] route_level_card: equal to the planner's bound on "
              f"{same} of {len(Q)} lanes ({(time.perf_counter() - t0) * 1e3:.1f}"
              f" ms for the batch on the card)", flush=True)
        check(same == len(Q), "route_level_card differs from the planner's "
              "bound")
        b = cfg.buckets[-1]
        m_wall, m_dev = profiled(lambda: fn(skhi, Q[:b], lo[:b], hi[:b]))
        s_wall, s_dev = profiled(lambda: single.search(Q[:b], lo[:b],
                                                       hi[:b]))
        print(f"[mesh] one {b}-lane batch: collective wall {m_wall:.1f} ms, "
              f"device-side {m_dev:.1f} ms (idle "
              f"{100 * max(0.0, 1 - m_dev / m_wall):.1f}%); the single "
              f"planner's (plan cache warm) wall {s_wall:.1f} ms, "
              f"device-side {s_dev:.1f} ms (idle "
              f"{100 * max(0.0, 1 - s_dev / s_wall):.1f}%)", flush=True)
        del svc, fn

        # ---- hybrid at the cell threshold: the windows, then the answers
        h_ids, h_d, plan = served["hybrid"]
        svc, fn = serve_checked(
            "hybrid", dataclasses.replace(params, strategy="hybrid",
                                          node_scan_threshold=0),
            (h_ids, h_d), ("scan_topk_windows",))
        st = fn.static
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, n_small, n_large, wst, wct = router.route_level_windows(
            skhi.di.shard(0), tl, th, svc.params, node_thr=st["node_thr"],
            W=st["W"])
        torch.cuda.synchronize()
        w_s = time.perf_counter() - t0
        lane, node = plan.small_nodes[0]
        e_st, e_ct = di.start[node], di.count[node]
        keep = e_ct > 0
        lane, e_st, e_ct = lane[keep], e_st[keep], e_ct[keep]
        o = torch.argsort(lane * (di.n + 1) + e_st)
        lane, e_st, e_ct = lane[o], e_st[o], e_ct[o]
        nz = torch.nonzero(wct > 0)
        g_lane, g_st, g_ct = nz[:, 0], wst[wct > 0], wct[wct > 0]
        same_w = (g_lane.numel() == lane.numel()
                  and torch.equal(g_lane, lane)
                  and torch.equal(g_st.long(), e_st)
                  and torch.equal(g_ct.long(), e_ct))
        same_n = int((n_small.cpu().numpy() == plan.n_windows).sum())
        same_c = int((c.cpu().numpy() == plan.card).sum())
        print(f"[mesh] route_level_windows (node_thr {st['node_thr']}, W "
              f"{st['W']}, returned {wst.shape[1]} wide): card equal on "
              f"{same_c}, window counts on {same_n} of {len(Q)} lanes; "
              f"{g_lane.numel()} windows, the planner's {lane.numel()}, "
              f"equal: {same_w}; large nodes {int(n_large.sum())}; "
              f"{w_s * 1e3:.1f} ms for the batch", flush=True)
        check(same_w and same_n == len(Q) and same_c == len(Q),
              "route_level_windows differs from the planner's windows")
        del svc, fn, wst, wct

        # ---- the int8 tier
        svc, fn = serve_checked("int8", dataclasses.replace(params,
                                                            quant="int8"),
                                served["int8"],
                                ("gather_l2_filter_q8", "scan_topk_q8"))
        del svc, fn

        # ---- the halving rounds, simulated on the card
        S, B, k = MESH_HALVING
        g = torch.Generator().manual_seed(5)
        dd = torch.randint(0, 6, (S, B, k), generator=g).float().sort(
            -1).values
        gi = torch.randint(0, 1 << 20, (S, B, k), generator=g)
        dd[:, :, -2:], gi[:, :, -2:] = float("inf"), -1
        dd, gi = dd.to(dev), gi.to(dev)
        t = (torch.arange(S, device=dev)[:, None, None] * k
             + torch.arange(k, device=dev)).expand(S, B, k).to(torch.int32)
        ids, d = gi.to(torch.int32), dd
        for rnd in range(S.bit_length() - 1):
            perm = [s ^ (1 << rnd) for s in range(S)]
            out = [_pair_merge_k(ids[s], d[s], t[s], ids[perm[s]],
                                 d[perm[s]], t[perm[s]], k)
                   for s in range(S)]
            ids, d, t = (torch.stack([o[j] for o in out]) for j in range(3))
        ei, ed = _merge_topk(gi, dd, k)
        ok = sum(torch.equal(ids[s].long(), ei) and torch.equal(d[s], ed)
                 for s in range(S))
        ties = int(((ed[:, 1:] == ed[:, :-1]) & torch.isfinite(ed[:, 1:]))
                   .sum())
        print(f"[mesh] halving simulation on the card, (S, B, k) = "
              f"{MESH_HALVING}: {ok} of {S} ranks end bit-equal to "
              f"_merge_topk ({ties} tied neighbours in its answer)",
              flush=True)
        check(ok == S and ties > 0, "the halving rounds differ from "
              "_merge_topk")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[mesh] pass {time.perf_counter() - t_pass:.1f}s", flush=True)


SHARDS = 4
# the shard pass's corpus: the first quarter of the main corpus (cut from
# 1M for the script's time limit)
SHARD_ROWS = 250_000
SHARD_INSERTS = 16_384
SHARD_BASE_DELETES = 4_096
SHARD_DELTA_DELETES = 1_024
SHARD_INT8_LANES = 32


def index_gib(di) -> float:
    """GiB of every tensor of a DeviceIndex (stacked or not)."""
    return sum(t.numel() * t.element_size()
               for t in vars(di).values() if torch.is_tensor(t)) / 2**30


def per_shard_truth(skhi, Q, lo, hi, k: int, dev):
    """The exact answer in the merge's tie order: each shard's f32 masked
    brute force (the plain scan over its real rows) on local ids, merged
    by smoke_reference.merge_shards in (dist, shard, local) order."""
    import smoke_reference as sref
    from repro_torch.kernels import ref

    S = skhi.num_shards
    qt, tl, th = (torch.as_tensor(a).to(dev) for a in (Q, lo, hi))
    ids = np.full((S, len(Q), k), -1, np.int64)
    dd = np.full((S, len(Q), k), np.inf, np.float32)
    for s in range(S):
        sh = skhi.di.shard(s)
        n_s = int(sh.count[sh.root])
        for b in range(0, len(Q), 64):
            a, d_ = ref.scan_topk_ref(sh.vecs[:n_s], sh.attrs[:n_s],
                                      qt[b:b + 64], tl[b:b + 64],
                                      th[b:b + 64], k)
            ids[s, b:b + 64] = a.cpu().numpy()
            dd[s, b:b + 64] = d_.cpu().numpy()
    return sref.merge_shards(ids, dd, S, k)


def shard_pass(index, di, params, cfg, Q, lo, hi, serve_bursts, dev, rows):
    """The sharded index on the card, in one process: ``build_sharded``
    over the first SHARD_ROWS rows of the main path's corpus into SHARDS
    round-robin shards (62,500 rows each at n = 1M; the widths kept),
    served through a ``KHIService`` at
    the config's params in the main path's bursts. Scan lanes are held to
    the per-shard f32 brute force merged in the merge's (dist, shard,
    local) order; every graph lane's per-shard ids and hops to
    smoke_reference.py's numpy DFS + beam search over that shard's
    arrays, and the merged answer to its numpy merge. Then the int8 tier
    (>= 95% of the checked lanes equal to the numpy int8 search, per
    shard, merged), hybrid at the cell threshold (pure-window lanes
    exact) and the bitmask expression E2 (exact against the per-shard
    masked brute force, merged). Then streaming at the config's
    ``delta_capacity`` per shard: SHARD_INSERTS inserts in bursts,
    deletes of base and delta rows, the requests checked against the
    live corpus, and one compaction through ``build_sharded`` timed by
    phase. The sharded and the single index's graph programs are traced
    in the same run. Returns shard 0 as (its host KHIIndex, a copy of
    its DeviceIndex), the index the streaming pass runs on."""
    import smoke_reference as sref
    from repro_torch.core import KHIConfig
    from repro_torch.core import khi as khi_mod
    from repro_torch.core import sharded as sh_mod
    from repro_torch.core.engine import (_query_batch_sharded,
                                         resolve_scorer_pair,
                                         with_quant_replica)
    from repro_torch.core.predicate import parse_expr
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import KHIService, ServeConfig

    S, k = SHARDS, cfg.k
    vecs, attrs = index.vecs[:SHARD_ROWS], index.attrs[:SHARD_ROWS]
    n, d = vecs.shape
    t_pass = time.perf_counter()
    scfg = ServeConfig(buckets=cfg.buckets, cache_size=cfg.cache_size)

    def build_timed(fn, *a, **kw):
        """Run ``fn`` with every shard's KHIIndex.build timed (seconds,
        index, its l2dist_qn calls) and every l2dist_qn call between
        CUDA events; -> (fn's result, per-shard records, seconds)."""
        l2_calls, per = [], []
        orig_l2, ops.l2dist_qn = l2dist_events(l2_calls)
        build = khi_mod.KHIIndex.build

        def timed_build(*ba, **bkw):
            t, c0 = time.perf_counter(), len(l2_calls)
            ix = build(*ba, **bkw)
            per.append((time.perf_counter() - t, ix, l2_calls[c0:]))
            return ix

        khi_mod.KHIIndex.build = timed_build
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = fn(*a, **kw)
            torch.cuda.synchronize()
        finally:
            ops.l2dist_qn = orig_l2
            khi_mod.KHIIndex.build = build
        return out, per, time.perf_counter() - t0

    def l2_s(calls):
        return sum(a.elapsed_time(b) for *_, a, b in calls) / 1e3

    # ---- build
    ops.reset_launches()
    ref.reset_calls()
    torch.cuda.reset_peak_memory_stats()
    skhi, per, build_s = build_timed(
        sh_mod.build_sharded, vecs, attrs, S,
        KHIConfig(M=cfg.M, builder="device"), device=dev)
    hosts = [ix for _, ix, _ in per]
    for ix in hosts:
        ix.nbrs = None                       # the stacked copy serves
    torch.cuda.empty_cache()
    print(f"[shard] build_sharded S={S} over n={n}: {build_s:.1f}s; per "
          f"shard " + ", ".join(
              f"{ix.n} rows {t:.1f}s (l2dist_qn {l2_s(c):.1f}s over "
              f"{len(c)} launches)" for t, ix, c in per)
          + f"; l2dist_qn {sum(l2_s(c) for *_, c in per):.1f}s in all; "
          f"pad waste (rows, nodes, levels) "
          f"{tuple(round(w, 6) for w in skhi.pad_waste)}; stacked index "
          f"{index_gib(skhi.di):.3f} GiB (single index {index_gib(di):.3f});"
          f" peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    check(skhi.num_shards == S and skhi.di.n == -(-n // S),
          "[shard] the stacked index has other shapes")

    # ---- f32 service at the config's params, the main path's bursts
    svc = KHIService(skhi, params, config=scfg)
    p = svc.params
    t0 = time.perf_counter()
    serve_bursts(svc, Q + np.float32(1e-3))        # warm-up, other keys
    warm_s = time.perf_counter() - t0
    before = svc.snapshot()
    t0 = time.perf_counter()
    results = serve_bursts(svc, Q)
    dt = time.perf_counter() - t0
    after = svc.snapshot()
    launches = {nm: c for nm, c in ops.LAUNCHES.items() if c}
    plain_cuda = {nm: v["cuda"] for nm, v in ref.CALLS.items() if v["cuda"]}
    print(f"[shard] f32: {len(Q)} requests in {dt:.3f}s ({len(Q) / dt:.1f} "
          f"QPS end-to-end); warm-up {warm_s:.1f}s; frontier_cap "
          f"{p.frontier_cap} scan_budget {p.scan_budget}; batches "
          f"{after['batches'] - before['batches']}, scan_lanes "
          f"{after['scan_lanes'] - before['scan_lanes']}; launches over the "
          f"build and the served runs {launches}", flush=True)
    for name in ("gather_l2_filter", "scan_topk", "l2dist_qn"):
        check(launches.get(name, 0) > 0, f"[shard] {name} was never "
              f"launched")
    check(not plain_cuda, f"[shard] the path fell through to a plain "
          f"version: {plain_cuda}")
    ids = np.stack([r.ids for r in results])
    dists = np.stack([r.dists for r in results])
    check_served(ids, dists, vecs, attrs, Q, lo, hi, "[shard]")
    plan = svc._planner.plan(lo, hi)
    use_scan = plan.use_scan
    si, gi = np.nonzero(use_scan)[0], np.nonzero(~use_scan)[0]
    check(len(si) > 0 and len(gi) > 0, "[shard] the bursts did not take "
          "both graph and scan lanes")
    t0 = time.perf_counter()
    st_ids, st_d = per_shard_truth(skhi, Q, lo, hi, k, dev)
    truth_s = time.perf_counter() - t0
    ok_s = lanes_exact(ids[si], dists[si], st_ids[si], st_d[si])
    same_s = (ids[si] == st_ids[si]).all(1)
    print(f"[shard] scan lanes ({len(si)}): equal to the per-shard f32 "
          f"brute force merged in (dist, shard, local) order on "
          f"{int(ok_s.sum())} ({int(same_s.sum())} with every id equal, the "
          f"rest near-ties); truth {truth_s:.1f}s", flush=True)
    check(bool(ok_s.all()), "[shard] scan lanes are not exact")

    # graph lanes: each shard's walk against numpy over that shard's arrays
    scorer, exact = resolve_scorer_pair(p)
    qg, lg, hg = (torch.as_tensor(a[gi]).to(dev) for a in (Q, lo, hi))
    l_ids, l_d, l_hops = _query_batch_sharded(skhi.di, qg, lg, hg, p,
                                              scorer, exact)
    l_ids, l_d = l_ids.cpu().numpy(), l_d.cpu().numpy()
    l_hops = l_hops.cpu().numpy()
    m_ids, _ = sref.merge_shards(l_ids, l_d, S, k)
    check(np.array_equal(m_ids, ids[gi]),
          "[shard] served graph lanes differ from the merged shard walks")
    def card_dist(s, i):
        """Lane i's f32 distances on shard s by the gather kernel, the
        walk's own sum order (a distance does not depend on its batch)."""
        sh = skhi.di.shard(s)
        qq, ql, qh = (torch.as_tensor(a[i][None]).to(dev)
                      for a in (Q, lo, hi))

        def dist(rows):
            t = torch.as_tensor(np.asarray(rows, np.int64)[None]).to(dev)
            return ops.gather_l2_filter(t, sh.vecs, sh.attrs, qq, ql,
                                        qh)[0].cpu().numpy()
        return dist

    t0 = time.perf_counter()
    r_ids, r_d, r_hops, per_shard = [], [], [], []
    for s, ix in enumerate(hosts):
        nb = skhi.di.nbrs[s].cpu().numpy()         # the padded height
        out, replayed = [], 0
        for j, i in enumerate(gi):
            e = sref.dfs_entries(ix.tree, ix.attrs, lo[i], hi[i], p.c_e,
                                 p.scan_budget)
            kw = dict(k=k, ef=p.ef, c_n=p.c_n, E=p.expand_width,
                      max_hops=p.hops())
            o = sref.beam_search(ix.vecs, ix.attrs, nb, e, Q[i], lo[i],
                                 hi[i], **kw)
            if not ((o[0] == l_ids[s, j]).all() and o[2] == l_hops[s, j]):
                # numpy's sum order may order a near-tie otherwise: replay
                # the same numpy walk on the card's distances
                o = sref.beam_search(ix.vecs, ix.attrs, nb, e, Q[i], lo[i],
                                     hi[i], dist=card_dist(s, i), **kw)
                replayed += 1
            out.append(o)
        del nb
        r_ids.append(np.stack([o[0] for o in out]))
        r_d.append(np.stack([o[1] for o in out]))
        r_hops.append(np.array([o[2] for o in out]))
        per_shard.append((int((l_ids[s] == r_ids[s]).all(1).sum()),
                          int((l_hops[s] == r_hops[s]).sum()), replayed))
    ref_s = time.perf_counter() - t0
    n_ids, _ = sref.merge_shards(np.stack(r_ids), np.stack(r_d), S, k)
    same_m = (n_ids == ids[gi]).all(1)
    rec_sh = recall(ids[gi], st_ids[gi])
    print(f"[shard] graph lanes ({len(gi)}): per shard, ids and hops equal "
          f"to the numpy DFS + beam search over the shard's arrays on "
          + ", ".join(f"{a} / {b}" for a, b, _ in per_shard)
          + f" of {len(gi)} (of them walked on the card's distances, a "
          f"near-tie numpy's sum order orders otherwise: "
          f"{[r for *_, r in per_shard]}; mean hops per shard "
          f"{[round(float(h.mean()), 1) for h in l_hops]}; {ref_s:.1f}s on "
          f"the host); served answers equal to the numpy merge in (dist, "
          f"shard, local) order on {int(same_m.sum())}; recall@{k} "
          f"{rec_sh:.4f}", flush=True)
    check(all(a == len(gi) and b == len(gi) for a, b, _ in per_shard),
          "[shard] a shard's walk differs from the numpy beam search")
    check(bool(same_m.all()), "[shard] served graph lanes differ from the "
          "numpy merge")
    trace_programs("shard f32", skhi, p, Q, lo, hi, split_lanes(use_scan),
                   planner=svc._planner)
    trace_programs("single f32", di, params, Q, lo, hi, [("graph", gi)])

    # ---- the int8 tier: the replica on the stacked index
    ops.reset_launches()
    ref.reset_calls()
    t0 = time.perf_counter()
    sq = dataclasses.replace(skhi, di=with_quant_replica(skhi.di, "int8"))
    torch.cuda.synchronize()
    attach_s = time.perf_counter() - t0
    svc8 = KHIService(sq, dataclasses.replace(params, quant="int8"),
                      config=scfg)
    serve_bursts(svc8, Q + np.float32(1e-3))
    t0 = time.perf_counter()
    res8 = serve_bursts(svc8, Q)
    dt8 = time.perf_counter() - t0
    l8 = {nm: c for nm, c in ops.LAUNCHES.items() if c}
    for name in ("gather_l2_filter_q8", "scan_topk_q8"):
        check(l8.get(name, 0) > 0, f"[shard int8] {name} was never launched")
    check(not any(v["cuda"] for v in ref.CALLS.values()),
          "[shard int8] the path fell through to a plain version")
    ids8 = np.stack([r.ids for r in res8])
    p8 = svc8.params
    use8 = svc8._planner.plan(lo, hi).use_scan
    si8, gi8 = np.nonzero(use8)[0], np.nonzero(~use8)[0]
    gs8 = lane_sample(gi8, SHARD_INT8_LANES, seed=21)
    ss8 = lane_sample(si8, SHARD_INT8_LANES, seed=22)
    kq = min(max(k, k * p8.rerank_mult), skhi.di.n)
    rr = max(k, min(p8.ef, k * p8.rerank_mult))
    t0 = time.perf_counter()
    lanes8 = np.concatenate([ss8, gs8])
    np_i = np.full((S, len(lanes8), k), -1, np.int64)
    np_d = np.full((S, len(lanes8), k), np.inf, np.float32)
    for s, ix in enumerate(hosts):
        n_s = ix.n
        deq = sref.dequant_rows(sq.di.qvecs[s][:n_s].cpu().numpy(),
                                sq.di.qscale[s][:n_s].cpu().numpy())
        nb = skhi.di.nbrs[s].cpu().numpy()
        for j, i in enumerate(lanes8):
            if use8[i]:
                a, b = sref.scan_rerank(deq, ix.vecs, ix.attrs, Q[i], lo[i],
                                        hi[i], k=k, kq=kq)
            else:
                e = sref.dfs_entries(ix.tree, ix.attrs, lo[i], hi[i],
                                     p8.c_e, p8.scan_budget)
                cand, _, _ = sref.beam_search(
                    deq, ix.attrs, nb, e, Q[i], lo[i], hi[i], k=rr,
                    ef=p8.ef, c_n=p8.c_n, E=p8.expand_width,
                    max_hops=p8.hops())
                a, b = sref.rerank(ix.vecs, cand, Q[i], k)
            np_i[s, j], np_d[s, j] = a, b
        del deq, nb
    n8_i, _ = sref.merge_shards(np_i, np_d, S, k)
    eq8 = (n8_i == ids8[lanes8]).all(1)
    n_s8 = int(eq8[:len(ss8)].sum())
    n_g8 = int(eq8[len(ss8):].sum())
    rb = sq.di.qvecs.numel() + sq.di.qscale.numel() * 4
    print(f"[shard int8] replica ({rb / 2**30:.3f} GiB) attached to the "
          f"stacked index in {attach_s:.3f}s; {len(Q)} requests in "
          f"{dt8:.3f}s ({len(Q) / dt8:.1f} QPS end-to-end); launches {l8}; "
          f"ids equal to the numpy int8 search per shard (scan: over-fetch "
          f"kq={kq} + f32 rerank; graph: beam search + f32 rerank of the "
          f"top rr={rr}), merged, on {n_s8} of {len(ss8)} sampled scan "
          f"lanes (of {len(si8)}) and {n_g8} of {len(gs8)} sampled graph "
          f"lanes (of {len(gi8)}; "
          f"{time.perf_counter() - t0:.1f}s on the host)", flush=True)
    check(n_s8 >= 0.95 * len(ss8) and n_g8 >= 0.95 * len(gs8),
          "[shard int8] the lanes disagree with the numpy int8 search")
    del svc8, sq
    torch.cuda.empty_cache()

    # ---- hybrid at the cell threshold: pure-window lanes exact
    ops.reset_launches()
    ref.reset_calls()
    svc_h = KHIService(skhi, dataclasses.replace(params, strategy="hybrid"),
                       config=scfg)
    serve_bursts(svc_h, Q + np.float32(1e-3))
    t0 = time.perf_counter()
    res_h = serve_bursts(svc_h, Q)
    dt_h = time.perf_counter() - t0
    lh = {nm: c for nm, c in ops.LAUNCHES.items() if c}
    check(lh.get("scan_topk_windows", 0) > 0,
          "[shard hybrid] the windowed scan was never launched")
    check(not any(v["cuda"] for v in ref.CALLS.values()),
          "[shard hybrid] the path fell through to a plain version")
    mode = svc_h._planner.plan(lo, hi).mode
    pure = np.nonzero(mode == 1)[0]
    ids_h = np.stack([r.ids for r in res_h])
    d_h = np.stack([r.dists for r in res_h])
    ok_h = lanes_exact(ids_h[pure], d_h[pure], st_ids[pure], st_d[pure])
    print(f"[shard hybrid {svc_h._planner.node_scan_threshold}] {len(Q)} "
          f"requests in {dt_h:.3f}s ({len(Q) / dt_h:.1f} QPS end-to-end); "
          f"lanes by mode: graph {int((mode == 0).sum())}, pure-window "
          f"{len(pure)}, mixed {int((mode == 2).sum())}; pure-window lanes "
          f"equal to the per-shard f32 truth, merged, on {int(ok_h.sum())}; "
          f"launches {lh}", flush=True)
    check(len(pure) > 0 and bool(ok_h.all()),
          "[shard hybrid] a pure-window lane is not exact")
    del svc_h

    # ---- the bitmask expression E2 against the masked brute force
    years = tuple(range(2005, 2024, 2))
    expr = parse_expr("a0 in [" + ", ".join(map(str, years)) + "]", cfg.m)
    mask = sref.year_mask(attrs, years)
    mt_i = np.full((S, len(Q), k), -1, np.int64)
    mt_d = np.full((S, len(Q), k), np.inf, np.float32)
    for s, ix in enumerate(hosts):
        mt_i[s], mt_d[s] = masked_truth(skhi.di.vecs[s][:ix.n], mask[s::S],
                                        Q, k, dev)
    e_ti, e_td = sref.merge_shards(mt_i, mt_d, S, k)
    ops.reset_launches()
    ref.reset_calls()
    svc.search_expr(Q + np.float32(1e-3), expr)
    t0 = time.perf_counter()
    e_ids, e_d = svc.search_expr(Q, expr)
    dt_e = time.perf_counter() - t0
    le = {nm: c for nm, c in ops.LAUNCHES.items() if c}
    ok_e = lanes_exact(e_ids, e_d, e_ti, e_td)
    print(f"[shard predicate] E2 ({len(years)} years, bitmask, "
          f"{int(mask.sum())} rows): {len(Q)} queries in {dt_e:.3f}s; "
          f"equal to the per-shard masked brute force, merged, on "
          f"{int(ok_e.sum())} of {len(Q)}; launches {le}", flush=True)
    check(le.get("scan_topk_mask", 0) > 0,
          "[shard predicate] the bitmask kernel was never launched")
    check(bool(ok_e.all()), "[shard predicate] a bitmask lane differs from "
          "the masked brute force")

    # ---- streaming: a delta of the config's capacity per shard
    ins_v, ins_a, n_copy, n_exact = stream_rows(
        index, di, Q, lo, hi, ids, dev, seed=13, count=SHARD_INSERTS)
    rng = np.random.default_rng(14)
    top1 = np.unique(ids[:, 0][ids[:, 0] >= 0])
    rest = np.setdiff1d(np.arange(n), top1)
    base_dels = np.concatenate([top1, rng.choice(rest, SHARD_BASE_DELETES,
                                                 replace=False)])
    delta_dels = n + rng.choice(SHARD_INSERTS, SHARD_DELTA_DELETES,
                                replace=False)
    dels = rng.permutation(np.concatenate([base_dels, delta_dels]))
    dead = np.zeros(n + SHARD_INSERTS, bool)
    dead[dels] = True

    def vec_of(e):
        return np.where((e < n)[:, None], vecs[np.minimum(e, n - 1)],
                        ins_v[np.maximum(e - n, 0)])

    def attrs_of(e):
        return np.where((e < n)[:, None], attrs[np.minimum(e, n - 1)],
                        ins_a[np.maximum(e - n, 0)])

    svc.enable_streaming(capacity=cfg.delta_capacity,
                         build_config=KHIConfig(M=cfg.M, builder="device"))
    ins_s, exts = stream_inserts(svc, ins_v, ins_a)
    check(np.array_equal(exts, np.arange(n, n + SHARD_INSERTS)),
          "[shard stream] the inserts got other ext ids")
    del_s = stream_deletes(svc, dels)
    snap = svc.snapshot()
    n_live = n + SHARD_INSERTS - len(dels)
    check(snap["n_live"] == n_live and snap["tombstones"] == len(base_dels)
          and snap["delta_fill"] == [SHARD_INSERTS // S] * S,
          f"[shard stream] snapshot after the writes: {snap}")
    print(f"[shard stream] {S} deltas of {cfg.delta_capacity} rows: "
          f"{SHARD_INSERTS} inserts ({n_copy} copies of in-box base rows, "
          f"{n_exact} exact) in {ins_s:.3f}s ({SHARD_INSERTS / ins_s:.0f} "
          f"rows/s), routed by ext % {S} (fills {snap['delta_fill']}); "
          f"{len(dels)} deletes ({len(base_dels)} base, {len(delta_dels)} "
          f"delta) in 8 bursts in {del_s:.3f}s ({len(dels) / del_s:.0f} "
          f"rows/s); n_live {snap['n_live']}", flush=True)
    s_ids, s_d, s_launch = timed_serve(svc, serve_bursts, Q,
                                       "[shard stream] f32:")
    check(s_launch.get("scan_topk", 0) > 0
          and s_launch.get("gather_l2_filter", 0) > 0,
          "[shard stream] a kernel of the path was never launched")
    stream_lanes_ok(s_ids, s_d, Q, lo, hi, vec_of, attrs_of, dead,
                    "[shard stream]")
    use_st = svc._planner.plan(lo, hi).use_scan
    ssi, sgi = np.nonzero(use_st)[0], np.nonzero(~use_st)[0]
    # the live truth: each shard's plain scan on its tombstoned attrs,
    # merged in (dist, shard, local) order, then the live delta's plain
    # scan by (dist, ext) (the base's ids are its exts in this epoch)
    t0 = time.perf_counter()
    b_ids, b_d = per_shard_truth(svc.index, Q, lo, hi, k, dev)
    d_live = ~dead[n:]
    d_ids, d_d = delta_truth(ins_v[d_live], ins_a[d_live],
                             np.arange(n, n + SHARD_INSERTS)[d_live], Q, lo,
                             hi, k, dev)
    lt_ids, lt_d = sref.merge_dist_ext([(b_ids, b_d), (d_ids, d_d)], k)
    ok_st = lanes_exact(s_ids[ssi], s_d[ssi], lt_ids[ssi], lt_d[ssi])
    # graph lanes: the sharded program on the tombstoned index, merged
    # with the numpy delta by (dist, ext)
    g_ids, g_d, _, _ = svc._planner.search(Q[sgi], lo[sgi], hi[sgi])
    gm = sref.merge_dist_ext([(g_ids.astype(np.int64), g_d),
                              (d_ids[sgi], d_d[sgi])], k)
    ok_sg = lanes_exact(s_ids[sgi], s_d[sgi], *gm)
    share = float((s_ids >= n).any(1).sum() / max(1, (s_ids >= 0).any(1)
                                                   .sum()))
    print(f"[shard stream] scan lanes ({len(ssi)}) equal to the live brute "
          f"force (each shard's plain scan on the tombstoned attrs, merged, "
          f"+ the live delta's, by (dist, ext)) on "
          f"{int(ok_st.sum())}; graph lanes ({len(sgi)}) equal to the "
          f"sharded graph program merged with the live delta's truth on "
          f"{int(ok_sg.sum())}; lanes holding a delta row {share:.4f} of the "
          f"answered ({time.perf_counter() - t0:.1f}s on the host)",
          flush=True)
    check(bool(ok_st.all()) and bool(ok_sg.all()),
          "[shard stream] the answers differ from the live corpus")
    check(share > 0, "[shard stream] no answered lane holds a delta row")

    # ---- one compaction through build_sharded, timed by phase
    st = svc._stream
    marks = {}
    live_corpus, stack = st.live_corpus, sh_mod.stack_shards

    def timed(fn, name):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            marks[name] = time.perf_counter() - t
            return out
        return call

    st.live_corpus = timed(live_corpus, "gather")
    sh_mod.stack_shards = timed(stack, "stack")
    try:
        _, cper, comp_s = build_timed(svc.compact)
    finally:
        del st.live_corpus
        sh_mod.stack_shards = stack
    post = svc.snapshot()
    builds = sum(t for t, *_ in cper)
    print(f"[shard stream] compaction through build_sharded in {comp_s:.1f}s:"
          f" live_corpus gather {marks['gather']:.1f}s, {S} shard builds "
          f"{builds:.1f}s (" + ", ".join(
              f"{ix.n} rows {t:.1f}s, l2dist_qn {l2_s(c):.1f}s"
              for t, ix, c in cper)
          + f"), stack_shards {marks['stack']:.1f}s, install "
          f"{comp_s - marks['gather'] - builds - marks['stack']:.1f}s; "
          f"n_live {snap['n_live']} -> {post['n_live']}, tombstones "
          f"{post['tombstones']}, delta_fill {post['delta_fill']}, epoch "
          f"{post['epoch']}", flush=True)
    check(len(cper) == S and post["tombstones"] == 0
          and post["delta_fill"] == [0] * S and post["n_live"] == n_live
          and svc.index.num_shards == S,
          f"[shard stream] snapshot after the compaction: {post}")
    for ix in (ix for _, ix, _ in cper):
        ix.nbrs = None
    post_scan = svc._planner.plan(lo[ssi], hi[ssi]).use_scan
    ids2, d2 = svc.search(Q[ssi], lo[ssi], hi[ssi])
    ok2 = lanes_exact(ids2, d2, s_ids[ssi], s_d[ssi])
    same2 = (ids2 == s_ids[ssi]).all(1) & (d2 == s_d[ssi]).all(1)
    print(f"[shard stream] after the compaction, the {len(ssi)} scan lanes "
          f"({int(post_scan.sum())} still dispatched to the scan): equal to "
          f"the answers before it on {int(ok2[post_scan].sum())} "
          f"({int(same2[post_scan].sum())} bit for bit); the pass took "
          f"{time.perf_counter() - t_pass:.1f}s", flush=True)
    check(bool(ok2[post_scan].all()),
          "[shard stream] scan lanes changed across the compaction")
    s0 = skhi.di.shard(0)
    s0 = dataclasses.replace(s0, **{
        f: getattr(s0, f).clone() for f in ("vecs", "attrs", "nbrs", "left",
                                            "right", "dim", "bl", "lo", "hi",
                                            "start", "count", "order")})
    del svc, skhi
    torch.cuda.empty_cache()
    return hosts[0], s0


SLO_FAULTS = "device_error%0,device_error@3,latency:50ms@5"
SLO_TRICKLE_S = 0.005          # the first half arrives one every 5 ms
SLO_INT8_LADDER = "ef=64,ef=32+expand_width=1+quant=int8"


def slo_pass(index, di, params, cfg, Q, lo, hi, is_s, f32_ids, use_scan,
             t_ids, t_d, ref_ent, dev, rows) -> None:
    """Degradation tiers and the SLO scheduler on the index already built,
    at the config's policy (``cfg.scheduler_config()``: slo_ms, qdepth,
    the ladder). (1) A fresh f32 service takes the ladder and warms every
    tier's buckets. (2) Each tier answers the 384 requests directly on an
    emptied cache: tier 0 equal to the main path's f32 answers; tiers 1-2's
    graph lanes equal to smoke_reference.beam_search at the tier's ef,
    c_n, E and hops() from the main path's reference entries on every
    lane, their scan lanes exact against the brute force; recall@10 by
    selectivity. (3) Backlog: the 384 requests at once, pumped, at
    thresholds (64, 128) with deadlines far off, through a service of
    buckets (1, 8, 32) (at the cell's 256-lane batch the backlog drains
    in two batches, which cannot cross two thresholds): every tier serves,
    every Served record equal to its tier's direct answer. (4) Open loop
    at the policy on the worker thread: 192 requests one every 5 ms, then
    192 at one instant, two tenants, ``SLO_FAULTS`` armed and a request
    dead on arrival last; checked: nothing dropped, the accounting, the
    faults reconciled with the injector's log, no device error that was
    not injected (a failing kernel would show here: the scheduler turns
    any exception into typed records), ticket 0 the only fault rejection,
    the other lanes of failed batches served after one retry, every Served
    record equal to its tier's direct answer, no plain version on the
    card; expiries are reported, not held to a bar. (5) An int8-bottom
    ladder on another service: one replica, attached once; its bottom
    tier held to smoke_reference's int8 beam search + f32 rerank and scan
    over-fetch + rerank at the tier's params (the int8 pass's 95% bar)."""
    import smoke_reference as sref
    from repro_torch.core import engine as eng
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import (FaultInjector, KHIService, Rejected,
                                   Request, Served, ServeConfig,
                                   SLOScheduler, TierSpec, replay_open_loop)

    t_pass = time.perf_counter()
    policy = cfg.scheduler_config()
    serve_cfg = ServeConfig(buckets=cfg.buckets, cache_size=cfg.cache_size)
    svc = KHIService(di, params, config=serve_cfg)
    svc.set_tiers([s.apply(svc.params) for s in policy.ladder])
    tp = svc._tier_params
    check(all((p.c_e, p.c_n, p.scan_budget, p.frontier_cap, p.k)
              == (tp[0].c_e, tp[0].c_n, tp[0].scan_budget,
                  tp[0].frontier_cap, tp[0].k) for p in tp),
          "[slo] a tier changed the router's inputs or k")
    t0 = time.perf_counter()
    for t in range(svc.n_tiers):        # every tier's buckets, other keys
        for b in svc.config.buckets:
            svc.search(Q[:b] + np.float32(2e-3), lo[:b], hi[:b], tier=t)
    torch.cuda.synchronize()
    print(f"[slo] policy: slo {policy.slo_ms} ms, qdepth {policy.qdepth}, "
          f"ladder {cfg.degrade_ladder!r}, thresholds "
          f"{policy.resolved_thresholds()}; tiers "
          + "; ".join(f"{t}: ef={p.ef} E={p.expand_width} hops<={p.hops()}"
                      for t, p in enumerate(tp))
          + f"; every tier's buckets warmed in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # ---- (2) each tier's direct answers
    gi, si = np.nonzero(~use_scan)[0], np.nonzero(use_scan)[0]
    sel = {"1/4": np.nonzero(~is_s)[0], "1/64": np.nonzero(is_s)[0]}
    nbrs = di.nbrs.cpu().numpy()
    direct = {}
    for t, p in enumerate(tp):
        svc._cache.clear()
        t0 = time.perf_counter()
        ids_t, d_t = svc.search(Q, lo, hi, tier=t)
        dt = time.perf_counter() - t0
        direct[t] = ids_t
        check_served(ids_t, d_t, index.vecs, index.attrs, Q, lo, hi,
                     f"[slo] tier {t}")
        exact = lanes_exact(ids_t[si], d_t[si], t_ids[si], t_d[si])
        check(bool(exact.all()), f"[slo] tier {t}: scan lanes not exact on "
              f"{int((~exact).sum())} lanes")
        rec = {k: recall(ids_t[i], t_ids[i]) for k, i in sel.items()}
        line = (f"[slo] tier {t} direct: {len(Q)} requests in {dt:.3f}s "
                f"({len(Q) / dt:.1f} QPS); recall@{cfg.k} "
                + ", ".join(f"{k} lanes {r:.4f}" for k, r in rec.items())
                + f"; scan lanes exact on {int(exact.sum())} of {len(si)}")
        if t == 0:
            check(np.array_equal(ids_t, f32_ids),
                  "[slo] tier 0 differs from the main path's f32 answers")
            print(line + "; ids equal to the main path's", flush=True)
            continue
        g_ids, _, g_hops, _ = svc._get_planner(t).search(Q[gi], lo[gi],
                                                         hi[gi])
        check(np.array_equal(g_ids, ids_t[gi]),
              f"[slo] tier {t}: served graph lanes differ from the graph "
              f"program's")
        t0 = time.perf_counter()
        ref_out = [sref.beam_search(index.vecs, index.attrs, nbrs, e, Q[i],
                                    lo[i], hi[i], k=cfg.k, ef=p.ef,
                                    c_n=p.c_n, E=p.expand_width,
                                    max_hops=p.hops())
                   for e, i in zip(ref_ent, gi)]
        same_ids = int((g_ids == np.stack([r[0] for r in ref_out]))
                       .all(1).sum())
        same_hops = int((g_hops == np.array([r[2] for r in ref_out])).sum())
        print(line + f"; graph lanes: ids equal to the numpy beam search on "
              f"{same_ids} of {len(gi)}, hops on {same_hops} (mean hops "
              f"{g_hops.mean():.1f}; reference "
              f"{time.perf_counter() - t0:.1f}s on the host)", flush=True)
        check(same_ids == len(gi) and same_hops >= 0.95 * len(gi),
              f"[slo] tier {t}: the hop loop disagrees with the numpy beam "
              f"search")
    del nbrs

    # ---- (3) a backlog down the ladder
    svc_b = KHIService(di, params, config=ServeConfig(buckets=(1, 8, 32),
                                                      cache_size=0))
    sched = SLOScheduler(svc_b, dataclasses.replace(
        policy, tier_thresholds=(64, 128), slo_ms=3_600_000.0),
        autostart=False)
    t0 = time.perf_counter()
    tickets = [sched.submit(Request(Q[i], lo[i], hi[i]), tenant=f"t{i % 2}")
               for i in range(len(Q))]
    while sched.pump():
        pass
    snap = sched.shutdown(drain=True)
    dt = time.perf_counter() - t0
    recs = [sched.result(t, timeout=0) for t in tickets]
    same = sum(isinstance(r, Served) and np.array_equal(
        r.result.ids, direct[r.tier][i]) for i, r in enumerate(recs))
    print(f"[slo] backlog: {len(Q)} requests at once, thresholds (64, 128), "
          f"batches of <= 32: {snap['batches']} batches in {dt:.2f}s, tiers "
          f"{snap['tier_served']}; Served ids equal to the tier's direct "
          f"answer on {same} of {len(Q)}", flush=True)
    check(set(snap["tier_served"]) == {"0", "1", "2"} and snap["dropped"] == 0,
          "[slo] the backlog did not serve at every tier")
    check(same == len(Q), "[slo] backlog answers differ from the direct ones")
    del svc_b, sched

    # ---- (4) open loop at the config's policy, faults armed
    svc._cache.clear()
    injector = FaultInjector.parse(SLO_FAULTS)
    reqs = [Request(Q[i], lo[i], hi[i]) for i in range(len(Q))]
    h = len(Q) // 2
    arrivals = [i * SLO_TRICKLE_S for i in range(h)]
    arrivals += [h * SLO_TRICKLE_S] * (len(Q) - h)
    ops.reset_launches()
    ref.reset_calls()
    torch.cuda.synchronize()
    sched = SLOScheduler(svc, policy, injector=injector)   # worker thread
    sub_at, timeline = [], []
    execute = sched._execute

    def timed_execute(batch, tier):
        """Each device step's (start, end) on the replay's clock, its
        lanes and tier: where the deadlines went."""
        t0 = time.monotonic() - t_start
        execute(batch, tier)
        timeline.append((t0, time.monotonic() - t_start, len(batch), tier))

    sched._execute = timed_execute

    def submit(item):
        sub_at.append(time.monotonic() - t_start)
        return sched.submit(item[1], tenant=f"t{item[0] % 2}")

    t_start = time.monotonic()
    tickets = replay_open_loop(submit, arrivals, list(enumerate(reqs)))
    t_doa = sched.submit(reqs[1], deadline_ms=0, tenant="t1")
    snap = sched.shutdown(drain=True, timeout=600.0)
    wall = time.monotonic() - t_start
    torch.cuda.synchronize()
    launches = {k: c for k, c in ops.LAUNCHES.items() if c}
    plain_cuda = {k: v["cuda"] for k, v in ref.CALLS.items()}
    recs = [sched.result(t, timeout=0) for t in tickets]
    doa = sched.result(t_doa, timeout=0)
    fired = injector.counts()
    lag = (np.asarray(sub_at) - np.asarray(arrivals)) * 1e3
    n_rej = sum(snap["rejected"].values())
    served = [(i, r) for i, r in enumerate(recs) if isinstance(r, Served)]
    faults = [(i, r) for i, r in enumerate(recs)
              if isinstance(r, Rejected) and r.reason == "fault"]
    other = [r.detail for r in recs if isinstance(r, Rejected)
             and r.reason == "fault" and "injected" not in r.detail]
    failed = {t for rec in injector.fired if rec["kind"] == "device_error"
              for t in rec["tickets"]} - {0}
    lat = {}
    for _, r in served:
        lat.setdefault(r.tier, []).append(r.latency_ms)
    same = sum(np.array_equal(r.result.ids, direct[r.tier][i])
               for i, r in served)
    print(f"[slo] open loop: {len(Q) + 1} submitted ({h} one every "
          f"{SLO_TRICKLE_S * 1e3:.0f} ms, {len(Q) - h} at "
          f"{arrivals[-1]:.3f}s, 1 dead on arrival) in {wall:.3f}s: served "
          f"{snap['served']} ({snap['served'] / wall:.1f} served/s), "
          f"rejected {snap['rejected']}, dropped {snap['dropped']}; tier mix "
          f"{snap['tier_served']}; batches {snap['batches']}, steps "
          f"{snap['steps']}, expired in queue {snap['expired_in_queue']}, "
          f"deadline breaches {snap['deadline_breaches']}", flush=True)
    print(f"[slo] open loop: latency ms by tier "
          + "; ".join(f"{t}: p50 {np.percentile(v, 50):.1f} p99 "
                      f"{np.percentile(v, 99):.1f} (n={len(v)})"
                      for t, v in sorted(lat.items()))
          + f"; EMA ms by tier {snap['ema_ms']}; arrival lag ms mean "
          f"{lag.mean():.3f} max {lag.max():.3f}; faults fired {fired}, "
          f"batch failures {snap['batch_failures']}, retries "
          f"{snap['retries']}, lane failures {snap['lane_failures']}, "
          f"injected {snap['injected_faults']}, device errors "
          f"{snap['device_errors']}; launches {launches}; plain-version "
          f"CUDA calls {plain_cuda}; Served ids equal to the tier's direct "
          f"answer on {same} of {len(served)}", flush=True)
    print("[slo] open loop batches (start-end s on the replay's clock, "
          "lanes, tier): " + ", ".join(f"{a:.3f}-{b:.3f} {n}@{t}"
                                       for a, b, n, t in timeline),
          flush=True)
    check(not other, f"[slo] device errors that were not injected: {other}")
    check(snap["device_errors"] == 0, "[slo] device_errors != 0")
    check(snap["dropped"] == 0 and snap["served"] + n_rej == len(Q) + 1,
          f"[slo] accounting: {snap}")
    check(sum(snap["tier_served"].values()) == snap["served"],
          "[slo] the tier mix does not sum to the served total")
    check(isinstance(doa, Rejected) and doa.reason == "expired",
          f"[slo] the dead-on-arrival request ended {doa}")
    check(snap["injected_faults"] == fired["device_error"]
          and snap["retries"] == snap["batch_failures"] >= 2,
          "[slo] the faults do not reconcile with the injector's log")
    check(len(faults) == 1 and faults[0][0] == 0
          and snap["lane_failures"] == 1,
          f"[slo] fault rejections {[i for i, _ in faults]}, expected "
          f"ticket 0 alone")
    check(all((isinstance(recs[t], Served) and recs[t].retries == 1)
              or (isinstance(recs[t], Rejected)
                  and recs[t].reason == "expired") for t in failed),
          "[slo] a lane of a failed batch was not served after its retry")
    check(same == len(served),
          "[slo] open-loop answers differ from the direct ones")
    check(all(v == 0 for v in plain_cuda.values()),
          f"[slo] the run fell through to a plain version: {plain_cuda}")
    for name in ("gather_l2_filter", "scan_topk"):
        check(launches.get(name, 0) > 0, f"[slo] {name} was never launched")
        rows[name]["slo_launches"] = launches.get(name, 0)
    del svc, sched

    # ---- (5) an int8-bottom ladder: one replica, the bottom tier to numpy
    attach = []
    orig = eng.with_quant_replica

    def timed_attach(d, q):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(d, q)
        torch.cuda.synchronize()
        attach.append(time.perf_counter() - t0)
        return out

    svc8 = KHIService(di, params, config=serve_cfg)
    eng.with_quant_replica = timed_attach
    try:
        svc8.set_tiers([s.apply(svc8.params)
                        for s in TierSpec.parse_ladder(SLO_INT8_LADDER)])
        p2 = svc8._tier_params[2]
        ops.reset_launches()
        ref.reset_calls()
        t0 = time.perf_counter()
        ids8, d8 = svc8.search(Q, lo, hi, tier=2)
        dt = time.perf_counter() - t0
        launches = {k: c for k, c in ops.LAUNCHES.items() if c}
        plain_cuda = {k: v["cuda"] for k, v in ref.CALLS.items()}
        g8, _, h8, _ = svc8._get_planner(2).search(Q[gi], lo[gi], hi[gi])
        shared = all(svc8._get_planner(t).index.qvecs is svc8.index.qvecs
                     for t in range(3))
    finally:
        eng.with_quant_replica = orig
    qv, qs = svc8.index.qvecs, svc8.index.qscale
    gib = (qv.numel() * qv.element_size() + qs.numel() * 4) / 2**30
    check_served(ids8, d8, index.vecs, index.attrs, Q, lo, hi,
                 "[slo int8] tier 2")
    check(np.array_equal(g8, ids8[gi]), "[slo int8] served graph lanes "
          "differ from the graph program's")
    check(len(attach) == 1 and shared and svc8._tier_params[0].quant == "none",
          f"[slo int8] the replica was attached {len(attach)} times, shared "
          f"by every tier's planner: {shared}")
    check(all(v == 0 for v in plain_cuda.values()),
          f"[slo int8] the path fell through to a plain version: "
          f"{plain_cuda}")
    for name in ("gather_l2_filter_q8", "scan_topk_q8", "gather_l2_filter"):
        check(launches.get(name, 0) > 0, f"[slo int8] {name} was never "
              f"launched")
    for name in ("gather_l2_filter_q8", "scan_topk_q8"):
        rows[name]["slo_launches"] = launches.get(name, 0)
    t0 = time.perf_counter()
    deq = sref.dequant_rows(qv.cpu().numpy(), qs.cpu().numpy())
    nbrs = di.nbrs.cpu().numpy()
    rr = max(p2.k, min(p2.ef, p2.k * p2.rerank_mult))
    same_ids = same_hops = 0
    for j, i in enumerate(gi):
        cand, _, hops = sref.beam_search(
            deq, index.attrs, nbrs, ref_ent[j], Q[i], lo[i], hi[i], k=rr,
            ef=p2.ef, c_n=p2.c_n, E=p2.expand_width, max_hops=p2.hops())
        r_ids, _ = sref.rerank(index.vecs, cand, Q[i], p2.k)
        same_ids += bool((r_ids == g8[j]).all())
        same_hops += int(hops == h8[j])
    del nbrs
    kq = min(max(p2.k, p2.k * p2.rerank_mult), len(index.vecs))
    ss = lane_sample(si)
    same_scan = sum(bool((sref.scan_rerank(
        deq, index.vecs, index.attrs, Q[i], lo[i], hi[i], k=p2.k, kq=kq)[0]
        == ids8[i]).all()) for i in ss)
    del deq
    rec = {k: recall(ids8[i], t_ids[i]) for k, i in sel.items()}
    print(f"[slo int8] ladder {SLO_INT8_LADDER!r}: the replica ({gib:.3f} "
          f"GiB) attached once in {attach[0]:.3f}s, shared by the 3 tiers' "
          f"planners; tier 2 (ef={p2.ef} E={p2.expand_width}): {len(Q)} "
          f"requests in {dt:.3f}s; recall@{cfg.k} "
          + ", ".join(f"{k} lanes {r:.4f}" for k, r in rec.items())
          + f"; graph lanes equal to the numpy int8 beam search + f32 rerank "
          f"(rr={rr}) on {same_ids} of {len(gi)}, hops on {same_hops}; scan "
          f"lanes equal to the numpy over-fetch (kq={kq}) + rerank on "
          f"{same_scan} of {len(ss)} sampled (of {len(si)}; "
          f"{time.perf_counter() - t0:.1f}s on "
          f"the host); launches {launches}; plain-version CUDA calls "
          f"{plain_cuda}", flush=True)
    check(same_ids >= 0.95 * len(gi) and same_hops >= 0.95 * len(gi)
          and same_scan >= 0.95 * len(ss),
          "[slo int8] tier 2 disagrees with the numpy reference")
    del svc8
    print(f"[slo] pass took {time.perf_counter() - t_pass:.1f}s", flush=True)


# ------------------------------------------------------------ streaming

STREAM_INSERTS = 65_536
STREAM_BASE_DELETES = 16_384
STREAM_DELTA_DELETES = 4_096
INSERT_BURSTS = (1, 8192, 37, 4096, 256, 2048, 1000, 8, 512, 64, 3000)


def stream_rows(index, di, Q, lo, hi, served_ids, dev, seed: int = 11,
                count: int = 0):
    """The rows the streaming pass inserts, in insertion order: half are
    copies of distinct base rows inside the served boxes (each lane's
    served answer, then other rows of its box), a quarter of them exact
    (the served answers among them) and the rest perturbed by N(0, 1e-3)
    per element, so each competes with its base row for the same lanes
    and forces (dist, ext) ties and near-ties; half are fresh rows of the
    same generator at another seed.
    ``count`` rows in all (STREAM_INSERTS unless given). Returns (vecs,
    attrs, copies, exact copies)."""
    from repro_torch.data import DatasetSpec, make_dataset

    rng = np.random.default_rng(seed)
    d = index.vecs.shape[1]
    count = count or STREAM_INSERTS
    half = count // 2
    per = -(-2 * half // len(Q))
    tl = torch.as_tensor(lo).to(dev)
    th = torch.as_tensor(hi).to(dev)
    picks = []
    for i in range(len(Q)):
        inb = ((di.attrs >= tl[i]) & (di.attrs <= th[i])).all(1)
        rows = torch.nonzero(inb)[:, 0].cpu().numpy()
        own = served_ids[i][served_ids[i] >= 0]
        extra = rng.choice(rows, size=min(len(rows), per), replace=False)
        picks.append(np.concatenate([own, extra])[:per])
    picks = np.concatenate(picks)
    picks = picks[np.sort(np.unique(picks, return_index=True)[1])][:half]
    # the exact copies: every served answer's first, then others at random
    own = np.isin(picks, served_ids[served_ids >= 0])
    n_exact = len(picks) // 4
    exact = np.concatenate([np.nonzero(own)[0],
                            rng.permutation(np.nonzero(~own)[0])])[:n_exact]
    noise = rng.normal(0, 1e-3, (len(picks), d)).astype(np.float32)
    noise[exact] = 0
    cv = index.vecs[picks] + noise
    spec = DatasetSpec("khi-serve", n=count, d=d,
                       m=index.attrs.shape[1],
                       attr_kinds=("year", "lognormal", "lognormal",
                                   "lognormal"),
                       attr_corr=0.85, n_clusters=64, seed=5)
    fv, fa = make_dataset(spec)
    nf = count - len(picks)
    vecs = np.concatenate([cv, fv[:nf]])
    attrs = np.concatenate([index.attrs[picks], fa[:nf]])
    order = rng.permutation(len(vecs))
    return (np.ascontiguousarray(vecs[order]),
            np.ascontiguousarray(attrs[order]), len(picks), n_exact)


def stream_inserts(svc, vecs, attrs):
    """Insert ``vecs``/``attrs`` in bursts of INSERT_BURSTS sizes; returns
    (seconds, ext ids)."""
    exts, s, i = [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while s < len(vecs):
        b = min(INSERT_BURSTS[i % len(INSERT_BURSTS)], len(vecs) - s)
        exts.append(svc.insert(vecs[s:s + b], attrs[s:s + b]))
        s += b
        i += 1
    torch.cuda.synchronize()
    return time.perf_counter() - t0, np.concatenate(exts)


def stream_deletes(svc, dels):
    """Delete ``dels`` in 8 bursts; returns the seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_del = sum(svc.delete(part) for part in np.array_split(dels, 8))
    torch.cuda.synchronize()
    check(n_del == len(dels), f"deleted {n_del} of {len(dels)} rows")
    return time.perf_counter() - t0


def timed_serve(svc, serve_bursts, Q, tag):
    """The warm-up pass, then the 384 requests, the launch counts set to
    0 just before the served run and read just after. Each layer of the
    served path is timed on the host over all its calls: the planner's
    plan, its graph and scan programs (each returns numpy, so its card
    time is inside), and under streaming the delta scan and the merge
    around it; "service" is the rest (keys, cache, padding). Beside them:
    the main thread's CPU time, the collector's and the new card
    segments. Prints the split; returns (ids, dists, launches). Over a
    sharded index the delta scan sums every shard's segment."""
    from repro_torch.kernels import ops, ref

    pl = svc._planner
    layers = [(pl, "plan", "plan"), (pl, "_run_graph", "graph program"),
              (pl, "_run_scan", "scan program")]
    if svc._stream is not None:
        layers += [(seg, "scan", "delta scan") for seg in svc._stream.deltas]
        layers += [(svc._stream, "merge", "merge")]
    marks = {name: (0, 0.0) for _, _, name in layers}

    def timed(fn, name):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            n, sec = marks[name]
            marks[name] = (n + 1, sec + time.perf_counter() - t)
            return out
        return call

    # the host beside the layers: Python's collector (time in collections),
    # the main thread's CPU time against the wall, and the caching
    # allocator's new card segments (cudaMalloc calls)
    gc_ms, gc_t0 = [0.0, 0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3
            gc_ms[1] += 1

    serve_bursts(svc, Q + np.float32(1e-3))         # warm-up, other keys
    before = svc.snapshot()["batches"]
    for obj, attr, name in layers:
        setattr(obj, attr, timed(getattr(obj, attr), name))
    ops.reset_launches()
    ref.reset_calls()
    torch.cuda.synchronize()
    segs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    gc.callbacks.append(on_gc)
    try:
        t0, c0 = time.perf_counter(), time.thread_time()
        results = serve_bursts(svc, Q)
        torch.cuda.synchronize()
        dt, cpu = time.perf_counter() - t0, time.thread_time() - c0
    finally:
        gc.callbacks.remove(on_gc)
        for obj, attr, _ in layers:
            delattr(obj, attr)
    segs = torch.cuda.memory_stats().get("segment.all.allocated", 0) - segs
    launches = dict(ops.LAUNCHES)
    plain_cuda = {k: v["cuda"] for k, v in ref.CALLS.items()}
    batches = svc.snapshot()["batches"] - before
    ms = {name: sec * 1e3 for name, (_, sec) in marks.items()}
    if "merge" in ms:
        ms["merge"] -= ms["delta scan"]
    ms["service"] = dt * 1e3 - sum(ms.values())
    print(f"{tag} {len(Q)} requests in {dt:.3f}s ({len(Q) / dt:.1f} QPS "
          f"end-to-end), {batches} batches; host ms by layer: "
          + ", ".join(f"{name} {t:.1f}" for name, t in ms.items())
          + f"; main thread CPU {cpu * 1e3:.1f} of the wall's "
          f"{dt * 1e3:.1f}; gc {gc_ms[0]:.1f} ms in {gc_ms[1]} collections "
          f"({len(gc.get_objects())} tracked objects); {segs} cudaMalloc; "
          f"launches { {k: c for k, c in launches.items() if c} }; "
          f"plain-version CUDA calls "
          f"{ {k: c for k, c in plain_cuda.items() if c} }", flush=True)
    check(all(v == 0 for v in plain_cuda.values()),
          f"{tag} the path fell through to a plain version: {plain_cuda}")
    ids = np.stack([r.ids for r in results])
    dists = np.stack([r.dists for r in results])
    if svc._stream is not None:
        check(ids.dtype == np.int64, f"{tag} the answers are not int64 ext "
              f"ids")
        check(marks["delta scan"][0] == batches * len(svc._stream.deltas),
              f"{tag} a batch skipped a delta scan")
    return ids, dists, launches


def delta_truth(vecs, attrs, exts, Q, lo, hi, k: int, dev):
    """The exact in-box top-k over rows carrying the ascending external
    ids ``exts`` (the live delta rows), by the plain scan on the card:
    (ext ids (B, k) int64, -1 padded; dists (B, k)); its ties go to the
    lower row, so to the lower ext."""
    from repro_torch.kernels import ref

    v = torch.as_tensor(np.ascontiguousarray(vecs)).to(dev)
    a = torch.as_tensor(np.ascontiguousarray(attrs)).to(dev)
    out_i, out_d = [], []
    for s in range(0, len(Q), 64):
        qq, ql, qh = (torch.as_tensor(x[s:s + 64]).to(dev)
                      for x in (Q, lo, hi))
        i, d = ref.scan_topk_ref(v, a, qq, ql, qh, k)
        i = i.cpu().numpy().astype(np.int64)
        out_i.append(np.where(i >= 0, exts[np.maximum(i, 0)], -1))
        out_d.append(d.cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_d)


def stream_lanes_ok(ids, dists, Q, lo, hi, vec_of, attrs_of, dead, tag):
    """Every lane: no deleted ext, every returned row in its box, distinct,
    ascending, distances within rtol 1e-4 of float64."""
    for i in range(len(Q)):
        got = ids[i][ids[i] >= 0]
        check(not dead[got].any(), f"{tag} lane {i}: a deleted ext served")
        check(len(set(got.tolist())) == len(got),
              f"{tag} lane {i}: duplicate ids")
        a = attrs_of(got)
        check(bool(((a >= lo[i]) & (a <= hi[i])).all()),
              f"{tag} lane {i}: an id outside the box was served")
        dd = dists[i][:len(got)]
        check(bool((np.diff(dd) >= 0).all()), f"{tag} lane {i}: not ascending")
        exact = ((vec_of(got).astype(np.float64) - Q[i]) ** 2).sum(1)
        check(bool(np.allclose(dd, exact, rtol=1e-4, atol=1e-8)),
              f"{tag} lane {i}: served distances are not the exact ones")


def stream_pass(index, di, params, cfg, Q, lo, hi, serve_bursts,
                dev) -> None:
    """The streaming write path at full width on ``index``, shard 0 of the
    shard pass's index (250,000 rows at n = 1M: its scale cut from the
    main path's 1M rows so that the script fits its time limit; the
    widths, the config's ``delta_capacity`` and the writes kept; the scan
    threshold 10% of its n): ``enable_streaming(capacity=
    cfg.delta_capacity)``; 65,536 inserts in
    bursts of 1 to 8,192 rows (``stream_rows``); deletes of every served
    lane's pre-streaming top-1 row, 16,384 random base rows and 4,096
    inserted rows; the 384 requests served and checked (scan lanes equal
    to the brute force over the live corpus: the base's plain scan on the
    tombstoned attrs merged with the numpy delta by (dist, ext); graph
    lanes' base part equal to the numpy DFS and beam search on the
    tombstoned attrs, the merged answer to that part merged with the numpy
    delta; every lane free of deleted ids and inside its box). The f32
    service is also served before streaming and between the inserts and
    the deletes, each run split by layer, and its programs are traced. A
    graph service on the unfused gather scans its delta with the box-scan
    kernel. The same writes on an int8 service with its own delta: scan
    lanes held to the numpy over-fetch + rerank, graph lanes to the numpy
    int8 beam search + rerank, each merged with the numpy int8 delta. The
    delta scan's kernel against its plain version, timed at the served, a
    full and an empty delta; then one compaction, timed by phase, whose
    scan lanes equal the answers before it and whose graph passes the
    builder and hop-loop checks."""
    import smoke_reference as sref
    from repro_torch.core import KHIConfig
    from repro_torch.core import khi as khi_mod
    from repro_torch.core.delta import DeltaSegment
    from repro_torch.core.engine import Planner, with_quant_replica
    from repro_torch.core.router import route_level_sync
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import KHIService, ServeConfig

    n, d = index.vecs.shape
    k = cfg.k
    cap = cfg.delta_capacity
    params = dataclasses.replace(params, scan_threshold=max(1, n // 10))
    print(f"[stream] the index: {n} rows (d={d}, M={cfg.M}), scan "
          f"threshold {params.scan_threshold} (10% of n)", flush=True)

    # ---- f32 service: served before streaming (its answers pick the rows
    # the pass inserts and deletes), after the inserts and after the
    # deletes, each run split by layer
    svc = KHIService(di, params, config=ServeConfig(
        buckets=cfg.buckets, cache_size=cfg.cache_size))
    print(f"[stream] host per PyTorch launch {launch_us(dev):.2f} us",
          flush=True)
    served_ids = timed_serve(svc, serve_bursts, Q,
                             "[stream] f32, before streaming:")[0]
    t0 = time.perf_counter()
    ins_v, ins_a, n_copy, n_exact = stream_rows(index, di, Q, lo, hi,
                                                served_ids, dev)
    rng = np.random.default_rng(12)
    top1 = np.unique(served_ids[:, 0][served_ids[:, 0] >= 0])
    rest = np.setdiff1d(np.arange(n), top1)
    base_dels = np.concatenate([top1, rng.choice(rest, STREAM_BASE_DELETES,
                                                 replace=False)])
    delta_dels = n + rng.choice(STREAM_INSERTS, STREAM_DELTA_DELETES,
                                replace=False)
    dels = rng.permutation(np.concatenate([base_dels, delta_dels]))
    print(f"[stream] rows: {STREAM_INSERTS} to insert ({n_copy} copies of "
          f"distinct in-box base rows, {n_exact} of them exact and the rest "
          f"at N(0, 1e-3); the rest fresh), "
          f"{len(dels)} to delete ({len(top1)} served top-1 rows, "
          f"{STREAM_BASE_DELETES} random base rows, {STREAM_DELTA_DELETES} "
          f"inserted rows); made in {time.perf_counter() - t0:.1f}s",
          flush=True)

    dead = np.zeros(n + STREAM_INSERTS, bool)
    dead[dels] = True
    delta_live = ~dead[n:]
    delta_exts = np.arange(n, n + STREAM_INSERTS)

    def vec_of(e):
        return np.where((e < n)[:, None], index.vecs[np.minimum(e, n - 1)],
                        ins_v[np.maximum(e - n, 0)])

    def attrs_of(e):
        return np.where((e < n)[:, None], index.attrs[np.minimum(e, n - 1)],
                        ins_a[np.maximum(e - n, 0)])

    svc.enable_streaming(capacity=cap, build_config=KHIConfig(
        M=cfg.M, builder="device"))
    ins_s, exts = stream_inserts(svc, ins_v, ins_a)
    check(np.array_equal(exts, delta_exts), "the inserts got other ext ids")
    timed_serve(svc, serve_bursts, Q, "[stream] f32, after the inserts:")
    del_s = stream_deletes(svc, dels)
    snap = svc.snapshot()
    n_live = n + STREAM_INSERTS - len(dels)
    check(snap["n_live"] == n_live and snap["tombstones"] == len(base_dels)
          and snap["delta_fill"] == [STREAM_INSERTS],
          f"snapshot after the writes: {snap}")
    print(f"[stream] capacity {cap} ({cap * (4 * d + 4 * cfg.m) / 1e6:.0f} MB"
          f" of f32 delta): {STREAM_INSERTS} inserts in {ins_s:.3f}s "
          f"({STREAM_INSERTS / ins_s:.0f} rows/s) in bursts of "
          f"{sorted(set(INSERT_BURSTS))} rows; {len(dels)} deletes in 8 "
          f"bursts in {del_s:.3f}s ({len(dels) / del_s:.0f} rows/s); n_live "
          f"{snap['n_live']}, tombstones {snap['tombstones']}", flush=True)

    ids, dists, launches = timed_serve(svc, serve_bursts, Q,
                                       "[stream] f32, after the deletes:")
    for name in ("scan_topk", "gather_l2_filter"):
        check(launches[name] > 0, f"[stream] {name} was never launched")
    stream_lanes_ok(ids, dists, Q, lo, hi, vec_of, attrs_of, dead,
                    "[stream]")
    use_scan = svc._planner.plan(lo, hi).use_scan
    trace_programs("stream f32", svc.index, svc.params, Q, lo, hi,
                   split_lanes(use_scan), planner=svc._planner)

    # ---- the truth: base plain scan on the tombstoned attrs + numpy delta
    t0 = time.perf_counter()
    qt = torch.as_tensor(Q).to(dev)
    tl = torch.as_tensor(lo).to(dev)
    th = torch.as_tensor(hi).to(dev)
    b_ids, b_d = [], []
    for s in range(0, len(Q), 64):
        a, b = ref.scan_topk_ref(svc.index.vecs, svc.index.attrs,
                                 qt[s:s + 64], tl[s:s + 64], th[s:s + 64], k)
        b_ids.append(a.cpu().numpy().astype(np.int64))
        b_d.append(b.cpu().numpy())
    b_ids, b_d = np.concatenate(b_ids), np.concatenate(b_d)
    d_ids, d_d = delta_truth(ins_v[delta_live], ins_a[delta_live],
                             delta_exts[delta_live], Q, lo, hi, k, dev)
    t_ids, t_d = sref.merge_dist_ext([(b_ids, b_d), (d_ids, d_d)], k)
    truth_s = time.perf_counter() - t0

    si, gi = np.nonzero(use_scan)[0], np.nonzero(~use_scan)[0]
    ok = lanes_exact(ids[si], dists[si], t_ids[si], t_d[si])
    same = (ids[si] == t_ids[si]).all(1)
    share = float(((ids >= n).any(1)).sum() / max(1, (ids >= 0).any(1).sum()))
    print(f"[stream] scan lanes ({len(si)}): equal to the live brute force "
          f"(base and live delta by the plain scan, merged by (dist, ext)) "
          f"on "
          f"{int(ok.sum())} ({int(same.sum())} with every id equal, the rest "
          f"near-ties); lanes holding a delta row {share:.4f} of the "
          f"answered; truth {truth_s:.1f}s", flush=True)
    check(bool(ok.all()), "[stream] scan lanes differ from the live brute "
          "force")
    check(share > 0, "[stream] no answered lane holds a delta row")

    # graph lanes: the base part against the numpy DFS + beam search on the
    # tombstoned attrs, the merged answer against that part + numpy delta
    p = svc.params
    nan_attrs = svc.index.attrs.cpu().numpy()
    g_ids, g_d, g_hops, _ = svc._planner.search(Q[gi], lo[gi], hi[gi])
    g_ext = g_ids.astype(np.int64)
    merged_e, merged_d = sref.merge_dist_ext(
        [(g_ext, g_d), (d_ids[gi], d_d[gi])], k)
    ok_m = lanes_exact(ids[gi], dists[gi], merged_e, merged_d)
    ent = route_level_sync(svc.index, tl[gi], th[gi], p)[0].cpu().numpy()
    t0 = time.perf_counter()
    ref_ent = [sref.dfs_entries(index.tree, nan_attrs, lo[i], hi[i], p.c_e,
                                p.scan_budget) for i in gi]
    same_ent = sum(ent[j][ent[j] >= 0].tolist() == e
                   for j, e in enumerate(ref_ent))
    nbrs = di.nbrs.cpu().numpy()
    ref_out = [sref.beam_search(index.vecs, nan_attrs, nbrs, e, Q[i], lo[i],
                                hi[i], k=k, ef=p.ef, c_n=p.c_n,
                                E=p.expand_width, max_hops=p.hops())
               for e, i in zip(ref_ent, gi)]
    r_ids = np.stack([r[0] for r in ref_out])
    r_d = np.stack([r[1][:k] for r in ref_out])
    r_hops = np.array([r[2] for r in ref_out])
    same_ids = (g_ids == r_ids).all(1)
    ref_m = sref.merge_dist_ext([(r_ids, r_d), (d_ids[gi], d_d[gi])], k)
    ok_r = lanes_exact(ids[gi], dists[gi], *ref_m)
    print(f"[stream] graph lanes ({len(gi)}): router entries equal to the "
          f"numpy DFS on the tombstoned attrs on {same_ent}, the hop loop's "
          f"ids to the numpy beam search on {int(same_ids.sum())}, hops on "
          f"{int((g_hops == r_hops).sum())} (mean hops {g_hops.mean():.1f}; "
          f"{time.perf_counter() - t0:.1f}s on the host); served lanes "
          f"equal to the base part merged with the numpy delta on "
          f"{int(ok_m.sum())}, to the numpy search merged "
          f"with it on {int(ok_r.sum())}; recall@{k} against the live truth "
          f"{recall(ids[gi], t_ids[gi]):.4f}", flush=True)
    check(same_ent == len(gi), "[stream] router entries differ from the DFS")
    check(same_ids.mean() >= 0.95 and (g_hops == r_hops).mean() >= 0.95,
          "[stream] the hop loop disagrees with the numpy beam search")
    check(bool(ok_m.all()), "[stream] served graph lanes differ from the "
          "base part merged with the delta")
    check(bool(ok_r[same_ids].all()), "[stream] served graph lanes differ "
          "from the numpy search merged with the delta")

    # ---- a graph service on the unfused gather: its delta is scanned by
    # the box-scan kernel too, never by the plain version
    pg = dataclasses.replace(params, strategy="graph",
                             backend="pallas_gather_l2")
    svc_g = KHIService(svc.index, pg, config=ServeConfig(
        buckets=cfg.buckets, cache_size=cfg.cache_size))
    svc_g.enable_streaming(capacity=cap)
    stream_inserts(svc_g, ins_v, ins_a)
    stream_deletes(svc_g, delta_dels)
    ids_g, dists_g, launches_g = timed_serve(
        svc_g, serve_bursts, Q, "[stream graph, pallas_gather_l2]")
    for name in ("gather_l2", "scan_topk"):
        check(launches_g[name] > 0,
              f"[stream graph] {name} was never launched")
    base_g, base_gd, _, _ = svc_g._planner.search(Q, lo, hi)
    ok_g = lanes_exact(ids_g, dists_g, *sref.merge_dist_ext(
        [(base_g.astype(np.int64), base_gd), (d_ids, d_d)], k))
    print(f"[stream graph, pallas_gather_l2] served lanes equal to its graph"
          f" program merged with the numpy delta on {int(ok_g.sum())} of "
          f"{len(Q)}", flush=True)
    check(bool(ok_g.all()), "[stream graph] served lanes differ from the "
          "graph program merged with the delta")
    del svc_g

    # ---- the delta scan's kernels against their plain versions, timed
    seg = svc._stream.delta
    B = min(256, len(Q))
    qb, lb, hb = qt[:B].contiguous(), tl[:B].contiguous(), th[:B].contiguous()
    got = ops.scan_topk(seg.vecs, seg.attrs, qb, lb, hb, k=k)
    want = ref.scan_topk_ref(seg.vecs, seg.attrs, qb, lb, hb, k)
    same_s, ties_s, err_s = topk_agree("delta scan_topk", *got, *want)
    full = DeltaSegment(cap, d, cfg.m, backend=cfg.backend, device=dev)
    full.insert(ins_v, ins_a, delta_exts)
    full.insert(ins_v[:cap - STREAM_INSERTS], ins_a[:cap - STREAM_INSERTS],
                delta_exts[:cap - STREAM_INSERTS] + STREAM_INSERTS)
    empty = DeltaSegment(cap, d, cfg.m, backend=cfg.backend, device=dev)
    times = {nm: time_ms(lambda s=s: ops.scan_topk(s.vecs, s.attrs, qb, lb,
                                                   hb, k=k), reps=10,
                         queued=True)
             for nm, s in (("served", seg), ("full", full), ("empty", empty))}
    del full, empty
    bytes_full = cap * (4 * d + 4 * cfg.m)
    bnd = bytes_full / HBM_BYTES_PER_S * 1e3
    bnd_attrs = cap * 4 * cfg.m / HBM_BYTES_PER_S * 1e3
    # the merge's host time on one served batch: the whole merge minus its
    # delta scan
    ids_b = np.zeros((B, k), np.int32)
    d_b = np.full((B, k), np.inf, np.float32)
    t0 = time.perf_counter()
    for _ in range(5):
        seg.scan(Q[:B], lo[:B], hi[:B], k)
    scan_s = (time.perf_counter() - t0) / 5
    t0 = time.perf_counter()
    for _ in range(5):
        svc._stream.merge(ids_b, d_b, Q[:B], lo[:B], hi[:B], k)
    merge_s = (time.perf_counter() - t0) / 5
    print(f"[stream] delta scan_topk at B = {B}, N = {cap}, d = {d}, k = {k}:"
          f" ids equal to the plain version on {same_s} slots ({ties_s} "
          f"near-ties), max abs err {err_s:.3g}; on the card alone "
          f"{times['served']:.4f} ms at the served delta "
          f"({STREAM_INSERTS - STREAM_DELTA_DELETES} live rows), "
          f"{times['full']:.4f} ms full ({cap} live), {times['empty']:.4f} ms"
          f" empty (every row NaN); byte bound {bnd:.4f} ms reading every "
          f"row ({bytes_full / 1e6:.0f} MB at 3.35 TB/s), {bnd_attrs:.4f} ms "
          f"reading the attrs alone; a served batch's delta scan "
          f"{scan_s * 1e3:.2f} ms of host wall, the merge around it "
          f"{(merge_s - scan_s) * 1e3:.2f} ms", flush=True)

    # ---- int8: its own service and delta on the same writes
    pq = dataclasses.replace(params, quant="int8")
    svc8 = KHIService(with_quant_replica(di, "int8"), pq, config=ServeConfig(
        buckets=cfg.buckets, cache_size=cfg.cache_size))
    svc8.enable_streaming(capacity=cap)
    stream_inserts(svc8, ins_v, ins_a)
    stream_deletes(svc8, dels)
    check(torch.equal(torch.isnan(svc8.index.attrs),
                      torch.isnan(svc.index.attrs)),
          "[stream int8] the tombstones differ from the f32 service's")
    ids8, dists8, launches8 = timed_serve(svc8, serve_bursts, Q,
                                          "[stream int8]")
    for name in ("scan_topk_q8", "gather_l2_filter", "gather_l2_filter_q8"):
        check(launches8[name] > 0, f"[stream int8] {name} was never launched")
    stream_lanes_ok(ids8, dists8, Q, lo, hi, vec_of, attrs_of, dead,
                    "[stream int8]")
    seg8 = svc8._stream.delta
    t0 = time.perf_counter()
    sq, ss = sref.quantize_rows_i8(ins_v)
    check(np.array_equal(seg8.qvecs[:STREAM_INSERTS].cpu().numpy(), sq)
          and np.array_equal(seg8.qscale[:STREAM_INSERTS].cpu().numpy(), ss),
          "[stream int8] the delta's replica differs from numpy's")
    deq = sref.dequant_rows(svc8.index.qvecs.cpu().numpy(),
                            svc8.index.qscale.cpu().numpy())
    d_deq = sref.dequant_rows(sq, ss)
    d_attrs = np.where(delta_live[:, None], ins_a, np.nan)
    use8 = svc8._planner.plan(lo, hi).use_scan
    p8 = svc8.params
    kq = min(max(k, k * p8.rerank_mult), n)
    kq_d = min(max(k, k * p8.rerank_mult), cap)
    rr = max(k, min(p8.ef, k * p8.rerank_mult))

    def delta8(i):
        """Lane i's int8 delta answer: numpy over-fetch + f32 rerank."""
        di_, dd_ = sref.scan_rerank(d_deq, ins_v, d_attrs, Q[i], lo[i],
                                    hi[i], k=k, kq=kq_d)
        return np.where(di_ >= 0, di_ + n, -1)[None], dd_[None]

    same8 = 0
    si8 = lane_sample(np.nonzero(use8)[0])
    for i in si8:
        bi, bd = sref.scan_rerank(deq, index.vecs, nan_attrs, Q[i], lo[i],
                                  hi[i], k=k, kq=kq)
        me, _ = sref.merge_dist_ext([(bi[None], bd[None]), delta8(i)], k)
        same8 += bool((me[0] == ids8[i]).all())
    # graph lanes: the numpy int8 beam search on the tombstoned attrs from
    # the numpy DFS's entries, the f32 rerank, merged with the int8 delta
    gi8 = lane_sample(np.nonzero(~use8)[0], seed=1)
    ent_of = dict(zip(gi.tolist(), ref_ent))
    g8_hops = svc8._planner.search(Q[gi8], lo[gi8], hi[gi8])[2]
    same8g = same8h = 0
    for j, i in enumerate(gi8):
        e = ent_of.get(int(i))
        if e is None:
            e = sref.dfs_entries(index.tree, nan_attrs, lo[i], hi[i], p8.c_e,
                                 p8.scan_budget)
        cand, _, hops = sref.beam_search(
            deq, nan_attrs, nbrs, e, Q[i], lo[i], hi[i], k=rr, ef=p8.ef,
            c_n=p8.c_n, E=p8.expand_width, max_hops=p8.hops())
        r8, r8d = sref.rerank(index.vecs, cand, Q[i], k)
        me, _ = sref.merge_dist_ext([(r8[None], r8d[None]), delta8(i)], k)
        same8g += bool((me[0] == ids8[i]).all())
        same8h += int(hops == g8_hops[j])
    del deq, nbrs
    share8 = float(((ids8 >= n).any(1)).sum()
                   / max(1, (ids8 >= 0).any(1).sum()))
    n8s = len(si8)
    print(f"[stream int8] scan lanes: ids equal to the numpy int8 over-fetch "
          f"(kq={kq}, delta {kq_d}) + f32 rerank of base and delta, merged "
          f"by (dist, ext), on {same8} of {n8s} sampled (of "
          f"{int(use8.sum())}); graph lanes: ids equal"
          f" to the numpy int8 beam search on the tombstoned attrs + f32 "
          f"rerank (rr={rr}), merged with the same delta, on {same8g} of "
          f"{len(gi8)} sampled (of {int((~use8).sum())}), hops on "
          f"{same8h}; lanes holding a delta row "
          f"{share8:.4f}; delta replica equal to numpy's "
          f"({time.perf_counter() - t0:.1f}s on the host)", flush=True)
    check(same8 >= 0.95 * n8s,
          "[stream int8] the scan lanes disagree with the numpy reference")
    check(same8g >= 0.95 * len(gi8) and same8h >= 0.95 * len(gi8),
          "[stream int8] the graph lanes disagree with the numpy reference")
    check(share8 > 0, "[stream int8] no answered lane holds a delta row")
    del svc8, seg8
    torch.cuda.empty_cache()

    # ---- one compaction, timed by phase
    st = svc._stream
    pre = svc.snapshot()
    l2_calls, marks = [], {}
    orig_l2, ops.l2dist_qn = l2dist_events(l2_calls)
    live_corpus, build = st.live_corpus, khi_mod.KHIIndex.build

    def timed_corpus(*a):
        t = time.perf_counter()
        out = live_corpus(*a)
        marks["gather"] = time.perf_counter() - t
        return out

    def timed_build(*a, **kw):
        t = time.perf_counter()
        out = build(*a, **kw)
        marks["build"] = time.perf_counter() - t
        marks["index"] = out
        return out

    st.live_corpus = timed_corpus
    khi_mod.KHIIndex.build = timed_build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        svc.compact()
        torch.cuda.synchronize()
    finally:
        ops.l2dist_qn = orig_l2
        del st.live_corpus
        khi_mod.KHIIndex.build = build
    comp_s = time.perf_counter() - t0
    new = marks.pop("index")
    post = svc.snapshot()
    check(len(l2_calls) > 0, "[stream] the compaction never launched "
          "l2dist_qn")
    print(f"[stream] compaction in {comp_s:.1f}s: live_corpus gather "
          f"{marks['gather']:.1f}s, build {marks['build']:.1f}s "
          f"({build_l2dist_split(new.tree, l2_calls, marks['build'])}), "
          f"install {comp_s - marks['gather'] - marks['build']:.1f}s; "
          f"snapshot n_live {pre['n_live']} -> {post['n_live']}, tombstones "
          f"{post['tombstones']}, delta_fill {post['delta_fill']}, epoch "
          f"{post['epoch']}", flush=True)
    del l2_calls
    check(post["tombstones"] == 0 and post["delta_fill"] == [0]
          and post["n_live"] == pre["n_live"] == n_live,
          f"[stream] snapshot after the compaction: {post}")
    # the scan lanes through the new epoch's scan program (exact), and as
    # served where the planner still sends them to it
    ps = Planner(svc.index, dataclasses.replace(svc.params, strategy="scan"))
    s_ids, s_d, _, _ = ps.search(Q[si], lo[si], hi[si])
    s_ext = np.where(s_ids >= 0, st.ext_of_base[np.maximum(s_ids, 0)], -1)
    post_scan = svc._planner.plan(lo[si], hi[si]).use_scan
    ids2, dists2 = svc.search(Q[si], lo[si], hi[si])
    same_p = (s_ext == ids[si]).all(1) & (s_d == dists[si]).all(1)
    same_v = ((ids2 == ids[si]).all(1) & (dists2 == dists[si]).all(1))
    print(f"[stream] after the compaction, the {len(si)} scan lanes: the new "
          f"epoch's scan equal to the answers before it (ids, and distances "
          f"bit for bit) on {int(same_p.sum())}; {int(post_scan.sum())} still"
          f" dispatched to the scan, served equal on "
          f"{int(same_v[post_scan].sum())}", flush=True)
    check(bool(same_p.all()) and bool(same_v[post_scan].all()),
          "[stream] scan lanes changed across the compaction")
    builder_check(new, svc.index, new.config.M)
    # the hop loop of the new graph on a sample of graph lanes
    sample = gi[:48]
    p2 = svc.params
    pl = Planner(svc.index, dataclasses.replace(p2, strategy="graph"))
    h_ids, _, h_hops, _ = pl.search(Q[sample], lo[sample], hi[sample])
    nb = svc.index.nbrs.cpu().numpy()
    ent2 = route_level_sync(svc.index, tl[sample], th[sample], p2)[0]
    ent2 = ent2.cpu().numpy()
    out2 = [sref.beam_search(new.vecs, new.attrs, nb, ent2[j][ent2[j] >= 0],
                             Q[i], lo[i], hi[i], k=k, ef=p2.ef, c_n=p2.c_n,
                             E=p2.expand_width, max_hops=p2.hops())
            for j, i in enumerate(sample)]
    del nb
    h_ext = np.where(h_ids >= 0, st.ext_of_base[np.maximum(h_ids, 0)], -1)
    same2 = (h_ids == np.stack([r[0] for r in out2])).all(1)
    hops2 = h_hops == np.array([r[2] for r in out2])
    print(f"[check] hop loop on the compacted graph: ids equal to the numpy "
          f"beam search on {int(same2.sum())} of {len(sample)} lanes, hops on "
          f"{int(hops2.sum())}; recall@{k} of those lanes against the live "
          f"truth {recall(h_ext, t_ids[sample]):.4f} (before the compaction "
          f"{recall(ids[sample], t_ids[sample]):.4f})", flush=True)
    check(same2.mean() >= 0.95 and hops2.mean() >= 0.95,
          "[stream] the compacted graph's hop loop disagrees with numpy")


def builder_check(index, di, M: int, seed: int = 0) -> None:
    """Graph rows of a few tree nodes (the root, where the 1M-row blocks
    run, and one node of each smaller kind) against the builder's rule
    recomputed in float64 on the host (smoke_reference.graph_rows). A
    decision of the rule within fp32's resolution (NEAR_TIE; e.g. every
    prune of a row with an exact copy among its candidates) may go either
    way on the card: the bounds hold the rows against the rule with such
    decisions taken the card's way, and the plain float64 rule's count is
    printed beside."""
    import smoke_reference as sref

    t = index.tree
    count = np.asarray(t.count)
    nodes = np.nonzero(count > 1)[0]
    rng = np.random.default_rng(seed)
    picks, seen = [], set()
    for target in (count.max(), count.max() // 4, 5000, 300, 40):
        p = int(nodes[np.argmin(np.abs(count[nodes] - target))])
        if p in seen:
            continue
        seen.add(p)
        s, c = int(t.start[p]), int(t.count[p])
        pos = np.sort(rng.choice(c, size=min(8, c), replace=False))
        picks.append((p, np.asarray(t.order[s:s + c], np.int64), pos))
    t0 = time.perf_counter()
    allrows = np.concatenate([mem[pos] for _, mem, pos in picks])
    d_all = sref.sq_dists_f64(index.vecs, index.vecs[allrows])
    ef_b = index.config.ef_b or 2 * M
    plain, exact, overlap, ties = [], [], [], []
    r0 = 0
    for p, mem, pos in picks:
        lvl = int(t.level[p])
        d_rows = d_all[r0:r0 + len(pos)][:, mem]
        got = di.nbrs[torch.as_tensor(mem[pos]).to(di.device), lvl] \
            .cpu().numpy()
        want0 = sref.graph_rows(index.vecs, mem, pos, d_rows, M=M, ef_b=ef_b)
        want, n_tie = sref.graph_rows(index.vecs, mem, pos, d_rows, M=M,
                                      ef_b=ef_b, rel_tol=NEAR_TIE, guide=got)
        for gr, wr, w0 in zip(got, want, want0):
            plain.append(bool((gr == w0).all()))
            exact.append(bool((gr == wr).all()))
            w = set(wr[wr >= 0].tolist())
            overlap.append(len(set(gr[gr >= 0].tolist()) & w)
                           / max(1, len(w)))
        ties.extend(n_tie.tolist())
        r0 += len(pos)
    plain, exact, overlap, ties = map(np.asarray,
                                      (plain, exact, overlap, ties))
    sizes = [len(mem) for _, mem, _ in picks]
    print(f"[check] builder: {int(exact.sum())} of {len(exact)} sampled "
          f"graph rows equal to the float64 recomputation with its near-ties"
          f" (decisions within {NEAR_TIE:g} x 2 x the squared norms) taken "
          f"the card's way, mean overlap {overlap.mean():.4f}; "
          f"{int((ties > 0).sum())} rows took {int(ties.sum())} near-ties "
          f"against float64; {int(plain.sum())} equal to the plain rule "
          f"(nodes of {sizes} rows; {time.perf_counter() - t0:.1f}s on the "
          f"host)", flush=True)
    check(exact.mean() >= 0.9 and overlap.mean() >= 0.97,
          "the builder's graph rows differ from the float64 recomputation")


# ---------------------------------------------------------------- the wide
# scan forms (ROADMAP F8): any 1 <= k <= N and any m on the card

WIDE_K = 100                   # the paper's largest k (benchmarks/vary_k.py)
WIDE_CU = "src/repro_torch/kernels/csrc/scan_topk_wide.cu"
WIDE_GRID_KS = (65, 100, 400)
WIDE_GRID_MS = (4, 9, 12)


def timed_once(fn):
    """(fn's result, its ms by CUDA events): a plain version too slow to
    run twice gives its answer and its time in one call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def list_phases(name, kern) -> dict:
    """A wide form's call split by the CUDA events its wrapper records
    between phases (``ops.WIDE_MARKS``: the sample pass and the thresholds
    (the bitmask's compaction, the windowed form's coverage pre-pass too);
    the score pass and the overflow re-pass; the select), the card kept asleep until the
    whole call is enqueued, so no phase holds the host's launch time; with
    the candidates a query listed
    (median, max) and the queries whose lists overflowed
    (``ops.WIDE_STATS``)."""
    from repro_torch.kernels import ops

    ops.WIDE_MARKS = []
    try:
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)   # the call enqueued whole: card time
        kern()
        torch.cuda.synchronize()
        marks = ops.WIDE_MARKS
    finally:
        ops.WIDE_MARKS = None
    split = {}
    for (_, e0), (phase, e1) in zip(marks, marks[1:]):
        split[phase] = split.get(phase, 0.0) + e0.elapsed_time(e1)
    st = ops.WIDE_STATS[name]
    cand = st[:-1].float()
    return dict(phase_ms=split, candidates_median=float(cand.median()),
                candidates_max=int(cand.max()), overflowed=int(st[-1]))


def wide_row(name, line, kern, plain, lib, nbytes, nops, what, rows,
             yardstick=""):
    """A wide form against its plain version at the served shape, with
    ``topk_agree``'s rule (random floats: the two sum in other orders);
    its time, the plain version's, the library's and its bound, its
    phases, candidates and overflowed queries; ``yardstick`` is printed
    after them."""
    ids, dd = kern()
    (rids, rdd), plain_ms = timed_once(plain)
    same, ties, err = topk_agree(name, ids, dd, rids, rdd)
    bms, by = bound_ms(nbytes, nops)
    r = rows[name] = dict(
        name=name, route="cuda", launches=0, source=WIDE_CU,
        replaces=SCAN_TPU + line, max_abs_err=err, ms=time_ms(kern, reps=3),
        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=time_ms(lib, reps=3))
    r.update(list_phases(name, kern))
    extra = ("; phases " + ", ".join(
        f"{p} {ms:.3f}" for p, ms in r["phase_ms"].items())
        + f" ms; candidates a query: median {r['candidates_median']:.0f}"
        f", max {r['candidates_max']}; {r['overflowed']} queries "
        f"overflowed{yardstick}")
    print(f"[kernels] {name} {what}: {r['ms']:.3f} ms (plain "
          f"{plain_ms:.3f}, library {r['library_ms']:.3f}, bound {bms:.3f} "
          f"by {by}), ids equal on {same} of {ids.numel()} slots ({ties} "
          f"near-ties), max abs err {err:.3g}{extra}", flush=True)
    return ids, dd


def wide_kernel_rows(corpus, cb, qv, qs, attrs, mask, q, qlo, qhi, n_pairs,
                     k, kq, dev, rows) -> None:
    """Each wide form at the served shape (B = 256, N = n, d = 768, m =
    4): the box scan in f32 at k and in bf16 / int8 at the over-fetch kq
    (k x rerank_mult), the bitmask scan (f32, bf16) and the windowed scan
    (f32, bf16, on synthetic windows) at k. The bitmask form also equals
    the f32 box form bit for bit on the mask as a one-attribute box.
    Library: (dequantize +) cdist + mask + topk; bounds as the narrow
    forms'. Then the grid checks (``wide_grid_checks``)."""
    from repro_torch.kernels import ops, quant, ref

    B, (n, d), m = q.shape[0], corpus.shape, attrs.shape[1]
    inf = float("inf")

    def box_lib(rows_f32, kk):
        def run():
            dist = torch.cdist(q, rows_f32())
            ok = ((attrs[None] >= qlo[:, None])
                  & (attrs[None] <= qhi[:, None])).all(-1)
            return torch.topk(torch.where(ok, dist, inf), kk, largest=False)
        return run

    head = B * 4 * (q.shape[1] + 2 * m)
    for name, kk, cx, row_bytes, extra in (
            ("scan_topk_wide", k, corpus, 4 * d, 0),
            ("scan_topk_wide_bf16", kq, cb, 2 * d, 0),
            ("scan_topk_wide_q8", kq, qv, d + 4, n * d)):
        if cx is qv:
            def kern(kk=kk):
                return ops.scan_topk_q8(qv, qs, attrs, q, qlo, qhi, k=kk)

            def plain(kk=kk):
                return ref.scan_topk_q8_ref(qv, qs, attrs, q, qlo, qhi, kk)
            lib = box_lib(lambda: quant.dequant_rows(qv, qs), kk)
        else:
            def kern(kk=kk, cx=cx):
                return ops.scan_topk(cx, attrs, q, qlo, qhi, k=kk)

            def plain(kk=kk, cx=cx):
                return ref.scan_topk_ref(cx, attrs, q, qlo, qhi, kk)
            lib = box_lib(lambda cx=cx: cx.float(), kk)
        ids, _ = wide_row(
            name, ":60" if cx is not qv else ":172", kern, plain, lib,
            n * row_bytes + attrs.numel() * 4 + head + B * kk * 8,
            n_pairs * d * 3 + extra,
            f"B={B} N={n} d={d} k={kk} ({n_pairs} passing pairs)", rows)
        check(bool((ids[0] == -1).all()), f"{name}: an empty box must give "
              f"(-1, +inf) lanes")

    okr = mask[:, 0] > 0
    n_rows = int(okr.sum())
    one_lo = torch.full((B, 1), 1e-30, device=dev)
    one_hi = torch.full((B, 1), inf, device=dev)
    for name, cx, eb in (("scan_topk_mask_wide", corpus, 4),
                         ("scan_topk_mask_wide_bf16", cb, 2)):
        def kern(cx=cx):
            return ops.scan_topk_mask(cx, mask, q, k=k)

        def lib(cx=cx):
            dist = torch.cdist(q, cx.float())
            return torch.topk(torch.where(okr[None], dist, inf), k,
                              largest=False)
        ids, dd = wide_row(
            name, ":241", kern,
            lambda cx=cx: ref.scan_topk_mask_ref(cx, mask, q, k), lib,
            n * 4 + n_rows * d * eb + q.numel() * 4 + B * k * 8,
            n_rows * B * d * 3, f"B={B} N={n} d={d} k={k} ({n_rows} rows "
            f"pass)", rows)
        bids, bdd = ops.scan_topk(cx, mask, q, one_lo, one_hi, k=k)
        torch.cuda.synchronize()
        check(torch.equal(ids, bids) and torch.equal(dd, bdd),
              f"{name} differs from the wide box scan on the mask as an "
              f"attribute: ids on {int((ids != bids).sum())} slots")
    print(f"[kernels] the wide bitmask forms equal the wide box forms on "
          f"the mask as a one-attribute box at k={k}", flush=True)

    st, ct = make_windows(B, n, dev)
    lane_rows, n_pass, rows_cov, rows_pass = window_pairs(attrs, qlo, qhi,
                                                          st, ct)
    for name, cx in (("scan_topk_windows_wide", corpus),
                     ("scan_topk_windows_wide_bf16", cb)):
        # the yardstick: the narrow windowed form at the served k on the
        # same windows (its launches stay out of the main path's counts)
        narrow = time_ms(lambda cx=cx: ops.scan_topk_windows(
            cx, attrs, q, qlo, qhi, st, ct, k=10), reps=3)
        def kern(cx=cx):
            return ops.scan_topk_windows(cx, attrs, q, qlo, qhi, st, ct, k=k)

        def plain(cx=cx):
            return ref.scan_topk_windows_ref(cx, attrs, q, qlo, qhi, st, ct,
                                             k)

        def lib(cx=cx):
            out = []
            for b, r in enumerate(lane_rows):
                if r.numel():
                    dist = torch.cdist(q[b:b + 1],
                                       cx.index_select(0, r).float())
                    a = attrs.index_select(0, r)
                    ok = ((a >= qlo[b]) & (a <= qhi[b])).all(-1)
                    out.append(torch.topk(torch.where(ok, dist[0], inf),
                                          min(k, r.numel()), largest=False))
            return out
        wide_row(name, ":305", kern, plain, lib,
                 rows_cov * m * 4 + rows_pass * d * cx.element_size()
                 + q.numel() * 4 + 2 * qlo.numel() * 4 + 2 * st.numel() * 4
                 + B * k * 8, n_pass * d * 3,
                 f"at synthetic windows: B={B} W={st.shape[1]} k={k}, "
                 f"{n_pass} passing (lane, row) pairs over {rows_cov} "
                 f"distinct rows", rows,
                 yardstick=f"; the narrow windowed form at k=10 on the same "
                           f"windows {narrow:.3f} ms")
        rows[name]["narrow_k10_ms"] = narrow
    del lane_rows
    wide_grid_checks(dev)


def wide_grid_checks(dev) -> None:
    """Every wide form ``torch.equal`` to its plain version on a 1/32-grid
    corpus, where every f32 sum is exact in any order: N = 3001, d = 96,
    B = 37, k in {65, 100, 400}; the box (f32, bf16, int8 on the grid) and
    windowed (f32, bf16) forms at m in {4, 9, 12}, the bitmask form (f32,
    bf16); lanes with an empty box, an all-pass box (every row but the
    NaN ones), a 20-row box and a one-row box."""
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(0xF8)
    N, d, B = 3001, 96, 37

    def grid(shape):
        return (rng.integers(-64, 65, size=shape) / 32).astype(np.float32)

    corpus = torch.as_tensor(grid((N, d)), device=dev)
    cb = corpus.to(torch.bfloat16)
    qv = torch.as_tensor(rng.integers(-32, 33, size=(N, d)),
                         dtype=torch.int8, device=dev)
    qs = torch.as_tensor(rng.choice([1 / 16, 1 / 32], size=(N, 1)),
                         dtype=torch.float32, device=dev)
    qv[qs[:, 0] == 1 / 32] *= 2
    q = torch.as_tensor(grid((B, d)), device=dev)
    mask = torch.as_tensor(rng.random((N, 1)).astype(np.float32),
                           device=dev) - 0.3
    mask[::31] = float("nan")
    mask[::37] = 0.0
    st, ct = make_windows(B, N, dev, W=8)
    n_calls = 0
    over = {}                  # overflowed queries by form (and forced)
    for m in WIDE_GRID_MS:
        a = rng.random((N, m)).astype(np.float32)
        a[:, 0] = rng.permutation(N)
        a[5::41, 1] = np.nan
        lo = (rng.random((B, m)) * 0.3).astype(np.float32)
        hi = lo + 0.55
        lo[:, 0], hi[:, 0] = -1.0, float(N)
        lo[0, 0], hi[0, 0] = 1.0, 0.0                # empty
        lo[1], hi[1] = -1.0, float(N)                # all pass
        lo[2], hi[2] = -1.0, float(N)
        lo[2, 0], hi[2, 0] = 100.0, 119.0            # 20 rows
        lo[3], hi[3] = -1.0, float(N)
        lo[3, 0], hi[3, 0] = 7.0, 7.0                # one row
        attrs = torch.as_tensor(a, device=dev)
        lo, hi = torch.as_tensor(lo, device=dev), torch.as_tensor(hi,
                                                                  device=dev)
        for k in WIDE_GRID_KS:
            pairs = [
                (lambda: ops.scan_topk(corpus, attrs, q, lo, hi, k=k),
                 lambda: ref.scan_topk_ref(corpus, attrs, q, lo, hi, k)),
                (lambda: ops.scan_topk(cb, attrs, q, lo, hi, k=k),
                 lambda: ref.scan_topk_ref(cb, attrs, q, lo, hi, k)),
                (lambda: ops.scan_topk_q8(qv, qs, attrs, q, lo, hi, k=k),
                 lambda: ref.scan_topk_q8_ref(qv, qs, attrs, q, lo, hi, k)),
                (lambda: ops.scan_topk_windows(corpus, attrs, q, lo, hi, st,
                                               ct, k=k),
                 lambda: ref.scan_topk_windows_ref(corpus, attrs, q, lo, hi,
                                                   st, ct, k)),
                (lambda: ops.scan_topk_windows(cb, attrs, q, lo, hi, st, ct,
                                               k=k),
                 lambda: ref.scan_topk_windows_ref(cb, attrs, q, lo, hi, st,
                                                   ct, k))]
            if m == WIDE_GRID_MS[0]:          # the bitmask reads no attrs
                pairs += [
                    (lambda: ops.scan_topk_mask(corpus, mask, q, k=k),
                     lambda: ref.scan_topk_mask_ref(corpus, mask, q, k)),
                    (lambda: ops.scan_topk_mask(cb, mask, q, k=k),
                     lambda: ref.scan_topk_mask_ref(cb, mask, q, k))]
            # the windowed forms again with their lists' capacity forced
            # down to k: lanes overflow, the exact re-pass finishes them
            pairs += [(kern, plain, k) for kern, plain in pairs[3:5]]
            for j, (kern, plain, *cap) in enumerate(pairs):
                ops.reset_launches()
                ops.WIDE_CAPACITY = cap[0] if cap else None
                try:
                    gi, gd = kern()
                finally:
                    ops.WIDE_CAPACITY = None
                launched = [nm for nm, c in ops.LAUNCHES.items() if c]
                wi, wd = plain()
                torch.cuda.synchronize()
                form = launched[0] if len(launched) == 1 else f"form {j}"
                tag = form + (" forced" if cap else "")
                over[tag] = over.get(tag, 0) + int(ops.WIDE_STATS[form][-1])
                check(len(launched) == 1 and "_wide" in form,
                      f"wide grid m={m} k={k} form {j}: launched {launched}")
                check(torch.equal(gi, wi) and torch.equal(gd, wd),
                      f"{form} m={m} k={k}: not equal to its plain "
                      f"version on the grid corpus (ids on "
                      f"{int((gi != wi).sum())} slots, dists on "
                      f"{int((gd != wd).sum())})")
                if j < 5 or cap:
                    check(bool((gi[0] == -1).all())
                          and int((gi[2] >= 0).sum()) <= 20,
                          f"{form} m={m} k={k}: the empty or the "
                          f"20-row box")
                n_calls += 1
    for form in ("scan_topk_windows_wide", "scan_topk_windows_wide_bf16"):
        check(over.get(form + " forced", 0) > 0,
              f"{form}: no list overflowed at a capacity of k on the grid")
    print(f"[kernels] wide forms on a 1/32-grid corpus (N={N}, d={d}, "
          f"B={B}): {n_calls} calls at k in {WIDE_GRID_KS}, m in "
          f"{WIDE_GRID_MS} (box, windowed, the windowed with the lists' "
          f"capacity forced to k) and the bitmask, every one torch.equal "
          f"to its plain version; overflowed queries summed over the calls "
          f"{json.dumps(over)}", flush=True)


LARGE_K_REQUESTS = 64


def served_once(svc, Q, lo=None, hi=None, expr=None):
    """One served burst of every request (boxes ``lo``/``hi``, or one
    filter ``expr`` for all), after a warm-up burst on other keys, its
    launch counts alone: -> (ids, dists, seconds, launches, plain-version
    CUDA calls, scan lanes)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import Request

    def burst(qs):
        tickets = [svc.submit(Request(qs[i], expr=expr) if expr is not None
                              else Request(qs[i], lo[i], hi[i]))
                   for i in range(len(qs))]
        res = svc.flush()
        return [res[t] for t in tickets]

    burst(Q + np.float32(1e-3))                    # warm-up, other keys
    before = svc.snapshot()["scan_lanes"]
    ops.reset_launches()
    ref.reset_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = burst(Q)
    dt = time.perf_counter() - t0
    launches = {n: c for n, c in ops.LAUNCHES.items() if c}
    plain = {n: v["cuda"] for n, v in ref.CALLS.items() if v["cuda"]}
    return (np.stack([r.ids for r in out]), np.stack([r.dists for r in out]),
            dt, launches, plain, svc.snapshot()["scan_lanes"] - before)


def large_k_pass(index, di, params, cfg, Q, lo, hi, dev, rows) -> None:
    """The 1M index served at k = 100: 64 requests (32 at 1/4, 32 at 1/64
    selectivity, mixed) under auto, then under int8 (over-fetch kq = 400,
    f32 rerank), each one burst with its launches counted alone. The
    scan lanes must equal the float64 top-k of their boxes; the graph
    lanes' recall@100 against the plain f32 brute force is printed."""
    from repro_torch.core.engine import with_quant_replica
    from repro_torch.serve import KHIService, ServeConfig

    from repro_torch.kernels import ref

    k = WIDE_K
    Qk, lok, hik = (x[:LARGE_K_REQUESTS] for x in (Q, lo, hi))
    # the graph lanes' recall against the plain f32 brute force on the
    # card; the float64 truth (on the host) for the scan lanes
    with torch.no_grad():
        t_ids = ref.scan_topk_ref(di.vecs, di.attrs,
                                  *(torch.as_tensor(x).to(dev)
                                    for x in (Qk, lok, hik)), k)[0]
    t_ids = t_ids.cpu().numpy()
    svc_cfg = ServeConfig(buckets=cfg.buckets, cache_size=cfg.cache_size)
    truth, truth_s = {}, 0.0
    for quant, form in (("none", "scan_topk_wide"),
                        ("int8", "scan_topk_wide_q8")):
        p = dataclasses.replace(params, k=k, quant=quant)
        dq = di if quant == "none" else with_quant_replica(di, quant)
        svc = KHIService(dq, p, config=svc_cfg)
        ids, dists, dt, launches, plain, n_scan = served_once(svc, Qk, lok,
                                                              hik)
        use_scan = svc._planner.plan(lok, hik).use_scan
        si, gi = np.nonzero(use_scan)[0], np.nonzero(~use_scan)[0]
        t0 = time.perf_counter()
        truth.update(box_truth_f64(index.vecs, index.attrs, Qk, lok, hik,
                                   [i for i in si if int(i) not in truth],
                                   k))
        truth_s += time.perf_counter() - t0
        ok = exact_lanes(si, ids, dists, truth)
        rec = recall(ids[gi], t_ids[gi])
        tag = "auto" if quant == "none" else quant
        print(f"[large k] {tag} k={k}"
              f"{'' if quant == 'none' else f' (kq={4 * k})'}: "
              f"{len(Qk)} requests in {dt:.3f}s ({len(Qk) / dt:.1f} QPS "
              f"end-to-end), {n_scan} scan lanes, {len(gi)} graph lanes; "
              f"scan lanes equal to the float64 truth on {int(ok.sum())} of "
              f"{len(si)}; graph lanes' recall@{k} {rec:.4f} (against the "
              f"f32 brute force); launches {launches}; float64 truth "
              f"{truth_s:.1f}s on the host", flush=True)
        check(not plain, f"large k {tag}: fell through to {plain}")
        check(launches.get(form, 0) > 0 and len(si) > 0,
              f"large k {tag}: {form} was never launched")
        check(bool(ok.all()), f"large k {tag}: a scan lane is not exact")
        check(bool(((ids >= 0).any(1) | (t_ids < 0).all(1)).all()),
              f"large k {tag}: a request whose box holds a row got no id")
        check_served(ids, dists, index.vecs, index.attrs, Qk, lok, hik,
                     f"large k {tag}")
        rows[form]["launches"] = launches.get(form, 0)
        del svc, dq


M12_N = 65_536
M12_M = 12


def m12_pass(cfg, dev, rows) -> None:
    """A KHI index over a 65,536-row, d = 768 corpus with 12 attributes
    (``year`` + 11 lognormal, the cell's correlation and clusters), built
    on the card and served: auto (the box scan's m > 8: its wide form),
    hybrid (the windowed wide form), both at the median routing bound of
    the 1/64 lanes as the threshold, a filter expression
    that lowers to the bitmask at k = 100 (the bitmask's wide form), then
    the same three on the index stored in bf16. Each run is one burst of
    64 requests (32 at 1/4, 32 at 1/64) with its launches counted alone;
    auto's scan lanes, hybrid's scan lanes and every expression lane must
    equal the float64 top-k (over the bf16 rounding for the bf16 index)."""
    import smoke_reference as sref
    from repro_torch.core import KHIConfig, KHIIndex
    from repro_torch.core.engine import device_put_index
    from repro_torch.core.predicate import compile_expr, parse_expr
    from repro_torch.data import DatasetSpec, make_dataset, make_queries
    from repro_torch.kernels import ops
    from repro_torch.serve import KHIService, ServeConfig

    t0 = time.perf_counter()
    spec = DatasetSpec("khi-m12", n=M12_N, d=cfg.d, m=M12_M,
                       attr_kinds=("year",) + ("lognormal",) * (M12_M - 1),
                       attr_corr=0.85, n_clusters=64, seed=12)
    vecs, attrs = make_dataset(spec)
    half = LARGE_K_REQUESTS // 2
    g = make_queries(vecs, attrs, n_queries=half, sigma=1 / 4, seed=13)
    s = make_queries(vecs, attrs, n_queries=half, sigma=1 / 64, seed=14)
    Q = np.concatenate([g[0], s[0]])
    lo = np.stack([p.lo for p in g[1] + s[1]]).astype(np.float32)
    hi = np.stack([p.hi for p in g[1] + s[1]]).astype(np.float32)
    index = KHIIndex.build(vecs, attrs, KHIConfig(M=cfg.M, builder="device"),
                           device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the routing bound over 12 attributes is loose (a 1/64 box's bound
    # holds about a third of the corpus at 3,000 rows on the CPU), so the
    # threshold is the median bound of the 1/64 lanes: about half of them
    # scan, the rest walk the graph
    from repro_torch.core.engine import Planner
    card = Planner(device_put_index(index, device=dev),
                   cfg.search_params()).plan(lo, hi).card
    thr = int(np.median(card[half:]))
    params = dataclasses.replace(cfg.search_params(), scan_threshold=thr,
                                 node_scan_threshold=thr)
    years = tuple(range(2005, 2024, 2))
    text = "a0 in [" + ", ".join(map(str, years)) + "]"
    expr = parse_expr(text, M12_M)
    check(compile_expr(expr, M12_M, box_budget=params.box_budget).mode
          == "bitmask", "m12: the expression does not lower to the bitmask")
    emask = sref.year_mask(attrs, years)
    held = np.median([((attrs >= a) & (attrs <= b)).all(1).sum()
                      for a, b in zip(lo[half:], hi[half:])])
    print(f"[m12] corpus ({M12_N}, {cfg.d}) x {M12_M} attrs, index built on "
          f"the card in {build_s:.1f}s (data included); scan threshold "
          f"{thr} (the median routing bound of the 1/64 lanes; the boxes "
          f"hold {int(held)} rows at the median); expression {text!r}: "
          f"{int(emask.sum())} rows", flush=True)
    svc_cfg = ServeConfig(buckets=cfg.buckets, cache_size=cfg.cache_size)
    lanes = np.arange(len(Q))
    for stored in ("f32", "bf16"):
        di = device_put_index(index, device=dev, vec_dtype=None
                              if stored == "f32" else torch.bfloat16)
        vt = vecs if stored == "f32" else sref.round_bf16(vecs)
        truth = box_truth_f64(vt, attrs, Q, lo, hi, lanes, cfg.k)
        e_ids, e_d = sref.topk_f64(vt, np.nonzero(emask)[0], Q, WIDE_K)
        sfx = "" if stored == "f32" else "_bf16"
        for run, form in (("auto", "scan_topk_wide"),
                          ("hybrid", "scan_topk_windows_wide"),
                          ("expr", "scan_topk_mask_wide")):
            form += sfx
            p = dataclasses.replace(
                params, strategy="hybrid" if run == "hybrid" else "auto",
                k=WIDE_K if run == "expr" else cfg.k)
            svc = KHIService(di, p, config=svc_cfg)
            if run == "expr":
                ids, dists, dt, launches, plain, _ = served_once(
                    svc, Q, expr=expr)
                ok = lanes_exact(ids, dists, e_ids, e_d)
                what = f"every lane ({len(Q)}) equal to the float64 truth " \
                       f"on {int(ok.sum())}"
            else:
                ids, dists, dt, launches, plain, _ = served_once(svc, Q, lo,
                                                                 hi)
                # auto's scan lanes, hybrid's pure-window lanes: exact
                exact = np.nonzero(svc._planner.plan(lo, hi).use_scan)[0]
                ok = exact_lanes(exact, ids, dists, truth)
                rec = recall(ids, np.stack([truth[i][0] for i in lanes]))
                what = (f"{len(exact)} exact lanes, equal to the float64 "
                        f"truth on {int(ok.sum())}; all lanes' recall@"
                        f"{cfg.k} {rec:.4f}")
                if run == "hybrid":    # the served call's lists
                    wst = ops.WIDE_STATS[form].cpu()
                    what += (f"; the last wide call's candidates a lane: "
                             f"median {float(wst[:-1].float().median()):.0f},"
                             f" max {int(wst[:-1].max())}; {int(wst[-1])} "
                             f"lanes overflowed")
                check(len(exact) > 0, f"m12 {stored} {run}: no exact lane")
                if stored == "f32":
                    check_served(ids, dists, vecs, attrs, Q, lo, hi,
                                 f"m12 {run}")
            print(f"[m12] {stored} {run}: {len(Q)} requests in {dt:.3f}s "
                  f"({len(Q) / dt:.1f} QPS); {what}; launches {launches}",
                  flush=True)
            check(not plain, f"m12 {stored} {run}: fell through to {plain}")
            check(launches.get(form, 0) > 0,
                  f"m12 {stored} {run}: {form} was never launched")
            check(bool(ok.all()), f"m12 {stored} {run}: an exact lane is not")
            rows[form]["launches"] = launches.get(form, 0)
            del svc
        del di
    del index
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- the LM
# substrate (decode serving, ROADMAP item 17a)

LM_B, LM_S, LM_NEW = 4, 32, 16
# positions the f32 check decodes past the prompt on both paths (prefill
# + decode against the all-decode path); cut from 16 for the time limit
LM_CONT = 4
# full width and depth: the archs whose full config fits one card in bf16
LM_FULL = ("gemma3-4b", "phi3-mini-3.8b", "minicpm3-4b", "qwen1.5-4b",
           "granite-moe-3b-a800m", "mamba2-780m")
# full width, depth cut: the body repeats kept (jamba: one repeat of its
# 8-layer block; the others 8 layers)
LM_CUT = {"jamba-v0.1-52b": 1, "phi3.5-moe-42b-a6.6b": 8,
          "qwen2-vl-72b": 8}
# the decode-vs-forward checks in f32: |decode - forward| <= LM_RTOL x the
# largest |forward logit| at every position (full fp32 products, no TF32;
# a batched forward and a one-token step sum in other orders)
LM_RTOL = 1e-3


def lm_cfg(arch: str):
    """The arch's full config, depth cut where it does not fit one card;
    -> (config, what was cut)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import Stage

    cfg = get_config(arch)
    if arch not in LM_CUT:
        return cfg, "full depth"
    (st,) = cfg.stages
    rep = LM_CUT[arch]
    cut = dataclasses.replace(cfg, stages=(Stage(rep, st.body),))
    return cut, (f"depth cut from {cfg.n_layers} to {cut.n_layers} layers "
                 f"({rep} of {st.repeat} repeats of a {len(st.body)}-layer "
                 f"body)")


def lm_batch(cfg, dev, seed: int = 0):
    """4 prompts of 32 tokens (M-RoPE positions on text for qwen2-vl, the
    decode path's; 512-d frame features for hubert), from numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (LM_B, LM_S)),
                                   dtype=torch.int32, device=dev)}
    if cfg.frontend == "audio":
        b["features"] = torch.as_tensor(rng.standard_normal(
            (LM_B, LM_S, cfg.frontend_dim)).astype(np.float32), device=dev)
    if cfg.mrope_sections is not None:
        b["mrope_pos"] = torch.arange(LM_S, dtype=torch.int32,
                                      device=dev).expand(LM_B, 3, LM_S)
    return b


def lm_checks(arch, cfg, dev) -> str:
    """In f32 at the pass's width and depth, MoE capacity raised so that
    no token drops (a 4-token decode step has capacity 1 at the config's
    1.25): teacher-forced ``decode_step`` logits against ``forward``'s at
    each prompt position and their argmax (except where forward's top two
    lie within the tolerance), then ``prefill`` + ``decode_step`` against
    the all-decode path over ``LM_CONT`` more positions. Returns a
    summary."""
    from repro_torch.models import model as M

    c32 = dataclasses.replace(cfg, dtype="float32")
    if c32.moe is not None:
        c32 = dataclasses.replace(c32, moe=dataclasses.replace(
            c32.moe, capacity_factor=c32.moe.n_padded / c32.moe.top_k))
    params = M.init_params(c32, torch.Generator(dev).manual_seed(7),
                           device=dev)
    batch = lm_batch(c32, dev, seed=1)
    T = LM_S + LM_NEW
    with torch.no_grad():
        fl, _ = M.forward(params, c32, batch)
        scale = float(fl.abs().max())
        cache = M.init_cache(c32, LM_B, T, device=dev)
        err, ties = 0.0, 0
        top2 = fl.float().topk(2, dim=-1).values
        for t in range(LM_S):
            lg, cache = M.decode_step(params, c32, cache,
                                      batch["tokens"][:, t:t + 1], t)
            err = max(err, float((lg[:, 0] - fl[:, t]).abs().max()))
            near = (top2[:, t, 0] - top2[:, t, 1]) <= LM_RTOL * scale
            same = lg[:, 0].argmax(-1) == fl[:, t].argmax(-1)
            ties += int(near.sum())
            check(bool((same | near).all()),
                  f"lm {arch}: decode's argmax differs from forward's at {t}")
        check(err <= LM_RTOL * scale, f"lm {arch}: decode vs forward max "
              f"abs err {err:.3g} > {LM_RTOL} x {scale:.3g}")
        # prefill + decode against the all-decode path, on the greedy
        # tokens of the all-decode path
        pl, pc = M.prefill(params, c32, batch, cache_len=T)
        perr = float((pl[:, 0] - lg[:, 0]).abs().max())
        cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        for t in range(LM_S, LM_S + LM_CONT):
            a, cache = M.decode_step(params, c32, cache, cur, t)
            b, pc = M.decode_step(params, c32, pc, cur, t)
            perr = max(perr, float((a - b).abs().max()))
            cur = a[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        check(perr <= LM_RTOL * scale, f"lm {arch}: prefill + decode vs "
              f"all-decode max abs err {perr:.3g}")
    del params, cache, pc, fl
    torch.cuda.empty_cache()
    return (f"f32 checks: decode vs forward max abs err {err:.3g}, prefill + "
            f"decode vs all-decode {perr:.3g} (tolerance {LM_RTOL} x "
            f"{scale:.3g}), argmax equal at {LM_B * LM_S} positions "
            f"({ties} near-ties)")


def lm_pass(dev, card: str) -> None:
    """Decode serving of the LM substrate at full width: each decode arch
    from the port's random init in bf16, 4 prompts of 32 tokens + 16 new
    greedy tokens through ``generate`` (timed after a 2-token warm-up,
    peak memory beside it), after the f32 checks of ``lm_checks``; the
    three archs that do not fit one card at their depth cut; hubert's
    ``forward`` once (it is encoder-only: ``generate`` must raise)."""
    from repro_torch.models import model as M
    from repro_torch.serve.generate import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in LM_FULL + tuple(LM_CUT) + ("hubert-xlarge",):
        cfg, cut = lm_cfg(arch)
        t0 = time.perf_counter()
        checks = lm_checks(arch, cfg, dev) if cfg.has_decode else ""
        check_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        params = M.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
        batch = lm_batch(cfg, dev)
        n_params = M.count_params(cfg)
        with torch.no_grad():
            if not cfg.has_decode:
                M.forward(params, cfg, batch)
                lg, ms = timed_once(lambda: M.forward(params, cfg, batch)[0])
                check(bool(torch.isfinite(lg).all())
                      and lg.shape == (LM_B, LM_S, cfg.vocab),
                      f"lm {arch}: forward gave {tuple(lg.shape)} or a "
                      f"non-finite logit")
                try:
                    generate(params, cfg, batch["tokens"], max_new_tokens=2)
                    fail(f"lm {arch}: generate did not raise")
                except ValueError:
                    pass
                print(f"[lm] {arch} (bf16, {n_params / 1e9:.3f}B params, "
                      f"{cut}): encoder-only, forward on ({LM_B}, {LM_S}) "
                      f"frames in {ms:.2f} ms, generate raises; peak "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                      f"card {card}", flush=True)
                del params, lg
                torch.cuda.empty_cache()
                continue
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            generate(params, cfg, batch["tokens"], max_new_tokens=2,
                     batch=extra)
            _, pre_ms = timed_once(lambda: M.prefill(
                params, cfg, batch, cache_len=LM_S + LM_NEW))
            out, gen_ms = timed_once(lambda: generate(
                params, cfg, batch["tokens"], max_new_tokens=LM_NEW,
                batch=extra))
        check(out.shape == (LM_B, LM_NEW) and bool(
            ((out >= 0) & (out < cfg.vocab)).all()),
            f"lm {arch}: generated {tuple(out.shape)} or a token out of range")
        new = LM_B * LM_NEW
        dec = (f"{new / (gen_ms - pre_ms) * 1e3:.1f} tok/s decoding"
               if gen_ms > pre_ms else "decoding not separable")
        print(f"[lm] {arch} (bf16, {n_params / 1e9:.3f}B params, {cut}): "
              f"generate {LM_B} x ({LM_S} + {LM_NEW}) in {gen_ms:.1f} ms: "
              f"{new / gen_ms * 1e3:.1f} tok/s with the prefill "
              f"({pre_ms:.1f} ms alone), {dec}; "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{checks} in {check_s:.1f}s; card {card}", flush=True)
        del params, out
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- training
# of the LM substrate (ROADMAP item 17b)

TRAIN_ARCH = "qwen1.5-4b"     # dense, full width: d_model 2560, vocab 151,936
TRAIN_LAYERS = 4              # depth cut from 40 for the time limit
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 16, 8, 256, 2
# the launcher's default (3e-3, the reference's, sized for the smoke
# configs) moves a logit by about lr x sum|h| ~ lr x 2,000 a step at
# d_model 2560 and overshoots: the loss rose from 12.8 to 19.6 within 6
# steps on an H100
TRAIN_LR = 3e-4
# the smoke-width step on the card against the port's CPU step, f32 with
# TF32 off: the two sum in other orders (a few ulps a layer); AdamW's eps
# at 1e-3 keeps an update within 1e3 x lr of its gradient's rounding
# (at 1e-8 an entry whose gradient is near 0 moves by a share of lr)
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6


def train_pass(dev, card: str) -> dict:
    """Training of the LM substrate through its launcher
    (``repro_torch.launch.train``): ``TRAIN_ARCH`` at full width in its
    configured dtype (bf16) with f32 moments and f32 gradient
    accumulation over ``TRAIN_MICRO`` microbatches, its depth cut to
    ``TRAIN_LAYERS``, ``TRAIN_STEPS`` steps of ``lm_batch``: each loss
    finite, the mean of the last 5 below the first; step ms, tokens/s and
    peak GiB. Then at the arch's smoke width in f32: one training step on
    the card against the port's CPU step on the same parameters and batch
    (TF32 off); a resume through a checkpoint (the launcher, deterministic
    algorithms on) reproducing the uninterrupted run's next losses and
    parameters bit for bit; ``compressed_psum`` over a one-rank NCCL group
    equal to the int8 quantize-dequantize arithmetic in numpy. Returns
    the full-width run's peak bytes (``max_memory_allocated``) and median
    step ms, which the ``[dryrun]`` pass holds its prediction to."""
    import shutil
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.lm import lm_batch, to_device
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import compressed_psum, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    args = T.parse_args(["--arch", TRAIN_ARCH, "--layers", str(TRAIN_LAYERS),
                         "--steps", str(TRAIN_STEPS), "--batch",
                         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                         "--n-micro", str(TRAIN_MICRO), "--lr",
                         str(TRAIN_LR)])
    torch.cuda.reset_peak_memory_stats()
    run = T.train(args, log=lambda line: None)
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 2**30
    full = get_config(TRAIN_ARCH)
    cfg = T.cut_depth(full, TRAIN_LAYERS)
    losses = run.losses
    step_ms = 1e3 * float(np.median(run.step_s[1:]))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    n_params = M.count_params(cfg)
    print(f"[train] {TRAIN_ARCH} ({cfg.dtype}, f32 moments and gradient "
          f"sums; {n_params / 1e9:.3f}B params; full width: d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; depth cut from {full.n_layers} "
          f"to {cfg.n_layers} layers): {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, {TRAIN_MICRO} microbatches a step, peak lr "
          f"{TRAIN_LR}: step "
          f"{step_ms:.1f} ms (median after the first; first "
          f"{1e3 * run.step_s[0]:.1f} ms), {tok_s:.0f} tokens/s, peak "
          f"{peak:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
          f"the last 5 {np.mean(losses[-5:]):.4f}); card {card}", flush=True)
    check(all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS,
          f"train: a loss is not finite: {losses}")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"train: the loss did not fall: {losses}")
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # one smoke-width step on the card against the CPU's
    sc = get_smoke_config(TRAIN_ARCH)
    opt = AdamWConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10,
                      eps=1e-3)
    cpu = torch.device("cpu")
    p_cpu = M.init_params(sc, torch.Generator().manual_seed(4), device=cpu)
    nb = lm_batch(sc, batch=8, seq=64, step=0, seed=4)
    step = make_train_step(sc, opt, n_micro=2)
    outs = []
    for where in (cpu, dev):
        p = tree_map(lambda t: t.to(where), p_cpu)
        outs.append(step(p, init_opt_state(p), to_device(nb, where)))
    (pc, _, mc), (pg, _, mg) = outs
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
    same = all(torch.allclose(a.cpu(), b, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
               for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
    lerr = abs(float(mg["loss"]) - float(mc["loss"]))
    check(same and lerr <= TRAIN_RTOL * abs(float(mc["loss"])),
          f"train: the card's smoke step differs from the CPU's (params max "
          f"abs err {err:.3g}, loss err {lerr:.3g})")

    # a resume through a checkpoint, deterministic algorithms on
    ck = os.path.join(HERE, "build", "train_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    base = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "6", "--batch", "8",
            "--seq", "64", "--n-micro", "2", "--ckpt-every", "3",
            "--ckpt-dir", ck]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        first = T.train(T.parse_args(base), log=lambda line: None)
        shutil.rmtree(os.path.join(ck, "step_6"))
        again = T.train(T.parse_args(base), log=lambda line: None)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ck, ignore_errors=True)
    rerr = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(again.params), tree_leaves(first.params)))
    check(again.start == 3 and again.losses == first.losses[3:]
          and rerr == 0.0,
          f"train: the resumed run differs: losses {again.losses} against "
          f"{first.losses[3:]}, params max abs diff {rerr:.3g}")

    # compressed_psum over a one-rank NCCL group
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        g = {"w": torch.randn((1000, 37), device=dev),
             "z": torch.zeros(5, device=dev)}
        r = {"w": 0.01 * torch.randn((1000, 37), device=dev),
             "z": torch.zeros(5, device=dev)}
        mean, new = compressed_psum(g, r)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    ok_c = True
    for key in g:
        v = (g[key] + r[key]).cpu().numpy()
        scale = np.float32(max(float(np.abs(v).max()), 1e-12)) / np.float32(
            127.0)
        deq = np.clip(np.rint(v / scale), -127, 127).astype(np.int8).astype(
            np.float32) * scale
        ok_c &= np.array_equal(mean[key].cpu().numpy(), deq) and \
            np.array_equal(new[key].cpu().numpy(), v - deq)
    check(ok_c, "train: compressed_psum at one rank differs from the "
          "quantize-dequantize arithmetic")
    print(f"[train] checks at the smoke width (f32, TF32 off): one step on "
          f"the card against the CPU's, params max abs err {err:.3g}, loss "
          f"err {lerr:.3g} (tolerance rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}); "
          f"a resume at step 3 of 6 through the launcher's checkpoint: "
          f"losses and params bit-equal to the uninterrupted run's; "
          f"compressed_psum over a one-rank NCCL group equal to the int8 "
          f"arithmetic bit for bit; the pass took "
          f"{time.perf_counter() - t0:.1f}s; card {card}", flush=True)
    return {"peak_bytes": peak_bytes, "step_ms": step_ms}


# ---------------------------------------------------------------- dry run
# of the LM substrate (ROADMAP item 17d): the count against the card

DRYRUN_PEAK_TOL = 0.15        # the allocator's 512-byte blocks, cuBLAS
DRYRUN_CELLS = (("qwen1.5-4b", "train_4k"), ("khi-serve", "serve_b256"))


def dryrun_pass(dev, card: str, train: dict) -> None:
    """The dry run (``repro_torch.launch.dryrun``) held to the card. (a)
    ``count_cell`` of the ``[train]`` configuration on the one-card layout
    ({"data": 1, "model": 1}: qwen1.5-4b at full width, ``TRAIN_LAYERS``
    layers, ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens in ``TRAIN_MICRO``
    microbatches) over fake CUDA tensors, then one real step of that
    configuration on the card under ``op_cost.CountingMode``: its FLOPs
    and bytes must equal the fake count, and the predicted peak must lie
    within ``DRYRUN_PEAK_TOL`` of the ``[train]`` pass's
    ``max_memory_allocated``; the roofline bound under the H100 constants
    beside ``[train]``'s median step ms. (b) Meanwhile, in subprocesses,
    the CLI on the production (16, 16) mesh for ``DRYRUN_CELLS`` (meta
    tensors): status ok; per-device peak against the card's memory, the
    dominant term, the bound and the count's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train as T
    from repro_torch.launch.op_cost import CountingMode
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    out_root = os.path.join(HERE, "build", "dryrun_smoke")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--cell", cell, "--mesh", "single", "--out", out_root, "--force",
         "--device", "meta"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for arch, cell in DRYRUN_CELLS]
    try:
        # (a) the one-card layout: the fake count, then the card's step
        cfg = T.cut_depth(get_config(TRAIN_ARCH), TRAIN_LAYERS)
        cells = {"train_4k": dict(kind="train", seq=TRAIN_SEQ,
                                  batch=TRAIN_BATCH)}
        rec = D.count_cell(TRAIN_ARCH, "train_4k", {"data": 1, "model": 1},
                           n_micro=TRAIN_MICRO, config=cfg, cells=cells,
                           device="cuda")
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev)
        opt = init_opt_state(params)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in lm_batch(
            cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, step=0).items()}
        step = make_train_step(cfg, AdamWConfig(), n_micro=TRAIN_MICRO)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with CountingMode() as mode:
            new = step(params, opt, batch)
            torch.cuda.synchronize()
            end = mode.live_bytes()
        step_peak = torch.cuda.max_memory_allocated()
        real = mode.cost
        del new, params, opt, batch
        gc.collect()
        torch.cuda.empty_cache()
        cnt, mem, rl = rec["counted"], rec["memory"], rec["roofline"]
        pred = mem["peak_bytes_per_device"]
        gap = pred / train["peak_bytes"] - 1
        bound_ms = 1e3 * rl["bound_s"]
        print(f"[dryrun] (a) {TRAIN_ARCH} {TRAIN_LAYERS} layers, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} "
              f"microbatches, one card: fake CUDA count {cnt['flops_global']:.6e}"
              f" FLOPs, {cnt['bytes_global']:.6e} bytes ({cnt['n_ops']:.0f} "
              f"ops; depth fitted from 1-3 layers: {cnt['depth_fit']}) in "
              f"{rec['count_s']:.1f}s; "
              f"the card's step {real.flops:.6e} FLOPs, "
              f"{real.bytes_accessed:.6e} bytes ({real.n_ops} ops); tracked "
              f"peak fake {cnt['local_peak_bytes']:.0f} / card "
              f"{real.peak_bytes:.0f} bytes (end {end:.0f}); predicted peak "
              f"{pred / 2**30:.3f} GiB (arguments {mem['argument_bytes']:.0f}"
              f" + temp {mem['temp_bytes']:.0f} + outputs "
              f"{mem['output_bytes']:.0f}) against [train]'s "
              f"max_memory_allocated {train['peak_bytes'] / 2**30:.3f} GiB "
              f"({100 * gap:+.2f}%; this step's own {step_peak / 2**30:.3f} "
              f"GiB above {before / 2**30:.3f}); roofline (H100 SXM5 "
              f"datasheet: 989.4 TFLOP/s bf16, 3.35 TB/s) compute "
              f"{1e3 * rl['compute_s']:.2f} ms, memory "
              f"{1e3 * rl['memory_s']:.2f} ms: bound {bound_ms:.2f} ms by "
              f"{rl['dominant']} against [train]'s median step "
              f"{train['step_ms']:.1f} ms, {100 * bound_ms / train['step_ms']:.1f}"
              f"% of it; card {card}", flush=True)
        check(real.flops == cnt["flops_global"]
              and real.bytes_accessed == cnt["bytes_global"],
              f"dryrun: the card's step counts {real.flops} FLOPs and "
              f"{real.bytes_accessed} bytes, the fake count "
              f"{cnt['flops_global']} and {cnt['bytes_global']}")
        check(abs(gap) <= DRYRUN_PEAK_TOL,
              f"dryrun: predicted peak {pred} bytes is {100 * gap:+.2f}% "
              f"off the measured {train['peak_bytes']}")
        # (b) the CLI on the production mesh
        total = torch.cuda.get_device_properties(0).total_memory
        for (arch, cell), p in zip(DRYRUN_CELLS, procs):
            out, err = p.communicate(timeout=300)
            check(p.returncode == 0, f"dryrun: the CLI failed on {arch} x "
                  f"{cell}: {err[-2000:]}")
            with open(os.path.join(out_root, "single",
                                   f"{arch}__{cell}.json")) as f:
                r = json.load(f)
            check(r["status"] == "ok", f"dryrun: {arch} x {cell} status "
                  f"{r['status']}: {r.get('error')}")
            m, q = r["memory"], r["roofline"]
            print(f"[dryrun] (b) {arch} x {cell} on the (16, 16) mesh "
                  f"(meta tensors): peak {m['peak_bytes_per_device'] / 2**30:.3f}"
                  f" GiB a card (temp an upper bound: {m['temp_upper_bound']})"
                  f" of the card's {total / 2**30:.1f} GiB; bound "
                  f"{1e3 * q['bound_s']:.3f} ms by {q['dominant']} (compute "
                  f"{1e3 * q['compute_s']:.3f}, memory {1e3 * q['memory_s']:.3f},"
                  f" collective {1e3 * q['collective_s']:.3f}); count_s "
                  f"{r['count_s']:.1f}; card {card}", flush=True)
    finally:
        for p in procs:
            p.kill()
    print(f"[dryrun] the pass took {time.perf_counter() - t0:.1f}s; card "
          f"{card}", flush=True)


def sass_check(_build) -> None:
    """The compiled l2dist_qn runs on the tensor cores: its SASS (cuobjdump)
    holds HGMMA (wgmma) instructions with TF32 operands."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = _build._lib_path("l2dist")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    fn, counts, first = None, {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "l2dist_qn_kernel" in fn and "HGMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
            # "/*addr*/  HGMMA.64x128x8.F32.TF32 R24, ... ;  /* encoding */"
            first = first or line.split("*/", 1)[1].split("/*")[0].strip()
    print(f"[sass] l2dist_qn_kernel instances: HGMMA per instance "
          f"{sorted(counts.values())}; e.g. {first!r}", flush=True)
    check(len(counts) == 2 and all(v > 0 for v in counts.values())
          and first is not None and "TF32" in first,
          "l2dist_qn's SASS holds no TF32 HGMMA instruction")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--phases", choices=["all", "kernels", "lm", "train"],
                    default="all")
    args = ap.parse_args()

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    # a run that nears the 1,200 s limit prints every thread's stack to
    # stderr, so a stall shows where it was
    faulthandler.dump_traceback_later(1140)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    check(smi.returncode == 0 and bool(smi.stdout.strip()),
          "nvidia-smi did not report the card")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[smoke] card: {card}", flush=True)
    dev = torch.device("cuda")

    # nvcc (one process per source) runs while the host makes the main
    # path's data; the thread only waits on its processes
    from repro_torch.kernels import _build
    built = {}

    def build():
        t0 = time.perf_counter()
        try:
            built["seconds"] = _build.build_all(verbose=True)
        except Exception as e:          # re-raised on the main thread
            built["error"] = e
        built["wall"] = time.perf_counter() - t0

    nvcc = threading.Thread(target=build, name="nvcc")
    nvcc.start()
    try:
        data = main_data(args.n) if args.phases == "all" else None
    finally:
        nvcc.join()
    if "error" in built:
        raise built["error"]
    print(f"[build] kernels built in {built['wall']:.1f}s ("
          f"{json.dumps({k: round(v, 1) for k, v in built['seconds'].items()})}"
          f"; beside the main path's data)", flush=True)
    sass_check(_build)

    from repro_torch.configs.khi_serve import config
    cfg = config()
    rows = {}
    if args.phases not in ("lm", "train"):
        rows = kernel_checks(args.n, cfg.d, cfg.m, cfg.k,
                             cfg.k * cfg.rerank_mult, dev,
                             synthetic_windows=args.phases == "kernels")
        mark("the kernel checks")
        torch.cuda.empty_cache()
    if args.phases == "all":
        main_path(args.n, 1_000_000, dev, rows, data)
    del data
    if args.phases in ("all", "lm"):
        gc.collect()
        torch.cuda.empty_cache()
        lm_pass(dev, card)
        mark("the LM pass")
    if args.phases in ("all", "train"):
        gc.collect()
        torch.cuda.empty_cache()
        measured = train_pass(dev, card)
        mark("the train pass")
        gc.collect()
        torch.cuda.empty_cache()
        dryrun_pass(dev, card, measured)
        mark("the dryrun pass")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
