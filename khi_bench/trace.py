"""Spans and device records of a traced run (``--trace 1``).

The benchmark records spans around its calls into each layer of the
program, by wrapping these names for the traced window only:

* ``service.search``: ``repro_torch.serve.KHIService.search``;
* ``planner.plan``: ``repro_torch.core.engine.Planner.plan``;
* ``graph.program``: ``repro_torch.core.engine.Planner._run_graph``;
* ``scan.program``: ``repro_torch.core.engine.Planner._run_scan``;
* ``gather_l2_filter``: ``repro_torch.kernels.ops.gather_l2_filter``, whose
  calls' shapes, in-range ids and passing ids are counted (on a stream of
  the benchmark's own, so that the program's stream keeps its timeline);
* ``l2dist_qn``: ``repro_torch.kernels.ops.l2dist_qn`` during the build,
  each call between two CUDA events.

``torch.profiler`` records the device's operations over the window. The
benchmark's own stream is told apart by a ``spin_kernel``
(``torch.cuda._sleep``) that it launches there first, which also ties the
profiler's clock to the host's.
"""

from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["Spans", "GatherCounter", "L2distEvents", "DeviceRecord",
           "read_profile", "merge_intervals", "idle_by_span"]


class Spans:
    """Host spans (name, start ns, end ns, lanes) around wrapped calls,
    in ``time.perf_counter_ns``. ``wrap`` replaces an attribute with a
    timed stand-in; ``restore`` puts every original back."""

    def __init__(self):
        self.records: List[Tuple[str, int, int, int]] = []
        self._saved: List[Tuple[object, str, object]] = []

    def wrap(self, owner, attr: str, name: str,
             lanes: Optional[Callable] = None) -> None:
        orig = getattr(owner, attr)
        records = self.records

        def timed(*a, **kw):
            t0 = time.perf_counter_ns()
            try:
                return orig(*a, **kw)
            finally:
                records.append((name, t0, time.perf_counter_ns(),
                                lanes(*a, **kw) if lanes else 0))

        self._saved.append((owner, attr, orig))
        setattr(owner, attr, timed)

    def restore(self) -> None:
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)

    def total(self, name: str) -> Tuple[float, int, int]:
        """(seconds, calls, lanes) of the spans named ``name``."""
        sel = [r for r in self.records if r[0] == name]
        return (sum(r[2] - r[1] for r in sel) / 1e9, len(sel),
                sum(r[3] for r in sel))


class GatherCounter:
    """Stand-in for ``ops.gather_l2_filter`` that counts what each call
    reads: host sums of its shape terms, and device sums of its in-range
    ids and of its passing ids (finite distances), made on ``stream``
    after the call's output is ready."""

    def __init__(self, ops_module, stream: Optional[torch.cuda.Stream]):
        self.ops = ops_module
        self.orig = ops_module.gather_l2_filter
        self.stream = stream
        self.calls = 0
        self.shape_bytes = 0          # ids, output, queries and boxes
        self.d = self.m = self.row_bytes = 0
        self._dev = None              # (in-range ids, passing ids) int64

    def __call__(self, idx, corpus, attrs, q, qlo, qhi):
        out = self.orig(idx, corpus, attrs, q, qlo, qhi)
        B, C = idx.shape
        N, d = corpus.shape
        m = attrs.shape[1]
        self.calls += 1
        self.shape_bytes += (B * C * idx.element_size() + B * C * 4
                             + B * d * 4 + 2 * B * m * 4)
        self.d, self.m = d, m
        self.row_bytes = d * corpus.element_size()
        if self._dev is None:
            self._dev = torch.zeros(2, dtype=torch.int64, device=out.device)
        if self.stream is None:
            self._count(idx, out, N)
        else:
            self.stream.wait_stream(torch.cuda.current_stream(out.device))
            with torch.cuda.stream(self.stream):
                self._count(idx, out, N)
            idx.record_stream(self.stream)
            out.record_stream(self.stream)
        return out

    def _count(self, idx, out, N):
        self._dev[0] += ((idx >= 0) & (idx < N)).sum()
        self._dev[1] += torch.isfinite(out).sum()

    def install(self) -> None:
        self.ops.gather_l2_filter = self

    def restore(self) -> None:
        self.ops.gather_l2_filter = self.orig

    def totals(self) -> Dict:
        """Sums over the calls: calls, n_valid, n_pass, bytes, ops."""
        if self.stream is not None:
            self.stream.synchronize()
        n_valid, n_pass = ((0, 0) if self._dev is None
                           else [int(x) for x in self._dev.tolist()])
        return {"calls": self.calls, "n_valid": n_valid, "n_pass": n_pass,
                "bytes": (self.shape_bytes + n_valid * self.m * 4
                          + n_pass * self.row_bytes),
                "ops": 3.0 * n_pass * self.d}


class L2distEvents:
    """Stand-in for ``ops.l2dist_qn`` during the build: each call between
    two CUDA events; ``seconds`` reads them after a synchronize."""

    def __init__(self, ops_module):
        self.ops = ops_module
        self.orig = ops_module.l2dist_qn
        self.events = []

    def __call__(self, q, c):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.orig(q, c)
        b.record()
        self.events.append((a, b))
        return out

    def install(self) -> None:
        self.ops.l2dist_qn = self

    def restore(self) -> None:
        self.ops.l2dist_qn = self.orig

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def merge_intervals(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of [start, end) intervals, sorted and disjoint."""
    out: List[List[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_by_span(busy: List[Tuple[int, int]], w0: int, w1: int,
                 spans: List[Tuple[str, int, int, int]],
                 outside: str = "client") -> Dict[str, float]:
    """Idle seconds of [w0, w1) (no interval of ``busy`` running), each gap
    named by the innermost span (the latest started) that holds its
    midpoint, ``outside`` where none does. Spans are in the same clock
    as ``busy``."""
    gaps, t = [], w0
    for s, e in busy:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    ordered = sorted(spans, key=lambda r: r[1])
    starts = [r[1] for r in ordered]
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        name = outside
        i = bisect.bisect_right(starts, mid)
        # the innermost span holding ``mid`` is the latest started that
        # has not ended; spans nest, so a short look back finds it
        for j in range(i - 1, max(-1, i - 64), -1):
            if ordered[j][2] > mid:
                name = ordered[j][0]
                break
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e9
    return out


class DeviceRecord:
    """What the profiler saw of the window: the program's operations (the
    benchmark's stream left out) as (start, end, name) in the profiler's
    clock, and the offset that takes host ``perf_counter_ns`` to it."""

    def __init__(self, ops: List[Tuple[int, int, str]], offset: int,
                 side_ops: int):
        self.ops = ops
        self.offset = offset
        self.side_ops = side_ops
        self.streams: Dict[int, int] = {}

    def busy(self) -> List[Tuple[int, int]]:
        return merge_intervals([(s, e) for s, e, _ in self.ops])

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        agg: Dict[str, Tuple[float, int]] = {}
        for s, e, name in self.ops:
            t, c = agg.get(name, (0.0, 0))
            agg[name] = (t + (e - s) / 1e9, c + 1)
        return agg

    def kernel(self, pattern: str) -> Tuple[float, int]:
        """(seconds, records) of the operations whose name matches."""
        rx = re.compile(pattern)
        t, c = 0.0, 0
        for name, (s, n) in self.by_name().items():
            if rx.search(name):
                t, c = t + s, c + n
        return t, c


def read_profile(prof, marker_host_ns: int) -> DeviceRecord:
    """The profiler's device-side records (kernels, copies, sets; host
    operators are not recorded), read raw. The streams that ran a
    ``spin_kernel`` are the benchmark's own; the first one, launched at
    host time ``marker_host_ns``, gives the clock offset."""
    from torch.autograd import DeviceType

    raw = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            continue
        s = e.start_ns()
        raw.append((s, s + e.duration_ns(), e.name(),
                    e.device_resource_id()))
    spins = sorted((s, r) for s, _, name, r in raw if "spin_kernel" in name)
    side = {r for _, r in spins}
    offset = spins[0][0] - marker_host_ns if spins else 0
    ops = [(s, e, name) for s, e, name, r in raw if r not in side]
    rec = DeviceRecord(ops, offset, len(raw) - len(ops))
    rec.streams = dict(collections.Counter(r for *_, r in raw))
    return rec
