"""The benchmark's one command, run from the root of a checkout:

    python3 -m khi_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

A run builds the cell's KHI shard on the card from the seed's corpus
(set-up), warms the served bucket, then drives
``repro_torch.serve.KHIService.search`` in a closed loop of bursts for
``--seconds``, each request with a fresh vector and a fresh box. After the
window it reads the peak memory, frees the program's state and judges a
seeded sample of the window's answers against the plain reference
(``check.py``). The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and ``checks`` last); the numbers
compared, each beside its limit, are also the last lines of standard
error. Untraced, the metrics are the cell's end-to-end ones; traced, its
per-layer ones, read by ``metrics/<name>.py`` from the spans and counters
of ``trace.py`` and the profiler's records.

Without a CUDA device, with fewer than the cell asks for, without the
program's sources in the checkout, or with JAX or the JAX package loaded,
it exits with another code than 0 and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import manifest as mf  # noqa: E402

__all__ = ["FORBIDDEN", "Cell", "PlanLog", "check_traffic", "run_cell",
           "forbidden_modules", "main"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# the hand kernels the served path launches, by their records' names
KERNEL_RECORDS = {"gather_l2_filter": r"gather_l2_filter_kernel",
                  "scan_topk": r"box_scan_kernel<float"}


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths, so that only a checkout's first run builds."""
    build = root / "build"
    for key, sub in (("REPRO_TORCH_BUILD_DIR", "repro_torch_kernels"),
                     ("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor_cache"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[key] = str(build / sub)


def import_program(root: Path):
    """``repro_torch`` from the checkout's ``src``, and from nowhere else."""
    pkg = root / "src" / "repro_torch" / "__init__.py"
    if not pkg.is_file():
        raise SystemExit(f"khi_bench: {pkg} not found; the benchmark runs "
                         f"the program of its own checkout")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch
    if Path(repro_torch.__file__).resolve() != pkg.resolve():
        raise SystemExit(f"khi_bench: repro_torch was imported from "
                         f"{repro_torch.__file__}, not from {pkg}")
    return repro_torch


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _merge(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for key, val in over.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], val)
        else:
            out[key] = val
    return out


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class PlanLog:
    """Records which lanes the program's planner sent to the exact scan in
    the window: ``Planner.plan`` is wrapped while the log is installed, and
    each call's boxes and ``use_scan`` kept. ``scan_lanes`` then tells, for
    requests of the window, the plan that served them."""

    def __init__(self):
        self.calls: List = []
        self._orig = None

    def install(self) -> None:
        from repro_torch.core.engine import Planner

        orig = self._orig = Planner.plan
        calls = self.calls

        def plan(planner, qlo, qhi):
            out = orig(planner, qlo, qhi)
            calls.append((np.array(qlo, np.float32),
                          np.array(qhi, np.float32),
                          np.array(out.use_scan, bool)))
            return out

        Planner.plan = plan

    def restore(self) -> None:
        from repro_torch.core.engine import Planner

        if self._orig is not None:
            Planner.plan, self._orig = self._orig, None

    def scan_lanes(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """(B,) bool: whether the plan that served each of these requests
        (found by its box, which is fresh for every request) sent it to the
        exact scan. Raises where a request met no plan in the window."""
        seen: Dict[bytes, bool] = {}
        for qlo, qhi, use_scan in self.calls:
            for a, b, u in zip(qlo, qhi, use_scan):
                seen[a.tobytes() + b.tobytes()] = bool(u)
        lo = np.ascontiguousarray(lo, np.float32)
        hi = np.ascontiguousarray(hi, np.float32)
        out = np.zeros(len(lo), bool)
        for i in range(len(lo)):
            key = lo[i].tobytes() + hi[i].tobytes()
            if key not in seen:
                raise RuntimeError(
                    f"request {i} of the sample met no plan of the program's "
                    f"planner in the window ({len(self.calls)} plan calls "
                    f"recorded): its exact lanes cannot be told apart")
            out[i] = seen[key]
        return out


def check_traffic(traffic: Dict) -> None:
    """Refuses a mix that asks for what the window does not do: it runs a
    closed loop whose clients each hold one request of a burst."""
    if traffic.get("loop") != "closed":
        raise ValueError(f"traffic loop {traffic.get('loop')!r}: the window "
                         f"runs a closed loop only")
    if int(traffic.get("clients", -1)) != int(traffic["burst"]):
        raise ValueError(f"traffic clients {traffic.get('clients')!r} with "
                         f"burst {traffic['burst']}: the closed loop sends "
                         f"one burst of all its clients at a time")


class Cell:
    """One cell's set-up and window. ``overrides`` ({"config": ...,
    "traffic": ...}) replace keys of the cell's files: the tests use it
    to run the same path at a size the CPU holds."""

    def __init__(self, workload_name: str, seed: int, device, *,
                 root: Path = mf.ROOT, overrides: Optional[Dict] = None,
                 trace: bool = False):
        import torch

        overrides = overrides or {}
        self.manifest = mf.load(root)
        self.workload = mf.workload(self.manifest, workload_name)
        self.name = workload_name
        self.cfg = _merge(mf.config(self.manifest, self.workload["config"],
                                    root), overrides.get("config", {}))
        self.traffic = _merge(mf.traffic(self.workload["traffic"]),
                              overrides.get("traffic", {}))
        check_traffic(self.traffic)
        self.limits = mf.cell_limits(workload_name)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = trace
        self.parts: Dict[str, float] = {}
        self.l2dist_s: Optional[float] = None
        self.di = None
        self.index = None

    # ---------------------------------------------------------- set-up
    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build_kernels(self) -> None:
        """Compile the program's kernels now (cached in the checkout after
        the first run), so that none compiles in the window."""
        t = time.perf_counter()
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            built = _build.build_all()
            for name in built:
                _build.library(name)
            log(f"[setup] kernels {built}")
        self.parts["kernels_s"] = time.perf_counter() - t

    def make_data(self) -> None:
        from . import generator

        t = time.perf_counter()
        corpus = generator.make_corpus(self.cfg, self.seed, self.device)
        self.boxes = generator.BoxSampler(corpus.attrs,
                                          self.traffic["sigma_min"],
                                          self.traffic["sigma_max"])
        cal = self.boxes.calibrate(
            corpus.attrs, generator._gen(self.device, self.seed, "calibrate"),
            rows=int(self.traffic["calibration_rows"]),
            boxes=int(self.traffic["calibration_boxes"]))
        self.vecs = corpus.vecs.cpu().numpy()
        self.attrs = corpus.attrs.cpu().numpy()
        # the streams read base rows from the host copy
        corpus.vecs = None
        self.stream = generator.RequestStream(corpus, self.vecs, self.boxes,
                                              self.traffic, self.seed)
        self.warm_stream = generator.RequestStream(
            corpus, self.vecs, self.boxes, self.traffic, self.seed,
            tag="warmup")
        self.chunks = [self.stream.next_chunk()
                       for _ in range(int(self.traffic["prefetch_chunks"]))]
        self._sync()
        self.parts["data_s"] = time.perf_counter() - t
        log(f"[data] corpus {self.vecs.shape} attrs {self.attrs.shape} "
            f"nn_dist {corpus.nn_dist:.6g} noise_std {corpus.noise_std:.4g}; "
            f"boxes: mult {cal['mult']:.6g}, achieved/target on "
            f"{cal['boxes']} boxes x {cal['rows']} rows (q05, q50, q95) "
            f"{[round(x, 4) for x in cal['ratio_q']]}; "
            f"{self.parts['data_s']:.2f}s")

    def build_index(self, keep_index: bool = False) -> None:
        import torch
        from repro_torch.core import KHIConfig, KHIIndex
        from repro_torch.core.engine import device_put_index
        from repro_torch.kernels import ops
        from .trace import L2distEvents

        timer = None
        if self.trace and self.device.type == "cuda":
            timer = L2distEvents(ops)
            timer.install()
        dtype = getattr(torch, self.cfg.get("vec_dtype", "float32"))
        self._sync()
        t = time.perf_counter()
        try:
            index = KHIIndex.build(self.vecs, self.attrs,
                                   KHIConfig(**self.cfg["index"]),
                                   device=self.device)
            self.di = device_put_index(index, device=self.device,
                                       vec_dtype=dtype)
            self._sync()
        finally:
            if timer is not None:
                timer.restore()
        self.build_s = time.perf_counter() - t
        if timer is not None:
            self.l2dist_s = timer.seconds()
        if keep_index:
            self.index = index
        else:
            index.nbrs = None
        del index
        log(f"[build] {self.build_s:.3f}s (height {self.di.height}, "
            f"{self.di.lo.shape[0]} tree nodes)"
            + (f"; l2dist_qn {self.l2dist_s:.3f}s by CUDA events"
               if self.l2dist_s is not None else ""))

    def params(self, **changed):
        """The configuration's search parameters, with ``changed`` keys
        replaced (the faults and the readings cut the search short)."""
        from repro_torch.core.engine import SearchParams
        return SearchParams(**{**self.cfg["search"], **changed})

    def service(self, di=None, **changed):
        from repro_torch.serve import KHIService, ServeConfig

        s = self.cfg["serve"]
        return KHIService(di if di is not None else self.di,
                          self.params(**changed),
                          config=ServeConfig(buckets=tuple(s["buckets"]),
                                             cache_size=int(s["cache_size"])))

    def warm(self, svc) -> None:
        """Serve ``warmup_bursts`` bursts of the warm-up stream: the one
        bucket this traffic fills, with requests the window never sends."""
        t = time.perf_counter()
        q, lo, hi = self.warm_stream.next_chunk()
        B = int(self.traffic["burst"])
        for i in range(int(self.traffic["warmup_bursts"])):
            svc.search(q[i * B:(i + 1) * B], lo[i * B:(i + 1) * B],
                       hi[i * B:(i + 1) * B])
        self._sync()
        self.parts["warmup_s"] = time.perf_counter() - t

    def setup(self, keep_index: bool = False):
        self.build_kernels()
        self.make_data()
        self.build_index(keep_index)
        svc = self.service()
        self.warm(svc)
        return svc

    # ---------------------------------------------------------- window
    def window(self, svc, seconds: float, search: Optional[Callable] = None
               ) -> Dict:
        """The closed loop: ``clients`` requests a burst, the next burst
        sent when the last answer is on the host, until ``seconds`` have
        passed. Bursts walk the stream's chunks in order (a chunk holds a
        whole number of bursts); drawing a further chunk stops the
        clock."""
        B = int(self.traffic["burst"])
        search = search or svc.search
        # what set-up left lives on, as a server's loaded state does: it is
        # frozen out of the collector, whose passes in the window then walk
        # the window's objects alone
        gc.collect()
        gc.freeze()
        try:
            return self._loop(search, B, seconds)
        finally:
            gc.unfreeze()

    def _loop(self, search: Callable, B: int, seconds: float) -> Dict:
        ids, dists, lat = [], [], []
        paused = 0.0
        chunk, pos, used = 0, 0, 0
        t_start = time.perf_counter()
        while True:
            if chunk == len(self.chunks):
                tp = time.perf_counter()
                self.chunks.append(self.stream.next_chunk())
                paused += time.perf_counter() - tp
            q, lo, hi = self.chunks[chunk]
            t0 = time.perf_counter()
            i, d = search(q[pos:pos + B], lo[pos:pos + B], hi[pos:pos + B])
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            ids.append(np.asarray(i))
            dists.append(np.asarray(d))
            used += B
            pos += B
            if pos >= len(q):
                chunk, pos = chunk + 1, 0
            if t1 - t_start - paused >= seconds:
                break
        sent = [np.concatenate([c[j] for c in self.chunks[:chunk + 1]])[:used]
                for j in range(3)]
        return {"seconds": t1 - t_start - paused, "answered": used,
                "burst": B, "latencies": np.asarray(lat),
                "ids": np.concatenate(ids), "dists": np.concatenate(dists),
                "q": sent[0], "lo": sent[1], "hi": sent[2],
                "t_start": t_start, "paused": paused}

    def sample(self, answered: int) -> np.ndarray:
        """The seeded, uniform sample of the window's answers to judge."""
        from . import generator
        rng = np.random.default_rng(generator.sub_seed(self.seed, "sample"))
        size = min(int(self.traffic["check_sample"]), answered)
        return np.sort(rng.choice(answered, size=size, replace=False))

    def judge(self, win: Dict, idx: np.ndarray, scan_lane) -> Dict:
        """The reference over the sample, on the device, after the
        program's state is freed."""
        import torch
        from . import check

        vecs = torch.as_tensor(self.vecs).to(self.device)
        attrs = torch.as_tensor(self.attrs).to(self.device)
        try:
            return check.judge(vecs, attrs, win["q"][idx], win["lo"][idx],
                               win["hi"][idx], win["ids"][idx],
                               win["dists"][idx], int(self.cfg["search"]["k"]),
                               scan_lane)
        finally:
            del vecs, attrs
            if self.device.type == "cuda":
                torch.cuda.empty_cache()


def _traced_window(cell: Cell, svc, seconds: float, ctx: Dict) -> Dict:
    """The window under torch.profiler, with the layer spans and the
    gather counter installed; fills ``ctx`` with what the per-layer
    readers read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import Planner
    from repro_torch.kernels import ops
    from repro_torch.serve import KHIService
    from .trace import GatherCounter, Spans, read_profile

    spans = Spans()
    spans.wrap(KHIService, "search", "service.search",
               lambda self, q, *a, **k: len(q))
    spans.wrap(Planner, "plan", "planner.plan",
               lambda self, lo, hi: len(lo))
    spans.wrap(Planner, "_run_graph", "graph.program",
               lambda self, qs, lo, hi: len(qs))
    spans.wrap(Planner, "_run_scan", "scan.program",
               lambda self, qs, lo, hi: len(qs))
    is_cuda = cell.device.type == "cuda"
    side = torch.cuda.Stream(cell.device) if is_cuda else None
    gather = GatherCounter(ops, side)
    gather.install()
    try:
        # on the CPU (the tests) the profiler records host operators only,
        # so the device's readers find nothing
        with profile(activities=[ProfilerActivity.CUDA if is_cuda
                                 else ProfilerActivity.CPU]) as prof:
            cell._sync()
            t_mark = time.perf_counter_ns()
            if is_cuda:
                with torch.cuda.stream(side):
                    torch.cuda._sleep(1000)
                cell._sync()
            win = cell.window(svc, seconds)
            cell._sync()
    finally:
        gather.restore()
        spans.restore()
    t = time.perf_counter()
    rec = read_profile(prof, t_mark)
    w0 = int(win["t_start"] * 1e9) + rec.offset
    w1 = w0 + int((win["seconds"] + win["paused"]) * 1e9)
    busy = [(max(s, w0), min(e, w1)) for s, e in rec.busy()
            if e > w0 and s < w1]
    ctx.update(spans=spans, gather=gather.totals(), device_record=rec,
               window_s=win["seconds"],
               busy_s=sum(e - s for s, e in busy) / 1e9,
               busy=busy, w0=w0, w1=w1)
    log(f"[trace] {len(rec.ops)} device records of the program "
        f"({rec.side_ops} of the benchmark's stream), read in "
        f"{time.perf_counter() - t:.2f}s; clock offset {rec.offset} ns; "
        f"records by stream {rec.streams}")
    return win


def short_name(name: str, most: int = 120) -> str:
    """A kernel's name without its argument list, and without its
    template arguments where they run past ``most`` letters."""
    name = name.split("(", 1)[0].removeprefix("void ")
    return name if len(name) <= most else name.split("<", 1)[0]


def _breakdown(ctx: Dict) -> Dict:
    from .trace import idle_by_span

    rec = ctx["device_record"]
    by_op: Dict[str, float] = {}
    for name, (t, _) in rec.by_name().items():
        by_op[short_name(name)] = by_op.get(short_name(name), 0.0) + t
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    spans = [(n, s + rec.offset, e + rec.offset, c)
             for n, s, e, c in ctx["spans"].records]
    idle = idle_by_span(ctx["busy"], ctx["w0"], ctx["w1"], spans)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name, t] for name, t in ops],
            "idle_gaps": [[name, t] for name, t in gaps]}


def run_cell(workload_name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", root: Path = mf.ROOT,
             overrides: Optional[Dict] = None,
             plant: Optional[Callable] = None) -> Dict:
    """One run of a cell. ``plant(cell, svc)``, for the tests, may return a
    stand-in for ``svc.search`` that breaks the timed path underneath."""
    import torch
    from repro_torch.kernels import ops

    is_cuda = torch.device(device).type == "cuda"
    cell = Cell(workload_name, seed, device, root=root, overrides=overrides,
                trace=trace)
    log(f"[config] {workload_name}: {cell.workload['config']} x "
        f"{cell.workload['traffic']}, seed {seed}, {seconds}s window, "
        f"trace {int(trace)}; card {card_line() if is_cuda else 'none'}")
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    svc = cell.setup()
    # from the start of the process: imports and kernels count too
    setup_s = time.perf_counter() - _T0
    log(f"[setup] {setup_s:.3f}s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in cell.parts.items())
        + f", build_s {cell.build_s:.2f}")
    search = plant(cell, svc) if plant else None
    before = svc.snapshot()
    launches0 = dict(ops.LAUNCHES)
    ctx: Dict = {"trace": trace}
    plans = PlanLog()
    plans.install()
    try:
        if trace:
            win = _traced_window(cell, svc, seconds, ctx)
        else:
            win = cell.window(svc, seconds, search)
    finally:
        plans.restore()
    after = svc.snapshot()
    snap = {key: after[key] - before[key] for key in
            ("requests", "batches", "pad_lanes", "cache_hits",
             "device_queries", "device_seconds", "scan_lanes")}
    launches = {key: ops.LAUNCHES[key] - launches0[key]
                for key in ops.LAUNCHES if ops.LAUNCHES[key] != launches0[key]}
    idx = cell.sample(win["answered"])
    scan_lane = plans.scan_lanes(win["lo"][idx], win["hi"][idx])
    peak = torch.cuda.max_memory_allocated(cell.device) if is_cuda else 0
    lat = win["latencies"]
    log(f"[window] {win['answered']} requests in {len(lat)} bursts of "
        f"{win['burst']} over {win['seconds']:.3f}s (client paused "
        f"{win['paused']:.3f}s); burst latency ms median "
        f"{1e3 * float(np.median(lat)):.2f}, p95 over requests "
        f"{1e3 * float(np.percentile(np.repeat(lat, win['burst']), 95)):.2f}"
        f", max {1e3 * float(lat.max()):.2f}")
    log(f"[window] service {snap}; kernel launches {launches}")
    if trace:
        rec = ctx["device_record"]
        for name, rx in KERNEL_RECORDS.items():
            t, c = rec.kernel(rx)
            log(f"[trace] {name}: {c} profiler records of "
                f"{launches.get(name, 0)} launches, {t:.6f}s on the card")
    # the program's state goes before the reference runs
    del svc, search
    cell.di = None
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = cell.judge(win, idx, scan_lane)
    log(f"[check] reference over {len(idx)} sampled requests in "
        f"{time.perf_counter() - t:.2f}s; box rows (min, q05, q50, q95, max) "
        f"{numbers['box_rows']}; scan lanes in the sample "
        f"{numbers['scan_lanes_sampled']}; recall@k {numbers['recall_at_k']}")
    from .check import compare
    checks = compare(numbers, cell.limits)
    ctx.update(window=win, numbers=numbers, build_s=cell.build_s,
               setup_s=setup_s, snapshot=snap, launches=launches,
               l2dist_s=cell.l2dist_s, window_s=ctx.get("window_s",
                                                         win["seconds"]))
    metrics = {}
    for m in mf.metrics_for(cell.manifest, workload_name, trace):
        value = mf.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if is_cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(cell.device)
                            if is_cuda else "cpu"),
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": int(win["answered"]),
              "failed": 0,
              "metrics": metrics,
              "device": device_info}
    if trace:
        device_info["busy_s"] = ctx["busy_s"]
        device_info["window_s"] = ctx["window_s"]
        result["breakdown"] = _breakdown(ctx)
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    return result


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m khi_bench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = mf.ROOT
    set_cache_dirs(root)
    import torch

    manifest = mf.load(root)
    chips = int(mf.workload(manifest, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"khi_bench: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 2
    import_program(root)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), root=root)
    found = forbidden_modules()
    if found:
        log(f"khi_bench: the run loaded {found}, which the port may not "
            f"use; no result")
        return 3
    for name, c in result["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
