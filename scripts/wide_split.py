"""Phase split of the scan family's plane design on an H100.

The plane design (``scan_topk_wide.cu``'s for every wide form before the
forms took candidate lists: the box and bitmask forms until their
redesign, the windowed forms until theirs) runs two kernels a query
chunk:
``wide_score_kernel`` writes a (chunk, N) distance plane, and
``wide_select_kernel`` selects and sorts each query's k from it. This
script times the two apart by the profiler's device records, counts the
score tiles that had a passing pair (live), and splits a live score
block's cycles by ``clock64()`` stamps taken by thread 0: the predicate
test, the slab loads (staging a 32-wide d slab of queries and rows into
shared memory) and the FMA loop.

The stamps are put into a copy of the source at build time (text
anchors in ``wide_score_kernel``; the library under test is built from
that copy), so the kernel in the repository carries none:

    python3 scripts/wide_split.py --src OLD/scan_topk_wide.cu \
        --forms box,box_bf16,box_q8,mask,mask_bf16

``--src`` is a source of the plane design (``git archive`` of a commit
before the box and bitmask forms' redesign); the repository's own file
holds none. The windowed forms' modes went with their plane design: the
source that had it also had its own copy of this script (``git
archive`` of a commit before the windowed redesign, run from that copy
with ``--forms win,win_bf16``). The inputs are
made on the card from a seed with the served shape's distributions
(``chip_smoke.py``'s kernel checks): N = 1M rows of d = 768 normal
floats, m = 4 uniform attrs, 256 queries with boxes of ~5% passing pairs
(one empty), a bitmask passing ~54% of rows. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))

import torch  # noqa: E402

# (anchor, text put after it) in wide_score_kernel; each anchor occurs once
PROBES = [
    ("  const int nq = min(WQ, B - b0);\n",
     "  const long long t_entry = probe_clock();\n"
     "  long long t_load = 0, t_fma = 0;\n"),
    ("  float acc[4][4];\n", "  const long long t_pred = probe_clock();\n"),
    ("    for (int k0 = 0; k0 < d; k0 += WD) {\n",
     "      const long long t_l0 = probe_clock();\n"),
    ("        Rs[r * WLD + c] = v;\n      }\n      __syncthreads();\n",
     "      const long long t_f0 = probe_clock();\n"
     "      t_load += t_f0 - t_l0;\n"),
    ("            acc[i][j] = fmaf(t, t, acc[i][j]);\n          }\n      }\n",
     "      t_fma += probe_clock() - t_f0;\n"),
]
EXIT_ANCHOR = ("#pragma unroll\n  for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
               "    for (int j = 0; j < 4; ++j) {\n"
               "      const int b = ty + 16 * i, r = tx + 16 * j;\n")
EXIT_PROBE = (
    "  if (g_probe != nullptr && tid == 0) {\n"
    "    long long* p = g_probe + 6 * ((size_t)blockIdx.y * gridDim.x +\n"
    "                                  blockIdx.x);\n"
    "    p[0] = t_entry; p[1] = t_pred; p[2] = t_load; p[3] = t_fma;\n"
    "    p[4] = probe_clock(); p[5] = t_load > 0;\n"
    "  }\n")
HEAD = (
    "#include <cuda_runtime.h>\n"
    "__device__ long long* g_probe = nullptr;\n"
    "__device__ __forceinline__ long long probe_clock() {\n"
    "  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t)::\"memory\");\n"
    "  return t;\n"
    "}\n")
TAIL = (
    "extern \"C\" int wide_set_probe(void* p) {\n"
    "  return (int)cudaMemcpyToSymbol(g_probe, &p, sizeof(p));\n"
    "}\n")

# form -> (entry, corpus kind, k, side)
FORMS = {
    "box": ("scan_topk_wide_f32", "f32", 100, None),
    "box_bf16": ("scan_topk_wide_bf16", "bf16", 400, None),
    "box_q8": ("scan_topk_wide_q8", "q8", 400, "scale"),
    "mask": ("scan_topk_mask_wide_f32", "f32", 100, "mask"),
    "mask_bf16": ("scan_topk_mask_wide_bf16", "bf16", 100, "mask"),
}


def probed_source(text: str) -> str:
    start = text.index("wide_score_kernel(")
    end = text.index("wide_select_kernel(")
    body = text[start:end]
    for anchor, add in PROBES:
        if body.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in wide_score_kernel: "
                             f"{anchor!r}")
        body = body.replace(anchor, anchor + add)
    if body.count(EXIT_ANCHOR) != 1:
        raise SystemExit("exit anchor not found once in wide_score_kernel")
    body = body.replace(EXIT_ANCHOR, EXIT_PROBE + EXIT_ANCHOR)
    return HEAD + text[:start] + body + text[end:] + TAIL


def build(src: Path, out_dir: Path, probed: bool) -> ctypes.CDLL:
    """The source as it is (``probed`` False: the times) or with the
    stamps (the split: a stamp's asm is a barrier to the compiler, so the
    probed kernel runs slower), built as ``kernels/_build.py`` builds."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "probed" if probed else "plain"
    cu = out_dir / f"scan_topk_wide_{tag}.cu"
    text = src.read_text()
    cu.write_text(probed_source(text) if probed else HEAD + text + TAIL)
    lib = out_dir / f"scan_topk_wide_{tag}.so"
    nvcc = "nvcc" if subprocess.run(["which", "nvcc"], capture_output=True
                                    ).returncode == 0 \
        else "/usr/local/cuda/bin/nvcc"
    # the source's own includes (scan_topk.cu) resolve beside the original
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(src.parent), "-o", str(lib), str(cu)],
                   check=True)
    return ctypes.CDLL(str(lib))


def device_ms(fn):
    """{kernel name: ms} of the device-side records of one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            continue
        out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, required=True,
                    help="a scan_topk_wide.cu of the plane design")
    ap.add_argument("--forms", default="box,box_bf16,box_q8,mask,mask_bf16")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.kernels import ops, quant

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[split] card: {smi}", flush=True)
    libs = {probed: build(args.src, HERE / "build" / "wide_split", probed)
            for probed in (False, True)}
    P, I = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, d, m, B = args.n, 768, 4, 256
    corpus = torch.randn((n, d), generator=g, device=dev)
    attrs = torch.rand((n, m), generator=g, device=dev)
    attrs[7::97, 1] = float("nan")
    q = torch.randn((B, d), generator=g, device=dev)
    qlo = torch.rand((B, m), generator=g, device=dev) * 0.6
    qhi = qlo + torch.rand((B, m), generator=g, device=dev) * 0.4 + 0.3
    qhi[0] = -1.0
    mask = torch.where(attrs[:, 0] < 0.55, 1.0, -1.0)[:, None].contiguous()
    mask[11::101] = float("nan")
    mask[13::103] = 0.0
    replicas = {"f32": corpus,
                "bf16": quant.quant_replica(corpus, "bf16")[0]}
    qv, qs = quant.quant_replica(corpus, "int8")
    replicas["q8"] = qv
    ok = ((attrs[None] >= qlo[:, None]) & (attrs[None] <= qhi[:, None])
          ).all(-1)                                    # (B, n)
    n_pairs = int(ok.sum())
    nt = -(-n // 64)
    pad = nt * 64 - n
    box_tiles = torch.nn.functional.pad(ok, (0, pad)).view(
        4, 64, nt, 64).any(3).any(1)                   # (qblocks, row tiles)
    row_ok = torch.nn.functional.pad(mask[:, 0] > 0, (0, pad)).view(nt, 64)
    print(f"[split] B={B} N={n} d={d} m={m}: {n_pairs} passing pairs, "
          f"{int((mask[:, 0] > 0).sum())} bitmask rows; {4 * nt} score "
          f"tiles of 64 x 64", flush=True)
    del ok
    for form in args.forms.split(","):
        entry, kind, k, side_kind = FORMS[form]
        cx = replicas[kind]
        side = {"scale": qs, "mask": mask}.get(side_kind)
        # the plane design's chunk: its (chunk, N) plane and key buffers
        # within the scratch cap
        chunk = max(1, min(B, ops.WIDE_SCRATCH_BYTES // (4 * n + 16 * k)))
        dist = torch.empty(chunk * n, dtype=torch.float32, device=dev)
        keys = torch.empty(2 * chunk * k, dtype=torch.int32, device=dev)
        idbuf = torch.empty(2 * chunk * k, dtype=torch.int32, device=dev)
        ids = torch.empty((B, k), dtype=torch.int32, device=dev)
        dd = torch.empty((B, k), dtype=torch.float32, device=dev)
        mask_form = side_kind == "mask"

        def call(lib):
            f = getattr(lib, entry)
            f.argtypes = [P] * 11 + [I] * 6 + [P]
            rc = f(cx.data_ptr(), None if side is None else side.data_ptr(),
                   None if mask_form else attrs.data_ptr(), q.data_ptr(),
                   None if mask_form else qlo.data_ptr(),
                   None if mask_form else qhi.data_ptr(), dist.data_ptr(),
                   keys.data_ptr(), idbuf.data_ptr(), ids.data_ptr(),
                   dd.data_ptr(), B, n, d, 0 if mask_form else m, k, chunk,
                   torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"{entry}: cudaError {rc}")

        call(libs[False])
        split = {}
        for _ in range(args.reps):
            for name, ms in device_ms(lambda: call(libs[False])).items():
                key = ("score" if "wide_score" in name else "select"
                       if "wide_select" in name else name)
                split[key] = split.get(key, 0.0) + ms / args.reps
        grid_blocks = nt * -(-chunk // 64) * -(-B // chunk)
        probe = torch.zeros(6 * grid_blocks, dtype=torch.int64, device=dev)
        libs[True].wide_set_probe(ctypes.c_void_p(probe.data_ptr()))
        call(libs[True])
        torch.cuda.synchronize()
        p = probe.view(-1, 6).double()
        live = p[:, 5] > 0
        lp = p[live]
        total = (lp[:, 4] - lp[:, 0]).mean().item()
        pred = (lp[:, 1] - lp[:, 0]).mean().item()
        load = lp[:, 2].mean().item()
        fma = lp[:, 3].mean().item()
        rest = total - pred - load - fma
        want_live = (int(row_ok.any(1).sum()) * 4 if mask_form
                     else int(box_tiles.sum()))
        dead = p[~live]
        dead_c = (dead[:, 4] - dead[:, 0]).mean().item() if len(dead) else 0
        print(f"[split] {form} ({entry}, k={k}): score "
              f"{split.get('score', 0):.3f} ms, select "
              f"{split.get('select', 0):.3f} ms"
              + "".join(f", {nm} {ms:.3f} ms" for nm, ms in split.items()
                        if nm not in ("score", "select"))
              + f"; live tiles {int(live.sum())} of {len(p)}"
              + f" (counted from the inputs: {want_live})"
              + f"; a live block's thread 0: predicate {pred:.0f} cycles "
              f"({100 * pred / total:.1f}%), slab loads {load:.0f} "
              f"({100 * load / total:.1f}%), FMA loop {fma:.0f} "
              f"({100 * fma / total:.1f}%), rest {rest:.0f} "
              f"({100 * rest / total:.1f}%), {total:.0f} in all; a dead "
              f"block {dead_c:.0f}", flush=True)
        del dist, keys, idbuf
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
