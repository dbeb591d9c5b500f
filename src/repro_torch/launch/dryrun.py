"""Multi-pod dry run of the port: count every (architecture x input-shape
x mesh) cell's step and record its memory, FLOPs, bytes, collectives and
roofline on NVIDIA H100 cards, with no card work and no allocation: the
counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 512 fake TPU host devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --cell train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Records go to ``build/dryrun/<mesh>/<arch>__<cell>[__<tag>].json``
(``--out`` another root); a record is reused unless ``--force``.
``--device cpu`` (or ``meta``) counts without a GPU.

How it runs. ``run_cell`` starts torch's ``fake`` process group at the
mesh's 256 or 512 ranks in its own process (``init_dryrun_process_group``,
the counterpart of the reference's ``XLA_FLAGS`` lines) and builds the
production mesh over it; a process that already runs a real group hands
the cell to a subprocess (the two cannot share a process). The step runs
under ``FakeTensor``s on ``--device`` (the card's device type by default),
counted by ``op_cost.CountingMode``. What each number is:

  - **Static bytes** (``memory.argument_bytes``, ``output_bytes``) are
    exact: each leaf's shard on one device (``local_shape`` of its spec),
    times its item size. ``alias_bytes`` counts the outputs the port
    writes into its inputs (decode's cache). The trees the reference
    donates are listed in ``donated``; the port's AdamW builds new
    parameters and moments while the step's inputs live, so a train
    step's outputs count in full.
  - **FLOPs and bytes** are counted over the global program at the cell's
    shapes (every microbatch's forward and backward, the gradient sums,
    one AdamW update) and divided by the card count: the even split the
    reference's roofline calls equivalent (``"split": "even"``). Two
    exact shortcuts keep the count short, each checked against a direct
    count in the tests: with more than 3 microbatches the count is
    C2 + (n-2)(C3 - C2) of the counts at 2 and 3 (every microbatch runs
    the same ops); with a stage of more than 3 repeats it is fitted from
    that stage at 1, 2 and 3 repeats as a + bR + cR^2 (each repeat runs
    the same ops; backward through a slice of a stacked leaf writes the
    whole leaf, the R^2 term).
  - **Temp** is the tracker's peak over the step at the local batch
    (batch / data.pod rows; for a train step its first two microbatches
    and the update, whose peak every later microbatch repeats) and full
    width, less what it left live (its outputs). A tensor of a
    parameter's shape counts at that parameter's shard of one device (the
    moments' shard for f32); activations count at full width, so where the
    model axis splits them temp is an upper bound
    (``memory.temp_upper_bound``). ``peak_bytes_per_device`` is
    argument + temp + output - alias, the reference's formula.
  - **Collectives** follow a layout model of the specs, each collective's
    wire bytes by the ring formulas of ``launch.roofline`` (NVLink inside
    a node of 8 consecutive ranks, the NIC across nodes):
      FSDP: an all-gather of each weight sharded on the fsdp axes in
        every microbatch's forward, another in its backward, and one
        reduce-scatter of its f32 gradient a step;
      data parallelism: an all-reduce over ``data`` (and over ``pod``) of
        each f32 gradient not sharded on that axis, once a step;
      tensor parallelism: in each layer whose heads (or SSM in_proj) are
        sharded on ``model`` one all-reduce of the (b_local, S, d_model)
        activations, and one more where its FFN is sharded, in the
        forward and again in the backward of every microbatch (only the
        forward in prefill and decode, at S = 1 in decode);
      MoE: where experts are sharded on ``model``, two all-to-alls of the
        (E, C, d_model) dispatch buffer a layer in the forward and two in
        the backward;
      khi-serve: the cross-shard merge, ``merge_bytes_per_device`` for
        each of the local batch's queries over the ``model`` axis.
    The vocab-parallel softmax's per-token statistics are left out.
  - **khi-serve**: the index bytes a device holds are one shard of
    ``sharded_input_specs`` at the cell's full shapes (1M rows a shard,
    d = 768). Its hop loop syncs with the host every hop, so it is not
    run: a hop's work is the fused gather's (``op_cost.
    gather_l2_filter_work``: B_local x E.c_n rows of d.4 + m.4 bytes)
    plus the expanded nodes' neighbour rows (B_local x E x M int32),
    scaled by ``max_hops`` as the reference scales its hop body; temp is
    one hop's candidate ids and distances (the pool is not counted).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..models.sharding import _axes, local_shape
from . import roofline as RL
from .mesh import (PRODUCTION_MESHES, init_dryrun_process_group,
                   make_production_mesh, mesh_axis_sizes)
from .op_cost import CountingMode, OpCost, count, gather_l2_filter_work
from .specs import (CELLS, SMOKE_CELLS, CellBuild, _leaves, build_cell,
                    cell_supported, cut_stages)

__all__ = ["OUT_DIR", "count_cell", "main", "run_cell"]

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
HARDWARE = ("NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s bf16 dense, "
            "3.35 TB/s HBM3, NVLink 450 GB/s, 50 GB/s NIC a card")


# ----------------------------------------------------------------- bytes

def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _tree_bytes(tree, sizes: dict) -> int:
    return int(sum(math.prod(local_shape(spec, shape, sizes))
                   * _itemsize(dt) for shape, dt, spec in tree.leaves()))


def _param_scale(cb: CellBuild):
    """The tracker's share of a tensor of a parameter's shape: that
    parameter's shard of one device (f32 tensors: the moments' shard), or
    None where every share is 1."""
    sizes = cb.sizes
    params = cb.trees["params"]
    moms = cb.trees["opt_state"].specs["mu"] if "opt_state" in cb.trees \
        else params.specs
    table = {}
    for (shape, dt, spec), zspec in zip(params.leaves(),
                                         _leaves(moms)):
        for sh in (shape, shape[1:]):
            for d, sp in ((dt, spec), (torch.float32, zspec)):
                full = math.prod(shape)
                frac = math.prod(local_shape(sp, shape, sizes)) / full
                key = (tuple(sh), d)
                table[key] = max(table.get(key, 0.0), frac)
    if all(v == 1.0 for v in table.values()):
        return None
    return lambda t: table.get((tuple(t.shape), t.dtype), 1.0)


# ----------------------------------------------------------------- counts

def _vec(c) -> np.ndarray:
    return np.array([c.flops, c.bytes_accessed, c.n_ops], dtype=np.float64)


def _count_at(cb: CellBuild, cfg, rows: int, n_micro: int = 1,
              scale=None):
    step, inputs = cb.instantiate(cfg, rows, n_micro)
    with cb.mode():
        out, cost = count(step, *inputs, scale=scale)
    del out
    return cost


def _global_vec(cb: CellBuild, cfg) -> np.ndarray:
    """(FLOPs, bytes, ops) of the global program at ``cfg``'s depth."""
    B = cb.meta["batch"]
    nm = cb.n_micro
    if cb.kind != "train" or nm <= 3:
        return _vec(_count_at(cb, cfg, B, nm))
    mb = B // nm
    c2 = _vec(_count_at(cb, cfg, 2 * mb, 2))
    c3 = _vec(_count_at(cb, cfg, 3 * mb, 3))
    return c2 + (nm - 2) * (c3 - c2)


def _depth_fitted(cb: CellBuild) -> np.ndarray:
    """``_global_vec`` at the cell's depth, each stage of more than 3
    repeats fitted from 1, 2 and 3 (the module docstring says why exact)."""
    cfg = cb.cfg
    R = [s.repeat for s in cfg.stages]
    deep = [i for i, r in enumerate(R) if r > 3]
    if not deep:
        return _global_vec(cb, cfg)
    base_r = [1 if i in deep else r for i, r in enumerate(R)]
    base = _global_vec(cb, cut_stages(cfg, base_r))
    total = base.copy()
    for i in deep:
        at = []
        for r in (2, 3):
            rr = list(base_r)
            rr[i] = r
            at.append(_global_vec(cb, cut_stages(cfg, rr)) - base)
        beta = (at[1] - 2 * at[0]) / 2
        alpha = at[0] - 3 * beta
        total += alpha * (R[i] - 1) + beta * (R[i] ** 2 - 1)
    return total


# ----------------------------------------------------------------- layout

def _group(sizes: dict, axes) -> int:
    return int(math.prod(sizes.get(a, 1) for a in axes))


def _spans(sizes: dict, axes) -> bool:
    """Whether a group over ``axes`` spans nodes of ``NODE_CARDS``
    consecutive ranks (the mesh's ranks are row-major over ``sizes``)."""
    stride, strides = 1, {}
    for a in reversed(list(sizes)):
        strides[a] = stride
        stride *= sizes[a]
    top = sum((sizes[a] - 1) * strides[a] for a in axes if a in sizes)
    return top // RL.NODE_CARDS != 0


def _lm_collectives(cb: CellBuild) -> List[tuple]:
    cfg, sizes, kind, nm = cb.cfg, cb.sizes, cb.kind, cb.n_micro
    recs: List[tuple] = []

    def add(k, size, axes, times=1):
        g = _group(sizes, axes)
        if g > 1 and size > 0 and times > 0:
            recs.extend([(k, float(size), g, _spans(sizes, axes))] * times)

    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    b_local = max(cb.meta["batch"] // _group(sizes, batch_axes), 1)
    rows = b_local // nm if kind == "train" else b_local
    seq = 1 if kind == "decode" else cb.meta["seq"]
    item = _itemsize(cfg.torch_dtype)
    params = cb.trees["params"]
    if kind == "train":
        fsdp = _axes(cb.rules.get("fsdp"))
        for shape, dt, spec in params.leaves():
            used = {a for e in spec for a in _axes(e)}
            n_loc = math.prod(local_shape(spec, shape, sizes))
            fa = tuple(a for a in fsdp if a in used)
            if fa:
                add("all-gather", n_loc * _group(sizes, fa) * _itemsize(dt),
                    fa, times=2 * nm)
                add("reduce-scatter", n_loc * 4, fa)
            for a in batch_axes:
                if a not in used:
                    add("all-reduce", n_loc * 4, (a,))
    passes = 2 * nm if kind == "train" else 1
    act = rows * seq * cfg.d_model * item

    def on_model(spec) -> bool:
        return any("model" in _axes(e) for e in spec)

    for si, stage in enumerate(cfg.stages):
        lp = params.specs["stages"][si]
        for j, spec in enumerate(stage.body):
            p = lp[f"l{j}"]
            n_ar = 0
            if spec.mixer == "attn":
                n_ar += on_model(p["attn"]["wq_b" if cfg.mla is not None
                                           else "wq"])
            else:
                n_ar += on_model(p["ssm"]["in_proj"])
            if spec.ffn == "dense":
                n_ar += on_model(p["dense"]["wi"])
            elif spec.ffn == "moe":
                wi = p["moe"]["wi"]            # (R, E, D, Fe)
                if "model" in _axes(wi[1]):
                    moe = cfg.moe
                    E = moe.n_padded
                    C = max(1, int(np.ceil(rows * seq * moe.top_k / E
                                           * moe.capacity_factor)))
                    add("all-to-all", E * C * cfg.d_model * item,
                        ("model",), times=2 * passes * stage.repeat)
                elif "model" in _axes(wi[3]):
                    n_ar += 1
            add("all-reduce", act, ("model",),
                times=n_ar * passes * stage.repeat)
    return recs


# ----------------------------------------------------------------- records

def _memory(cb: CellBuild, temp: float, note: str) -> dict:
    arg = sum(_tree_bytes(t, cb.sizes) for t in cb.trees.values())
    out = sum(_tree_bytes(t, cb.sizes) for t in cb.out_trees.values())
    alias = _tree_bytes(cb.out_trees["cache"], cb.sizes) \
        if cb.kind == "decode" else 0
    return {"argument_bytes": int(arg), "output_bytes": int(out),
            "alias_bytes": int(alias), "temp_bytes": int(temp),
            "peak_bytes_per_device": int(arg + temp + out - alias),
            "temp_upper_bound": cb.sizes.get("model", 1) > 1,
            "temp_note": note}


def _lm_counts(cb: CellBuild, n_chips: int):
    sizes = cb.sizes
    flops, nbytes, n_ops = _depth_fitted(cb)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    b_local = max(cb.meta["batch"] // _group(sizes, batch_axes), 1)
    nm = cb.n_micro
    if cb.kind == "train":
        if b_local % nm:
            raise ValueError(f"{nm} microbatches do not split the local "
                             f"batch of {b_local} rows")
        local_nm = min(nm, 2)
        local = _count_at(cb, cb.cfg, local_nm * (b_local // nm), local_nm,
                          scale=_param_scale(cb))
        note = (f"the step at {b_local} local rows ({local_nm} of its {nm} "
                f"microbatches and the update), full width")
    else:
        local = _count_at(cb, cb.cfg, b_local, scale=_param_scale(cb))
        note = f"the step at {b_local} local rows, full width"
    temp = max(local.peak_bytes - local.end_bytes, 0.0)
    coll = RL.collective_bytes(_lm_collectives(cb))
    counted = {"flops_global": float(flops), "bytes_global": float(nbytes),
               "n_ops": int(n_ops), "local_peak_bytes": local.peak_bytes,
               "local_end_bytes": local.end_bytes,
               "depth_fit": any(s.repeat > 3 for s in cb.cfg.stages),
               "micro_fit": cb.kind == "train" and nm > 3}
    return _per_card(flops / n_chips, nbytes / n_chips, coll), temp, note, \
        counted


def _per_card(flops, nbytes, coll) -> OpCost:
    """One card's share of the program and its collectives (by kind,
    their ``total`` and the ``network`` share)."""
    return OpCost(flops=float(flops), bytes_accessed=float(nbytes),
                  collective_bytes=coll["total"], coll_by_kind=coll)


def _khi_counts(cb: CellBuild, n_chips: int):
    from ..core.sharded import _resolve_merge, merge_bytes_per_device

    m, sp, sizes = cb.meta, cb.search_params, cb.sizes
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    b_local = max(m["batch"] // _group(sizes, data_axes), 1)
    C = sp.expand_width * sp.c_n
    vec_dt = cb.trees["index"].shapes["vecs"][1]
    flops, nbytes = gather_l2_filter_work(
        b_local, C, m["d"], m["m"], vec_bytes=_itemsize(vec_dt))
    mode = CountingMode()
    hops = m["max_hops"]
    mode.add_kernel("gather_l2_filter", flops, nbytes, launches=hops)
    mode.cost.bytes_accessed += hops * b_local * sp.expand_width * m["M"] * 4
    S = sizes["model"]
    merge = _resolve_merge("auto", S) if S > 1 else "allgather"
    per_row = merge_bytes_per_device(sp.k, S, merge)
    recs = []
    if S > 1:
        spans = _spans(sizes, ("model",))
        if merge == "halving":
            rounds = S.bit_length() - 1
            recs = [("collective-permute", per_row / rounds * b_local, S,
                     spans)] * rounds
        else:
            recs = [("all-gather", 8 * sp.k * S * b_local, S, spans)]
    coll = RL.collective_bytes(recs)
    temp = b_local * C * (4 + 4)
    counted = {"index_bytes_per_device": _tree_bytes(cb.trees["index"],
                                                     sizes),
               "flops_global": mode.cost.flops * n_chips,
               "bytes_global": mode.cost.bytes_accessed * n_chips,
               "kernels": dict(mode.cost.kernels), "merge": merge,
               "khi_hops_bound_scale": float(hops)}
    note = (f"one hop's candidate ids and distances, ({b_local}, {C}) "
            f"int32 + f32; the pool is not counted")
    return (_per_card(mode.cost.flops, mode.cost.bytes_accessed, coll), temp,
            note, counted)


def count_cell(arch: str, cell: str, sizes: dict, *,
               n_micro: Optional[int] = None, variant: str = "",
               device="cuda", config=None,
               cells: Optional[Dict[str, dict]] = None) -> dict:
    """The dry-run record of one cell over a mesh of axis ``sizes``
    (without the process group: ``run_cell`` adds it). ``config`` and
    ``cells`` replace the arch's config and the cell table."""
    t0 = time.perf_counter()
    cb = build_cell(arch, cell, sizes, n_micro=n_micro, variant=variant,
                    device=device, config=config, cells=cells)
    n_chips = int(math.prod(sizes.values()))
    rec = dict(cb.meta)
    rec["device"] = str(cb.device)
    counts = _khi_counts if cb.kind == "serve" else _lm_counts
    card, temp, note, counted = counts(cb, n_chips)
    mf = RL.model_flops(cb.kind, cb.meta["n_params"], cb.meta["n_active"],
                        cb.meta["batch"], cb.meta["seq"])
    rl = RL.terms_from(flops=card.flops, bytes_accessed=card.bytes_accessed,
                       coll_bytes=card.collective_bytes, n_chips=n_chips,
                       model_flops_global=mf,
                       coll_network_bytes=card.coll_by_kind["network"])
    rec["memory"] = _memory(cb, temp, note)
    rec["donated"] = [k for k, t in cb.trees.items() if t.donated]
    rec["roofline"] = rl.to_dict()
    rec["collectives"] = card.coll_by_kind
    rec["counted"] = counted
    rec["split"] = "even"
    rec["hardware"] = HARDWARE
    rec["count_s"] = time.perf_counter() - t0
    return rec


# ----------------------------------------------------------------- cells

def _subprocess_cell(arch, cell, mesh_name, out_root, *, n_micro, tag,
                     variant, device, smoke) -> dict:
    """The cell in a fresh interpreter (this process runs a real group)."""
    src = str(pathlib.Path(__file__).resolve().parents[2])
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--cell", cell, "--mesh", mesh_name, "--out", str(out_root),
           "--force", "--device", str(device), "--tag", tag]
    if n_micro:
        cmd += ["--n-micro", str(n_micro)]
    if variant:
        cmd += ["--variant", variant]
    if smoke:
        cmd.append("--smoke")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"the dry run of {arch} x {cell} failed in its "
                           f"subprocess:\n{r.stderr[-3000:]}")
    suffix = f"__{tag}" if tag else ""
    path = pathlib.Path(out_root) / mesh_name / f"{arch}__{cell}{suffix}.json"
    return json.loads(path.read_text())


def run_cell(arch: str, cell: str, mesh_name: str, *, force: bool = False,
             n_micro=None, tag: str = "", variant: str = "",
             out_dir=None, device="cuda", smoke: bool = False) -> dict:
    """Count one cell on the production mesh (``single``: (16, 16),
    ``multi``: (2, 16, 16)) and write its record; ``smoke`` takes the
    arch's smoke config and ``SMOKE_CELLS``. A record with status
    "error" is written before the error is raised again."""
    out_root = pathlib.Path(out_dir or OUT_DIR)
    out_path = out_root / mesh_name
    out_path.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    out_file = out_path / f"{arch}__{cell}{suffix}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())
    multi = mesh_name == "multi"
    need = math.prod(PRODUCTION_MESHES[multi][0])
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != need):
        return _subprocess_cell(arch, cell, mesh_name, out_root,
                                n_micro=n_micro, tag=tag, variant=variant,
                                device=device, smoke=smoke)
    own = not dist.is_initialized()
    if own:
        init_dryrun_process_group(need)
    rec = dict(arch=arch, cell=cell, mesh=mesh_name, n_chips=need, tag=tag)
    try:
        dev_type = "cuda" if str(device).startswith("cuda") else "cpu"
        mesh = make_production_mesh(multi_pod=multi, device_type=dev_type)
        sizes = mesh_axis_sizes(mesh)
        rec["n_chips"] = int(mesh.size())
        cfg = None
        if arch != "khi-serve":
            cfg = get_smoke_config(arch) if smoke else get_config(arch)
            ok, why = cell_supported(cfg, cell)
            if not ok:
                rec.update(status="skipped", reason=why)
                out_file.write_text(json.dumps(rec, indent=1))
                return rec
        rec.update(count_cell(arch, cell, sizes, n_micro=n_micro,
                              variant=variant, device=device, config=cfg,
                              cells=SMOKE_CELLS if smoke else None))
        rec["status"] = "ok"
        rl, mem = rec["roofline"], rec["memory"]
        print(f"[dryrun] OK  {mesh_name:6s} {arch:24s} {cell:12s} "
              f"count={rec['count_s']:.1f}s dom={rl['dominant']} "
              f"bound={rl['bound_s'] * 1e3:.2f}ms "
              f"peak={mem['peak_bytes_per_device'] / 2**30:.2f}GiB",
              flush=True)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        out_file.write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] ERR {mesh_name:6s} {arch:24s} {cell:12s} {e}",
              flush=True)
        raise
    finally:
        if own:
            dist.destroy_process_group()
    out_file.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (or 'khi-serve')")
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true",
                    help="sweep every supported cell on both meshes")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--tag", default="", help="variant tag for perf runs")
    ap.add_argument("--variant", default="",
                    help="ep<N>|nofsdp|fsdppod|bf16vec|hops64")
    ap.add_argument("--out", default=None,
                    help=f"records' root (default {OUT_DIR})")
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors lie: cuda (default), cpu "
                    "or meta")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs at SMOKE_CELLS' shapes")
    args = ap.parse_args(argv)

    if args.all:
        t0 = time.perf_counter()
        failed = []
        for mesh_name in ("single", "multi"):
            for arch in ARCH_IDS + ["khi-serve"]:
                cells = (["serve_b256"] if arch == "khi-serve"
                         else list(CELLS))
                for cell in cells:
                    try:
                        run_cell(arch, cell, mesh_name, force=args.force,
                                 tag=args.tag, out_dir=args.out,
                                 device=args.device, smoke=args.smoke)
                    except Exception:
                        failed.append((mesh_name, arch, cell))
        print(f"[dryrun] --all took {time.perf_counter() - t0:.1f}s; "
              f"{len(failed)} cells failed {failed}", flush=True)
        return 1 if failed else 0
    if not args.arch or not args.cell:
        ap.error("--arch/--cell required unless --all")
    run_cell(args.arch, args.cell, args.mesh, force=args.force,
             n_micro=args.n_micro, tag=args.tag or args.variant,
             variant=args.variant, out_dir=args.out, device=args.device,
             smoke=args.smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
