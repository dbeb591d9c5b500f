"""The port's dry run (``repro_torch.launch.{specs,dryrun}``) against the
JAX package's: ``CELLS``, ``cell_supported`` and ``pick_n_micro`` for
every arch x cell x mesh, ``n_params`` / ``n_active`` / ``n_micro`` of
``build_lowering``'s meta and ``_zero_shardings``' moment specs (the
reference runs in a subprocess with 512 fake XLA host devices), the
exact shortcuts of the count (microbatches and depth) against direct
counts, and ``run_cell`` on every arch's smoke config on both production
meshes (in subprocesses: the fake process group is global to its
process): status ``ok`` or the reference's skip reason, static bytes
equal to the sum of the local shards, and the khi-serve record's index
bytes equal to the reference's ``sharded_input_specs`` a shard."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.op_cost import count
from repro_torch.models.config import Stage

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
SIZES = {"single": {"data": 16, "model": 16},
         "multi": {"pod": 2, "data": 16, "model": 16}}

# the reference on its production meshes: each arch's train_4k meta and
# moment specs by leaf path, and khi-serve's meta and index shapes
_REFERENCE = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from repro.configs import ARCH_IDS, get_config
from repro.launch import specs as js
from repro.launch.mesh import (make_production_mesh, mesh_axis_sizes,
                               sharding_rules)
from repro.models import model as M
from repro.models.sharding import axis_rules
from repro.optim import init_opt_state
from repro.core.sharded import sharded_input_specs
from repro.configs.khi_serve import config as khi_config

def path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

out = {}
for name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    sizes, rules = mesh_axis_sizes(mesh), sharding_rules(mesh)
    for arch in ARCH_IDS:
        _, meta = js.build_lowering(arch, "train_4k", mesh)
        cfg = get_config(arch)
        sds = jax.eval_shape(lambda k: M.init_params(cfg, k),
                             jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
        with axis_rules(rules, sizes):
            pshard = js._to_shardings(mesh, M.param_logical_axes(
                cfg, fsdp=True), sds)
            mom = js._zero_shardings(mesh, pshard, sds)
        specs = {path(kp): [list(e) if isinstance(e, tuple) else e
                            for e in s.spec]
                 for kp, s in jax.tree_util.tree_flatten_with_path(mom)[0]}
        out[f"{name}/{arch}"] = {"meta": meta, "zero": specs}
    _, kmeta = js.build_lowering("khi-serve", "serve_b256", mesh)
    kc = khi_config()
    skhi, q = sharded_input_specs(
        n_per_shard=kc.n_per_shard, d=kc.d, m=kc.m, height=kc.height,
        nodes_per_shard=kc.nodes_per_shard, M=kc.M,
        n_shards=sizes["model"], batch=kmeta["batch"])
    leaves = jax.tree.leaves(skhi)
    out[f"{name}/khi-serve"] = {
        "meta": kmeta,
        "index_bytes": int(sum(l.size * l.dtype.itemsize for l in leaves)),
        "n_shards": sizes["model"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REFERENCE],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield "/".join(map(str, path)), tree


def _listed(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_cells_and_support_equal_reference():
    assert S.CELLS == jspecs.CELLS
    for arch in ARCH_IDS:
        for cell in S.CELLS:
            assert S.cell_supported(get_config(arch), cell) == \
                jspecs.cell_supported(jget_config(arch), cell)
    from repro.configs.khi_serve import config as jkhi
    from repro_torch.configs.khi_serve import config as tkhi
    for cell in list(S.CELLS) + ["serve_b256"]:
        assert S.cell_supported(tkhi(), cell) == \
            jspecs.cell_supported(jkhi(), cell)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_pick_n_micro_equals_reference(mesh):
    for arch in ARCH_IDS:
        tc, jc = get_config(arch), jget_config(arch)
        for info in S.CELLS.values():
            for b in (info["batch"], 64):
                assert S.pick_n_micro(tc, b, info["seq"], SIZES[mesh]) == \
                    jspecs.pick_n_micro(jc, b, info["seq"], SIZES[mesh])


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_meta_and_zero_specs_equal_reference(reference, mesh):
    sizes = SIZES[mesh]
    for arch in ARCH_IDS:
        ref = reference[f"{mesh}/{arch}"]
        cb = S.build_cell(arch, "train_4k", sizes, device="meta")
        for key in ("arch", "cell", "kind", "batch", "seq", "n_params",
                    "n_active", "n_micro"):
            assert cb.meta[key] == ref["meta"][key], (arch, key)
        params = cb.trees["params"]
        zero = S.zero_specs(params.specs, params.shapes, sizes)
        got = {p: _listed(s) for p, s in _walk(zero)}
        assert got == ref["zero"], arch
        assert cb.trees["opt_state"].specs["mu"] == zero
    khi = S.build_cell("khi-serve", "serve_b256", sizes, device="meta")
    ref = reference[f"{mesh}/khi-serve"]["meta"]
    for key, val in ref.items():
        assert khi.meta[key] == val, key
    assert khi.search_params.strategy == "graph"


def _direct(cb, cfg, rows, nm):
    step, inputs = cb.instantiate(cfg, rows, nm)
    with cb.mode():
        _, c = count(step, *inputs)
    return np.array([c.flops, c.bytes_accessed, c.n_ops])


def test_count_shortcuts_equal_direct_counts():
    """More than 3 microbatches and more than 3 repeats of a stage: the
    fitted counts equal direct counts exactly."""
    smoke = get_smoke_config("qwen1.5-4b")
    body = smoke.stages[0].body
    cfg = dataclasses.replace(smoke, stages=(Stage(4, body), Stage(1, body)))
    cells = {"train_4k": dict(kind="train", seq=8, batch=8),
             "prefill_32k": dict(kind="prefill", seq=8, batch=2)}
    cb = S.build_cell("qwen1.5-4b", "train_4k", {"data": 1, "model": 1},
                      device="meta", n_micro=4, config=cfg, cells=cells)
    want = _direct(cb, cfg, 8, 4)
    assert np.array_equal(D._depth_fitted(cb), want)
    assert np.array_equal(D._global_vec(cb, cfg), want)
    cb = S.build_cell("qwen1.5-4b", "prefill_32k", {"data": 1, "model": 1},
                      device="meta", config=cfg, cells=cells)
    assert np.array_equal(D._depth_fitted(cb), _direct(cb, cfg, 2, 1))


_RUN = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.specs import CELLS
out = []
for mesh, arch in json.loads(sys.argv[1]):
    cells = ["serve_b256"] if arch == "khi-serve" else list(CELLS)
    for cell in cells:
        out.append(run_cell(arch, cell, mesh, force=True, out_dir=sys.argv[2],
                            device="cpu", smoke=arch != "khi-serve"))
print(json.dumps(out))
"""


def _local_bytes(shape, dtype, spec, sizes):
    n = 1
    for dim, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        ways = 1
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            ways *= sizes[a]
        n *= dim // ways
    return n * torch.empty((), dtype=dtype).element_size()


def test_run_cell_every_arch_on_both_meshes(tmp_path, reference):
    jobs = [[("single", a) for a in ARCH_IDS[i::3]] for i in range(3)]
    jobs[0] += [("multi", "qwen1.5-4b"), ("single", "khi-serve"),
                ("multi", "khi-serve")]
    jobs[1] += [("multi", "jamba-v0.1-52b")]
    jobs[2] += [("multi", "phi3.5-moe-42b-a6.6b")]
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", _RUN, json.dumps(j),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for j in jobs]
    recs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            recs += json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            p.kill()
    assert len(recs) == 10 * 4 + 3 * 4 + 2
    for rec in recs:
        arch, cell, mesh = rec["arch"], rec["cell"], rec["mesh"]
        sizes = SIZES[mesh]
        assert rec["n_chips"] == math.prod(sizes.values())
        if arch == "khi-serve":
            ref = reference[f"{mesh}/khi-serve"]
            assert rec["status"] == "ok"
            assert rec["counted"]["index_bytes_per_device"] == \
                ref["index_bytes"] // ref["n_shards"]
            assert rec["counted"]["kernels"] == {
                "gather_l2_filter": rec["max_hops"]}
            continue
        ok, why = jspecs.cell_supported(jget_config(arch), cell)
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == why
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        cb = S.build_cell(arch, cell, sizes, device="meta",
                          config=get_smoke_config(arch),
                          cells=S.SMOKE_CELLS)
        mem = rec["memory"]
        assert mem["argument_bytes"] == sum(
            _local_bytes(*leaf, sizes) for t in cb.trees.values()
            for leaf in t.leaves())
        assert mem["output_bytes"] == sum(
            _local_bytes(*leaf, sizes) for t in cb.out_trees.values()
            for leaf in t.leaves())
        assert mem["peak_bytes_per_device"] == (
            mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
            - mem["alias_bytes"])
        assert mem["temp_bytes"] > 0 and rec["roofline"]["flops"] > 0
        assert rec["split"] == "even" and rec["count_s"] > 0
        if cb.kind == "train":      # FSDP and the data axis' all-reduces
            assert rec["collectives"]["all-gather_count"] > 0
            assert rec["collectives"]["all-reduce_count"] > 0


def _free_port() -> int:
    import socket
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


def test_no_gpu_and_a_running_group_hand_off_or_raise(tmp_path):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        D.count_cell("qwen1.5-4b", "train_4k", {"data": 1, "model": 1})
    code = (
        "import json, sys, torch.distributed as dist\n"
        "dist.init_process_group('gloo', init_method='tcp://127.0.0.1:"
        f"{_free_port()}', rank=0, world_size=1)\n"
        "from repro_torch.launch.dryrun import run_cell\n"
        "r = run_cell('mamba2-780m', 'decode_32k', 'single', force=True, "
        "out_dir=sys.argv[1], device='cpu', smoke=True)\n"
        "assert dist.get_backend() == 'gloo'\n"
        "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["n_chips"] == 256
