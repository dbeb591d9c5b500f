"""The port's production mesh and logical-axis sharding against the JAX
package: ``launch.mesh`` (``make_production_mesh`` on torch's fake
backend and on a 4-rank gloo world, ``mesh_axis_sizes``,
``sharding_rules``) and ``models.sharding`` (``logical_to_spec`` of every
parameter, moment, cache and batch leaf of every arch under both
production meshes' rules, ``to_placements`` and ``local_shape`` on a
(2, 2) gloo world). Groups start only in subprocesses: a process group
is global to its process."""

import json
import os
import socket
import subprocess
import sys
import types

import pytest

from repro.configs import get_config as jget_config
from repro.launch import mesh as jmesh
from repro.models import model as JM
from repro.models import sharding as jsh
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as S
from repro_torch.models import model as TM
from repro_torch.models import sharding as tsh
from repro_torch.optim import adamw as tadamw

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
SIZES = {"single": {"data": 16, "model": 16},
         "multi": {"pod": 2, "data": 16, "model": 16}}


def _stub(sizes):
    """A mesh both packages read: the reference's ``axis_names`` and
    ``devices.shape``, the port's ``mesh_dim_names`` and ``shape``."""
    shape = tuple(sizes.values())
    return types.SimpleNamespace(
        axis_names=tuple(sizes), devices=types.SimpleNamespace(shape=shape),
        mesh_dim_names=tuple(sizes), shape=shape)


def _run(code: str, timeout: int = 120):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=timeout)


def _walk(tree, path=()):
    """(path, leaf) over nested dicts and lists; tuples are leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def test_production_mesh_on_fake_backend():
    r = _run(
        "import torch.distributed as dist\n"
        "from repro_torch.launch.mesh import *\n"
        "for multi, world in ((False, 256), (True, 512)):\n"
        "    init_dryrun_process_group(world)\n"
        "    try:\n"
        "        init_dryrun_process_group(world)\n"
        "        raise SystemExit('a second group started')\n"
        "    except RuntimeError as e:\n"
        "        assert 'process of its own' in str(e), e\n"
        "    if multi:\n"
        "        try:\n"
        "            make_production_mesh(multi_pod=False)\n"
        "            raise SystemExit('a 512-rank group made a 256 mesh')\n"
        "        except RuntimeError as e:\n"
        "            assert '256' in str(e) and 'init_dryrun' in str(e), e\n"
        "    m = make_production_mesh(multi_pod=multi)\n"
        "    print(tuple(m.shape), m.mesh_dim_names, mesh_axis_sizes(m),\n"
        "          sharding_rules(m)['batch'])\n"
        "    dist.destroy_process_group()\n")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines == [
        "(16, 16) ('data', 'model') {'data': 16, 'model': 16} ('data',)",
        "(2, 16, 16) ('pod', 'data', 'model') {'pod': 2, 'data': 16, "
        "'model': 16} ('pod', 'data')"]


def test_missing_fake_backend_raises():
    r = _run("import sys\n"
             "sys.modules['torch.testing._internal.distributed.fake_pg'] = "
             "None\n"
             "from repro_torch.launch.mesh import init_dryrun_process_group\n"
             "init_dryrun_process_group(256)\n")
    assert r.returncode != 0
    assert "fake process-group backend" in r.stderr


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_world_refuses_mesh_and_places_leaves(tmp_path):
    port = _free_port()
    worker = os.path.join(HERE, "_torch_sharding_worker.py")
    outs = [tmp_path / f"rank{r}.json" for r in range(4)]
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(port),
                               str(outs[r])], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        for p in procs:
            p.communicate(timeout=120)
    finally:
        for p in procs:
            p.kill()
    for r in range(4):
        res = json.loads(outs[r].read_text())
        assert res["ok"], res.get("error")
        assert "256" in res["refused"] and "4" in res["refused"]
        assert len(res["leaves"]) > 20
        sharded = 0
        for shape, spec, got, want in res["leaves"]:
            assert got == want, (shape, spec)
            sharded += got != shape
        assert sharded > 10


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_axis_sizes_and_rules_equal_reference(mesh):
    stub = _stub(SIZES[mesh])
    assert tmesh.mesh_axis_sizes(stub) == jmesh.mesh_axis_sizes(stub)
    assert tmesh.sharding_rules(stub) == jmesh.sharding_rules(stub)
    assert S.rules_for(SIZES[mesh]) == jmesh.sharding_rules(stub)


def test_to_placements_refuses_axes_out_of_mesh_order():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError, match="order"):
        tsh.to_placements((("data", "pod"), None), mesh)
    assert tsh.local_shape((("pod", "data"), "model"), (64, 32),
                           SIZES["multi"]) == (2, 2)


def _pairs(arch: str):
    """(what, logical, shape) of every parameter (fsdp off and on), moment,
    cache and batch leaf of ``arch``'s full config, taken from each
    package; the logical names must agree leaf by leaf."""
    tcfg, jcfg = get_config(arch), jget_config(arch)
    shapes = dict(_walk(TM._map(TM.param_specs(tcfg),
                                lambda leaf, _: leaf[1])))
    out = []
    for fsdp in (False, True):
        tax = dict(_walk(TM.param_logical_axes(tcfg, fsdp=fsdp)))
        jax_ = dict(_walk(JM.param_logical_axes(jcfg, fsdp=fsdp)))
        assert tax == jax_
        out += [(f"param{int(fsdp)}", tax[p], shapes[p]) for p in tax]
        tmom = tadamw.opt_logical_axes(TM.param_logical_axes(tcfg,
                                                             fsdp=fsdp))
        jmom = jadamw.opt_logical_axes(JM.param_logical_axes(jcfg,
                                                             fsdp=fsdp))
        tm, jm = dict(_walk(tmom["mu"])), dict(_walk(jmom["mu"]))
        assert tm == jm
        out += [(f"mu{int(fsdp)}", tm[p], shapes[p]) for p in tm]
    cache_ax = dict(_walk(S.cache_logical(tcfg)))
    for B, T in ((128, 32768), (1, 524288)):
        cshapes = dict(_walk(S._cache_shapes(tcfg, B, T)))
        out += [("cache", cache_ax[p], cshapes[p][0]) for p in cache_ax]
    for cell, info in S.CELLS.items():
        b = S._batch_shapes(tcfg, info["batch"], info["seq"],
                            with_targets=info["kind"] == "train")
        out += [("batch", S.batch_logical(b)[k], b[k][0]) for k in b]
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_to_spec_equals_reference(arch):
    pairs = _pairs(arch)
    for mesh, sizes in SIZES.items():
        rules = jmesh.sharding_rules(_stub(sizes))
        with jsh.axis_rules(rules, sizes):
            want = [tuple(jsh.logical_to_spec(ax, shape))
                    for _, ax, shape in pairs]
        assert tsh.logical_to_spec(pairs[0][1], pairs[0][2]) == \
            tuple([None] * len(pairs[0][2]))          # no rules: replicated
        with tsh.axis_rules(rules, sizes):
            got = [tsh.logical_to_spec(ax, shape) for _, ax, shape in pairs]
        assert got == want, [(w, ax, s) for (w, ax, s), g, e
                             in zip(pairs, got, want) if g != e][:5]
        # the rules name each mesh axis at most once a spec, and every
        # named axis divides its dim
        for g, (_, _, shape) in zip(got, pairs):
            tsh.local_shape(g, shape, sizes)
