"""Package rules of the port, checked in fresh interpreters: importing any
``repro_torch`` module loads neither JAX nor the reference package and
needs no ``nvcc``, and entry points called without a device raise on a
machine without a GPU, naming ``device="cpu"``."""

import os
import pkgutil
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run(code: str, **env):
    full = dict(os.environ, PYTHONPATH=SRC, **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=full, timeout=120)


def test_import_every_module_without_jax_or_reference():
    import repro_torch
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    assert "repro_torch.kernels.ops" in mods and len(mods) >= 20
    assert "repro_torch.core.predicate" in mods
    assert "repro_torch.core.delta" in mods
    assert "repro_torch.core.sharded" in mods
    assert "repro_torch.distributed.elastic" in mods
    assert "repro_torch.launch.mesh" in mods
    assert "repro_torch.checkpoint.manager" in mods
    assert "repro_torch.core.query_ref" in mods
    # the LM substrate: models, decode serving and the 10 arch configs
    for name in ("config", "layers", "model", "sharding", "ssm"):
        assert f"repro_torch.models.{name}" in mods
    assert "repro_torch.serve.generate" in mods
    # training of the LM substrate
    for name in ("data.lm", "optim.adamw", "train.step", "train.compressed",
                 "launch.train"):
        assert f"repro_torch.{name}" in mods
    # the production mesh and the dry run
    for name in ("mesh", "specs", "op_cost", "roofline", "dryrun"):
        assert f"repro_torch.launch.{name}" in mods
    from repro_torch.configs import _MODULES
    for name in _MODULES.values():
        assert f"repro_torch.configs.{name}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    # an empty PATH: no nvcc can be found, and none is needed
    r = _run(code, PATH="")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("call", [
    "from repro_torch.core.engine import device_put_index as f; f(None)",
    "from repro_torch.serve import KHIService as f; f(None)",
    "from repro_torch.core.engine import Planner as f; "
    "f(None, __import__('repro_torch.core.engine').core.engine."
    "SearchParams())",
    "from repro_torch.core.build_device import build_graphs_device as f; "
    "f(None, None)",
    "from repro_torch.launch.serve import main; main(['--n', '50'])",
    "from repro_torch.launch.serve import main; main(['--mode', 'generate'])",
    "from repro_torch.launch.train import main; "
    "main(['--arch', 'qwen1.5-4b', '--smoke', '--steps', '1'])",
    "from repro_torch.launch.dryrun import count_cell as f; "
    "f('qwen1.5-4b', 'train_4k', {'data': 1, 'model': 1})",
])
def test_entry_points_default_to_cuda_and_raise(call):
    r = _run("import torch\n"
             "assert not torch.cuda.is_available()\n" + call)
    assert r.returncode != 0
    assert "device=\"cpu\"" in r.stderr, r.stderr[-2000:]
