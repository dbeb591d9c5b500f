"""Nothing the benchmark runs imports JAX or the JAX package ``repro``:
every module of ``khi_bench`` and every metric reader, compared by whole
top-level names (``repro_torch`` is the port, not ``repro``)."""

import ast
import subprocess
import sys

from khi_bench import manifest as mf
from khi_bench.run import FORBIDDEN, forbidden_modules

SOURCES = sorted(p for p in mf.HERE.rglob("*.py")
                 if "tests" not in p.relative_to(mf.HERE).parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_repro():
    assert SOURCES
    for path in SOURCES:
        assert not top_level_imports(path) & set(FORBIDDEN), path


def test_forbidden_compares_whole_names():
    planted = ("reprox", "repro_torch.fake", "repro.fake", "jaxlib.fake")
    saved = {n: sys.modules.get(n) for n in planted}
    try:
        for n in planted:
            sys.modules[n] = sys
        found = forbidden_modules()
        assert "repro" in found and "jaxlib" in found
        assert "reprox" not in found and "repro_torch" not in found
    finally:
        for n, mod in saved.items():
            if mod is None:
                del sys.modules[n]
            else:
                sys.modules[n] = mod


def test_a_run_loads_no_jax_or_repro():
    """A whole small run of a cell on the CPU, in a fresh process, then
    the check the benchmark makes before it prints a result."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(mf.ROOT)!r}, {str(mf.ROOT / 'src')!r}]\n"
        "from khi_bench.run import run_cell, forbidden_modules\n"
        "from khi_bench.tests.util import SEED, SMALL, workloads\n"
        "from khi_bench import readings, faults\n"
        "from khi_bench import manifest as mf\n"
        "for m in mf.load()['end_to_end'] + mf.load()['per_layer']:\n"
        "    mf.reader(m['name'])\n"
        "run_cell(workloads()[0], SEED, 0.5, True, device='cpu',\n"
        "         overrides=SMALL)\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(mf.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_main_refuses_without_a_card_or_the_program(tmp_path):
    """No result line where there is no card (this host), and none in a
    directory that holds only BENCHMARK.json and khi_bench/."""
    import shutil
    shutil.copy(mf.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(mf.HERE, tmp_path / "khi_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (mf.ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "khi_bench.run", "--workload",
             workloads_first(), "--seed", "1", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=300,
            cwd=str(cwd), env={"PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path),
                               "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"correct"' not in out.stdout


def workloads_first():
    return mf.load()["workloads"][0]["name"]
