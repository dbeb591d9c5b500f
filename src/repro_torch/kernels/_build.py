"""Build the CUDA kernels with ``nvcc`` at first use and load them with
ctypes.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``). Libraries land in ``build/repro_torch_kernels/``
at the checkout root (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a
hash of their source and the sources it includes, so an edited source
rebuilds and an unchanged one loads at once. ``build_all`` starts one ``nvcc`` per source, all together.
Nothing here runs at import time: importing the package needs no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["SOURCES", "ARCH_FLAGS", "build_dir", "nvcc_command", "build_all",
           "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "gather_l2_filter": "gather_l2_filter.cu",
    "scan_topk": "scan_topk.cu",
    "scan_topk_wide": "scan_topk_wide.cu",
    "l2dist": "l2dist.cu",
}
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc at first use on a CUDA tensor")


def _source_bytes(name: str) -> bytes:
    """A source and the csrc files it includes (``#include "..."``, one
    level), so an edited include rebuilds the library too."""
    src = (CSRC / SOURCES[name]).read_bytes()
    deps = re.findall(rb'^#include "([^"]+)"', src, re.M)
    return src + b"".join((CSRC / dep.decode()).read_bytes() for dep in deps)


def _lib_path(name: str) -> Path:
    src = _source_bytes(name)
    tag = hashlib.sha256(src + " ".join(ARCH_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{tag}.so"


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
            "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(CSRC / SOURCES[name])]


def build_all(names=None, *, verbose: bool = False) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source in parallel.
    Returns {name: seconds} for what was built (0.0 when it was cached).
    ``verbose`` prints ptxas's register and shared-memory report."""
    names = list(names or SOURCES)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    done: Dict[str, float] = {}
    nvcc = None
    for name in names:
        out = _lib_path(name)
        if out.exists():
            done[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(nvcc_command(name, tmp, nvcc),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        done[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, out)
        if verbose:
            print(f"[build] {SOURCES[name]} {done[name]:.1f}s\n{log}",
                  flush=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
