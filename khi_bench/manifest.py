"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``configs[*].file`` (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``;
* a cell's limits for ``correct``: ``cells/<workload>.json``;
* a metric: ``metrics/<metric>.py``, a reader ``read(ctx)`` that returns
  the metric's value, or None where it finds nothing to read.

Later cells, mixes and metrics come as new files beside these; nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

__all__ = ["HERE", "ROOT", "load", "workload", "config", "traffic",
           "cell_limits", "metrics_for", "reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


def workload(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def cell_limits(workload_name: str) -> Dict:
    return _json(HERE / "cells" / f"{workload_name}.json")["limits"]


def metrics_for(manifest: Dict, workload_name: str,
                trace: bool) -> List[Dict]:
    """The metrics a run of the cell reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its ``workloads`` list (if any)
    names the cell."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload_name in m["workloads"]]


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "khi_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
