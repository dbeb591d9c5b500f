"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size. For each seed, one set-up, then a short window of each
side, each sent the same stream of requests from its start and judged by
``check.compare`` against the cell's limits (the sample is drawn from what
the side answered):

* ``program``: the program as the configuration states it (the lower
  readings);
* ``control_bf16``: the control, the same program over a bf16 copy of the
  corpus (``device_put_index(vec_dtype=torch.bfloat16)``, the nearest
  precision below the configuration's float32), which has to come out as
  not correct;
* ``ef_k``, ``one_hop``: the router and the hop loop cut short
  (``faults.SHORT_SEARCHES``), the upper readings of ``recall_miss``.

The benchmark's runs never run this.

    python3 -m khi_bench.readings --workload <name> --seeds 1,2,3 \\
        --seconds 5

Prints one JSON line a (seed, side) with every number compared, the
checks and ``correct``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from . import manifest as mf
from .check import compare
from .faults import SHORT_SEARCHES
from .run import (Cell, PlanLog, forbidden_modules, import_program, log,
                  set_cache_dirs)


def reading(cell: Cell, svc, seconds: float, side: str) -> dict:
    cell.warm(svc)
    plans = PlanLog()
    plans.install()
    try:
        win = cell.window(svc, seconds)
    finally:
        plans.restore()
    idx = cell.sample(win["answered"])
    numbers = cell.judge(win, idx, plans.scan_lanes(win["lo"][idx],
                                                    win["hi"][idx]))
    checks = compare(numbers, cell.limits)
    return {"seed": cell.seed, "side": side, "requests": win["answered"],
            "qps": win["answered"] / win["seconds"], **numbers,
            "correct": all(c["ok"] for c in checks.values()),
            "checks": {k: [c["value"], c["limit"]]
                       for k, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m khi_bench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    set_cache_dirs(mf.ROOT)
    import torch

    if not torch.cuda.is_available():
        log("khi_bench.readings: no CUDA device")
        return 2
    import_program(mf.ROOT)
    from repro_torch.core.engine import device_put_index

    for seed in (int(s) for s in args.seeds.split(",")):
        cell = Cell(args.workload, seed, "cuda")
        svc = cell.setup(keep_index=True)
        print(json.dumps(reading(cell, svc, args.seconds, "program")),
              flush=True)
        del svc
        k = int(cell.cfg["search"]["k"])
        for side, changed in SHORT_SEARCHES.items():
            print(json.dumps(reading(cell, cell.service(**changed(k)),
                                     args.seconds, side)), flush=True)
        low = device_put_index(cell.index, device=cell.device,
                               vec_dtype=torch.bfloat16)
        print(json.dumps(reading(cell, cell.service(low), args.seconds,
                                 "control_bf16")), flush=True)
        del low, cell
        gc.collect()
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        log(f"khi_bench.readings: loaded {found}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
