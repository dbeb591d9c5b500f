"""What the benchmark's tests share: the program on the path, and the
overrides that run a cell's path at a size the CPU holds."""

from __future__ import annotations

import sys

from khi_bench import manifest as mf

SRC = str(mf.ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

# n = 4,000 rows at d = 32, the scan threshold at the cells' 10% of n,
# bursts of 32: every piece of a run, at a size a test run holds
SMALL = {"config": {"n": 4000, "d": 32, "search": {"scan_threshold": 400}},
         "traffic": {"burst": 32, "clients": 32, "chunk_requests": 1024,
                     "prefetch_chunks": 1, "warmup_bursts": 1,
                     "calibration_rows": 4000, "calibration_boxes": 256,
                     "check_sample": 256}}

SEED = 2**31 + 2**30 + 12345          # a seed past 32 signed bits


def workloads():
    return [w["name"] for w in mf.load()["workloads"]]
