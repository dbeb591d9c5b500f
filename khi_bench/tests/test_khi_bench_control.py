"""The comparison that decides ``correct``, shown to fail: a run of each
cell's path at a size the CPU holds (the look for a card skipped, the
kernels' plain versions serving), as the configuration states it, under
its control (the program over a bf16 copy of the corpus) and with each
fault a served cell can have planted under the timed path."""

import pytest

from khi_bench import faults
from khi_bench.run import run_cell
from khi_bench.tests.util import SEED, SMALL, workloads


def small(vec_dtype="float32"):
    return {"config": dict(SMALL["config"], vec_dtype=vec_dtype),
            "traffic": SMALL["traffic"]}


@pytest.mark.parametrize("workload", workloads())
def test_sound_run_is_correct(workload):
    res = run_cell(workload, SEED, 1.0, False, device="cpu",
                   overrides=small())
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"qps", "p95_ms", "recall_at_k",
                                   "build_s", "setup_s"}
    assert res["metrics"]["recall_at_k"]["value"] > 0.9


@pytest.mark.parametrize("workload", workloads())
def test_control_bf16_is_not_correct(workload):
    res = run_cell(workload, SEED, 1.0, False, device="cpu",
                   overrides=small("bfloat16"))
    assert not res["correct"]
    c = res["checks"]["dist_rel_gap"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_is_not_correct(fault):
    res = run_cell(workloads()[0], SEED, 1.0, False, device="cpu",
                   overrides=small(), plant=faults.FAULTS[fault])
    assert not res["correct"], (fault, res["checks"])


def test_traced_run_is_correct_and_reports_per_layer_metrics():
    res = run_cell(workloads()[0], SEED, 1.0, True, device="cpu",
                   overrides=small())
    assert res["correct"]
    assert {"planner.ms_per_batch", "graph.ms_per_lane"} <= set(
        res["metrics"])
    assert "breakdown" in res and "window_s" in res["device"]
