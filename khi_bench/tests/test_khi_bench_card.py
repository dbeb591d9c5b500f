"""The benchmark's path on the card at a small size: the kernels, the
profiler's records, the benchmark's own stream and the clock offset.
Each test decides inside itself whether there is a card."""

import pytest
import torch

from khi_bench import generator, manifest as mf
from khi_bench.run import run_cell, set_cache_dirs
from khi_bench.tests.util import SEED, workloads

pytestmark = pytest.mark.gpu

CARD = {"config": {"n": 50000, "d": 128, "search": {"scan_threshold": 5000}},
        "traffic": {"chunk_requests": 4096, "prefetch_chunks": 1,
                    "warmup_bursts": 2, "calibration_rows": 50000,
                    "calibration_boxes": 512, "check_sample": 512}}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    set_cache_dirs(mf.ROOT)


def test_generator_is_deterministic_on_the_card():
    need_card()
    cfg = mf.config(mf.load(), "khi-youtube-1m")
    cfg.update(n=100000)
    a = generator.make_corpus(cfg, SEED, "cuda")
    b = generator.make_corpus(cfg, SEED, "cuda")
    assert torch.equal(a.vecs, b.vecs) and torch.equal(a.attrs, b.attrs)


@pytest.mark.parametrize("trace", [False, True])
def test_small_run_on_the_card(trace):
    need_card()
    res = run_cell(workloads()[0], SEED, 2.0, trace, device="cuda",
                   overrides=CARD)
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] < dev["window_s"]
        roof = res["metrics"]["gather_l2_filter_roofline"]["value"]
        assert 0 < roof <= 105
        assert res["breakdown"]["device_ops"]
        assert 0 < res["metrics"]["device.idle_pct"]["value"] < 100
