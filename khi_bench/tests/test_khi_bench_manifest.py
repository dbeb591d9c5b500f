"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from khi_bench import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = mf.load()


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((mf.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert M["paths"] == ["khi_bench"]
    assert 1 <= len(M["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_check_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_unique_and_well_formed(group):
    names = [e["name"] for e in M[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_files_and_reduced():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("khi_bench/")
        cfg = json.loads((mf.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_workloads_name_their_files():
    used = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        mf.config(M, w["config"])
        assert mf.traffic(w["traffic"])["burst"] > 0
        limits = mf.cell_limits(w["name"])
        from khi_bench.check import NUMBERS
        assert set(limits) == set(NUMBERS)
        used.add(w["config"])
        # each cell reports setup_s, another end-to-end metric and a
        # per-layer one
        e2e = [m["name"] for m in mf.metrics_for(M, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mf.metrics_for(M, w["name"], True)
    assert used == {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_are_well_formed_and_have_readers():
    e2e = {m["name"] for m in M["end_to_end"]}
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(mf.reader(m["name"]))
    assert "setup_s" in e2e


def test_metrics_for_filters_by_workloads_key():
    fake = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
            "per_layer": [{"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in mf.metrics_for(fake, "x", False)] == ["a", "b"]
    assert [m["name"] for m in mf.metrics_for(fake, "x", True)] == []
    assert [m["name"] for m in mf.metrics_for(fake, "y", True)] == ["c"]


def test_traffic_keys_that_the_window_does_not_run_are_refused():
    from khi_bench.run import check_traffic

    for w in M["workloads"]:
        check_traffic(mf.traffic(w["traffic"]))
    base = mf.traffic(M["workloads"][0]["traffic"])
    no_loop = {k: v for k, v in base.items() if k != "loop"}
    for bad in (dict(base, loop="open"),
                dict(base, clients=base["burst"] + 1), no_loop):
        with pytest.raises(ValueError):
            check_traffic(bad)
