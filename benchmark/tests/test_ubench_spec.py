"""The harness finds every configuration, cell, traffic mix, limit and
metric of BENCHMARK.json by name, and the file keeps the contract's
shape."""

import re

import pytest

from ubench_tiny import BENCH, CELLS, ROOT, harness

BENCHMARK = harness.benchmark_json(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    spec = harness.load_cell(cell, ROOT)
    assert spec["chips"] == 1
    assert spec["config"]["reduced"] == []
    assert harness.kind_of(spec).Cell
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("config", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    body = harness.read_json(ROOT / config["file"])
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert body["reduced"] == config["reduced"] == []
    assert config["file"].startswith("benchmark/configs/")


@pytest.mark.parametrize("metric", BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in BENCHMARK["end_to_end"]}
    assert set(metric["workloads"]) <= set(CELLS)


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCHMARK[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCHMARK["per_layer"]}
    assert layers <= {"engine", "serving forward", "train step", "device"}


def test_every_file_is_named_from_a_name():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
