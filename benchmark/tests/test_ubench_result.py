"""The result line keeps the contract's keys; the trace reduces to busy,
idle and breakdown as stated; the command refuses to run without a card
or without the program."""

import io
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

from ubench_tiny import BENCH, ROOT, tiny_spec, harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_last_line_has_the_contracts_keys():
    spec = tiny_spec("c2-serve-700x16")
    result = harness.run_cell(spec, 5, 0.2, False, "cpu", time.perf_counter())
    result["device"] = dict({"platform": "gpu", "kind": "a card", "count": 1},
                            **result["device"])
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.print_result(result)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line) == KEYS  # checks last
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert list(line["checks"]) == ["mask_mismatch", "band_flips"]
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    tail = err.getvalue().splitlines()[-2:]
    assert [x.split()[:2] for x in tail] == [["check", "mask_mismatch"], ["check", "band_flips"]]


def event(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_trace_summary():
    unit = "ubench.call"
    events = [
        event("user_annotation", unit, 0, 100), event("user_annotation", unit, 100, 100),
        event("kernel", "conv", 10, 30), event("kernel", "conv", 30, 20),  # overlap: 10-50
        event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60, 10),
        event("kernel", "relu", 150, 40), event("kernel", "late", 190, 30),  # clipped at 200
        event("cpu_op", "aten::copy_", 50, 10),
        event("cpu_op", "outer", 70, 80), event("cuda_runtime", "cudaLaunchKernel", 100, 5),
    ]
    s = harness.summarise_trace(events, unit)
    assert s["wall_s"] == 200e-6
    assert abs(s["busy_s"] - (40 + 10 + 50) * 1e-6) < 1e-12
    assert abs(s["kernel_busy_s"] - 90e-6) < 1e-12
    assert abs(s["copy_s"]["HtoD"] - 10e-6) < 1e-12
    ops = dict(s["breakdown"]["device_ops"])
    assert abs(ops["conv"] - 50e-6) < 1e-12 and abs(ops["late"] - 30e-6) < 1e-12
    gaps = dict(s["breakdown"]["idle_gaps"])
    # idle 0-10 (no op), 50-60 (copy_), 70-150 (outer: midpoint 110)
    assert abs(gaps["(no host op)"] - 10e-6) < 1e-12
    assert abs(gaps["aten::copy_"] - 10e-6) < 1e-12
    assert abs(gaps["outer"] - 80e-6) < 1e-12


def run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "c2-serve-700x16",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_exits_without_a_result_without_cuda():
    res = run_py(ROOT)
    assert res.returncode == 2 and res.stdout == ""
    assert "CUDA device" in res.stderr


def test_exits_without_a_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    res = run_py(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


def test_train_device_ms_reads_a_traced_epoch(monkeypatch):
    """On the card, a train cell's end-to-end line adds the device's busy
    ms a step over the epoch traced after the window; the CPU reads none."""
    from types import SimpleNamespace

    kind = harness.kind_of(tiny_spec("c2-train-recipe"))
    monkeypatch.setattr(kind, "profile", lambda run, unit: ({"busy_s": 0.57}, run()))
    window = {"window_s": 2.0, "units": 40, "failed": 0}
    card = SimpleNamespace(device="cuda", traced_epoch=lambda: 38)
    assert kind.Cell.end_to_end(card, window) == {"train_step_ms": 50.0,
                                                  "train_device_ms": 0.57 / 38 * 1e3}
    cpu = SimpleNamespace(device="cpu", traced_epoch=None)
    assert kind.Cell.end_to_end(cpu, window) == {"train_step_ms": 50.0}
