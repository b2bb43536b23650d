"""The benchmark's machinery, shared by every cell: finding a cell's
configuration, its architecture, traffic, limits and metrics by name; the
run (set-up, window, traced stretch, the check); reading the profiler's
trace; the result line. What belongs to one configuration, architecture,
traffic mix or metric lives in files of its own (README.md), which this
module finds by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "unetseg_tpu")
PROFILE_TRIES = 3  # a profiler session with no device activity is repeated
TOP = 10  # entries of each breakdown list


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path) -> Dict[str, Any]:
    return read_json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path) -> Dict[str, Any]:
    """The cell `name` of BENCHMARK.json with its configuration, the
    configuration's architecture module, traffic, limits and the metrics it
    reports, each read from its own file."""
    bench = benchmark_json(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def reports(metric):
        return name in metric.get("workloads", [name])

    body = read_json(root / config["file"])
    model_config(body["model"], config["name"])  # a key the program lacks fails here
    return {
        "name": name,
        "chips": cell["chips"],
        "config": body,
        "architecture": architecture_of(body),
        "traffic": read_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": read_json(HERE / "limits" / f"{name}.json")["limits"],
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def load_module(path: Path, name: str):
    """The module of the file `path`, loaded once a process under `name`."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def kind_of(spec: Dict[str, Any]):
    """The traffic kind's module, kinds/<kind>.py."""
    kind = spec["traffic"]["kind"]
    return load_module(HERE / "kinds" / f"{kind}.py", f"ubench_kind_{kind}")


def architecture_of(config: Dict[str, Any]):
    """The architecture module a configuration names under "architecture"
    (reference/<architecture>.py; `unet` where it names none): everything
    of the benchmark that depends on the net's layer graph (README.md)."""
    arch = config.get("architecture", "unet")
    return load_module(HERE / "reference" / f"{arch}.py", f"ubench_arch_{arch}")


def model_config(model: Dict[str, Any], config: str = "(unnamed)"):
    """The program's ModelConfig of a configuration file's "model": every
    key passed, each one a field that ModelConfig declares; a field the
    file leaves out takes ModelConfig's default."""
    from unetseg_tpu_torch.core.config import ModelConfig

    unknown = sorted(set(model) - {f.name for f in dataclasses.fields(ModelConfig)})
    if unknown:
        raise ValueError(f"configuration {config}: model key(s) {unknown} are not fields of "
                         "the program's ModelConfig")
    return ModelConfig(**model)


def print_phases(marks: List[Tuple[str, float]]) -> None:
    """One stderr line with the seconds of each set-up phase of a cell."""
    parts = [f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:])]
    print(f"set-up phases: {', '.join(parts)}", file=sys.stderr, flush=True)


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """metrics/<name>.py's read(observation) -> value, or None where it
    finds nothing to read."""
    module = "ubench_metric_" + name.replace(".", "_")
    return load_module(HERE / "metrics" / f"{name}.py", module).read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# --------------------------------------------------------------- the trace
def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _clip(iv: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def summarise_trace(events: List[Dict[str, Any]], unit: str) -> Dict[str, Any]:
    """Reduce a chrome trace's events (times in microseconds) to seconds:
    the traced wall (first to last `unit` annotation), the union of device
    activity within it (busy), the union of its kernels alone (kernels:
    memory copies and sets left out), copy time by direction, and the
    breakdown: device operations by summed time, and idle gaps by the
    innermost host operation that spans each gap's midpoint."""
    marks = [e for e in events if e.get("name") == unit and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {unit!r} annotation")
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    busy = _union(_clip([(e["ts"], e["ts"] + e["dur"]) for e in device], lo, hi))
    kernels = _union(_clip([(e["ts"], e["ts"] + e["dur"]) for e in device
                            if e["cat"] == "kernel"], lo, hi))
    copies: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    for e in device:
        by_op[e["name"][:200]] = by_op.get(e["name"][:200], 0.0) + e["dur"] / 1e6
        if e["cat"] == "gpu_memcpy":
            for d in ("HtoD", "DtoH", "DtoD"):
                if d in e["name"]:
                    copies[d] = copies.get(d, 0.0) + e["dur"] / 1e6
    host = sorted((e for e in events
                   if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")
                   and "dur" in e and e.get("name") != unit), key=lambda e: e["ts"])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps: Dict[str, float] = {}
    # one sweep in time: each thread's host operations nest, so a stack per
    # thread holds the operations open at a gap's midpoint, innermost on top
    stacks: Dict[Any, List[Dict[str, Any]]] = {}
    i = 0
    for a, b in idle:
        mid = (a + b) / 2
        while i < len(host) and host[i]["ts"] <= mid:
            e = host[i]
            st = stacks.setdefault(e.get("tid"), [])
            while st and st[-1]["ts"] + st[-1]["dur"] < e["ts"]:
                st.pop()
            st.append(e)
            i += 1
        open_ops = []
        for st in stacks.values():
            while st and st[-1]["ts"] + st[-1]["dur"] < mid:
                st.pop()
            if st:
                open_ops.append(st[-1])
        name = min(open_ops, key=lambda e: e["dur"])["name"][:200] if open_ops else "(no host op)"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "wall_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_busy_s": sum(b - a for a, b in kernels) / 1e6,
        "copy_s": copies,
        "breakdown": {"device_ops": top(by_op), "idle_gaps": top(gaps)},
    }


def profile(run: Callable[[], int], unit: str) -> Tuple[Dict[str, Any], int]:
    """Run `run` (which annotates each unit of work with `unit` and returns
    how many it ran) under torch.profiler and summarise its trace. A
    session that records no device activity is repeated, up to
    PROFILE_TRIES times, then fails (frozen copy of chip_smoke.py:577,
    device_times). The chrome trace goes to a temporary file under TMPDIR
    and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(PROFILE_TRIES):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            n = run()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            events = read_json(Path(path)).get("traceEvents", [])
        finally:
            os.unlink(path)
        summary = summarise_trace(events, unit)
        if summary["kernel_busy_s"] > 0:
            return summary, n
    raise RuntimeError(f"torch.profiler recorded no device time in {PROFILE_TRIES} sessions")


# ----------------------------------------------------------------- the run
def run_cell(spec: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str,
             t0: float) -> Dict[str, Any]:
    """Set up the cell, measure its window, trace a stretch when asked,
    check what the window produced against the reference, and return the
    result line's object (without `device`'s card fields)."""
    import torch

    kind = kind_of(spec)
    t_import = time.perf_counter() - t0
    cell = kind.Cell(spec, device, seed)
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"setup: {setup_s:.3f} s, of which imports {t_import:.3f} s", file=sys.stderr,
          flush=True)
    from unetseg_tpu_torch.ops.kernels.launches import launch_counts, reset_launch_counts

    reset_launch_counts()
    window = cell.window(seconds)
    launched = {k: v / window["units"] for k, v in launch_counts().items() if v}
    print(f"window: {window['units']} {cell.unit} in {window['window_s']:.3f} s; kernel "
          f"launches per unit {launched}", file=sys.stderr, flush=True)
    result: Dict[str, Any] = {"attempted": window["units"], "failed": window["failed"]}
    dev: Dict[str, Any] = {}
    if trace:
        summary, n = profile(cell.traced, cell.unit)
        obs = dict(cell.observation(window), launches=launched, trace=summary,
                   traced_units=n)
        metrics = {}
        for m in spec["per_layer"]:
            value = metric_reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = summary["breakdown"]
        dev.update(busy_s=summary["busy_s"], window_s=summary["wall_s"])
    else:
        values = dict(cell.end_to_end(window), setup_s=setup_s)
        # a metric of the device's trace has no value on the CPU, where the tests run
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in values}
    dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    readings = cell.readings()
    checks = {k: {"value": readings[k], "limit": spec["limits"][k]} for k in spec["limits"]}
    correct = window["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return dict(correct=correct, metrics=metrics, device=dev, **result, checks=checks)


def card(device_count: int) -> Dict[str, Any]:
    """The card's platform, name, count and power limit."""
    import subprocess

    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": device_count}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits",
                            "-i", "0"], capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        out["power_limit_w"] = None
    return out


def print_result(result: Dict[str, Any]) -> None:
    """The check's numbers as the last lines of stderr, then the result as
    the last line of stdout, `checks` its last key."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr, flush=True)
    keys = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
    line = {k: result[k] for k in keys if k in result}
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
