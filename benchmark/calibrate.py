"""Readings that the limits of a cell's check are set from (PERF.md):
the program's numbers over many seeds (the lower readings), and the
control's and each planted fault's over a few (the upper readings), all
at the cell's own sizes and in one process. The benchmark's runs never
run this.

    python3 benchmark/calibrate.py --workload NAME --seeds N [N ...]
        [--faults control,half,...] [--fault-seeds K]

A serving cell's program reading comes from `check_calls` calls on
distinct batches (a short window at the cell's own load); a training
cell's from its set-up's first steps. Prints one JSON line per seed and
mode, then a summary line: per number, the largest program reading and
each fault's smallest.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()
sys.path[:0] = [str(HERE), str(ROOT)]

import harness  # noqa: E402
import faults  # noqa: E402


def reading(spec, seed: int, device: str, fault: str = "") -> dict:
    import torch

    kind = harness.kind_of(spec)
    t0 = time.perf_counter()
    with faults.planted(spec["traffic"]["kind"], fault):
        cell = kind.Cell(spec, device, seed)
    if fault == "control":
        faults.control(cell)
    if hasattr(cell, "serve"):
        n = len(cell.batches)
        for i in range(spec["traffic"]["check_calls"]):
            cell._keep(i, i % n, cell.serve(cell.batches[i % n]))
    out = cell.readings()
    detail = getattr(cell, "detail", None)
    del cell
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return {"seed": seed, "mode": fault or "program", "readings": out,
            "seconds": time.perf_counter() - t0, "detail": detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    args = p.parse_args(argv)
    spec = harness.load_cell(args.workload, ROOT)
    rows = []
    for seed in args.seeds:
        rows.append(reading(spec, seed, "cuda"))
        print(json.dumps(rows[-1], default=str), flush=True)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in args.seeds[: args.fault_seeds]:
            rows.append(reading(spec, seed, "cuda", fault))
            print(json.dumps(rows[-1], default=str), flush=True)
    summary = {}
    for name in spec["limits"]:
        summary[name] = {"program_max": max(r["readings"][name] for r in rows
                                            if r["mode"] == "program")}
        for mode in {r["mode"] for r in rows} - {"program"}:
            summary[name][f"{mode}_min"] = min(r["readings"][name] for r in rows
                                               if r["mode"] == mode)
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
