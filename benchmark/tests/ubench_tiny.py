"""Shared by the benchmark's tests: the paths, and each cell cut to a size
a CPU test can hold (a base-4 net in float32, frames of 256^2 or 252^2)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

CELLS = [w["name"] for w in harness.benchmark_json(ROOT)["workloads"]]
SERVE = {"frames": 2, "size": 256, "tile_input": 252, "tile_batch": 8, "pool_batches": 2,
         "warmup_calls": 1, "check_calls": 2, "trace_calls": 1}
TRAIN = {"frames": 8, "size": 252, "batch": 2, "steps_per_epoch": 4, "epochs_drawn": 2,
         "trace_steps": 2}


def tiny_spec(cell: str, dtype: str = "float32", **traffic) -> dict:
    """The cell's spec with a base-4 net in `dtype` and small traffic."""
    spec = harness.load_cell(cell, ROOT)
    spec = copy.deepcopy(spec, {id(spec["architecture"]): spec["architecture"]})
    spec["config"]["model"].update(base_features=4, compute_dtype=dtype)
    t = spec["traffic"]
    t.update(SERVE if t["kind"] == "serve_tiles" else TRAIN)
    t.update(traffic)
    return spec
