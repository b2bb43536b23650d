"""Benchmark of unetseg_tpu_torch (the PyTorch + CUDA port) on NVIDIA GPUs.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. One process runs one cell of
BENCHMARK.json: set-up (the kernel library from its build cache inside
the checkout, weights and inputs made from --seed, the cell's shapes
warmed up), a window of --seconds, then the check of what the window
produced against the plain reference (benchmark/reference). With
--trace 0 the last line of stdout holds the cell's end-to-end metrics;
with --trace 1 a stretch after the window runs under torch.profiler and
the line holds the per-layer metrics, the device's busy and traced
seconds, and a breakdown. The numbers compared and their limits are the
last lines of stderr and the line's last key, `checks`.

Exits 2 without a result where CUDA is absent or has fewer devices than
the cell asks for, and 3 where a module of JAX or of the JAX package has
been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()
sys.path[:0] = [str(HERE), str(ROOT)]

import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {spec['chips']} CUDA device(s); found {n}", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    result["device"] = dict(harness.card(spec["chips"]), **result["device"])
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
