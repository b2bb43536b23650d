"""Host cost of one of the port's spans (unetseg_tpu_torch.utils.profiling.
annotate) with no profiler recording: microseconds per span, alone and
nested one inside another, less the loop's own cost, best of `--repeats`.

Usage: python tools/span_cost.py [--spans 200000] [--repeats 5]
Prints one JSON line.
"""

import argparse
import json
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from unetseg_tpu_torch.utils.profiling import annotate, reset_span_totals  # noqa: E402


def per_iteration_us(body, n: int, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e6


def empty():
    pass


def one():
    with annotate("span_cost.outer"):
        pass


def nested():
    with annotate("span_cost.outer"):
        with annotate("span_cost.inner"):
            pass


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spans", type=int, default=200_000)
    p.add_argument("--repeats", type=int, default=5)
    a = p.parse_args()
    base = per_iteration_us(empty, a.spans, a.repeats)
    single = per_iteration_us(one, a.spans, a.repeats) - base
    pair = per_iteration_us(nested, a.spans, a.repeats) - base
    reset_span_totals()
    print(json.dumps({"us_per_span": single, "us_per_nested_span": pair / 2,
                      "host": platform.processor() or platform.machine(),
                      "python": platform.python_version()}))


if __name__ == "__main__":
    main()
