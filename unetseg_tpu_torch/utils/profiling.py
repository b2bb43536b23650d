"""Tracing and timing hooks (counterpart of unetseg_tpu/utils/profiling.py):
a torch.profiler trace context that writes a TensorBoard-loadable trace,
the program's spans (`annotate`) with their host-clock totals, a
wall-clock timer that synchronises the devices of the results it waits on
(CUDA launches are asynchronous: a clock read without a synchronise times
the launch, not the work), and per-device memory statistics.

Spans. `annotate(name)` is the one span of the program. While a profiler
records, it is a `record_function` region of the trace, on the trace's
clock, and adds nothing to the totals (host times under the profiler's
per-operator recording are inflated). Otherwise it reads the host clock
twice and adds, under its name, one to the count, its duration to the
total and its duration less that of the spans opened inside it (on the
same thread) to the self time. The totals are always kept, as the kernel
wrappers' launch counts are; `ops/kernels/launches.reset_launch_counts`
clears both, so one call starts a measured window. The program's spans are
serve.* in infer/engine.Predictor.masks_tiled and train.* in
train/steps.make_train_step; their docstrings say what each covers.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed region (the CPU, and CUDA where it is
    available) into `log_dir` as a TensorBoard trace; a no-op if None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


_TOTALS: Dict[str, List[int]] = {}  # name -> [count, total ns, self ns]
_TOTALS_LOCK = threading.Lock()
_OPEN = threading.local()  # .stack: the open timed spans' child ns, innermost last


class annotate:
    """Span `name` over a `with` block: a region of the profiler's trace
    while a profiler records, else a timed span added to span_totals()."""

    __slots__ = ("name", "_region", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name
        self._region = None

    def __enter__(self) -> None:
        if _autograd_profiler._is_profiler_enabled:
            self._region = torch.profiler.record_function(self.name)
            self._region.__enter__()
            return
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        stack.append(0)
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc: Any) -> None:
        if self._region is not None:
            self._region.__exit__(*exc)
            return
        dt = time.perf_counter_ns() - self._t0
        stack = _OPEN.stack
        child = stack.pop()
        if stack:
            stack[-1] += dt
        with _TOTALS_LOCK:
            e = _TOTALS.get(self.name)
            if e is None:
                e = _TOTALS[self.name] = [0, 0, 0]
            e[0] += 1
            e[1] += dt
            e[2] += dt - child


def span_totals() -> Dict[str, Dict[str, float]]:
    """{name: {"count", "total_s", "self_s"}} of the timed spans closed
    since the last reset_span_totals()."""
    with _TOTALS_LOCK:
        return {k: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9}
                for k, (c, t, s) in _TOTALS.items()}


def reset_span_totals() -> None:
    with _TOTALS_LOCK:
        _TOTALS.clear()


def _sync(x: Any) -> None:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _sync(v)


class DeviceTimer:
    """Wall-clock timer that synchronises on device results.

    >>> t = DeviceTimer()
    >>> out = step(...)
    >>> dt = t.stop(out)   # waits for the devices of `out`, returns seconds
    """

    def __init__(self) -> None:
        self.start()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *sync_on: Any) -> float:
        for x in sync_on:
            _sync(x)
        return time.perf_counter() - self._t0


def memory_stats() -> Dict[str, Dict[str, Any]]:
    """torch.cuda.memory_stats per CUDA device ({} where there is none)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
