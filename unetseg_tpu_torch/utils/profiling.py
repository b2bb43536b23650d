"""Tracing and timing hooks (counterpart of unetseg_tpu/utils/profiling.py):
a torch.profiler trace context that writes a TensorBoard-loadable trace,
named regions in the profiler's timeline, a wall-clock timer that
synchronises the devices of the results it waits on (CUDA launches are
asynchronous: a clock read without a synchronise times the launch, not
the work), and per-device memory statistics.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

import torch


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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


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
