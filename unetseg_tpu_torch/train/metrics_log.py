"""Structured metrics logging (a copy of unetseg_tpu/train/metrics_log.py).

Every log point emits a JSONL record (step, epoch, loss, steps/sec,
MPix/s) beside the human-readable stdout line, so runs are
machine-comparable.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, TextIO


@dataclass
class MetricsLogger:
    jsonl_path: Optional[str] = None
    # None = the CURRENT sys.stdout at log time (a sys.stdout default would
    # bind whatever stream exists when the class is defined, e.g. a closed
    # pytest capture buffer)
    stream: Optional[TextIO] = None
    _fh: Optional[TextIO] = None
    _t0: float = field(default_factory=time.time)

    def __post_init__(self):
        if self.jsonl_path:
            parent = os.path.dirname(os.path.abspath(self.jsonl_path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(self.jsonl_path, "a")

    def log(self, record: Dict[str, Any], echo: bool = True) -> None:
        record = {"t": round(time.time() - self._t0, 3), **record}
        if self._fh:
            self._fh.write(json.dumps(_jsonable(record)) + "\n")
            self._fh.flush()
        if echo:
            parts = [f"{k}={_fmt(v)}" for k, v in record.items() if k != "t"]
            print("  ".join(parts), file=self.stream or sys.stdout, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def _jsonable(record: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in record.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = float(v)
    return out


class StepTimer:
    """steps/sec and megapixels/sec since the last reset, on the host clock;
    the caller syncs the device at the edges it measures."""

    def __init__(self, pixels_per_step: int = 0):
        self.pixels_per_step = pixels_per_step
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    def rates(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        sps = self._steps / dt
        out = {"steps_per_sec": sps}
        if self.pixels_per_step:
            out["mpix_per_sec"] = sps * self.pixels_per_step / 1e6
        return out
