"""Launch counters of the kernel wrappers.

Each wrapper of a hand-written kernel is registered with `counted`, which
gives it a `launches` attribute; the wrapper adds one where it launches
its kernel and nowhere else (never on the plain CPU route). A run that
must show which kernels it went through resets the counts, runs, and
reads them back. A run in other processes (a command line, a script of
commands) sets UNETSEG_LAUNCH_LOG to a file: each process that imported
the wrappers then appends one JSON line at exit, {"argv", "pid",
"launches"} with its nonzero counts.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
from typing import Callable, Dict, List

KERNELS: List[Callable] = []
LOG_ENV = "UNETSEG_LAUNCH_LOG"


def counted(fn: Callable) -> Callable:
    fn.launches = 0
    KERNELS.append(fn)
    return fn


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    """{wrapper name: launches} for every registered wrapper whose module
    has been imported."""
    return {k.__name__: k.launches for k in KERNELS}


def _log_launches(path: str) -> None:
    line = json.dumps({"argv": sys.argv, "pid": os.getpid(),
                       "launches": {k: v for k, v in launch_counts().items() if v}})
    with open(path, "a") as f:
        f.write(line + "\n")


if os.environ.get(LOG_ENV):
    atexit.register(_log_launches, os.environ[LOG_ENV])
