"""Launch counters of the kernel wrappers.

Each wrapper of a hand-written kernel is registered with `counted`, which
gives it a `launches` attribute; the wrapper adds one where it launches
its kernel and nowhere else (never on the plain CPU route). A run that
must show which kernels it went through resets the counts, runs, and
reads them back.
"""

from __future__ import annotations

from typing import Callable, Dict, List

KERNELS: List[Callable] = []


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
