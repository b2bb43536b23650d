"""Readings of the program's own spans (unetseg_tpu_torch.utils.profiling:
annotate, span_totals): host milliseconds a unit of work spends in a span,
over the window. The program clears the totals with its launch counts,
which the harness resets at the window's start, and a span adds nothing
while the profiler records, so the traced stretch after the window leaves
them as the window made them."""

from typing import Any, Dict, Optional

ROOTS = {"serve": "serve.call", "train": "train.step"}  # one a call, one a step


def per_unit_ms(obs: Dict[str, Any], kind: str, span: str) -> Optional[float]:
    """span's host ms per root span (a masks call or a train step) in a cell
    of `kind`; None in a cell of another kind, in a program without spans,
    where the span is missing or reads 0, or where the root's count is not
    the window's units."""
    if obs["kind"] != kind:
        return None
    try:
        from unetseg_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    root, got = totals.get(ROOTS[kind]), totals.get(span)
    if root is None or got is None or root["count"] != obs["units"] or got["total_s"] <= 0:
        return None
    return got["total_s"] / root["count"] * 1e3
