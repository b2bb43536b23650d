"""The per-layer readers see the window's kernel launches per unit, the
same dict as the stderr line prints; launches during the traced stretch
after the window leave it unchanged."""

import io
import time
from contextlib import redirect_stderr

from ubench_tiny import tiny_spec, harness

PER_CALL = 3  # the stand-in wrapper's launches a call of the window
TRACED = 5  # and during the traced stretch


def test_readers_see_the_windows_launches(monkeypatch):
    from unetseg_tpu_torch.ops.kernels import launches

    monkeypatch.setattr(launches, "KERNELS", list(launches.KERNELS))

    @launches.counted
    def standin_kernel():
        standin_kernel.launches += 1

    spec = tiny_spec("c2-serve-700x16")
    kind = harness.kind_of(spec)
    window = kind.Cell.window

    def launching_window(self, seconds):
        w = window(self, seconds)
        for _ in range(PER_CALL * w["units"]):
            standin_kernel()
        return w

    def traced_profile(run, unit):
        n = run()
        for _ in range(TRACED):
            standin_kernel()
        summary = {"wall_s": 1.0, "busy_s": 0.5, "kernel_busy_s": 0.5, "copy_s": {},
                   "breakdown": {"device_ops": [], "idle_gaps": []}}
        return summary, n

    seen = []
    monkeypatch.setattr(kind.Cell, "window", launching_window)
    monkeypatch.setattr(harness, "profile", traced_profile)
    monkeypatch.setattr(harness, "metric_reader", lambda name: lambda obs: seen.append(obs))
    err = io.StringIO()
    with redirect_stderr(err):
        result = harness.run_cell(spec, 2**31 + 11, 0.2, True, "cpu", time.perf_counter())
    assert result["attempted"] >= 1 and result["metrics"] == {}
    assert seen and all(obs["launches"] == {"standin_kernel": float(PER_CALL)} for obs in seen)
    assert f"kernel launches per unit {{'standin_kernel': {float(PER_CALL)}}}" in err.getvalue()
    assert standin_kernel.launches == PER_CALL * result["attempted"] + TRACED
