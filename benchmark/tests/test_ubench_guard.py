"""The import guard: a run fails where a module of JAX, its libraries or
the JAX package is loaded, compared by whole top-level names, and the
harness, the reference and the port's modules it drives load none."""

import subprocess
import sys
import types

from ubench_tiny import BENCH, ROOT, harness


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules  # what this process holds
    for name in ("unetseg_tpu_torch", "unetseg_tpu_torch.infer", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    before = set(harness.forbidden_modules())
    assert not before & {"unetseg_tpu_torch", "jaxtyping", "flaxen"}
    monkeypatch.setitem(sys.modules, "unetseg_tpu.infer", types.ModuleType("unetseg_tpu.infer"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert {"unetseg_tpu", "jax"} <= set(harness.forbidden_modules())


def test_a_run_loads_no_jax():
    code = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
sys.path.insert(0, {str(BENCH / 'tests')!r})
from ubench_tiny import tiny_spec, CELLS
import harness, faults, calibrate
for cell in CELLS:
    harness.run_cell(tiny_spec(cell), 11, 0.1, False, "cpu", time.perf_counter())
print(harness.forbidden_modules())
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
