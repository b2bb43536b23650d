"""On the card (marker `cuda`; each test skips without one): every cell
runs briefly at its own size and reads `correct` true, and its control,
the fp8 reference in the program's place, fails its check there."""

import json
import subprocess
import sys

import pytest

from ubench_tiny import CELLS, ROOT, harness

import calibrate

pytestmark = pytest.mark.cuda


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    need_card()
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 71), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    need_card()
    spec = harness.load_cell(cell, ROOT)
    out = calibrate.reading(spec, 2**31 + 72, "cuda", "control")["readings"]
    assert any(out[k] > spec["limits"][k] for k in spec["limits"]), out
