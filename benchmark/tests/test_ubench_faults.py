"""With the timed path broken underneath, a run's check reads `correct`
false: for each fault a cell can have (faults.py) and for the control,
the reference in fp8 in the program's place. The look for a chip is
skipped; everything else is a whole run of the harness at a tiny size.

The serving control runs on a net whose planted intensity path is weak
(gain 2, head weights at full scale): at this size the default planted
net's masks stand clear of the threshold even in fp8, as they do not at
the cells' own size, where the control is read on the chip (PERF.md)."""

import time

import pytest

from ubench_tiny import tiny_spec, harness

import faults

SEED = 2**31 + 4242
WEAK = {"gain": 2.0, "level": 0.475, "head_scale": 1.0}
CASES = ([("c2-serve-700x16", f) for f in faults.SERVE]
         + [("c2-serve-flagship", f) for f in ("half", "altered")]
         + [(c, f) for c in ("c2-train-recipe", "c3-train-border") for f in faults.TRAIN])


def with_control(cls):
    """The kind's Cell with the control put in the program's place."""
    class Control(cls):
        def __init__(self, *a):
            super().__init__(*a)
            faults.control(self)

    return Control


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_reads_not_correct(cell, fault, monkeypatch):
    weak = fault == "control" and "serve" in cell
    spec = tiny_spec(cell, plant=WEAK) if weak else tiny_spec(cell)
    if fault == "control":
        kind = harness.kind_of(spec)
        monkeypatch.setattr(kind, "Cell", with_control(kind.Cell))
    with faults.planted(spec["traffic"]["kind"], fault):
        out = harness.run_cell(spec, SEED, 0.2, False, "cpu", time.perf_counter())
    assert not out["correct"], out["checks"]


def test_sound_run_with_the_weak_plant_is_correct():
    spec = tiny_spec("c2-serve-700x16", plant=WEAK)
    out = harness.run_cell(spec, SEED, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
