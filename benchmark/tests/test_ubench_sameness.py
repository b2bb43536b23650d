"""The harness reaches the net through its configuration's architecture
module, and every number the four cells compute without a clock is the
one it computed before (ubench_parent.py): the operations, bounds and
layers of every serving call and train step, and the seeded and planted
variables at full width. The parameter counts and the reference's logits
are held beside their witnesses, in test_ubench_flops.py and
test_ubench_reference.py."""

import pytest

from ubench_parent import CONFIGS, RECORDED, SERVE, digests, summary
from ubench_tiny import ROOT, harness

import flops
import synth

CELLS = [(CONFIGS[0], t) for t in SERVE] + [(c, "train-recipe") for c in CONFIGS]


def config(name):
    return harness.read_json(ROOT / "benchmark" / "configs" / f"{name}.json")


@pytest.mark.parametrize("name,traffic", CELLS)
def test_counts_are_the_parents(name, traffic):
    cfg = config(name)
    t = harness.read_json(ROOT / "benchmark" / "traffic" / f"{traffic}.json")
    count = flops.serve_call if t["kind"] == "serve_tiles" else flops.train_step
    assert summary(count(harness.architecture_of(cfg), cfg["model"], t)) == \
        RECORDED[f"{name}/{traffic}"]


@pytest.mark.parametrize("name", CONFIGS)
def test_variables_are_the_parents(name):
    cfg = config(name)
    arch = harness.architecture_of(cfg)
    v = synth.variables(arch, cfg["model"], 0, "cpu")
    assert digests(v) == RECORDED[f"{name}/variables"]
    if f"{name}/planted" in RECORDED:
        plant = harness.read_json(ROOT / "benchmark" / "traffic" / "serve-700x16.json")["plant"]
        assert digests(arch.plant_intensity_path(v, **plant))["values"] == \
            RECORDED[f"{name}/planted"]


def test_configurations_name_the_unet_by_default():
    for name in CONFIGS:
        assert "architecture" not in config(name)
        assert harness.architecture_of(config(name)) is harness.architecture_of(
            {"architecture": "unet"})
