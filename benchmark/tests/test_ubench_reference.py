"""The plain reference agrees with the port at a tiny width on the CPU: the
forward (and, bit for bit, with the reference before architecture
modules, ubench_parent.py), every serving cell's masks and every training
cell's first steps, each through a whole run of the harness."""

import hashlib
import time

import numpy as np
import pytest
import torch

from ubench_parent import RECORDED, SEED  # seeds run past 32 signed bits
from ubench_tiny import CELLS, tiny_spec, harness

import synth


def test_reference_forward_is_the_ports_unet():
    from unetseg_tpu_torch.core.config import ModelConfig
    from unetseg_tpu_torch.models.unet import UNet
    from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict

    model = {"in_channels": 1, "num_classes": 3, "base_features": 4, "levels": 5}
    arch = harness.architecture_of({})
    variables = synth.variables(arch, model, SEED, "cpu")
    net = UNet(ModelConfig(num_classes=3, base_features=4, compute_dtype="float32"))
    net.load_state_dict(flax_to_state_dict(variables))
    x = torch.rand((2, 188, 188), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = net(x[..., None]).permute(0, 3, 1, 2)
        params, stats = arch.to_tensors(variables, "cpu")
        got, _ = arch.forward(params, stats, x[:, None], model)
    assert got.shape == want.shape == (2, 3, 4, 4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert hashlib.sha256(got.numpy().tobytes()).hexdigest() == RECORDED["logits"]


def run(spec, seed=SEED):
    return harness.run_cell(spec, seed, 0.2, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", [c for c in CELLS if "serve" in c])
def test_serving_cell_agrees(cell):
    out = run(tiny_spec(cell))
    assert out["correct"] and out["checks"]["mask_mismatch"]["value"] == 0.0
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in harness.load_cell(cell, harness.Path(
        harness.HERE.parent))["end_to_end"]}


@pytest.mark.parametrize("cell", [c for c in CELLS if "train" in c])
def test_training_cell_agrees(cell):
    out = run(tiny_spec(cell))
    assert out["correct"], out["checks"]
    assert out["attempted"] % 4 == 0  # whole epochs of 4 steps


def test_masks_follow_the_planted_cells():
    spec = tiny_spec("c2-serve-700x16")
    kind = harness.kind_of(spec)
    cell = kind.Cell(spec, "cpu", SEED)
    masks = cell.serve(cell.batches[0])
    bright = cell.batches[0] > 0.475
    assert masks.dtype == np.uint8 and set(np.unique(masks)) <= {0, 1}
    assert (masks == bright).mean() > 0.95
