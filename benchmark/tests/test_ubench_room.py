"""A configuration whose net is no U-Net arrives as new files alone: the
toy architecture module arch_nearest.py (beside this file), named by a
configuration, goes through the seeded variables, the reference's forward
and masks, the serving call's and the train step's counts, and the train
check's readout, with no file of the harness changed."""

import types

import numpy as np
import pytest
import torch

from ubench_tiny import BENCH, harness

import flops
import synth
from reference import serve as ref_serve
from reference import train as ref_train

CONFIG = {"architecture": "arch_nearest",
          "model": {"in_channels": 1, "num_classes": 2, "base_features": 4, "levels": 2}}
MODEL = CONFIG["model"]
SIZE = 64  # 64 -> 60, 30 -> 26, 52 -> 48
SERVE = {"frames": 2, "size": 64, "tile_input": 64, "tile_batch": 4, "members": 1, "tta": "none"}
TRAIN = {"batch": 2, "size": SIZE, "steps_per_epoch": 2, "check_steps": 2, "optimizer": "adam",
         "learning_rate": 3e-4, "cosine_decay": True, "num_epochs": 4, "ema_decay": 0.999,
         "elastic_alpha": 20.0, "elastic_sigma": 3.0, "aug_gamma": 0.35, "aug_illum": 0.15,
         "aug_noise": 0.05, "standardize": True, "w0": 10.0, "sigma_w": 5.0}


@pytest.fixture(scope="module")
def arch():
    """The toy, loaded by the harness's loader under the name a
    configuration's `architecture` resolves to."""
    toy = harness.load_module(BENCH / "tests" / "arch_nearest.py", "ubench_arch_arch_nearest")
    assert harness.architecture_of(CONFIG) is toy
    return toy


def test_variables_follow_the_toys_leaves(arch):
    v = synth.variables(arch, MODEL, 2**31 + 1, "cpu")
    assert sorted(v["params"]) == ["a0", "a1", "b0", "logits"]
    assert v["params"]["b0"]["conv0"]["kernel"].shape == (3, 3, 12, 4)
    n = flops.param_count(arch, MODEL)
    assert n["params"] == sum(x.size for k, x in _leaves(v["params"]))
    assert n["stats"] == sum(x.size for k, x in _leaves(v["batch_stats"]))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_reference_forward_and_masks(arch):
    v = arch.plant_intensity_path(synth.variables(arch, MODEL, 2**31 + 2, "cpu"))
    params, stats = arch.to_tensors(v, "cpu")
    x = torch.rand((2, 1, SIZE, SIZE), generator=torch.Generator().manual_seed(3))
    logits, _ = arch.forward(params, stats, x, MODEL)
    assert logits.shape == (2, 2, flops.shapes(SIZE, 2)["out"], 48)
    frames, _ = synth.cell_frames(synth.generator(5, "frames", "cpu"), 2, SIZE, "cpu")
    masks, _ = ref_serve.masks(frames, ref_serve.nets_from(arch, [v], "cpu"), arch, MODEL,
                               SIZE, "none", "mean", "mean", False, 0.5)
    assert masks.shape == frames.shape
    assert ((masks == 1) == (frames > 0.475)).float().mean() > 0.95


def test_serving_call_counts_the_toys_layers(arch):
    call = flops.serve_call(arch, MODEL, SERVE)
    fwd = arch.forward_layers(MODEL, 4, 64)
    # two frames of four 48^2 output tiles each, in chunks of four tiles
    assert call["forwards"] == 2 and "upsample" in [x["name"] for x in call["layers"]]
    assert call["model_flops"] == 2 * flops.model_flops(fwd)


def test_train_step_counts_the_toys_layers(arch):
    fwd = {x["name"]: x for x in arch.forward_layers(MODEL, 2, SIZE)}
    step = {x["name"]: x for x in flops.train_step(arch, MODEL, TRAIN)["layers"]}
    assert flops.model_flops(list(step.values())) == \
        3 * flops.model_flops(list(fwd.values())) - fwd["a0.conv0"]["ops"]
    assert "a0.conv0.dgrad" not in step and "head.bn_relu" not in step
    # the upsampling's backward writes its input's gradient, a quarter of its output
    assert step["upsample.bwd"]["out_bytes"] == fwd["upsample"]["out_bytes"] / 4


def test_train_check_reads_the_toys_watched_leaves(arch):
    """The train kind's readout with the reference itself in the program's
    place: its state under the program's names (arch.ref_key), its first
    steps followed again by the reference, and a reading for each
    leaf group arch.watched names, each at rounding."""
    kind = harness.kind_of({"traffic": {"kind": "train_steps"}})
    cell = kind.Cell.__new__(kind.Cell)
    seed = 2**31 + 9
    images, labels = synth.cell_frames(synth.generator(seed, "frames", "cpu"), 4, SIZE, "cpu")
    draws = synth.augment_draws(synth.generator(seed, "draws", "cpu"), 2, 2, SIZE, TRAIN, "cpu")
    cell.__dict__.update(
        device="cpu", model=MODEL, t=TRAIN, config=CONFIG, arch=arch, three_class=False,
        variables=synth.variables(arch, MODEL, seed, "cpu"), images=images, labels=labels,
        weights=synth.weight_maps(labels, TRAIN["w0"], TRAIN["sigma_w"]), raw_draws=draws,
        orders=[torch.tensor([[0, 1], [2, 3]])], start=2)
    params, stats = arch.to_tensors(cell.variables, "cpu")
    tr = ref_train.Trainer(params, stats, TRAIN, 2, count=2)
    name = {arch.ref_key(p): p for p in _program_names(params, stats)}

    def state():
        def named(tree):
            return {name[k]: v.clone() for k, v in tree.items()}

        return types.SimpleNamespace(
            params=named(tr.params), batch_stats=named(tr.stats), ema_params=named(tr.ema),
            ema_batch_stats=named(tr.ema_stats), opt_state={"mu": named(tr.mu)})

    cell.snap, losses = {0: state()}, []
    for s, (x, y, w) in enumerate(cell.batches()):
        losses.append(tr.step(x, y, w, draws[s], arch, MODEL, False, 2, 1.0)["loss"])
        cell.snap[s + 1] = state()
    cell.got = cell.program_readout(losses)
    out = cell.readings()
    assert list(out) == ["loss_gap", "grad1_gap", "change_gap", *arch.watched(MODEL)]
    assert all(np.isfinite(v) and v < 1e-5 for v in out.values()), out


def _program_names(params, stats):
    """The program's state-dict names of the toy's leaves."""
    out = []
    for k in list(params) + list(stats):
        block, *rest = k.split("/")
        if block == "logits":
            out.append(f"logits.{'weight' if rest[0] == 'kernel' else 'bias'}")
        else:
            sub, leaf = rest
            leaf = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
                    "var": "running_var"}.get(leaf, leaf)
            out.append(f"{block}.{sub}.{leaf}")
    return out
