"""The port's benchmark (unetseg_tpu_torch/bench.py) against the JAX
package's bench.py, on the CPU.

bench.py's `segment` is a closure inside its main(), and bench.py stays as
it is, so the JAX side is rebuilt here from the public functions it calls
(bench.py:99-162): UNet, fold_batchnorm and the folded apply, mirror_pad,
extract_tiles, stitch, and softmax > 0.5. Its `section` (bench.py:283-289)
is copied the same way. The keys of its JSON line are read from its
source.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.core.config import DataConfig as JaxDataConfig
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.core.config import TrainConfig as JaxTrainConfig
from unetseg_tpu.infer.folding import fold_batchnorm as jax_fold_batchnorm
from unetseg_tpu.infer.tiling import extract_tiles as jax_extract_tiles
from unetseg_tpu.infer.tiling import mirror_pad as jax_mirror_pad
from unetseg_tpu.infer.tiling import plan_tiles as jax_plan_tiles
from unetseg_tpu.infer.tiling import stitch as jax_stitch
from unetseg_tpu.models.fast_init import fast_random_variables as jax_fast_random_variables
from unetseg_tpu.models.unet import UNet as JaxUNet
import chip_smoke
from unetseg_tpu_torch import bench
from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.infer.tiling import min_tile_input
from unetseg_tpu_torch.models.fast_init import fast_random_variables

REPO = Path(__file__).resolve().parents[1]
CFG = dict(base_features=4, compute_dtype="float32")
SIZE, FRAMES, CHUNK = 96, 2, 2
# masks must agree at every pixel whose JAX probability is further than
# this from the threshold
PROB_TOL = 1e-4
VARIANT_D = dict(tier2=True, fused_enc0=True, dec_fuse="tail", cblock=("all",))


def he_rescaled(variables):
    """The JAX fast_random_variables tree with each conv kernel's N(0, 0.05)
    draws scaled to He fan-out std sqrt(2 / (kH kW O)), and BatchNorm's
    identity parameters and statistics drawn around the identity (scale,
    var in [0.5, 1.5]; bias, mean in [-0.2, 0.2]) from RandomState(0), as
    the port's fast_init draws them. At base 4 the flat 0.05 shrinks the
    activations through 18 convs until every probability lies within
    6e-5 of 0.5, where the mask comparison would test nothing; and with
    every bias 0 the net maps a * x to a * f(x), so the masks would not
    see the input's scale (the normalisation's divisor)."""
    rs = np.random.RandomState(0)
    draw = {"scale": (0.5, 1.5), "var": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.2, 0.2)}

    def walk(tree, bn=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k.startswith("bn"))
            elif k == "kernel":
                kh, kw, _, co = v.shape
                out[k] = np.asarray(v) * np.float32(np.sqrt(2.0 / (kh * kw * co)) / 0.05)
            elif bn:
                out[k] = rs.uniform(*draw[k], v.shape).astype(np.float32)
            else:
                out[k] = np.array(v)
        return out

    return {k: walk(v) for k, v in variables.items()}


@pytest.fixture(scope="module")
def jax_segment():
    """bench.py's segment (its non-TPU forward, the folded apply) at base
    4 fp32: the variables, the frames, the stitched probabilities and the
    masks."""
    cfg = JaxModelConfig(**CFG)
    tile_in = min_tile_input(SIZE)
    variables = he_rescaled(jax_fast_random_variables(JaxUNet(cfg=cfg), jax.random.key(0),
                                                      input_size=SIZE))
    fmodel, fvars = jax_fold_batchnorm(cfg, variables)
    apply_fn = jax.jit(fmodel.apply)
    grid = jax_plan_tiles(SIZE, SIZE, tile_in)
    n_tiles = FRAMES * grid.num_tiles
    frames = np.random.RandomState(0).rand(FRAMES, SIZE, SIZE).astype(np.float32)
    tiles = jax.vmap(lambda im: jax_extract_tiles(jax_mirror_pad(im, grid), grid))(
        jnp.asarray(frames))
    x = (tiles.reshape(n_tiles, grid.tile_in, grid.tile_in) - 0.5) / 0.5
    outs = [jax.nn.softmax(apply_fn(fvars, x[s:s + CHUNK, ..., None]), -1)[..., 1]
            for s in range(0, n_tiles, CHUNK)]
    p = jnp.concatenate(outs).reshape(FRAMES, grid.num_tiles, grid.tile_out, grid.tile_out)
    p = np.asarray(jax.vmap(lambda m: jax_stitch(m[..., None], grid)[..., 0])(p))
    return dict(variables=variables, frames=frames, tile_in=tile_in, probs=p,
                masks=(p > 0.5).astype(np.uint8))


@pytest.mark.parametrize("options", [{}, VARIANT_D], ids=["default", "variant_d"])
def test_segment_matches_jax_segment(jax_segment, options):
    segment = bench.make_segment(ModelConfig(**CFG), jax_segment["variables"], SIZE, FRAMES,
                                 jax_segment["tile_in"], CHUNK, "cpu", **options)
    masks = segment(torch.from_numpy(jax_segment["frames"])).numpy()
    assert masks.shape == (FRAMES, SIZE, SIZE) and masks.dtype == np.uint8
    clear = np.abs(jax_segment["probs"] - 0.5) > PROB_TOL
    assert clear.mean() > 0.99  # the comparison covers the frames
    want = jax_segment["masks"][clear]
    assert 0 < want.mean() < 1  # both classes present
    assert np.array_equal(masks[clear], want)


def test_segment_refuses_unknown_options():
    v = fast_random_variables(ModelConfig(**CFG), 0)
    with pytest.raises(ValueError, match="cblock"):
        bench.make_segment(ModelConfig(**CFG), v, SIZE, FRAMES, min_tile_input(SIZE), CHUNK,
                           "cpu", cblock=("nope",))
    with pytest.raises(ValueError, match="dec_fuse"):
        bench.make_segment(ModelConfig(**CFG), v, SIZE, FRAMES, min_tile_input(SIZE), CHUNK,
                           "cpu", dec_fuse="none")


def jax_section(recipe, tp, name, **fallback):
    """bench.py:283-289's section."""
    known = {f.name for f in dataclasses.fields(tp)}
    kw = dict(fallback)
    kw.update({k: v for k, v in (recipe.get(name) or {}).items() if k in known})
    return tp(**kw)


RECIPES = {
    "best_recipe": json.loads((REPO / "configs" / "best_recipe.json").read_text()),
    "empty": {},
    "train_only": {"train": {"num_epochs": 3, "batch_size": 2, "not_a_field": 1}},
    "data_only": {"data": {"augment": False, "aug_noise": 0.0}, "train": None},
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_resolution_matches_bench_py(tmp_path, name):
    path = tmp_path / "recipe.json"
    path.write_text(json.dumps(RECIPES[name]))
    train_cfg, data_cfg = bench.resolve_recipe(bench.load_recipe(path))
    recipe = RECIPES[name]
    want_train = jax_section(recipe, JaxTrainConfig, "train", optimizer="adam",
                             learning_rate=3e-4, cosine_decay=True, num_epochs=40)
    want_data = jax_section(recipe, JaxDataConfig, "data", augment=True, standardize=True,
                            aug_gamma=0.35, aug_illum=0.15, aug_noise=0.05)
    assert dataclasses.asdict(train_cfg) == dataclasses.asdict(want_train)
    assert dataclasses.asdict(data_cfg) == dataclasses.asdict(want_data)


def test_missing_recipe_file_takes_the_fallbacks(tmp_path):
    assert bench.load_recipe(tmp_path / "absent.json") == {}
    train_cfg, _ = bench.resolve_recipe({})
    assert (train_cfg.optimizer, train_cfg.learning_rate, train_cfg.num_epochs) == (
        "adam", 3e-4, 40)


def bench_py_keys():
    """The keys of bench.py's JSON line: the `record` literal, its
    `record[...] =` assignments and _measure_train_step's returned dict."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == "record" for t in node.targets):
            keys += [k.value for k in node.value.keys]
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) and \
                node.value.id == "record" and isinstance(node.ctx, ast.Store):
            keys.append(node.slice.value)
        if isinstance(node, ast.FunctionDef) and node.name == "_measure_train_step":
            (ret,) = [n for n in ast.walk(node)
                      if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
            keys += [k.value for k in ret.value.keys]
    return keys


TRAIN = {"train_steps_per_sec": 21.37, "train_step_ms": 46.8,
         "train_step_config": "augmented best-recipe step, batch 4, 512^2, kernel path"}


def test_record_has_bench_py_keys_and_roundings():
    rec = bench.build_record(178.123456, 512, 16, {}, TRAIN, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert sorted(rec) == sorted(bench_py_keys() + ["device"])
    assert rec["metric"] == ("sustained overlap-tile segmentation, 512x512 frames, full-width "
                             "bf16 folded U-Net, batch 16")
    assert rec["value"] == 178.12 and rec["unit"] == "MPix/s/chip"
    baseline = json.loads((REPO / "baselines" / "torch_cpu.json").read_text())["mpix_per_sec"]
    assert rec["vs_baseline"] == round(178.123456 / baseline, 1) == 1515.9
    assert {k: rec[k] for k in TRAIN} == TRAIN
    assert rec["seg_seq01"] is None and rec["seg_seq02"] is None
    assert "not measured" in rec["seg_source"]
    assert rec["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    json.dumps(rec)


def test_record_without_train_baseline_or_card(tmp_path):
    rec = bench.build_record(50.0, 512, 16, VARIANT_D, {}, None,
                             baseline_path=tmp_path / "absent.json")
    assert rec["vs_baseline"] == 1.0 and rec["device"] is None
    assert not set(TRAIN) & set(rec)
    assert rec["metric"].endswith(", tier2, fused_enc0, dec_fuse=tail, cblock=all")


@pytest.mark.parametrize("variant", [None, *chip_smoke.VARIANTS])
def test_serving_launches_match_chip_smoke(variant):
    opts, want = ({}, chip_smoke.DEFAULT_LAUNCHES) if variant is None else \
        chip_smoke.VARIANTS[variant]
    assert bench.serving_launches(ModelConfig(), **opts) == want


def test_train_launches_match_chip_smoke():
    assert bench.TRAIN_LAUNCHES == chip_smoke.TRAIN_LAUNCHES
    # one 512^2 segment call of 16 frames is one chunk of 16 700^2 tiles
    assert bench.forward_chunks(512, 16, min_tile_input(512), 16) == 1


def test_train_timing_on_the_cpu():
    out = bench.measure_train_step(1, 2, device="cpu", model_cfg=ModelConfig(**CFG), size=188)
    assert out["train_step_ms"] > 0 and out["train_steps_per_sec"] > 0
    assert out["train_step_config"] == "augmented best-recipe step, batch 4, 188^2, plain path"


def test_bench_command_without_cuda_exits_1():
    r = subprocess.run([sys.executable, "-m", "unetseg_tpu_torch", "bench"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert r.stdout == ""
    lines = [ln for ln in r.stderr.splitlines() if ln.startswith("bench:")]
    assert len(lines) == 1 and "CUDA" in lines[0] and "no result" in lines[0]


def test_bench_import_loads_no_jax_or_triton():
    code = ("import sys, unetseg_tpu_torch.bench; print(sorted(m for m in "
            "('jax', 'flax', 'triton', 'unetseg_tpu') if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
