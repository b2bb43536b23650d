"""The port's `infer`, `predict` and `refine` commands on the CPU: their
flags, that a --config value is never overridden by a flag default, the
ensemble refusals, that without --cpu the work goes to the card, and
`refine` against the JAX command on the same files."""

import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image

from chip_smoke import plant_intensity_path
from unetseg_tpu.cli.main import main as jax_main
from unetseg_tpu_torch.cli import main as cli
from unetseg_tpu_torch.core.config import InferConfig, ModelConfig, TrainConfig
from unetseg_tpu_torch.infer import engine
from unetseg_tpu_torch.infer.engine import Predictor, load_image_01
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.train import checkpoint as ckpt
from unetseg_tpu_torch.train.state import create_train_state

TINY = dict(base_features=4, compute_dtype="float32")
SIZE = 252  # input 252 -> output 68


def _frames(root, n=4, size=90):
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(3)
    yy, xx = np.mgrid[:size, :size]
    for t in range(n):
        img = 0.25 + 0.05 * rs.standard_normal((size, size))
        for cy, cx, r in rs.uniform([10, 10, 8], [size - 10, size - 10, 16], (6, 3)):
            img[(yy - cy - t) ** 2 + (xx - cx) ** 2 <= r * r] += 0.45
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, f"t{t:03d}.tif"))
    return root


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A data root with sequence 01, two light checkpoints (raw + EMA
    each) of planted tiny nets, and a tiny recipe config."""
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "data" / "HeLa")
    _frames(os.path.join(root, "01"))
    cfg = ModelConfig(**TINY)
    dirs = []
    for seed in (2, 4):
        state = create_train_state(plant_intensity_path(fast_random_variables(cfg, seed)), cfg,
                                   TrainConfig(ema_decay=0.999), device="cpu")
        d = str(tmp / f"ck{seed}")
        ckpt.Checkpointer(d).save_light_payload(ckpt.device_light_payload(state), 1, 0.5)
        dirs.append(d)
    conf = tmp / "tiny.json"
    conf.write_text(json.dumps({
        "model": {"base_features": 4, "compute_dtype": "float32"},
        "infer": {"image_size": SIZE, "tile_input": SIZE, "tile_batch": 2, "min_cell_size": 7,
                  "temporal_markers": True, "temporal_bidi": True, "boundary_grow": 1.0,
                  "ensemble_merge": "vote"},
        "infer_per_sequence": {"01": {"boundary_grow": 1.5}},
    }))
    return dict(root=root, dirs=dirs, config=str(conf), tmp=tmp)


def test_infer_writes_the_predictors_mask(setup, tmp_path, capsys):
    img = os.path.join(setup["root"], "01", "t000.tif")
    pred = Predictor.from_checkpoint(setup["dirs"][0], ModelConfig(**TINY),
                                     InferConfig(image_size=SIZE, tile_input=SIZE), device="cpu")
    for tiled, want in ((False, pred.predict_image(load_image_01(img, SIZE))),
                        (True, pred.predict_image_tiled(load_image_01(img)))):
        out = str(tmp_path / f"mask_{tiled}.png")
        args = ["infer", "--cpu", "--config", setup["config"], "--checkpoint-dir",
                setup["dirs"][0], "--input", img, "--output", out] + (["--tiled"] if tiled else [])
        assert cli.main(args) == 0
        assert f"wrote {out}" in capsys.readouterr().out
        np.testing.assert_array_equal(np.array(Image.open(out)), want * 255)
    assert want.shape == (90, 90) and 0 < want.mean() < 1


def _capture(monkeypatch):
    """Record what the commands hand to the Predictor; return a fake one."""
    seen = {}

    class Fake:
        def predict_sequence(self, *a, **kw):
            seen["sequence"] = (a, kw)
            return []

        def predict_image(self, image):
            return np.zeros((2, 2), np.uint8)

    def ctor(name):
        def make(*args, **kw):
            seen.update(ctor=name, args=args, **kw)
            return Fake()
        return classmethod(lambda cls, *a, **kw: make(*a, **kw))

    for name in ("from_checkpoint", "from_checkpoints", "from_torch_checkpoint"):
        monkeypatch.setattr(engine.Predictor, name, ctor(name))
    return seen


@pytest.mark.parametrize("flags,ctor,ema", [
    ([], "from_checkpoint", False),
    (["--ema"], "from_checkpoint", True),
    (["--ema-both"], "from_checkpoints", "both"),
    (["--two"], "from_checkpoints", False),
    (["--two", "--ema"], "from_checkpoints", True),
])
def test_predict_routes_checkpoints_and_keeps_the_config(setup, monkeypatch, flags, ctor, ema):
    seen = _capture(monkeypatch)
    ck = ",".join(setup["dirs"]) if "--two" in flags else setup["dirs"][0]
    flags = [f for f in flags if f != "--two"]
    assert cli.main(["predict", "--config", setup["config"], "--data-root", setup["root"],
                     "--sequence", "01", "--checkpoint-dir", ck, *flags]) == 0
    assert seen["ctor"] == ctor and seen["ema"] == ema and seen["device"] == "cuda"
    icfg = seen["infer_cfg"]
    # the config's values and the per-sequence override stand: no flag default replaced them
    assert (icfg.min_cell_size, icfg.boundary_grow, icfg.ensemble_merge, icfg.image_size) == \
        (7, 1.5, "vote", SIZE)
    assert seen["model_cfg"] == ModelConfig(**TINY)
    _, kw = seen["sequence"]
    assert kw["temporal_markers"] and kw["temporal_bidi"]
    assert (kw["tiled"], kw["watershed"], kw["device_cc"], kw["marker_frac"]) == \
        (False, False, False, 0.5)


def test_predict_flags_override_the_config(setup, monkeypatch):
    seen = _capture(monkeypatch)
    assert cli.main(["predict", "--cpu", "--config", setup["config"], "--data-root",
                     setup["root"], "--sequence", "01", "--torch-checkpoint", "ref.pth",
                     "--threshold", "0.4", "--min-cell-size", "3", "--standardize",
                     "--normalize", "--tta", "flips", "--tta-merge", "gmean",
                     "--ensemble-merge", "mean", "--boundary-grow", "2", "--no-temporal-bidi",
                     "--tiled", "--resize-output", "64", "--batch-size", "3", "--marker-frac",
                     "0.6", "--three-class", "--dtype", "bfloat16",
                     "--output-dir", str(setup["tmp"] / "out")]) == 0
    assert seen["ctor"] == "from_torch_checkpoint" and seen["args"] == ("ref.pth",)
    assert seen["device"] == "cpu"
    icfg = seen["infer_cfg"]
    assert (icfg.threshold, icfg.min_cell_size, icfg.standardize, icfg.normalize, icfg.tta,
            icfg.tta_merge, icfg.ensemble_merge, icfg.boundary_grow) == \
        (0.4, 3, True, True, "flips", "gmean", "mean", 2.0)
    assert seen["model_cfg"] == ModelConfig(num_classes=3, base_features=4)
    (seq, masks, inst), kw = seen["sequence"]
    assert seq == os.path.join(setup["root"], "01")
    assert (masks, inst) == (str(setup["tmp"] / "out" / "01_RES"),
                             str(setup["tmp"] / "out" / "01_RES_INST"))
    assert (kw["tiled"], kw["resize_output_to"], kw["batch_size"], kw["marker_frac"],
            kw["temporal_bidi"]) == (True, 64, 3, 0.6, False)


@pytest.mark.parametrize("command", ["infer", "predict"])
def test_commands_run_on_the_card_by_default(setup, monkeypatch, tmp_path, command):
    """Without --cpu both commands hand their Predictor to the card."""
    seen = _capture(monkeypatch)
    monkeypatch.setattr(engine, "load_image_01", lambda *a: np.zeros((4, 4), np.float32))
    extra = (["--input", "t.tif", "--output", str(tmp_path / "m.png")] if command == "infer"
             else ["--data-root", setup["root"], "--sequence", "01"])
    assert cli.main([command, "--checkpoint-dir", setup["dirs"][0], *extra]) == 0
    assert seen["device"] == "cuda"


@pytest.mark.parametrize("flags", [["--two"], ["--ema-both"]])
def test_epoch_with_an_ensemble_exits(setup, flags):
    ck = ",".join(setup["dirs"]) if flags == ["--two"] else setup["dirs"][0]
    flags = [f for f in flags if f != "--two"]
    with pytest.raises(SystemExit, match="--epoch is per-checkpoint"):
        cli.main(["predict", "--cpu", "--data-root", setup["root"], "--sequence", "01",
                  "--checkpoint-dir", ck, "--epoch", "1", *flags])
    with pytest.raises(SystemExit, match="--checkpoint-dir or --torch-checkpoint"):
        cli.main(["predict", "--cpu", "--data-root", setup["root"], "--sequence", "01"])


def test_predict_then_refine_matches_jax_refine(setup, tmp_path, capsys):
    """predict --cpu writes the sequence of a raw + EMA ensemble; refine
    rewrites its instances as the JAX command does on the same files."""
    out = str(tmp_path / "pred")
    assert cli.main(["predict", "--cpu", "--config", setup["config"], "--data-root",
                     setup["root"], "--sequence", "01", "--checkpoint-dir", setup["dirs"][0],
                     "--ema-both", "--no-temporal-bidi", "--output-dir", out]) == 0
    assert "wrote 8 files" in capsys.readouterr().out
    masks, inst = os.path.join(out, "01_RES"), os.path.join(out, "01_RES_INST")
    icfg = dataclasses.replace(cli._seq_infer_cfg(cli._load_config(
        cli.build_parser().parse_args(["predict", "--config", setup["config"]])),
        cli.build_parser().parse_args(["predict"]), "01"), temporal_bidi=False)
    pred = Predictor.from_checkpoints(setup["dirs"][:1], ModelConfig(**TINY), icfg, ema="both",
                                      device="cpu")
    frames = [load_image_01(os.path.join(setup["root"], "01", f"t{t:03d}.tif"), SIZE)
              for t in range(4)]
    for num, b, ins in pred.predict_frames(frames, range(4), temporal_markers=True):
        np.testing.assert_array_equal(np.array(Image.open(
            os.path.join(masks, f"mask{num:03d}.tif"))) > 0, b > 0)
        np.testing.assert_array_equal(np.array(Image.open(
            os.path.join(inst, f"m{num:03d}.tif"))), pred._grown(ins))
    res = {}
    for name, run in (("port", cli.main), ("jax", jax_main)):
        res[name] = str(tmp_path / name)
        assert run(["refine", "--config", setup["config"], "--masks-dir", masks,
                    "--instance-dir", inst, "--output-dir", res[name], "--max-frames", "3",
                    "--boundary-grow", "1.5"]) == 0
    assert sorted(os.listdir(res["port"])) == sorted(os.listdir(res["jax"])) == \
        [f"m{t:03d}.tif" for t in range(4)]
    for f in os.listdir(res["jax"]):
        np.testing.assert_array_equal(np.array(Image.open(os.path.join(res["port"], f))),
                                      np.array(Image.open(os.path.join(res["jax"], f))))
    assert cli.main(["refine", "--cpu", "--masks-dir", str(tmp_path), "--instance-dir", inst,
                     "--output-dir", res["port"]]) == 1
