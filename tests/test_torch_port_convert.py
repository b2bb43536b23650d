"""tools/jax_checkpoint_to_torch.py: a JAX checkpoint of a base-4 net
with an EMA shadow, written by unetseg_tpu.train.checkpoint's own writer,
converted into the port's light stream and served by the port's
Predictor (raw, EMA and the raw + EMA ensemble) against the JAX
Predictor on the same frames."""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

from unetseg_tpu.core.config import InferConfig as JaxInferConfig
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.infer.engine import Predictor as JaxPredictor
from unetseg_tpu.models.unet import UNet as JaxUNet
from unetseg_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from unetseg_tpu.train.checkpoint import restore_params_for_inference, save_checkpoint
from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.train.checkpoint import best_epoch

TOOL = Path(__file__).resolve().parents[1] / "tools" / "jax_checkpoint_to_torch.py"
TINY = dict(base_features=4, compute_dtype="float32")
SIZE = 188
ATOL = 2e-4  # tests/test_torch_port_slice.py's tolerance against the JAX U-Net
LOSSES = {0: 0.5, 1: 0.25}  # epoch 1 is the best


def _tool():
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_state(seed, ema=True):
    """A JAX train state (SGD) with seeded numpy weights and BN statistics,
    and an EMA shadow of another seed's."""
    raw = fast_random_variables(ModelConfig(**TINY), seed)
    shadow = fast_random_variables(ModelConfig(**TINY), seed + 10) if ema else {}
    return _tool().restore_template(JaxModelConfig(**TINY)).replace(
        params=raw["params"], batch_stats=raw["batch_stats"],
        ema_params=shadow.get("params"), ema_batch_stats=shadow.get("batch_stats"))


def _jax_predictor(directory, ema, icfg):
    """The JAX Predictor of from_checkpoints(ema=...) on the best epoch:
    its members restored by restore_params_for_inference (with a traced
    template instead of an initialised one, which compiles for a minute
    here)."""
    template = _tool().restore_template(JaxModelConfig(**TINY))
    members = [restore_params_for_inference(directory, template, ema=use)
               for use in ((False, True) if ema == "both" else (ema,))]
    params, stats = [m[0] for m in members], [m[1] for m in members]
    if ema != "both":
        params, stats = params[0], stats[0]
    return JaxPredictor(model=JaxUNet(cfg=JaxModelConfig(**TINY)), params=params,
                        batch_stats=stats, cfg=icfg)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    jdir, pdir = str(root / "jax"), str(root / "port")
    extra = {"config": {"model": {"base_features": 4}}}
    save_checkpoint(jdir, _jax_state(3), 0, LOSSES[0], extra=extra)
    ck = JaxCheckpointer(jdir, sync=True)
    ck.save(_jax_state(5), 1, LOSSES[1], extra)
    ck.close()
    assert _tool().main(["--checkpoint-dir", jdir, "--output-dir", pdir]) == 0
    return jdir, pdir


def test_writes_the_ports_light_stream(dirs):
    jdir, pdir = dirs
    assert sorted(os.listdir(pdir)) == ["0.json", "0.pt", "1.json", "1.pt"]
    for e, loss in LOSSES.items():
        with open(os.path.join(pdir, f"{e}.json")) as f:
            meta = json.load(f)
        assert meta == {"epoch": e, "val_loss": loss,
                        "extra": {"config": {"model": {"base_features": 4}}}}
    assert best_epoch(pdir) == 1


@pytest.mark.parametrize("ema", [False, True, "both"])
def test_converted_checkpoint_serves_as_the_jax_predictor(dirs, ema):
    jdir, pdir = dirs
    x = np.random.RandomState(1).rand(2, SIZE, SIZE).astype(np.float32)
    icfg = dict(image_size=SIZE, normalize=True)
    got = Predictor.from_checkpoints([pdir], ModelConfig(**TINY), InferConfig(**icfg),
                                     ema=ema, device="cpu").probs(x).numpy()
    want = np.asarray(_jax_predictor(jdir, ema, JaxInferConfig(**icfg)).probs(x))
    assert got.shape == want.shape == (2, 4, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_one_epoch_and_a_missing_shadow(dirs, tmp_path):
    """--epoch converts that epoch alone; a checkpoint without EMA
    converts without a shadow, and the port's EMA load then raises."""
    jdir, _ = dirs
    one = str(tmp_path / "one")
    assert _tool().main(["--checkpoint-dir", jdir, "--output-dir", one, "--epoch", "0"]) == 0
    assert sorted(os.listdir(one)) == ["0.json", "0.pt"]
    plain, out = str(tmp_path / "plain"), str(tmp_path / "plain_port")
    save_checkpoint(plain, _jax_state(7, ema=False), 2, 0.1)
    assert _tool().convert(plain, out) == {2: False}
    Predictor.from_checkpoint(out, ModelConfig(**TINY), device="cpu")
    with pytest.raises(FileNotFoundError, match="no EMA shadow"):
        Predictor.from_checkpoint(out, ModelConfig(**TINY), ema=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        _tool().convert(plain, out, epoch=5)
