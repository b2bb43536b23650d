"""The port's training pipeline against the JAX package on the CPU: the
eval step, the epoch train step, the dataset functions, the train() loop,
resume, checkpoint -> Predictor, and the preprocess / train commands.

Tiny nets (base 4, input 188, fp32). The JAX loop runs once per module.
Tolerances: eval metrics 1e-5 relative (one forward, f32 sums of a few
hundred terms in two orders); the epoch step's losses and parameters and
the loop's history 1e-4 relative (a few SGD steps through a net whose
gradients agree to ~1e-5, compounded); resume bit for bit (the same
program on the same inputs); the CLI's device weight maps 1e-3 of scipy's
(as tests/test_weight_maps.py holds the JAX device maps).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from unetseg_tpu.core.config import Config as JaxConfig
from unetseg_tpu.core.config import DataConfig as JaxDataConfig
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.core.config import TrainConfig as JaxTrainConfig
from unetseg_tpu.data import dataset as jax_dataset
from unetseg_tpu.models.unet import UNet as JaxUNet
from unetseg_tpu.train.loop import train as jax_train
from unetseg_tpu.train.state import TrainState as JaxTrainState
from unetseg_tpu.train.state import create_train_state as jax_create_train_state
from unetseg_tpu.train.steps import make_epoch_train_step as jax_make_epoch_train_step
from unetseg_tpu.train.steps import make_eval_step as jax_make_eval_step
from unetseg_tpu_torch.cli.main import main
from unetseg_tpu_torch.core.config import (
    Config,
    DataConfig,
    InferConfig,
    ModelConfig,
    TrainConfig,
)
from unetseg_tpu_torch.data import dataset
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.infer.tiling import min_tile_input
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.ops.weight_maps import weight_map_np
from unetseg_tpu_torch.train import checkpoint as ckpt
from unetseg_tpu_torch.train.loop import train
from unetseg_tpu_torch.train.state import create_train_state
from unetseg_tpu_torch.train.steps import make_epoch_train_step, make_eval_step
from unetseg_tpu_torch.utils.flax_bridge import state_dict_to_flax

TINY = dict(base_features=4, compute_dtype="float32")
S = 188
LR = 1e-4


def _frames(n, seed):
    """n frames of S^2: a few disks, one whose edge crosses the 4x4 output
    window at the center (so accuracy and IoU are not trivial), noise
    around 0.3 / 0.7 intensities, and weights in [1, 3)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:S, :S]
    masks = np.zeros((n, S, S), np.int32)
    for i in range(n):
        for lab in range(1, 5):
            cy, cx, r = rs.uniform(20, S - 20), rs.uniform(20, S - 20), rs.uniform(10, 25)
            masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = lab
        r = rs.uniform(15, 25)
        cx = 94 + r + rs.uniform(-1.5, 1.5)
        masks[i][(yy - 94) ** 2 + (xx - cx) ** 2 < r * r] = 5
    imgs = (0.3 + 0.4 * (masks > 0) + 0.05 * rs.randn(n, S, S)).astype(np.float32)
    weights = rs.uniform(1.0, 3.0, (n, S, S)).astype(np.float32)
    return imgs, masks, weights


def live_variables(seed, **cfg):
    """Seeded variables whose BatchNorm shifts (+3) keep nearly every ReLU
    open, so no max-pool meets the exact ties that XLA and torch route
    differently (tests/test_torch_port_train_step.py)."""
    v = fast_random_variables(ModelConfig(**TINY, **cfg), seed)
    for name, block in v["params"].items():
        if name.startswith(("enc", "dec")):
            for i in range(2):
                block[f"bn{i}"]["bias"] += 3.0
    return v


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_state(v, num_classes=2):
    return JaxTrainState.create(
        apply_fn=JaxUNet(cfg=JaxModelConfig(**TINY, num_classes=num_classes)).apply,
        params=v["params"], batch_stats=v["batch_stats"], tx=optax.sgd(LR))


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("num_classes,standardize", [(2, False), (3, True)])
def test_eval_step_matches_jax(num_classes, standardize):
    v = fast_random_variables(ModelConfig(**TINY, num_classes=num_classes), 1)
    imgs, masks, _ = _frames(3, 2)
    valid = np.array([True, True, False])
    jm = jax_make_eval_step(JaxUNet(cfg=JaxModelConfig(**TINY, num_classes=num_classes)),
                            three_class=num_classes == 3, standardize=standardize)(
        _jax_state(v, num_classes), jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(valid))
    state = create_train_state(v, ModelConfig(**TINY, num_classes=num_classes), TrainConfig())
    m = make_eval_step(three_class=num_classes == 3, standardize=standardize)(
        state, *(torch.from_numpy(a) for a in (imgs, masks, valid)))
    assert set(m) == set(jm) == {"val_loss", "val_acc", "val_iou"}
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert 0.0 < float(m["val_acc"]) < 1.0  # the metrics see both classes


def test_epoch_train_step_matches_jax():
    v = live_variables(5)
    imgs, masks, weights = _frames(6, 3)
    idx, valid = dataset.epoch_index_matrix(np.arange(5), 2, shuffle=True, seed=3)
    assert not valid.all()  # a padded last batch
    jstep = jax_make_epoch_train_step(JaxUNet(cfg=JaxModelConfig(**TINY)), donate=False,
                                      augment=False, lanes=False)
    jstate, jms = jstep(_jax_state(v), *(jnp.asarray(a) for a in (imgs, masks, weights)),
                        jnp.asarray(idx), jnp.asarray(valid), jax.random.key(0))
    state = create_train_state(v, ModelConfig(**TINY), TrainConfig(learning_rate=LR,
                                                                    momentum=0.0))
    step = make_epoch_train_step(augment=False)
    state, ms = step(state, *(torch.from_numpy(a) for a in (imgs, masks, weights, idx, valid)))
    np.testing.assert_allclose(ms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-4)
    np.testing.assert_allclose(ms["grad_norm"].numpy(), np.asarray(jms["grad_norm"]), rtol=1e-4)
    got = _leaves(state_dict_to_flax({**state.params, **state.batch_stats}))
    want = _leaves({"params": jstate.params, "batch_stats": jstate.batch_stats})
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_dataset_functions_equal_jax(tmp_path):
    for n, p, seed in ((10, 0.1, 0), (17, 0.1, 3), (6, 0.34, 1)):
        for a, b in zip(dataset.train_val_split(n, p, seed),
                        jax_dataset.train_val_split(n, p, seed)):
            np.testing.assert_array_equal(a, b)
    for shuffle in (False, True):
        for a, b in zip(dataset.epoch_index_matrix(np.arange(7), 3, shuffle, 5),
                        jax_dataset.epoch_index_matrix(np.arange(7), 3, shuffle, 5)):
            np.testing.assert_array_equal(a, b)
    assert dataset.num_batches(9, 2) == jax_dataset.num_batches(9, 2) == 5
    root = _write_tree(tmp_path, 3, weight_maps=True)
    ours = dataset.HeLaArrays.load(DataConfig(data_root=root, sequence="01"))
    theirs = jax_dataset.HeLaArrays.load(JaxDataConfig(data_root=root, sequence="01"))
    for name in ("images", "masks", "weight_maps"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    batches = [list(f(d, np.arange(3), 2, True, 7)) for f, d in
               ((dataset.iter_batches, ours), (jax_dataset.iter_batches, theirs))]
    for a, b in zip(*batches):
        for name in ("images", "masks", "weight_maps", "valid"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


# ------------------------------------------------------------------- loop
def _loop_cfgs(ckpt_dir_jax, ckpt_dir_port):
    train_kw = dict(batch_size=2, num_epochs=2, log_every=100, learning_rate=LR)
    jcfg = JaxConfig(model=JaxModelConfig(**TINY), data=JaxDataConfig(augment=False),
                     train=JaxTrainConfig(checkpoint_dir=ckpt_dir_jax, **train_kw))
    pcfg = Config(model=ModelConfig(**TINY), data=DataConfig(augment=False),
                  train=TrainConfig(checkpoint_dir=ckpt_dir_port, **train_kw))
    return jcfg, pcfg


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """The JAX loop and the port's on the same 10 frames (9 train in 5
    batches, the last padded; 1 validation frame), from the same initial
    variables: JAX's create_train_state on split(key(seed))[1], as its loop
    makes them."""
    base = tmp_path_factory.mktemp("loop")
    imgs, masks, weights = _frames(10, 7)
    jcfg, pcfg = _loop_cfgs(str(base / "jax"), str(base / "port"))
    jres = jax_train(jcfg, data=jax_dataset.HeLaArrays(imgs, masks, weights, []))
    init = jax_create_train_state(jax.random.split(jax.random.key(0))[1],
                                  model_cfg=JaxModelConfig(**TINY), input_size=S)
    init = jax.tree.map(np.asarray, {"params": init.params, "batch_stats": init.batch_stats})
    pres = train(pcfg, data=dataset.HeLaArrays(imgs, masks, weights, []), device="cpu",
                 init=init)
    return jres, pres, pcfg, imgs


def test_train_loop_matches_jax(loop_runs):
    jres, pres, _, _ = loop_runs
    assert len(pres.history) == len(jres.history) == 2
    for got, want in zip(pres.history, jres.history):
        for k in ("train_loss", "val_loss", "val_acc", "val_iou"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert pres.history[0]["val_loss"] != pres.history[1]["val_loss"]
    assert pres.best_epoch == jres.best_epoch
    np.testing.assert_allclose(pres.best_val_loss, jres.best_val_loss, rtol=1e-4)


def test_checkpoints_restore_and_serve(loop_runs):
    _, pres, pcfg, imgs = loop_runs
    d = pcfg.train.checkpoint_dir
    assert ckpt.latest_epoch(d) == 1 and ckpt.best_epoch(d) == pres.best_epoch
    # the full stream restores the final state bit for bit
    template = create_train_state(0, pcfg.model, pcfg.train, steps_per_epoch=5)
    restored, epoch, extra = ckpt.restore_checkpoint(d, template)
    assert epoch == 1 and extra["config"]["train"]["batch_size"] == 2
    assert restored.step == pres.state.step == 10
    for name in ("params", "batch_stats"):
        for k, t in getattr(pres.state, name).items():
            assert torch.equal(getattr(restored, name)[k], t), k
    for k, t in pres.state.opt_state["trace"].items():
        assert torch.equal(restored.opt_state["trace"][k], t), k
    # an epoch only the full stream holds restores its f32 params; the
    # light stream's best epoch holds bf16-rounded params
    final = _leaves(ckpt.restore_params_for_inference(d, epoch=1))
    want = _leaves(state_dict_to_flax({**pres.state.params, **pres.state.batch_stats}))
    assert final.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(final[k], want[k], err_msg=k)
    variables = ckpt.restore_params_for_inference(d)
    for k, a in _leaves(variables["params"]).items():
        np.testing.assert_array_equal(a, torch.from_numpy(a).bfloat16().float().numpy(), k)
    # one tile a frame: min_tile_input(188) = 380 -> 196 output pixels
    pred = Predictor(pcfg.model, variables,
                     InferConfig(tile_input=min_tile_input(S), tile_batch=2), "cpu")
    out = pred.masks_tiled(imgs[:2])
    assert out.shape == (2, S, S) and out.dtype == np.uint8 and set(np.unique(out)) <= {0, 1}
    with pytest.raises(FileNotFoundError, match="EMA"):
        ckpt.restore_params_for_inference(d, ema=True)


def test_resume_continues_bit_for_bit(tmp_path):
    """Two epochs straight equal one epoch (stopped by max_steps, on the
    host feed), a resume and one more (on the device feed): the feeds take
    the same batches and draw the same augmentation from each epoch's
    (seed, epoch) generator; Adam and the EMA ride along."""
    imgs, masks, weights = _frames(10, 8)
    data = dataset.HeLaArrays(imgs, masks, weights, [])
    runs = {}
    for name in ("straight", "resumed"):
        cfg = Config(model=ModelConfig(**TINY), data=DataConfig(
            elastic_alpha=200.0, elastic_sigma=10.0, aug_gamma=0.2, aug_noise=0.05),
            train=TrainConfig(batch_size=2, num_epochs=2, optimizer="adam", learning_rate=1e-3,
                              ema_decay=0.9, checkpoint_dir=str(tmp_path / name)))
        if name == "resumed":
            train(cfg, data=data, device="cpu", max_steps=5)
            assert ckpt.latest_epoch(cfg.train.checkpoint_dir) == 0
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, resume=True))
        runs[name] = train(cfg, data=data, device="cpu")
    a, b = runs["straight"], runs["resumed"]
    assert len(b.history) == 1 and a.state.step == b.state.step == 10
    for name in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        for k, t in getattr(a.state, name).items():
            assert torch.equal(getattr(b.state, name)[k], t), f"{name} {k}"
    assert a.state.opt_state["count"] == b.state.opt_state["count"] == 10
    for part in ("mu", "nu"):
        for k, t in a.state.opt_state[part].items():
            assert torch.equal(b.state.opt_state[part][k], t), f"{part} {k}"
    np.testing.assert_array_equal(a.history[1]["train_loss"], b.history[0]["train_loss"])


# -------------------------------------------------------------------- CLI
def _write_tree(tmp_path, n, weight_maps=False):
    root = tmp_path / "HeLa"
    for sub in ("01", "01_ST/SEG", "01_ST/WEIGHT_MAPS"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    imgs, masks, _ = _frames(n, 9)
    for i in range(n):
        Image.fromarray((imgs[i].clip(0, 1) * 255).astype(np.uint8)).save(
            root / "01" / f"t{i:03d}.tif")
        Image.fromarray(masks[i].astype(np.uint16)).save(
            root / "01_ST" / "SEG" / f"man_seg{i:03d}.tif")
        if weight_maps:
            np.save(root / "01_ST" / "WEIGHT_MAPS" / f"weight_map_{i:03d}.npy",
                    weight_map_np(masks[i]))
    return str(root)


def test_cli_preprocess_device_paper(tmp_path, capsys):
    """Paper mode takes the device path (here its plain version on the
    CPU); the JAX command's --device is accepted and changes nothing."""
    root = _write_tree(tmp_path, 2)
    wm_dir = os.path.join(root, "01_ST", "WEIGHT_MAPS")
    maps = []
    for extra in ([], ["--device", "--force"]):
        assert main(["preprocess", "--cpu", "--mode", "paper", "--data-root", root,
                     "--sequence", "01", *extra]) == 0
        assert "2 written" in capsys.readouterr().out
        maps.append([np.load(os.path.join(wm_dir, f"weight_map_{i:03d}.npy")) for i in range(2)])
    for i in range(2):
        mask = np.array(Image.open(os.path.join(root, "01_ST", "SEG", f"man_seg{i:03d}.tif")))
        np.testing.assert_allclose(maps[0][i], weight_map_np(mask, mode="paper"), atol=1e-3)
        np.testing.assert_array_equal(maps[1][i], maps[0][i])


def test_cli_preprocess_paper_many_instances(tmp_path, capsys):
    """A mask of 300 instances, more than the JAX package's largest label
    bucket (256): paper mode writes its map, within 1e-3 of scipy's."""
    root = _write_tree(tmp_path, 1)
    mask = np.zeros((64, 64), np.uint16)
    for k in range(300):  # 2x2 cells on a 3 x 4 pitch, labels 7, 14, ...
        y, x = 3 * (k // 15), 4 * (k % 15)
        mask[y : y + 2, x : x + 2] = 7 * (k + 1)
    Image.fromarray(mask).save(os.path.join(root, "01_ST", "SEG", "man_seg000.tif"))
    assert main(["preprocess", "--cpu", "--mode", "paper", "--data-root", root,
                 "--sequence", "01"]) == 0
    assert "1 written" in capsys.readouterr().out
    got = np.load(os.path.join(root, "01_ST", "WEIGHT_MAPS", "weight_map_000.npy"))
    np.testing.assert_allclose(got, weight_map_np(mask, mode="paper"), atol=1e-3)


@pytest.mark.parametrize("command", ["preprocess", "train"])
def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch, command):
    """Without --cpu both commands hand their work to the card."""
    from unetseg_tpu_torch.ops import weight_maps
    from unetseg_tpu_torch.train import loop

    seen = []
    monkeypatch.setattr(weight_maps, "weight_map",
                        lambda m, **kw: seen.append(kw["device"]) or weight_map_np(m))
    monkeypatch.setattr(loop, "train", lambda cfg, **kw: seen.append(kw["device"]) or
                        loop.TrainResult(None, 0.5, 0, []))
    root = _write_tree(tmp_path, 1)
    mode = ["--mode", "paper"] if command == "preprocess" else []
    assert main([command, "--data-root", root, "--sequence", "01", *mode]) == 0
    assert seen and set(seen) == {"cuda"}


def test_cli_train_writes_metrics_and_both_streams(tmp_path, capsys):
    root = _write_tree(tmp_path, 4, weight_maps=True)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": {"base_features": 4}, "train": {"batch_size": 2}}))
    ck, metrics = tmp_path / "ck", tmp_path / "m.jsonl"
    assert main(["train", "--cpu", "--config", str(cfg), "--dtype", "float32", "--data-root", root,
                 "--sequence", "01", "--epochs", "1", "--max-steps", "2", "--checkpoint-dir",
                 str(ck), "--metrics-jsonl", str(metrics), "--no-augment"]) == 0
    assert "training finished" in capsys.readouterr().out
    events = [json.loads(line)["event"] for line in metrics.read_text().splitlines()]
    assert events[0] == "start" and "epoch" in events and "checkpoint_full" in events
    assert ckpt.latest_epoch(str(ck)) == 0 and ckpt.best_epoch(str(ck)) == 0


def _profiled_run(tmp_path, **train_kw):
    """A profiled train() on 5 frames; -> (the logged events, each
    train.step region of the one trace written with the regions nested in
    it)."""
    imgs, masks, weights = _frames(5, 10)
    log = tmp_path / "metrics.jsonl"
    max_steps = train_kw.pop("max_steps", None)
    cfg = Config(model=ModelConfig(**TINY), data=DataConfig(augment=False), train=TrainConfig(
        batch_size=2, save_checkpoint=False, profile_dir=str(tmp_path / "prof"),
        metrics_jsonl=str(log), **train_kw))
    train(cfg, data=dataset.HeLaArrays(imgs, masks, weights, []), device="cpu",
          max_steps=max_steps)
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    events = json.loads((tmp_path / "prof" / traces[0]).read_text())["traceEvents"]
    regions = [e for e in events if e.get("cat") == "user_annotation"]
    steps = []
    for st in (e for e in regions if e["name"] == "train.step"):
        end = st["ts"] + st["dur"] + 1e-3
        steps.append(sorted(e["name"] for e in regions if e is not st and
                            st["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end))
    return [json.loads(x)["event"] for x in log.read_text().splitlines()], steps


PHASES = sorted(["train.augment", "train.forward", "train.backward", "train.update"])


def test_profile_dir_writes_a_trace(tmp_path):
    """profile_dir keeps the epoch feed and writes, through
    utils/profiling.trace, a chrome trace of the second epoch's train
    part (where the JAX loop writes a jax one) in which every step is a
    train.step region holding the four phases."""
    events, steps = _profiled_run(tmp_path, num_epochs=2)
    assert "device_data" in events and events.count("profile_written") == 1
    assert len(steps) == 3 and all(s == PHASES for s in steps)  # 5 frames, batches of 2


def test_profile_dir_on_the_host_feed(tmp_path):
    """On the host feed (max_steps), profile_dir traces profile_steps
    steps from the second."""
    events, steps = _profiled_run(tmp_path, num_epochs=2, max_steps=3, profile_steps=1)
    assert "device_data" not in events and events.count("profile_written") == 1
    assert steps == [PHASES]
