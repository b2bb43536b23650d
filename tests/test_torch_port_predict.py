"""The rest of the port's Predictor against the JAX package's on the CPU:
tiled probabilities, ensembles (mean, gmean, vote), device connected
components, the checkpoint loaders and predict_sequence with every
option. Tiny nets (base_features=4, fp32); variables are seeded numpy
arrays in the Flax layout, handed to both packages. Each JAX side is
computed once per module."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import plant_intensity_path
from unetseg_tpu.core.config import InferConfig as JaxInferConfig
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.infer.engine import Predictor as JaxPredictor
from unetseg_tpu.infer.engine import load_image_01 as jax_load_image_01
from unetseg_tpu.infer.tiling import TTA_TRANSFORMS as JAX_TTA
from unetseg_tpu.models.unet import UNet as JaxUNet
from unetseg_tpu.utils.torch_import import load_reference_checkpoint as jax_load_reference
from unetseg_tpu_torch.core.config import InferConfig, ModelConfig, TrainConfig
from unetseg_tpu_torch.infer.engine import Predictor, _resize_nearest_binary
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.train import checkpoint as ckpt
from unetseg_tpu_torch.train.state import create_train_state
from unetseg_tpu_torch.utils.torch_import import load_reference_checkpoint, to_reference_state_dict

TINY = dict(base_features=4, compute_dtype="float32")
SEED = 2  # a tiny random net whose probabilities spread around 0.5
TILE = 252  # output 68
NEAR = 1e-4  # a pixel this close to the threshold may fall either way
ICFG = InferConfig(image_size=TILE, tile_input=TILE, tile_batch=3, min_cell_size=5)


def _vars(seed, num_classes=2):
    return fast_random_variables(ModelConfig(num_classes=num_classes, **TINY), seed)


def _jax(variables, icfg=ICFG, num_classes=2):
    ens = isinstance(variables, list)
    return JaxPredictor(
        model=JaxUNet(cfg=JaxModelConfig(num_classes=num_classes, **TINY)),
        params=[v["params"] for v in variables] if ens else variables["params"],
        batch_stats=[v["batch_stats"] for v in variables] if ens else variables["batch_stats"],
        cfg=JaxInferConfig(**dataclasses.asdict(icfg)),
    )


def _port(variables, icfg=ICFG, num_classes=2):
    return Predictor(ModelConfig(num_classes=num_classes, **TINY), variables, icfg, "cpu")


def _x(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _near(p, thr=0.5):
    """Pixels whose decision may flip under 1e-4 of error: the binary
    threshold, and for class probabilities also the argmax."""
    if p.ndim == 2 or p.shape[-1] != 3:
        return np.abs(p - thr) < NEAR
    top = np.sort(p, axis=-1)
    return (np.abs(p[..., 1] + p[..., 2] - thr) < NEAR) | (top[..., 2] - top[..., 1] < NEAR)


# ------------------------------------------------------------ tiled probs
@pytest.mark.parametrize("num_classes,shape", [(2, (100, 100)), (2, (60, 75)), (3, (100, 100))])
def test_probs_tiled_matches_jax(num_classes, shape):
    """A 2x2 tile grid in chunks of 3 (the last padded with tile 0), a
    ragged single tile, and a 3-class head's (h, w, 3) probabilities."""
    v = _vars(SEED, num_classes)
    img = _x(1, *shape)
    want = _jax(v, num_classes=num_classes).probs_tiled(img)
    pred = _port(v, num_classes=num_classes)
    got = pred.probs_tiled(img)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    near = _near(want)
    np.testing.assert_array_equal(pred.predict_image_tiled(img)[~near],
                                  (want > 0.5)[~near].astype(np.uint8))


@pytest.mark.parametrize("num_classes", [2, 3])
def test_tiled_apply_matches_jax(num_classes):
    """tiled_apply over a 2x2 grid in chunks of 3, the ragged last chunk
    padded with copies of its first tile."""
    from unetseg_tpu.infer.tiling import plan_tiles as jax_plan_tiles
    from unetseg_tpu.infer.tiling import tiled_apply as jax_tiled_apply
    from unetseg_tpu_torch.infer.tiling import plan_tiles, tiled_apply

    v = _vars(SEED, num_classes)
    img = _x(2, 100, 100)
    jp, pp = _jax(v, num_classes=num_classes), _port(v, num_classes=num_classes)
    want = np.asarray(jax_tiled_apply(jp._probs_fn, img, jax_plan_tiles(100, 100, TILE), 3))
    with torch.inference_mode():
        got = tiled_apply(pp._probs, torch.from_numpy(img), plan_tiles(100, 100, TILE), 3).numpy()
    assert got.shape == want.shape == ((100, 100) if num_classes == 2 else (100, 100, 3))
    np.testing.assert_allclose(got, want, atol=1e-4)


# -------------------------------------------------------------- ensembles
@pytest.fixture(scope="module")
def members():
    return [_vars(s) for s in (SEED, 6, 10)]  # seeds whose probabilities spread


@pytest.mark.parametrize("merge", ["mean", "gmean", "vote"])
@pytest.mark.parametrize("m", [2, 3])
def test_ensemble_merges_match_jax(members, merge, m):
    icfg = dataclasses.replace(ICFG, ensemble_merge=merge)
    imgs = _x(5, 2, TILE, TILE)
    want = np.asarray(_jax(members[:m], icfg).probs(imgs))
    got = _port(members[:m], icfg).probs(imgs).numpy()
    assert got.shape == want.shape == (2, 68, 68)
    if merge != "vote":
        np.testing.assert_allclose(got, want, atol=1e-4)
        return
    near = np.zeros(want.shape, bool)
    for v in members[:m]:
        near |= _near(np.asarray(_jax(v).probs(imgs)))
    assert set(np.unique(got)) <= {0.0, 1.0} and near.mean() < 0.02
    np.testing.assert_array_equal(got[~near], want[~near])


def test_three_class_ensemble_takes_the_mean(members):
    vs = [_vars(s, 3) for s in (SEED, 6)]
    icfg = dataclasses.replace(ICFG, ensemble_merge="vote")
    imgs = _x(6, 1, TILE, TILE)
    want = np.asarray(_jax(vs, icfg, 3).probs(imgs))
    got = _port(vs, icfg, 3).probs(imgs).numpy()
    assert got.shape == (1, 68, 68, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_ensemble_vote_masks_tiled_match_jax(members):
    """The best recipe's merges: members by vote inside each forward
    chunk, then the four flips by vote."""
    icfg = dataclasses.replace(ICFG, ensemble_merge="vote", tta="flips", tta_merge="vote")
    imgs = _x(7, 2, 60, 60)
    want = _jax(members, icfg).masks_tiled(imgs)
    got = _port(members, icfg).masks_tiled(imgs)
    near = np.zeros(imgs.shape, bool)
    for v in members:
        jp = _jax(v)
        for fwd, inv in JAX_TTA["flips"]:
            t = np.ascontiguousarray(fwd(imgs))
            near |= np.asarray(inv(np.stack([_near(jp.probs_tiled(im)) for im in t])))
    assert got.dtype == np.uint8 and near.mean() < 0.05 and 0.02 < want.mean() < 0.98
    np.testing.assert_array_equal(got[~near], want[~near])


def test_predictor_validates_the_ensemble_merge(members):
    with pytest.raises(ValueError, match="ensemble_merge"):
        _port(members, dataclasses.replace(ICFG, ensemble_merge="max"))
    with pytest.raises(ValueError, match="at least one member"):
        _port([], ICFG)


# -------------------------------------------------------------- device CC
def _cell_images(seed, n, size):
    """Bright discs (0.70) on a dark background (0.25) with noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    out = []
    for _ in range(n):
        img = 0.25 + 0.05 * rs.standard_normal((size, size))
        for cy, cx, r in rs.uniform([0, 0, 15], [size, size, 40], (12, 3)):
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] += 0.45
        out.append(np.clip(img, 0, 1))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("num_classes", [2, 3])
def test_labels_device_matches_jax(num_classes):
    """On every frame without a pixel within 1e-4 of the threshold (or of
    an argmax tie) the raw labels equal JAX's; seed 10's net leaves at
    least two such frames of eight."""
    v = _vars(10, num_classes)
    imgs = _cell_images(8, 8, TILE)
    jp = _jax(v, num_classes=num_classes)
    p = np.asarray(jp.probs(imgs))
    clean = [k for k in range(len(imgs)) if not _near(p[k]).any()]
    assert len(clean) >= 2
    want = jp.labels_device(imgs)
    got = _port(v, num_classes=num_classes).labels_device(imgs)
    assert got.dtype == np.int32 and got.shape == want.shape == (8, 68, 68)
    np.testing.assert_array_equal(got[clean], want[clean])
    assert all(len(np.unique(got[k])) > 2 for k in clean)


# ---------------------------------------------------------------- loaders
def test_from_torch_checkpoint_matches_jax(tmp_path):
    v = _vars(SEED)
    path = str(tmp_path / "best_unet_model_epoch_18.pth")
    torch.save(to_reference_state_dict(v), path)
    got_v, want_v = load_reference_checkpoint(path), jax_load_reference(path)
    for part in ("params", "batch_stats"):
        for block in want_v[part]:
            for name, leaf in want_v[part][block].items():
                leaves = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
                for k, arr in leaves:
                    g = got_v[part][block][name]
                    np.testing.assert_array_equal(g[k] if k else g, np.asarray(arr))
    icfg = dataclasses.replace(ICFG, normalize=True)
    pred = Predictor.from_torch_checkpoint(path, ModelConfig(**TINY), icfg, device="cpu")
    jpred = JaxPredictor.from_torch_checkpoint(
        path, JaxModelConfig(**TINY), JaxInferConfig(**dataclasses.asdict(icfg)))
    imgs = _x(9, 2, TILE, TILE)
    got = pred.probs(imgs).numpy()
    np.testing.assert_allclose(got, np.asarray(jpred.probs(imgs)), atol=1e-4)
    np.testing.assert_array_equal(got, _port(v, icfg).probs(imgs).numpy())


def _bf16_params(v):
    """The variables as the light checkpoint stores them: bf16 params, f32
    statistics."""
    def tree(t):
        return {k: tree(x) if isinstance(x, dict)
                else torch.from_numpy(np.asarray(x)).bfloat16().float().numpy()
                for k, x in t.items()}

    return {"params": tree(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two light checkpoint directories, each with raw weights and an EMA
    shadow from other seeds; returns the dirs and the stored variables."""
    cfg = ModelConfig(**TINY)
    root = tmp_path_factory.mktemp("ck")
    dirs, stored = [], []
    for raw_seed, ema_seed in ((SEED, 3), (4, 5)):
        state = create_train_state(_vars(raw_seed), cfg, TrainConfig(ema_decay=0.999),
                                   device="cpu")
        shadow = create_train_state(_vars(ema_seed), cfg, device="cpu")
        state = dataclasses.replace(state, ema_params=shadow.params,
                                    ema_batch_stats=shadow.batch_stats)
        d = str(root / f"seed{raw_seed}")
        ck = ckpt.Checkpointer(d)
        ck.save_light_payload(ckpt.device_light_payload(state), epoch=3, val_loss=0.5)
        dirs.append(d)
        stored += [_bf16_params(_vars(raw_seed)), _bf16_params(_vars(ema_seed))]
    return dirs, stored


@pytest.mark.parametrize("how", ["one", "one ema", "one epoch", "list ema=True",
                                 "two", "two ema", "two both", "one both"])
def test_checkpoint_loaders(checkpoints, how):
    """from_checkpoint / from_checkpoints read the port's own light stream:
    the same members, bit for bit, as a Predictor built from the stored
    variables (raw of seed 2, EMA of 3; raw of 4, EMA of 5)."""
    dirs, (r0, e0, r1, e1) = checkpoints
    cfg, kw = ModelConfig(**TINY), dict(infer_cfg=ICFG, device="cpu")
    pred, want = {
        "one": (lambda: Predictor.from_checkpoint(dirs[0], cfg, **kw), [r0]),
        "one ema": (lambda: Predictor.from_checkpoint(dirs[0], cfg, ema=True, **kw), [e0]),
        "one epoch": (lambda: Predictor.from_checkpoint(dirs[1], cfg, epoch=3, **kw), [r1]),
        "list ema=True": (lambda: Predictor.from_checkpoints(dirs[:1], cfg, ema=True, **kw), [e0]),
        "two": (lambda: Predictor.from_checkpoints(dirs, cfg, **kw), [r0, r1]),
        "two ema": (lambda: Predictor.from_checkpoints(dirs, cfg, ema=True, **kw), [e0, e1]),
        "two both": (lambda: Predictor.from_checkpoints(dirs, cfg, ema="both", **kw),
                     [r0, e0, r1, e1]),
        "one both": (lambda: Predictor.from_checkpoints(dirs[:1], cfg, ema="both", **kw),
                     [r0, e0]),
    }[how]
    pred = pred()
    assert len(pred.members) == len(want)
    imgs = _x(10, 1, TILE, TILE)
    np.testing.assert_array_equal(
        pred.probs(imgs).numpy(), _port(want if len(want) > 1 else want[0]).probs(imgs).numpy())


# ------------------------------------------------------------- sequences
def _write_frames(d, n=6, size=90, seed=11):
    """Cell-like TIFF frames: drifting bright discs on a dark background."""
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    cells = rs.uniform([10, 10, 6], [size - 10, size - 10, 14], (7, 3))
    vel = rs.uniform(-2, 2, (7, 2))
    for t in range(n):
        img = 0.25 + 0.05 * rs.standard_normal((size, size))
        for (cy, cx, r), (vy, vx) in zip(cells, vel):
            img[(yy - cy - t * vy) ** 2 + (xx - cx - t * vx) ** 2 <= r * r] += 0.45
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(d, f"t{t:03d}.tif"))
    return d


SEQ_CASES = {
    "default": ({}, {}, 2),
    "tiled": ({"tiled": True}, {}, 2),
    "resize_output_to": ({"resize_output_to": 90}, {}, 2),
    "device_cc": ({"device_cc": True}, {}, 2),
    "watershed": ({"watershed": True, "marker_frac": 0.6}, {}, 2),
    "temporal_bidi": ({"temporal_markers": True, "temporal_bidi": True},
                      {"temporal_bidi_frames": 3}, 2),
    "boundary_grow": ({"temporal_markers": True}, {"boundary_grow": 1.5}, 2),
    "three_class": ({}, {}, 3),
    "three_class_tiled": ({"tiled": True}, {}, 3),
}


def _seq_vars(num_classes):
    """Nets whose masks follow the frames' cells: the binary head through a
    planted intensity path (chip_smoke.plant_intensity_path), the 3-class
    head a random net whose masks break into several instances."""
    if num_classes == 2:
        return plant_intensity_path(_vars(SEED))
    return _vars(10, 3)


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    return _write_frames(str(tmp_path_factory.mktemp("seq") / "01"))


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_predict_sequence_matches_jax(seq_dir, tmp_path, case):
    opts, cfg_kw, nc = SEQ_CASES[case]
    icfg = dataclasses.replace(ICFG, tile_batch=4, **cfg_kw)
    v = _seq_vars(nc)
    jp, pp = _jax(v, icfg, nc), _port(v, icfg, nc)
    out = {}
    for name, pred in (("jax", jp), ("port", pp)):
        m, i = str(tmp_path / name / "RES"), str(tmp_path / name / "RES_INST")
        written = pred.predict_sequence(seq_dir, m, i, batch_size=4, **opts)
        out[name] = (m, i, sorted(os.path.relpath(p, str(tmp_path / name)) for p in written))
    assert out["port"][2] == out["jax"][2] and len(out["jax"][2]) == 12

    # the pixels that may fall either way, from the JAX probabilities
    paths = sorted(os.listdir(seq_dir))
    tiled = opts.get("tiled", False)
    imgs = [jax_load_image_01(os.path.join(seq_dir, f), None if tiled else TILE) for f in paths]
    probs = [jp.probs_tiled(im) for im in imgs] if tiled else list(np.asarray(jp.probs(
        np.stack(imgs))))
    near = [_near(p) for p in probs]
    if "resize_output_to" in opts:
        near = [_resize_nearest_binary(n.astype(np.uint8), 90) > 0 for n in near]
    same = 0
    for k in range(len(paths)):
        read = {n: [np.array(Image.open(os.path.join(d, f"{p}{k:03d}.tif")))
                    for d, p in ((out[n][0], "mask"), (out[n][1], "m"))] for n in out}
        (mj, ij), (mp, ip) = read["jax"], read["port"]
        assert mp.dtype == np.uint8 and ip.dtype == np.uint16 and ip.shape == ij.shape
        np.testing.assert_array_equal(mp[~near[k]], mj[~near[k]])
        if np.array_equal(mp, mj):
            same += 1
            np.testing.assert_array_equal(ip, ij)
    assert same >= len(paths) / 2
    assert any(len(np.unique(np.array(Image.open(os.path.join(out["port"][1], f))))) > 2
               for f in os.listdir(out["port"][1]))


@pytest.mark.parametrize("kw,nc", [
    ({"device_cc": True, "tiled": True}, 2), ({"device_cc": True}, 3),
    ({"temporal_markers": True, "device_cc": True}, 2), ({"temporal_bidi": True}, 2)])
def test_predict_sequence_refusals_match_jax(seq_dir, tmp_path, kw, nc):
    v = _vars(SEED, nc)
    for pred in (_jax(v, num_classes=nc), _port(v, num_classes=nc)):
        with pytest.raises(ValueError):
            pred.predict_sequence(seq_dir, str(tmp_path / "m"), str(tmp_path / "i"), **kw)
    with pytest.raises(ValueError):
        _port(v, num_classes=nc).predict_frames([], [], **kw)
    with pytest.raises(FileNotFoundError):
        _port(v, num_classes=nc).predict_sequence(str(tmp_path), str(tmp_path / "m"),
                                                  str(tmp_path / "i"))


def test_predict_frames_is_the_core_of_predict_sequence(seq_dir, tmp_path):
    """The in-memory core on the loaded frames gives the written masks and
    the instances before the grow."""
    from unetseg_tpu_torch.infer.engine import load_image_01

    icfg = dataclasses.replace(ICFG, tile_batch=4, boundary_grow=1.0, temporal_bidi_frames=2)
    pred = _port(_seq_vars(2), icfg)
    kw = dict(temporal_markers=True, temporal_bidi=True, batch_size=4)
    pred.predict_sequence(seq_dir, str(tmp_path / "m"), str(tmp_path / "i"), **kw)
    paths = sorted(os.listdir(seq_dir))
    frames = np.stack([load_image_01(os.path.join(seq_dir, f), TILE) for f in paths])
    seen = []
    for num, b, inst in pred.predict_frames(frames, list(range(len(paths))), **kw):
        seen.append(num)
        np.testing.assert_array_equal(
            np.array(Image.open(str(tmp_path / "m" / f"mask{num:03d}.tif"))) > 0, b > 0)
        np.testing.assert_array_equal(
            np.array(Image.open(str(tmp_path / "i" / f"m{num:03d}.tif"))), pred._grown(inst))
        assert inst.dtype == np.uint16 and b.dtype == np.uint8
    assert seen == [3, 4, 5, 0, 1, 2]  # the sweep window's frames after the sweep
