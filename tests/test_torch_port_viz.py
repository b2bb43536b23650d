"""The port's visualisation slice against the JAX package on the CPU:
viz/overlays.py's arrays, the visualize / visualize-prediction commands'
files and PNG pixels against the JAX commands', visualize-augmentation's
panel, and the single-image elastic_deform against JAX elastic_deform
with the uniforms rebuilt from the key's two draws."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import ctc_sequence
from unetseg_tpu.cli.main import main as jax_main
from unetseg_tpu.ops import elastic as jel
from unetseg_tpu.viz import overlays as jov
from unetseg_tpu_torch.cli import main as cli
from unetseg_tpu_torch.ops import elastic as el
from unetseg_tpu_torch.viz import overlays as ov

FRAMES, SIZE = 4, 128


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """4 frames of drifting cells with a division (t*.tif) and their
    instance labels (m*.tif, mask*.tif beside them as the predict command
    writes them), plus one frame's binary prediction and ground truth."""
    root = tmp_path_factory.mktemp("viz")
    frames, labels, _ = ctc_sequence(np.random.RandomState(5), FRAMES, SIZE)
    imgs, inst = root / "imgs", root / "inst"
    imgs.mkdir()
    inst.mkdir()
    for t, (f, lab) in enumerate(zip(frames, labels)):
        Image.fromarray(np.round(f * 255).astype(np.uint8)).save(imgs / f"t{t:03d}.tif")
        Image.fromarray(lab.astype(np.uint16)).save(inst / f"m{t:03d}.tif")
        Image.fromarray(((lab > 0) * 255).astype(np.uint8)).save(inst / f"mask{t:03d}.tif")
    Image.fromarray(((labels[1] > 0) * 255).astype(np.uint8)).save(root / "pred.png")
    Image.fromarray(labels[1].astype(np.uint16)).save(root / "gt.tif")
    return dict(root=root, imgs=str(imgs), inst=str(inst), frames=frames, labels=labels)


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def test_overlay_arrays_equal_jax(seq):
    img, lab = seq["frames"][0], seq["labels"][0]
    ids = {int(k): 100 + int(k) for k in np.unique(lab) if k}
    assert ov.centroids(lab) == jov.centroids(lab)
    for args in ((img, lab), (img * 255, lab, ids, 0.7)):
        np.testing.assert_array_equal(ov.overlay_instances(*args), jov.overlay_instances(*args))
    np.testing.assert_array_equal(ov._distinct_colors(9), jov._distinct_colors(9))


@pytest.mark.parametrize("tracks", [False, True])
def test_visualize_matches_jax(seq, tmp_path, tracks):
    """The same vis_frame_NNN.png files, pixel for pixel; --max-frames
    and --resize-image as the JAX command takes them."""
    outs = {}
    for name, run in (("port", cli.main), ("jax", jax_main)):
        out = tmp_path / name
        argv = ["visualize", "--instance-dir", seq["inst"], "--images-dir", seq["imgs"],
                "--output-dir", str(out), "--max-frames", "3", "--resize-image"]
        assert run(argv + (["--tracks"] if tracks else []) + (["--cpu"] if name == "port"
                                                              else [])) == 0
        outs[name] = out
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) == [f"vis_frame_{t:03d}.png"
                                                         for t in range(3)]
    for n in names:
        np.testing.assert_array_equal(_pixels(outs["port"] / n), _pixels(outs["jax"] / n))


@pytest.mark.parametrize("gt", [False, True])
def test_visualize_prediction_matches_jax(seq, tmp_path, gt):
    outs = {}
    for name, run in (("port", cli.main), ("jax", jax_main)):
        outs[name] = str(tmp_path / f"{name}_panel.png")
        argv = ["visualize-prediction", "--input", os.path.join(seq["imgs"], "t001.tif"),
                "--prediction", str(seq["root"] / "pred.png"), "--output", outs[name]]
        assert run(argv + (["--gt", str(seq["root"] / "gt.tif")] if gt else [])) == 0
    np.testing.assert_array_equal(_pixels(outs["port"]), _pixels(outs["jax"]))


def test_visualize_augmentation_draws_its_field_from_the_seed(seq, tmp_path, capsys):
    """The command's panel is save_augmentation_panel of elastic_deform
    with the uniforms of a torch generator seeded by --seed, on the CPU
    with --cpu."""
    out = str(tmp_path / "aug.png")
    img_path = os.path.join(seq["imgs"], "t002.tif")
    mask_path = os.path.join(seq["inst"], "m002.tif")
    assert cli.main(["visualize-augmentation", "--cpu", "--input", img_path, "--mask",
                     mask_path, "--output", out, "--alpha", "300", "--sigma", "8",
                     "--seed", "3"]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {out}"
    image = np.asarray(Image.open(img_path).convert("L"), np.float32) / 255.0
    mask = np.asarray(Image.open(mask_path)).astype(np.int32)
    u = el.draw_elastic(torch.Generator().manual_seed(3), 1, SIZE, SIZE)[0]
    di, dm = el.elastic_deform(torch.from_numpy(image), torch.from_numpy(mask), u, 300.0, 8.0)
    assert dm.dtype == torch.int32 and not torch.equal(dm, torch.from_numpy(mask))
    want = str(tmp_path / "want.png")
    ov.save_augmentation_panel(want, image, mask, di.numpy(), dm.numpy())
    np.testing.assert_array_equal(_pixels(out), _pixels(want))


@pytest.mark.parametrize("alpha,sigma,h,w", [(30.0, 4.0, 40, 52), (2000.0, 20.0, 64, 64)])
def test_elastic_deform_matches_jax(alpha, sigma, h, w):
    """The image at 1e-4; the mask equal wherever neither sampling
    coordinate lies within 1e-4 of a half-pixel tie (the JAX nearest tap
    rounds half up, the port's half to even; ROADMAP Queue 3)."""
    rs = np.random.RandomState(int(alpha))
    image = rs.rand(h, w).astype(np.float32)
    mask = rs.randint(0, 7, (h, w)).astype(np.int32)
    key = jax.random.key(9)
    want_img, want_mask = jel.elastic_deform(key, jnp.asarray(image), jnp.asarray(mask),
                                             alpha=alpha, sigma=sigma)
    kx, ky = jax.random.split(key)
    u = np.stack([np.asarray(jax.random.uniform(k, (h, w), jnp.float32, -1.0, 1.0))
                  for k in (kx, ky)])  # u[0] drives dx, u[1] dy
    img, msk = el.elastic_deform(torch.from_numpy(image), torch.from_numpy(mask),
                                 torch.from_numpy(u), alpha=alpha, sigma=sigma)
    assert img.shape == msk.shape == (h, w) and msk.dtype == torch.int32
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), atol=1e-4)
    yy, xx = el.displaced_coords(torch.from_numpy(u)[None], alpha, sigma)
    tie = ((yy[0] - yy[0].floor() - 0.5).abs() < 1e-4) | ((xx[0] - xx[0].floor() - 0.5).abs()
                                                          < 1e-4)
    differ = msk.numpy() != np.asarray(want_mask)
    assert not (differ & ~tie.numpy()).any()
    assert tie.float().mean() < 1e-2


def test_new_modules_import_no_jax_nor_matplotlib():
    """The modules of the visualisation, export and utility slice import
    neither the JAX package nor matplotlib or Pillow at import."""
    code = ("import sys\n"
            "import unetseg_tpu_torch.viz.overlays, unetseg_tpu_torch.infer.export\n"
            "import unetseg_tpu_torch.infer.serving, unetseg_tpu_torch.ops.kernels.library\n"
            "import unetseg_tpu_torch.utils.provenance, unetseg_tpu_torch.utils.profiling\n"
            "import unetseg_tpu_torch.cli.main, unetseg_tpu_torch.ops.elastic\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'flax', 'optax', 'orbax', 'unetseg_tpu', 'PIL', 'matplotlib'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
