"""The port's data/rescue.py against the JAX package's: rescue_frame on
synthetic silver labels and gold markers, and build_overlay_root on a
synthetic data root (a rescued sequence with frames that have missing
markers, covered markers and no markers, and a passthrough sequence):
the same stats, the same label TIFFs and weight-map .npy files, the same
links."""

import os

import numpy as np
import pytest
from PIL import Image

from unetseg_tpu.data.rescue import build_overlay_root as jax_build_overlay_root
from unetseg_tpu.data.rescue import rescue_frame as jax_rescue_frame
from unetseg_tpu_torch.data.rescue import build_overlay_root, rescue_frame

SIZE = 96


def _frame(seed):
    """Silver labels of 3-5 cells and gold markers: one inside each silver
    cell, two in the background (missing), one half covered."""
    rs = np.random.RandomState(seed)
    silver = np.zeros((SIZE, SIZE), np.uint16)
    markers = np.zeros((SIZE, SIZE), np.uint16)
    n = rs.randint(3, 6)
    for k in range(n):
        y, x = rs.randint(8, SIZE - 20, 2)
        silver[y:y + 12, x:x + 12] = k + 1
        markers[y + 4:y + 7, x + 4:x + 7] = k + 1
    for k, (y, x) in enumerate(rs.randint(2, SIZE - 6, (2, 2))):
        if not silver[y:y + 4, x:x + 4].any():
            markers[y:y + 4, x:x + 4] = n + 1 + k
    ys, xs = np.nonzero(silver == 1)
    markers[ys.min() - 2:ys.min() + 2, xs.min():xs.min() + 3] = n + 5  # half covered
    return silver, markers


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(core_radius=10.0, ignore_radius=25.0)),
    (2, dict(cover_thresh=0.75, core_radius=6.0, ignore_radius=12.0)),
])
def test_rescue_frame_equals_jax(seed, kw):
    silver, markers = _frame(seed)
    out, ignore, n = rescue_frame(silver, markers, **kw)
    jout, jignore, jn = jax_rescue_frame(silver, markers, **kw)
    assert n == jn and n >= 1
    assert out.dtype == jout.dtype
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(ignore, jignore)
    np.testing.assert_array_equal(out[silver > 0], silver[silver > 0])


@pytest.fixture
def root(tmp_path):
    """Sequence 01 (frames 0-1 with markers, frame 2 without, frame 3
    without a silver mask) and sequence 02 (passthrough)."""
    r = tmp_path / "HeLa"
    for d in ("01", "01_ST/SEG", "01_ST/WEIGHT_MAPS", "01_GT/TRA", "02", "02_ST/SEG"):
        (r / d).mkdir(parents=True)
    rs = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray((rs.rand(SIZE, SIZE) * 255).astype(np.uint8)).save(
            r / "01" / f"t{i:03d}.tif")
        if i == 3:
            continue
        silver, markers = _frame(10 + i)
        Image.fromarray(silver).save(r / "01_ST" / "SEG" / f"man_seg{i:03d}.tif")
        np.save(r / "01_ST" / "WEIGHT_MAPS" / f"weight_map_{i:03d}.npy",
                rs.rand(SIZE, SIZE))
        if i < 2:
            Image.fromarray(markers).save(r / "01_GT" / "TRA" / f"man_track{i:03d}.tif")
    return str(r)


@pytest.mark.parametrize("kw", [
    dict(core_radius=10.0, ignore_radius=25.0),
    dict(core_radius=8.0, ignore_radius=20.0, core_weight=5.0, w0=30.0, sigma=2.0,
         weight_map_mode="paper"),
])
def test_build_overlay_root_equals_jax(root, tmp_path, kw):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    stats = build_overlay_root(root, ours, rescue_sequences=["01"],
                               passthrough_sequences=["02"], **kw)
    jstats = jax_build_overlay_root(root, theirs, rescue_sequences=["01"],
                                    passthrough_sequences=["02"], **kw)
    assert list(stats) == list(jstats) == ["01"]
    assert vars(stats["01"]) == vars(jstats["01"])
    assert stats["01"].frames_seen == 3 and stats["01"].frames_rescued == 2
    for sub in ("01_ST/SEG", "01_ST/WEIGHT_MAPS"):
        names = sorted(os.listdir(os.path.join(ours, sub)))
        assert names == sorted(os.listdir(os.path.join(theirs, sub))) and len(names) == 3
        for name in names:
            a, b = os.path.join(ours, sub, name), os.path.join(theirs, sub, name)
            if name.endswith(".npy"):
                np.testing.assert_array_equal(np.load(a), np.load(b))
            else:
                np.testing.assert_array_equal(np.array(Image.open(a)), np.array(Image.open(b)))
    for link in ("01", "01_GT", "02", "02_ST"):
        assert os.path.islink(os.path.join(ours, link))
        assert os.readlink(os.path.join(ours, link)) == os.readlink(os.path.join(theirs, link))
    # a rescued frame's map: the annulus zeroed, the core at least core_weight
    m0 = np.array(Image.open(os.path.join(ours, "01_ST", "SEG", "man_seg000.tif")))
    wm = np.load(os.path.join(ours, "01_ST", "WEIGHT_MAPS", "weight_map_000.npy"))
    silver = _frame(10)[0]
    core = (m0 > 0) & (silver == 0)
    assert core.any() and (wm[core] >= kw.get("core_weight", 3.0)).all() and (wm == 0).any()
    # rerunning over an existing root keeps it
    build_overlay_root(root, ours, rescue_sequences=["01"], passthrough_sequences=["02"], **kw)
