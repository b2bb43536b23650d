"""The port's post-processing against the JAX package's on the CPU: the
copies of post/cc, post/watershed (both floods; the native one built into
the port's own build directory), post/boundary and post/temporal bit for
bit on seeded masks, and the torch label propagation of post/cc_device
against JAX's and scipy's."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.post import boundary as jax_boundary
from unetseg_tpu.post import cc as jax_cc
from unetseg_tpu.post import cc_device as jax_cc_device
from unetseg_tpu.post import temporal as jax_temporal
from unetseg_tpu.post import watershed as jax_watershed
from unetseg_tpu_torch.post import boundary, cc, cc_device, temporal, watershed

SHAPE = (96, 128)


def _disks(shape, cells):
    """uint16 labels of discs (cy, cx, r); a later disc overwrites."""
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    lab = np.zeros(shape, np.uint16)
    for k, (cy, cx, r) in enumerate(cells):
        lab[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = k + 1
    return lab


def _sequence(n=6, seed=0):
    """Binary frames of drifting discs, two pairs touching, plus specks."""
    rs = np.random.RandomState(seed)
    cells = [(30, 30, 13), (30, 53, 12), (70, 40, 11), (66, 62, 12), (40, 100, 14), (80, 105, 7)]
    vel = rs.uniform(-1.5, 1.5, (len(cells), 2))
    frames = []
    for t in range(n):
        moved = [(cy + t * v[0], cx + t * v[1], r) for (cy, cx, r), v in zip(cells, vel)]
        m = _disks(SHAPE, moved) > 0
        m |= rs.rand(*SHAPE) > 0.995
        frames.append(m.astype(np.uint8))
    return frames


@pytest.fixture(scope="module")
def frames():
    return _sequence()


@pytest.mark.parametrize("min_size,relabel", [(1, False), (15, False), (40, True)])
def test_cc_copy_equals_original(frames, min_size, relabel):
    rs = np.random.RandomState(min_size)
    for m in frames[:3] + [(rs.rand(*SHAPE) > 0.6).astype(np.uint8)]:
        got = cc.get_instance_masks(m, min_size=min_size, relabel=relabel)
        want = jax_cc.get_instance_masks(m, min_size=min_size, relabel=relabel)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cc._STRUCT8, jax_cc._STRUCT8)


@pytest.mark.parametrize("backend", ["native", "python"])
def test_watershed_copy_equals_original(frames, backend):
    for m in frames[:2]:
        for frac, merge in ((0.6, 0.0), (0.5, 0.7)):
            got = watershed.get_instance_masks_watershed(
                m, min_size=20, marker_frac=frac, merge_saddle_frac=merge, backend=backend)
            want = jax_watershed.get_instance_masks_watershed(
                m, min_size=20, marker_frac=frac, merge_saddle_frac=merge, backend=backend)
            np.testing.assert_array_equal(got, want)
        interior = np.zeros_like(m)
        interior[::7, ::5] = 1
        np.testing.assert_array_equal(
            watershed.expand_markers(m, interior, min_size=5, backend=backend),
            jax_watershed.expand_markers(m, interior, min_size=5, backend=backend))
    assert len(set(np.unique(watershed.get_instance_masks_watershed(
        frames[0], min_size=20, backend=backend))) - {0}) >= 5  # touching pairs split


def test_native_watershed_builds_into_the_port(frames):
    lib = watershed._load()
    so = Path(lib._name)
    assert so.parent == Path(watershed.__file__).resolve().parents[1] / "build" / "native"
    markers, dist = watershed.distance_markers(frames[0])
    py = watershed.watershed(-dist, markers, frames[0], backend="python")
    np.testing.assert_array_equal(watershed.watershed(-dist, markers, frames[0]), py)
    with pytest.raises(ValueError, match="backend"):
        watershed.watershed(-dist, markers, frames[0], backend="skimage")


def test_native_watershed_build_failure_raises(monkeypatch, tmp_path):
    """Where the JAX package falls back to the Python flood, the port's
    native backend raises."""
    bad = tmp_path / "watershed.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(watershed, "_SRC", bad)
    monkeypatch.setattr(watershed, "_BUILD", tmp_path / "build")
    watershed._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            watershed.watershed(np.zeros((4, 4)), np.zeros((4, 4)), np.ones((4, 4)))
    finally:
        watershed._load.cache_clear()


@pytest.mark.parametrize("radius", [0.0, 1.0, 1.5, 3.0])
def test_boundary_copy_equals_original(frames, radius):
    inst = cc.get_instance_masks(frames[0], min_size=20)
    np.testing.assert_array_equal(boundary.grow_instances(inst, radius),
                                  jax_boundary.grow_instances(inst, radius))


def test_temporal_copy_equals_original(frames):
    kw = dict(min_size=50, marker_frac=0.5, min_overlap=40)
    prev = prev_j = None
    insts = []
    for m in frames:
        prev = temporal.temporal_instance_masks(m, prev, **kw)
        prev_j = jax_temporal.temporal_instance_masks(m, prev_j, **kw)
        np.testing.assert_array_equal(prev, prev_j)
        insts.append(prev)
    # a first frame whose two cells touch along a wide contact (one
    # distance peak) before they part: the backward sweep splits it
    wide = np.zeros(SHAPE, np.uint8)
    wide[16:48, 12:80] = 1
    apart = np.zeros(SHAPE, np.uint8)
    apart[16:48, 12:42] = apart[16:48, 50:80] = 1
    pair = [wide, apart, apart]
    pair_insts = [temporal.temporal_instance_masks(m, None, **kw) for m in pair]
    assert len(np.unique(pair_insts[0])) == 2
    for bins, ins, max_frames in ((frames, insts, None), (frames, insts, 3),
                                  (pair, pair_insts, 8)):
        got = temporal.refine_backward(bins, ins, max_frames=max_frames, **kw)
        want = jax_temporal.refine_backward(bins, ins, max_frames=max_frames, **kw)
        assert len(got) == len(want) == len(bins)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(np.unique(got[0])) == 3  # the sweep split the first frame


# ------------------------------------------------------------- device CC
def _spiral(n):
    m = np.zeros((n, n), np.uint8)
    m[0, :] = 1
    m[:, -1] = 1
    m[-1, :] = 1
    m[2:, 0] = 1
    return m


def _cc_cases():
    rs = np.random.RandomState(0)
    diag = np.zeros((6, 6), np.uint8)
    diag[[0, 1, 2], [0, 1, 2]] = 1
    return {
        "random": ((rs.rand(3, 64, 80) > 0.7).astype(np.uint8), 1),
        "min_size": ((np.random.RandomState(1).rand(2, 48, 48) > 0.75).astype(np.uint8), 5),
        "diagonal": (diag[None], 1),
        "spiral": (np.stack([_spiral(32), _spiral(32).T]), 1),
        "empty": (np.zeros((2, 8, 8), np.uint8), 15),
    }


@pytest.mark.parametrize("case", list(_cc_cases()))
def test_label_components_device_equals_jax_and_scipy(case):
    masks, min_size = _cc_cases()[case]
    raw = cc_device.label_components_device(torch.from_numpy(masks)).numpy()
    assert raw.dtype == np.int32 and raw.shape == masks.shape
    for k, m in enumerate(masks):
        np.testing.assert_array_equal(
            raw[k], np.asarray(jax_cc_device.label_components_device(jnp.asarray(m))))
        want = cc.get_instance_masks(m, min_size=min_size, relabel=True)
        np.testing.assert_array_equal(cc_device.compact_labels(raw[k], min_size, relabel=True),
                                      want)
        np.testing.assert_array_equal(
            cc_device.get_instance_masks_device(m, min_size=min_size, device="cpu"), want)
    if case == "diagonal":
        assert len(set(np.unique(raw)) - {0}) == 1


def test_raw_labels_are_min_flat_index():
    m = np.zeros((2, 4, 8), np.uint8)
    m[0, 1, 2:5] = 1
    m[1, 3, 7] = 1
    raw = cc_device.label_components_device(torch.from_numpy(m)).numpy()
    # each frame's smallest flat index: (1*8+2) -> 11; (3*8+7) -> 32
    assert set(np.unique(raw[0])) == {0, 11} and set(np.unique(raw[1])) == {0, 32}


@pytest.mark.parametrize("max_iters,check_every", [(10, 4), (10, 32), (37, 5), (4096, 32)])
def test_cap_stops_where_jax_stops(max_iters, check_every):
    """An unconverged spiral at the cap equals JAX's at the same cap; the
    iteration count is JAX's loop count."""
    m = _spiral(32)
    want = np.asarray(jax_cc_device.label_components_device(jnp.asarray(m), max_iters=max_iters))
    got, iters = cc_device.propagate_labels(torch.from_numpy(m)[None], max_iters, check_every)
    np.testing.assert_array_equal(got[0].numpy(), want)
    full, n = cc_device.propagate_labels(torch.from_numpy(m)[None])
    assert iters == min(n, max_iters)
    if iters < max_iters:  # converged: one fewer is still the fixpoint, two fewer is not
        np.testing.assert_array_equal(got, cc_device.propagate_labels(
            torch.from_numpy(m)[None], iters - 1)[0])
        assert not torch.equal(got, cc_device.propagate_labels(
            torch.from_numpy(m)[None], iters - 2)[0])
