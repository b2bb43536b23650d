"""The train step's kernels (unetseg_tpu_torch/ops/kernels/conv3x3_train.py,
ops/kernels/elastic.py) against the JAX package's Pallas kernels in
interpret mode.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
the plain versions (and the wrappers' routing) to the TPU kernels'
semantics: dgrad and wgrad through the 2-phase lanes helpers of the JAX
package at odd, non-square sizes, the decoder-entry wgrad at a crop offset
(odd row offset; the lanes kernel needs an even column offset), and the
elastic resampler, reflect boundary and nearest-tap ties included. Inputs
are seeded numpy arrays, fp32. Tolerances: 2e-5 absolute for dgrad and
the sampler (sums of <= 9*16 products of O(1) values, as in
tests/test_conv3x3_train.py), 1e-4 relative for the weight gradients
(sums over a few thousand pixels). The CUDA kernels are held to these
plain versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.ops.elastic import displacement_pad, elastic_deform_batch, reflect_index
from unetseg_tpu.ops.pallas.conv3x3 import from_lanes_p2, lane_stride, to_lanes_p2
from unetseg_tpu.ops.pallas.conv3x3_train import (
    conv3x3_dec0_dw,
    conv3x3_phase2_dw,
    conv3x3_phase2_dx,
)
from unetseg_tpu.ops.pallas.elastic import PAD_X, PAD_Y
from unetseg_tpu.ops.pallas.elastic import sample_displaced as jax_sample_displaced
from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT
from unetseg_tpu_torch.ops.kernels import elastic as KE
from unetseg_tpu_torch.ops.kernels.launches import launch_counts, reset_launch_counts
from unetseg_tpu_torch.utils.flax_bridge import _conv_to_torch


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _rand(rs, *shape, scale=1.0, shift=0.0):
    return ((rs.rand(*shape) - shift) * scale).astype(np.float32)


def _stride(width):
    return lane_stride(-(-width // 2))


@pytest.mark.parametrize("h,w,ci,co", [(15, 21, 8, 16), (12, 12, 16, 8)])
def test_dgrad_matches_phase2_dx(h, w, ci, co):
    rs = np.random.RandomState(h * w)
    g = _rand(rs, 2, h - 2, w - 2, co, shift=0.5)
    k = _rand(rs, 3, 3, ci, co, scale=0.2, shift=0.5)  # HWIO
    dx = conv3x3_phase2_dx(to_lanes_p2(jnp.asarray(g)), jnp.asarray(k), _stride(w),
                           gh_valid=h - 2, interpret=True)
    want = from_lanes_p2(dx[:h], 2, w)
    got = KT.conv3x3_dgrad(_t(g), _t(_conv_to_torch(k)))
    assert got.shape == want.shape == (2, h, w, ci)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("h,w,ci,co", [(15, 21, 8, 16), (13, 10, 1, 8)])
def test_wgrad_matches_phase2_dw(h, w, ci, co):
    """CI=1 is the stem: the lanes path zero-pads it to 4 channels, as
    lanes_train does, and keeps channel 0 of the gradient."""
    rs = np.random.RandomState(h + w + ci)
    x = _rand(rs, 2, h, w, ci)
    g = _rand(rs, 2, h - 2, w - 2, co, shift=0.5)
    xj = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, 3))) if ci == 1 else x
    dw = conv3x3_phase2_dw(to_lanes_p2(jnp.asarray(xj)), to_lanes_p2(jnp.asarray(g)),
                           _stride(w), gh_valid=h - 2, interpret=True)
    want = _conv_to_torch(np.asarray(dw)[:, :, :ci])
    got = KT.conv3x3_wgrad(_t(x), _t(g))
    assert got.dtype == torch.float32 and tuple(got.shape) == (co, ci, 3, 3)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("row_off,col_off", [(3, 4), (4, 2)])
def test_dec0_wgrad_matches_dec0_dw(row_off, col_off):
    ns, nu, cis, ciu, co = 20, 11, 8, 8, 16
    rs = np.random.RandomState(row_off * 10 + col_off)
    skip = _rand(rs, 2, ns, ns, cis)
    up = _rand(rs, 2, nu, nu, ciu)
    g = _rand(rs, 2, nu - 2, nu - 2, co, shift=0.5)
    dw = conv3x3_dec0_dw(
        to_lanes_p2(jnp.asarray(skip)), to_lanes_p2(jnp.asarray(up)),
        to_lanes_p2(jnp.asarray(g)), _stride(ns), gh_valid=nu - 2,
        row_off=row_off, lane_off=col_off // 2, interpret=True,
    )
    want = _conv_to_torch(np.asarray(dw))
    got = KT.conv3x3_dec0_wgrad(_t(skip), _t(up), _t(g), row_off, col_off)
    assert tuple(got.shape) == (co, cis + ciu, 3, 3)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_sampler_matches_pallas_and_gather_path():
    """The port's sampler on the coordinates the JAX package builds, against
    sample_displaced(interpret=True) and the XLA gather path of
    elastic_deform_batch (as tests/test_pallas_kernels.py:96-144 builds
    them); a large alpha sends taps past the frame, into the reflection."""
    from unetseg_tpu.ops.elastic import displacement_fields

    b, h, w = 2, 64, 128
    alpha, sigma = 30.0, 4.0
    d = displacement_pad(alpha, sigma)
    rs = np.random.RandomState(3)
    images = jnp.asarray(rs.rand(b, h, w), jnp.float32)
    masks = jnp.asarray(rs.randint(0, 7, (b, h, w)), jnp.int32)
    key = jax.random.key(11)
    ref_img, ref_mask = elastic_deform_batch(key, images, masks, alpha=alpha, sigma=sigma)

    keys = jax.random.split(key, b)
    dys, dxs = jax.vmap(lambda k: displacement_fields(k, (h, w), alpha, sigma, 4.0))(keys)
    yy = jnp.clip(jnp.arange(h, dtype=jnp.float32)[None, :, None] + dys, -d, h - 1 + d - 1.001)
    xx = jnp.clip(jnp.arange(w, dtype=jnp.float32)[None, None, :] + dxs, -d, w - 1 + d - 1.001)
    rows = reflect_index(jnp.arange(-(d + PAD_Y), h + d + PAD_Y), h)
    cols = reflect_index(jnp.arange(-(d + PAD_X), w + d + PAD_X), w)
    pack = jnp.stack([images, masks.astype(jnp.float32)], axis=1)[:, :, rows[:, None], cols[None, :]]
    p_img, p_mask = jax_sample_displaced(pack, yy, xx, d, interpret=True)

    reset_launch_counts()
    img, mask = KE.sample_displaced(_t(np.asarray(images)), _t(np.asarray(masks)),
                                    _t(np.asarray(yy)), _t(np.asarray(xx)))
    assert launch_counts()["sample_displaced"] == 0  # CPU: the plain version
    assert mask.dtype == torch.int32
    assert float(jnp.abs(yy).max()) > h or float(xx.min()) < 0  # taps reflect
    np.testing.assert_allclose(_np(img), np.asarray(p_img), atol=2e-5)
    np.testing.assert_allclose(_np(img), np.asarray(ref_img), atol=2e-5)
    np.testing.assert_array_equal(_np(mask), np.asarray(p_mask).astype(np.int32))
    np.testing.assert_array_equal(_np(mask), np.asarray(ref_mask))


def test_sampler_nearest_tap_rounds_half_to_even():
    """Coordinates on exact half-pixel ties: the gather path's nearest tap
    follows jnp.round, which goes to the even neighbour (2.5 -> 2,
    3.5 -> 4), never always up; the port must too."""
    h = w = 8
    lab = np.arange(h * w, dtype=np.int32).reshape(1, h, w)
    img = lab.astype(np.float32) / 64
    yy = np.full((1, h, w), 2.5, np.float32)
    xx = np.tile(np.array([0.5, 1.5, 2.5, 3.5, 4.5, 5.5, -0.5, 6.5], np.float32), (1, h, 1))
    _, mask = KE.sample_displaced(_t(img), _t(lab), _t(yy), _t(xx))
    want_cols = np.array([0, 2, 2, 4, 4, 6, 0, 6])  # -0.5 rounds to -0 -> col 0
    np.testing.assert_array_equal(_np(mask)[0, 0], 2 * w + want_cols)
