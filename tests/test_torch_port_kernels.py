"""The port's serving-path kernels (unetseg_tpu_torch/ops/kernels/conv3x3.py)
against the JAX package's Pallas kernels in interpret mode.

On the CPU each wrapper runs its plain PyTorch version, so these tests
hold the plain versions, and the wrappers' routing, to the TPU kernels'
semantics: the stem with one input channel, the fused pool, the tconv
flip, the decoder-entry crop (an even offset against the Pallas kernel,
an odd one against lanes_net._dec_entry_nhwc) and the fused head. Inputs
and weights are seeded numpy arrays handed to both packages; fp32
throughout, atol 2e-5 as in tests/test_conv3x3.py. The CUDA kernels
themselves are compared with these plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.infer.lanes_net import _dec_entry_nhwc
from unetseg_tpu.ops.pallas.conv3x3 import (
    conv3x3_head_phase2,
    conv3x3_phase2,
    dec_conv0_phase2,
    from_lanes,
    from_lanes_p2,
    lane_stride,
    tconv2x2_phase2,
    to_lanes,
    to_lanes_p2,
)
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.utils.flax_bridge import _conv_to_torch, _tconv_to_torch

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _np(t):
    return t.detach().cpu().numpy()


def _rand(rs, *shape, scale=1.0, shift=0.0):
    return (rs.rand(*shape).astype(np.float32) - shift) * scale


@pytest.mark.parametrize("ci,fuse_pool", [(1, False), (8, True), (8, False)])
def test_conv3x3_bias_relu_matches_phase2(ci, fuse_pool):
    """Stem (CI=1, zero-padded to 4 channels for the Pallas kernel as
    lanes_net does) and enc0 conv1 with the fused 2x2 pool (odd output
    height: the pool floors)."""
    rs = np.random.RandomState(ci + fuse_pool)
    x = _rand(rs, 2, 23, 132, ci)
    w = _rand(rs, 3, 3, ci, 16, scale=0.1)
    b = _rand(rs, 16, shift=0.5)
    pad = 4 - ci if ci < 4 else 0
    xj = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, pad)))
    wj = np.pad(w, ((0, 0), (0, 0), (0, pad), (0, 0)))
    stride = lane_stride(66)
    got = K.conv3x3_bias_relu(_t(x), _t(_conv_to_torch(w)), _t(b), fuse_pool=fuse_pool)
    res = conv3x3_phase2(
        to_lanes_p2(jnp.asarray(xj)), jnp.asarray(wj), jnp.ones((16, 1)),
        jnp.asarray(b).reshape(16, 1), stride, interpret=True,
        fuse_pool=fuse_pool, unit_scale=True,
    )
    if fuse_pool:
        out_l, pool_l = res
        y, pooled = got
        assert pooled.shape == (2, 10, 65, 16)
        want_pool = from_lanes(pool_l, 2, 65)[:, :10]
        np.testing.assert_allclose(_np(pooled), np.asarray(want_pool), atol=ATOL)
    else:
        out_l, y = res, got
    assert y.shape == (2, 21, 130, 16)
    np.testing.assert_allclose(
        _np(y), np.asarray(from_lanes_p2(out_l, 2, 130)), atol=ATOL
    )


def test_tconv2x2_bias_matches_phase2():
    """The flax kernel converted by the bridge (spatial flip) gives the
    Pallas tconv's result through torch's ConvTranspose2d convention."""
    rs = np.random.RandomState(8)
    x = _rand(rs, 2, 11, 130, 8)
    w = _rand(rs, 2, 2, 8, 4, shift=0.5)
    b = _rand(rs, 4)
    got = K.tconv2x2_bias(_t(x), _t(_tconv_to_torch(w)), _t(b))
    out_l = tconv2x2_phase2(
        to_lanes(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b).reshape(4, 1),
        256, interpret=True,
    )
    want = from_lanes_p2(out_l, 2, 260)
    assert got.shape == want.shape == (2, 22, 260, 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_dec_conv0_matches_phase2_even_offset():
    rs = np.random.RandomState(9)
    skip = _rand(rs, 2, 30, 140, 8)
    up = _rand(rs, 2, 20, 132, 8)
    w = _rand(rs, 3, 3, 16, 8, scale=0.1)
    b = _rand(rs, 8, shift=0.5)
    got = K.dec_conv0(_t(skip), _t(up), _t(_conv_to_torch(w)), _t(b), 5, 4)
    out_l = dec_conv0_phase2(
        to_lanes_p2(jnp.asarray(skip)), to_lanes_p2(jnp.asarray(up)),
        jnp.asarray(w), jnp.ones((8, 1)), jnp.asarray(b).reshape(8, 1),
        item_stride=128, out_rows=18, row_off=5, lane_off=2, interpret=True,
        unit_scale=True,
    )
    want = from_lanes_p2(out_l, 2, 130)
    assert got.shape == want.shape == (2, 18, 130, 8)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_dec_conv0_odd_offset_matches_dec_entry():
    """Odd crop offsets (which the Pallas kernel cannot take) against the
    JAX package's split-kernel decoder entry."""
    rs = np.random.RandomState(10)
    skip = _rand(rs, 2, 27, 25, 8)
    up = _rand(rs, 2, 20, 18, 4)
    w = _rand(rs, 3, 3, 12, 8, scale=0.1)
    b = _rand(rs, 8, shift=0.5)
    got = K.dec_conv0(_t(skip), _t(up), _t(_conv_to_torch(w)), _t(b), 3, 3)
    want = _dec_entry_nhwc(
        jnp.asarray(skip), jnp.asarray(up),
        {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.float32,
    )
    assert got.shape == want.shape == (2, 18, 16, 8)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("nc", [2, 3])
def test_conv3x3_head_matches_phase2(nc):
    rs = np.random.RandomState(11 + nc)
    x = _rand(rs, 2, 21, 130, 16)
    w = _rand(rs, 3, 3, 16, 16, scale=0.1)
    b = _rand(rs, 16, shift=0.5)
    ko = _rand(rs, 16, nc, shift=0.5)
    bo = _rand(rs, nc)
    got = K.conv3x3_head(
        _t(x), _t(_conv_to_torch(w)), _t(b), _t(_conv_to_torch(ko[None, None])), _t(bo)
    )
    ll = conv3x3_head_phase2(
        to_lanes_p2(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b).reshape(16, 1),
        jnp.asarray(ko), jnp.asarray(bo), lane_stride(65), interpret=True,
    )
    want = from_lanes_p2(ll, 2, 128)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 19, 128, nc)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    rs = np.random.RandomState(12)
    x = _t(_rand(rs, 1, 10, 12, 4))
    w = _t(_rand(rs, 8, 4, 3, 3))
    b = _t(_rand(rs, 8))
    K.reset_launch_counts()
    got = K.conv3x3_bias_relu(x, w, b)
    torch.testing.assert_close(got, K.conv3x3_bias_relu_plain(x, w, b), rtol=0, atol=0)
    counts = K.launch_counts()  # every imported kernel wrapper, train ones too
    assert {"conv3x3_bias_relu", "tconv2x2_bias", "dec_conv0", "conv3x3_head"} <= set(counts)
    assert set(counts.values()) == {0}


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 10, 12, 32), device="meta")
    w = torch.empty((64, 32, 3, 3), device="meta")
    b = torch.empty((64,), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        K.conv3x3_bias_relu(x, w, b)
    with pytest.raises(ValueError, match="different devices"):
        K.conv3x3_bias_relu(x, torch.empty((64, 32, 3, 3)), b)
