"""The tier-2 train step's kernels (unetseg_tpu_torch/ops/kernels/
conv3x3_train.py: conv3x3_dense_dgrad, conv3x3_dense_wgrad,
conv3x3_dec0_dense_wgrad, and the Functions Conv3x3DenseTrain and
DecConv0DenseTrain) against the JAX package's dense-lanes Pallas kernels
in interpret mode.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
the plain versions (and the wrappers' routing) to the TPU kernels'
semantics at odd, non-square sizes. The JAX inputs go through the dense
`to_lanes` with each item's width zero-padded to the lane stride (as
tests/test_conv3x3_train.py:276-277 does), which zeroes the dead tail
lanes as make_conv_dense_train's `_mask` does; no garbage rows are given.
Inputs are seeded numpy arrays, fp32. Tolerances: 2e-5 absolute for dgrad
(sums of <= 9*16 products of O(1) values, as in
tests/test_conv3x3_train.py), 1e-4 relative for the weight gradients (sums
over a few thousand pixels); the Functions' forward and gradients as
tests/test_conv3x3_train.py:256-305 holds the JAX custom VJPs to lax
autodiff. The CUDA kernels are held to these plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py); here also the weight
gradient's split-K chunk count at every train shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.ops.pallas.conv3x3 import from_lanes, lane_stride, to_lanes
from unetseg_tpu.ops.pallas.conv3x3_train import (
    conv3x3_dec0_dense_dw,
    conv3x3_dense_dw,
    conv3x3_dense_dx,
    make_conv_dense_train,
    make_dec0_dense_train,
)
from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT
from unetseg_tpu_torch.ops.kernels.launches import launch_counts, reset_launch_counts
from unetseg_tpu_torch.utils.flax_bridge import _conv_to_torch


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _rand(rs, *shape, scale=1.0, shift=0.0):
    return ((rs.rand(*shape) - shift) * scale).astype(np.float32)


def _lanes(x, stride):
    """NHWC -> dense lanes with each item's width zero-padded to `stride`."""
    return to_lanes(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, stride - x.shape[2]), (0, 0))))


@pytest.mark.parametrize("h,w,ci,co", [(15, 21, 8, 16), (12, 17, 16, 8)])
def test_dense_dgrad_matches_dense_dx(h, w, ci, co):
    rs = np.random.RandomState(h * w)
    g = _rand(rs, 2, h - 2, w - 2, co, shift=0.5)
    k = _rand(rs, 3, 3, ci, co, scale=0.2, shift=0.5)  # HWIO
    stride = lane_stride(w)
    dx = conv3x3_dense_dx(_lanes(g, stride), jnp.asarray(k), stride, gh_valid=h - 2,
                          interpret=True)
    want = from_lanes(dx[:h], 2, w)
    reset_launch_counts()
    got = KT.conv3x3_dense_dgrad(_t(g), _t(_conv_to_torch(k)))
    assert launch_counts()["conv3x3_dense_dgrad"] == 0  # CPU: the plain version
    assert got.shape == want.shape == (2, h, w, ci)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("h,w,ci,co", [(15, 21, 8, 16), (13, 10, 16, 8)])
def test_dense_wgrad_matches_dense_dw(h, w, ci, co):
    rs = np.random.RandomState(h + w + ci)
    x = _rand(rs, 2, h, w, ci)
    g = _rand(rs, 2, h - 2, w - 2, co, shift=0.5)
    stride = lane_stride(w)
    dw = conv3x3_dense_dw(_lanes(x, stride), _lanes(g, stride), stride, gh_valid=h - 2,
                          interpret=True)
    want = _conv_to_torch(np.asarray(dw))
    got = KT.conv3x3_dense_wgrad(_t(x), _t(g))
    assert got.dtype == torch.float32 and tuple(got.shape) == (co, ci, 3, 3)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("off", [3, 4])
def test_dec0_dense_wgrad_matches_dec0_dense_dw(off):
    """Odd and even crop offsets (row_off = lane_off): the dense layout has
    no parity constraint, and at 512^2 dec2 reads skip1 at (41, 41)."""
    hs, ws, hu, wu, cis, ciu, co = 21, 20, 12, 11, 8, 8, 16
    rs = np.random.RandomState(off)
    skip = _rand(rs, 2, hs, ws, cis)
    up = _rand(rs, 2, hu, wu, ciu)
    g = _rand(rs, 2, hu - 2, wu - 2, co, shift=0.5)
    stride = lane_stride(ws)
    dw = conv3x3_dec0_dense_dw(_lanes(skip, stride), _lanes(up, stride), _lanes(g, stride),
                               stride, gh_valid=hu - 2, row_off=off, lane_off=off,
                               interpret=True)
    want = _conv_to_torch(np.asarray(dw))
    got = KT.conv3x3_dec0_dense_wgrad(_t(skip), _t(up), _t(g), off, off)
    assert tuple(got.shape) == (co, cis + ciu, 3, 3)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _grad_check(got, want, names, tols):
    for a, b, name, tol in zip(got, want, names, tols):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=tol, rtol=1e-4, err_msg=name)


def test_conv3x3_dense_train_matches_make_conv_dense_train():
    """Forward and the x / w / b gradients against jax.vjp of the JAX
    custom VJP (its dense dx and dw kernels in its backward)."""
    n, ci, co = 21, 8, 16
    rs = np.random.RandomState(13)
    x = rs.rand(2, n, n, ci).astype(np.float32)
    w = ((rs.rand(3, 3, ci, co) - 0.5) * 0.2).astype(np.float32)
    bb = (rs.rand(co) - 0.5).astype(np.float32)
    ct = rs.rand(2, n - 2, n - 2, co).astype(np.float32)
    stride = lane_stride(n)
    conv = make_conv_dense_train(stride, h_valid=n, interpret=True)
    z_ref, vjp = jax.vjp(lambda x, w, b: from_lanes(conv(_lanes(x, stride), w, b)[: n - 2], 2, n - 2),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(bb))
    dx_ref, dw_ref, db_ref = vjp(jnp.asarray(ct))

    xt, wt, bt = (_t(a).requires_grad_(True) for a in (x, _conv_to_torch(w), bb))
    z = KT.Conv3x3DenseTrain.apply(xt, wt, bt)
    (z * _t(ct)).sum().backward()
    np.testing.assert_allclose(_np(z), np.asarray(z_ref), atol=2e-5)
    _grad_check((xt.grad, wt.grad, bt.grad), (dx_ref, _conv_to_torch(np.asarray(dw_ref)), db_ref),
                ("dx", "dw", "db"), (2e-4, 3e-3, 3e-3))


def test_dec_conv0_dense_train_matches_make_dec0_dense_train():
    """Forward and the skip / up / w / b gradients against jax.vjp of the
    fused dense decoder entry at an odd crop offset: the crop's gradient
    lands in a zero skip-frame gradient at (3, 3)."""
    ns, nu, cis, ciu, co, off = 21, 12, 8, 8, 16, 3
    rs = np.random.RandomState(5)
    skip = rs.rand(2, ns, ns, cis).astype(np.float32)
    up = rs.rand(2, nu, nu, ciu).astype(np.float32)
    w = (rs.rand(3, 3, cis + ciu, co) - 0.5).astype(np.float32)
    bb = (rs.rand(co) - 0.5).astype(np.float32)
    ct = rs.rand(2, nu - 2, nu - 2, co).astype(np.float32)
    stride = lane_stride(ns)
    fused = make_dec0_dense_train(stride, up_w=nu, row_off=off, lane_off=off,
                                  skip_rows_valid=ns, skip_w_valid=ns, interpret=True)

    def jax_z(skip, up, w, b):
        z = fused(_lanes(skip, stride), _lanes(up, stride), w, b)
        return from_lanes(z[: nu - 2], 2, nu - 2)

    z_ref, vjp = jax.vjp(jax_z, *(jnp.asarray(a) for a in (skip, up, w, bb)))
    refs = vjp(jnp.asarray(ct))

    ts = [_t(a).requires_grad_(True) for a in (skip, up, _conv_to_torch(w), bb)]
    z = KT.DecConv0DenseTrain.apply(*ts, off, off)
    (z * _t(ct)).sum().backward()
    np.testing.assert_allclose(_np(z), np.asarray(z_ref), atol=2e-5)
    _grad_check([t.grad for t in ts],
                (refs[0], refs[1], _conv_to_torch(np.asarray(refs[2])), refs[3]),
                ("dskip", "dup", "dw", "db"), (2e-4, 2e-4, 3e-3, 3e-3))
    # outside the crop the skip gets no gradient
    assert not np.any(_np(ts[0].grad)[:, :off]) and not np.any(_np(ts[0].grad)[:, off + nu:])


# Every weight gradient of the train step at 512^2, (g's height = width,
# the sources' channels, co): the stem, enc0 conv1, dec3 conv0 (skip, up)
# and conv1; tier 2's enc1 conv0 and conv1, dec2 conv0 (skip1, up2) and conv1
TRAIN_WGRADS = [(510, (1,), 64), (508, (64,), 64), (326, (64, 64), 64), (324, (64,), 64),
                (252, (64,), 128), (250, (128,), 128), (166, (128, 128), 128),
                (164, (128,), 128)]


def _blocks_per_chunk(cis, co):
    slices = 1 if cis == (1,) else sum(-(-c // KT.WGRAD_CHANNELS) for c in cis)
    return slices * (co // 64)


def test_wgrad_chunks_fill_one_wave():
    """The split-K chunk count of every weight gradient of the train step
    at 512^2 (tier 1 and tier 2): its blocks fit one wave of the H100's
    132 SMs (the wgmma kernel and the stem's TMA kernel one block per SM)
    and fill at least 96% of it. dec2 conv0 (two 128-channel sources, co
    128: 8 blocks a chunk) gets 16 chunks, where rounding up would give 17
    and a tail wave; the stem gets 132."""
    for n, cis, co in TRAIN_WGRADS:
        per_sm = KT.WGRAD_STEM_BLOCKS_PER_SM if cis == (1,) else KT.WGRAD_BLOCKS_PER_SM
        chunks = KT.wgrad_chunks(4, n, n, cis, co, 132)
        assert 0.96 * per_sm * 132 <= chunks * _blocks_per_chunk(cis, co) <= per_sm * 132, \
            (n, cis, co, chunks)
    assert KT.wgrad_chunks(4, 166, 166, (128, 128), 128, 132) == 16
    assert KT.wgrad_chunks(4, 510, 510, (1,), 64, 132) == 132
    assert KT.wgrad_chunks(1, 3, 3, (64,), 64, 132) == 1  # one tile: one chunk
    # 32-channel sources take a 64-channel slice each (the copy zero-fills)
    assert KT.wgrad_chunks(1, 9, 40, (32, 32), 64, 132) == 9  # 3 x 3 tiles


@pytest.mark.parametrize("n,cis,co", [s for s in TRAIN_WGRADS if s[1] != (1,)])
def test_wgrad_ring_fits_shared_memory(n, cis, co):
    """The wgmma kernel's ring at each train shape it runs: its dynamic
    shared memory (8 stages of a 4x16-pixel g tile and a 6x18-pixel x
    window, 1 KB aligned, plus the mbarriers; 181,376 bytes) within the
    232,448 bytes an H100 block can use, its blocks per SM within the SM's
    228 KB, and every block's range of tiles long enough to fill the ring."""
    smem = KT.wgrad_smem_bytes()
    assert smem == 1024 + 8 * (8192 + 14336) + 128 <= KT.SMEM_PER_BLOCK
    assert KT.WGRAD_BLOCKS_PER_SM * (smem + 1024) <= 228 * 1024
    th, tw = KT.WGRAD_TILE
    tiles = 4 * -(-n // th) * -(-n // tw)
    assert tiles // KT.wgrad_chunks(4, n, n, cis, co, 132) >= KT.WGRAD_STAGES
