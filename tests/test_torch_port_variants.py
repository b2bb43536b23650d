"""The port's serving variants against the JAX package on the CPU.

folded_forward_kernels with the options tier2, fused_enc0, dec_fuse and
cblock against folded_forward_tier1 with the same options (Pallas kernels
in interpret mode); the fused kernels' plain versions (enc0_fused,
dec_tail) against enc0_fused_phase2 and dec_tail_phase2; the routed
counterparts (conv3x3_dense, dec_conv0_dense, conv3x3_cblock) against
conv3x3_lanes, dec_conv0_lanes and conv_cblock.conv3x3_cblock (with the
unit scale every ported path passes them); conv3x3_bias_relu and
conv3x3_dense against conv3x3_nhwc; the Predictor with every option on
against the JAX Predictor; the options' refusals.

Tiny fp32 nets at base 8 (the JAX tier 2 needs base % 8, and base 8
puts enc4 at 128 output channels, the width cblock routes), input 188;
seeded numpy variables in the Flax layout, handed to both packages.
Forward parity at atol 5e-4 as in tests/test_lanes_net.py, kernels at
2e-5 as in tests/test_conv3x3.py. On the CPU the wrappers run their
plain versions; the CUDA kernels are held to those on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.core.config import InferConfig as JaxInferConfig
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.infer.engine import Predictor as JaxPredictor
from unetseg_tpu.infer.folding import fold_batchnorm as jax_fold_batchnorm
from unetseg_tpu.infer.lanes_net import folded_forward_tier1
from unetseg_tpu.models.unet import UNet as JaxUNet
from unetseg_tpu.ops.pallas.conv3x3 import (
    conv3x3_lanes,
    conv3x3_nhwc,
    dec_conv0_lanes,
    dec_tail_phase2,
    enc0_fused_phase2,
    from_lanes,
    from_lanes_p2,
    from_lanes_sparse2,
    lane_stride,
    to_lanes,
    to_lanes_p2,
)
from unetseg_tpu.ops.pallas.conv_cblock import conv3x3_cblock as jax_conv3x3_cblock
from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.infer.folding import fold_batchnorm
from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels, supports_tier2
from unetseg_tpu_torch.infer.tiling import extract_tiles, mirror_pad, plan_tiles, stitch
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.utils.flax_bridge import _conv_to_torch, flax_to_state_dict

BASE8 = dict(base_features=8, compute_dtype="float32")
SEED = 8
ATOL_NET, ATOL = 5e-4, 2e-5
VARIANTS = {
    "a_tier2": dict(tier2=True),
    "b_fused_enc0_tail": dict(fused_enc0=True, dec_fuse="tail"),
    "d_cblock_all": dict(cblock=("all",)),
    "e_all": dict(tier2=True, fused_enc0=True, dec_fuse="tail", cblock=("all",)),
}


def _x(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _rand(rs, *shape, scale=1.0, shift=0.0):
    return (rs.rand(*shape).astype(np.float32) - shift) * scale


@pytest.fixture(scope="module")
def net():
    variables = fast_random_variables(ModelConfig(**BASE8), SEED)
    rs = np.random.RandomState(SEED)
    for block in variables["params"].values():  # nonzero conv, tconv and head biases
        for leaf in (block.values() if "kernel" not in block else [block]):
            leaf["bias"][:] = rs.uniform(-0.2, 0.2, leaf["bias"].shape)
    _, jfv = jax_fold_batchnorm(JaxModelConfig(**BASE8), variables)
    folded = fold_batchnorm(ModelConfig(**BASE8), flax_to_state_dict(variables))
    return variables, jfv["params"], folded, _x(5, 2, 188, 188, 1)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_tier1(net, name):
    """Each option set against the JAX forward with the same options (the
    JAX reference computed once, in this test); the JAX folded_forward_tier1
    defaults to dec_fuse="none", the Predictors to "head"."""
    _, jparams, folded, x = net
    opts = VARIANTS[name]
    jopts = {"dec_fuse": "head", **opts, "cblock": frozenset(opts.get("cblock", ()))}
    want = np.asarray(folded_forward_tier1(
        jparams, jnp.asarray(x), JaxModelConfig(**BASE8), interpret=True, **jopts))
    with torch.inference_mode():
        got = folded_forward_kernels(folded, torch.from_numpy(x), **opts).numpy()
    assert got.shape == want.shape == (2, 4, 4, 2) and got.dtype == np.float32
    assert want.std() > 1e-2  # the tiny net's logits vary: the comparison discriminates
    np.testing.assert_allclose(got, want, atol=ATOL_NET)


def test_enc0_fused_plain_matches_phase2():
    """Stem + conv1 + pool against the TPU kernel (its stem input padded to
    4 channels, as lanes_net does); skip and pooled at their valid sizes."""
    rs = np.random.RandomState(20)
    s, f = 34, 16
    x = _rand(rs, 2, s, s, 1)
    k0 = _rand(rs, 3, 3, 1, f, scale=0.5, shift=0.5)
    b0 = _rand(rs, f, scale=0.2, shift=0.5)
    k1 = _rand(rs, 3, 3, f, f, scale=0.2, shift=0.5)
    b1 = _rand(rs, f, scale=0.2, shift=0.5)
    skip, pooled = K.enc0_fused(_t(x), _t(_conv_to_torch(k0)), _t(b0),
                                _t(_conv_to_torch(k1)), _t(b1))
    xl = to_lanes_p2(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, 0), (0, 3))))
    k0p = jnp.pad(jnp.asarray(k0), ((0, 0), (0, 0), (0, 3), (0, 0)))
    skip_l, pool_l = enc0_fused_phase2(
        xl, k0p, jnp.asarray(b0).reshape(f, 1), jnp.asarray(k1), jnp.asarray(b1).reshape(f, 1),
        lane_stride(s // 2), h_valid=s, interpret=True,
    )
    ho = s - 4
    want_skip = np.asarray(from_lanes_p2(skip_l[:ho], 2, ho))
    want_pool = np.asarray(from_lanes(pool_l[: ho // 2], 2, ho // 2))
    assert skip.shape == want_skip.shape == (2, ho, ho, f)
    assert pooled.shape == want_pool.shape == (2, ho // 2, ho // 2, f)
    assert want_pool.std() > 1e-2
    np.testing.assert_allclose(skip.numpy(), want_skip, atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), want_pool, atol=ATOL)


def test_dec_tail_plain_matches_phase2():
    """conv0 (skip cropped at an even offset, which the TPU kernel needs),
    conv1 and the 1x1 head against the TPU kernel."""
    rs = np.random.RandomState(21)
    hs, hu, c = 36, 28, 8
    skip = _rand(rs, 2, hs, hs, c)
    up = _rand(rs, 2, hu, hu, c)
    w0 = _rand(rs, 3, 3, 2 * c, 16, scale=0.1)
    b0 = _rand(rs, 16, shift=0.5)
    w1 = _rand(rs, 3, 3, 16, 16, scale=0.1)
    b1 = _rand(rs, 16, shift=0.5)
    ko = _rand(rs, 16, 2, shift=0.5)
    bo = _rand(rs, 2)
    off = (hs - hu) // 2
    got = K.dec_tail(_t(skip), _t(up), _t(_conv_to_torch(w0)), _t(b0), _t(_conv_to_torch(w1)),
                     _t(b1), _t(_conv_to_torch(ko[None, None])), _t(bo), off, off)
    stride = lane_stride(hs // 2)
    pad_u = jnp.pad(jnp.asarray(up), ((0, 0), (0, 0), (0, 2 * stride - hu), (0, 0)))
    ll = dec_tail_phase2(
        to_lanes_p2(jnp.asarray(skip)), to_lanes_p2(pad_u), jnp.asarray(w0),
        jnp.asarray(b0).reshape(16, 1), jnp.asarray(w1), jnp.asarray(b1).reshape(16, 1),
        jnp.asarray(ko), jnp.asarray(bo), stride, out_rows=hu - 4, row_off=off,
        lane_off=off // 2, interpret=True,
    )
    want = np.asarray(from_lanes_p2(ll, 2, hu - 4))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, hu - 4, hu - 4, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("fuse_pool", [False, True])
def test_conv3x3_dense_matches_lanes(fuse_pool):
    """The tier-2 conv against the dense-lanes kernel, with its sparse
    fused pool (odd output height: the pool floors)."""
    rs = np.random.RandomState(22 + fuse_pool)
    x = _rand(rs, 2, 21, 130, 8)
    w = _rand(rs, 3, 3, 8, 16, scale=0.1)
    b = _rand(rs, 16, shift=0.5)
    got = K.conv3x3_dense(_t(x), _t(_conv_to_torch(w)), _t(b), fuse_pool=fuse_pool)
    res = conv3x3_lanes(
        to_lanes(jnp.asarray(x)), jnp.asarray(w), jnp.ones((16, 1), jnp.float32),
        jnp.asarray(b).reshape(16, 1), lane_stride(130), interpret=True, fuse_pool=fuse_pool,
    )
    if fuse_pool:
        (y, pooled), (out_l, pool_l) = got, res
        want_pool = np.asarray(from_lanes_sparse2(pool_l, 2, 64))
        assert pooled.shape == want_pool.shape == (2, 9, 64, 16)
        np.testing.assert_allclose(pooled.numpy(), want_pool, atol=ATOL)
    else:
        y, out_l = got, res
    want = np.asarray(from_lanes(out_l, 2, 128))
    assert y.shape == want.shape == (2, 19, 128, 16)
    np.testing.assert_allclose(y.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("row_off,col_off", [(5, 7), (4, 4)])
def test_dec_conv0_dense_matches_lanes(row_off, col_off):
    """The tier-2 decoder entry, and dec_conv0, against the dense-lanes
    kernel: odd and even crop offsets (dense lanes take any)."""
    rs = np.random.RandomState(24 + row_off)
    skip = _rand(rs, 2, 30, 40, 8)
    up = _rand(rs, 2, 20, 22, 8)
    w = _rand(rs, 3, 3, 16, 8, scale=0.1)
    b = _rand(rs, 8, shift=0.5)
    out_l = dec_conv0_lanes(
        to_lanes(jnp.asarray(skip)), to_lanes(jnp.asarray(up)), jnp.asarray(w),
        jnp.ones((8, 1), jnp.float32), jnp.asarray(b).reshape(8, 1), 128, out_rows=18,
        row_off=row_off, lane_off=col_off, interpret=True,
    )
    want = np.asarray(from_lanes(out_l, 2, 20))
    for fn in (K.dec_conv0_dense, K.dec_conv0):
        got = fn(_t(skip), _t(up), _t(_conv_to_torch(w)), _t(b), row_off, col_off)
        assert got.shape == want.shape == (2, 18, 20, 8)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_cblock_matches_pallas(relu):
    rs = np.random.RandomState(26 + relu)
    x = rs.randn(1, 13, 17, 64).astype(np.float32)
    k = (rs.randn(3, 3, 64, 128) * 0.1).astype(np.float32)
    b = rs.randn(128).astype(np.float32)
    got = K.conv3x3_cblock(_t(x), _t(_conv_to_torch(k)), _t(b), relu=relu)
    want = np.asarray(jax_conv3x3_cblock(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                         relu=relu, interpret=True))
    assert got.shape == want.shape == (1, 11, 15, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("ci", [1, 8])
def test_conv3x3_matches_conv3x3_nhwc(ci):
    """conv + bias, then ReLU, for the stem width and a wider input:
    conv3x3_bias_relu and conv3x3_dense against the TPU kernel."""
    rs = np.random.RandomState(28 + ci)
    x = _rand(rs, 2, 20, 132, ci)
    w = _rand(rs, 3, 3, ci, 16, scale=0.3)
    b = _rand(rs, 16, shift=0.5)
    want = np.asarray(conv3x3_nhwc(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
                                   relu=True, interpret=True))
    for fn in (K.conv3x3_bias_relu, K.conv3x3_dense):
        got = fn(_t(x), _t(_conv_to_torch(w)), _t(b))
        assert got.shape == want.shape == (2, 18, 130, 16)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_predictor_with_every_variant_matches_jax_predictor(net):
    """masks_tiled with tier2, fused_enc0, dec_fuse="tail" and cblock "all"
    against the JAX Predictor (which runs FoldedUNet on the CPU: the same
    function); probabilities to 1e-4, masks equal off the threshold."""
    variables = net[0]
    kw = dict(tile_input=252, tile_batch=2)
    jpred = JaxPredictor(
        model=JaxUNet(cfg=JaxModelConfig(**BASE8)), params=variables["params"],
        batch_stats=variables["batch_stats"], cfg=JaxInferConfig(**kw),
    )
    pred = Predictor(ModelConfig(**BASE8), variables, InferConfig(**kw), "cpu",
                     **VARIANTS["e_all"])
    imgs = _x(6, 2, 60, 60)
    grid = plan_tiles(60, 60, kw["tile_input"])
    tiles = extract_tiles(mirror_pad(torch.from_numpy(imgs), grid), grid)
    with torch.inference_mode():
        p = pred._probs(tiles.reshape(-1, grid.tile_in, grid.tile_in))
    o = grid.tile_out
    got_p = stitch(p.reshape(*tiles.shape[:2], o, o), grid).numpy()
    want_p = np.stack([jpred.probs_tiled(im) for im in imgs])
    np.testing.assert_allclose(got_p, want_p, atol=1e-4)
    got, want = pred.masks_tiled(imgs), jpred.masks_tiled(imgs)
    near = np.abs(want_p - pred.cfg.threshold) < 1e-3
    assert got.shape == want.shape == imgs.shape and got.dtype == np.uint8
    assert near.mean() < 0.02 and 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got[~near], want[~near])


def test_invalid_options_raise(net):
    variables, _, folded, x = net
    xt = torch.from_numpy(x)
    cfg = ModelConfig(**BASE8)
    for bad in (dict(dec_fuse="fused"), dict(dec_fuse="none"), dict(cblock=("enc9c0",)),
                dict(cblock=("dec0c0",)), dict(cblock=("enc0c1",))):
        with pytest.raises(ValueError, match="dec_fuse|cblock"):
            folded_forward_kernels(folded, xt, **bad)
        with pytest.raises(ValueError, match="dec_fuse|cblock"):
            Predictor(cfg, variables, InferConfig(), "cpu", **bad)
    bilinear = ModelConfig(bilinear=True, **BASE8)
    bil_vars = fast_random_variables(bilinear, SEED)
    for opts in VARIANTS.values():  # no kernel forward for this net: refuse every variant
        with pytest.raises(ValueError, match="kernel forward"):
            Predictor(bilinear, bil_vars, InferConfig(), "cpu", **opts)
    with pytest.raises(ValueError, match="multiple of 128"):
        K.conv3x3_cblock(torch.zeros(1, 10, 10, 8), torch.zeros(64, 8, 3, 3), torch.zeros(64))


def test_supports_tier2_where_the_kernel_forward_runs():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert supports_tier2(ModelConfig(), cuda) and supports_tier2(ModelConfig(**BASE8), cpu)
    assert supports_tier2(ModelConfig(base_features=4, compute_dtype="float32"), cpu)
    assert not supports_tier2(ModelConfig(**BASE8), cuda)
    assert not supports_tier2(dataclasses.replace(ModelConfig(), bilinear=True), cuda)
