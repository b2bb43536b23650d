"""The port's serving variants against the JAX package on the CPU.

folded_forward_kernels with the options tier2, fused_enc0, dec_fuse and
cblock against folded_forward_tier1 with the same options (Pallas kernels
in interpret mode); the fused kernels' plain versions (enc0_fused,
dec_tail) against enc0_fused_phase2 and dec_tail_phase2; the routed
counterparts (conv3x3_dense, dec_conv0_dense, conv3x3_cblock) against
conv3x3_lanes, dec_conv0_lanes and conv_cblock.conv3x3_cblock (with the
unit scale every ported path passes them); conv3x3_bias_relu and
conv3x3_dense against conv3x3_nhwc; the Predictor with every option on
against the JAX Predictor; the options' refusals; the wrappers each
option set's forward calls, spied on, against bench.serving_launches (the
default reaches every middle stage through its wrapper), and the default
forward bit for bit equal to the composition with a cuDNN-style middle
(F.conv2d, bias in the compute dtype, F.relu, F.max_pool2d, torch.cat of
the cropped skip and the up-conv) that it replaced.

Tiny fp32 nets at base 8 (the JAX tier 2 needs base % 8, and base 8
puts enc4 at 128 output channels, the width cblock routes), input 188;
seeded numpy variables in the Flax layout, handed to both packages.
Forward parity at atol 5e-4 as in tests/test_lanes_net.py, kernels at
2e-5 as in tests/test_conv3x3.py. On the CPU the wrappers run their
plain versions; the CUDA kernels are held to those on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
from unetseg_tpu_torch import bench
from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
from unetseg_tpu_torch.infer import kernel_net
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.infer.folding import fold_batchnorm
from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels, supports_tier2
from unetseg_tpu_torch.infer.tiling import extract_tiles, mirror_pad, plan_tiles, stitch
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.models.unet import center_crop_nhwc, compute_dtype, to_nchw, to_nhwc
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


# ------------------------------------------------- the kernel middle's route
WRAPPERS = ("conv3x3_bias_relu", "conv3x3_dense", "conv3x3_cblock", "enc0_fused",
            "tconv2x2_bias", "dec_conv0", "dec_conv0_dense", "conv3x3_head", "dec_tail")


@pytest.fixture
def spied(monkeypatch):
    """Every serving wrapper wrapped to record (name, args, kwargs) and run:
    in ops/kernels/conv3x3.py, where the custom operators of
    ops/kernels/library.py look them up, and where infer/kernel_net.py
    imported the variants' wrappers by name."""
    calls = []
    for name in WRAPPERS:
        def spy(*args, _fn=getattr(K, name), _name=name, **kw):
            calls.append((_name, args, kw))
            return _fn(*args, **kw)
        monkeypatch.setattr(K, name, spy)
        if hasattr(kernel_net, name):
            monkeypatch.setattr(kernel_net, name, spy)
    return calls


@pytest.mark.parametrize("name", ["default", *sorted(VARIANTS)])
def test_forward_calls_the_wrappers_it_launches(net, spied, name):
    """Each option set's forward calls each wrapper as often as
    bench.serving_launches counts its launches on the card (base 8: cblock
    routes enc4's two 128-channel convs alone). The default reaches each
    middle stage through its wrapper: 13 conv3x3_bias_relu (the stem, enc0
    conv1 and the 11 middle convs; enc0..enc3 conv1 with the pool), 4
    tconv2x2_bias, 4 dec_conv0 reading the whole skip, one conv3x3_head."""
    _, _, folded, x = net
    opts = VARIANTS.get(name, {})
    with torch.inference_mode():
        folded_forward_kernels(folded, torch.from_numpy(x), **opts)
    cfg = ModelConfig(**BASE8)
    assert Counter(n for n, _, _ in spied) == bench.serving_launches(cfg, **opts)
    if name != "default":
        return
    assert bench.serving_launches(cfg) == {"conv3x3_bias_relu": 13, "tconv2x2_bias": 4,
                                           "dec_conv0": 4, "conv3x3_head": 1}
    pooled = [a[0].shape[1] - 2 for n, a, kw in spied
              if n == "conv3x3_bias_relu" and kw.get("fuse_pool")]
    assert pooled == [184, 88, 40, 16]  # enc0..enc3 conv1's outputs at 188^2
    entries = [(a[0].shape[1], a[1].shape[1]) for n, a, _ in spied if n == "dec_conv0"]
    assert entries == [(16, 8), (40, 8), (88, 8), (184, 8)]  # (skip, up) at 188^2: no crop


def _cudnn_style_forward(folded, x):
    """The default kernel forward as composed before its middle ran on the
    kernels: the ends through the wrappers' plain versions, the middle on
    NCHW views of channels_last storage: F.conv2d with the bias in the
    compute dtype, F.relu, F.max_pool2d at the next level's start, the skip
    center-cropped and concatenated before the up-conv's output."""
    p, cfg = folded, folded.cfg
    x = x.to(compute_dtype(cfg)).contiguous()

    def conv(h, c):
        return F.relu(F.conv2d(h, c.weight.to(h.dtype), c.bias.to(h.dtype)))

    h = K.conv3x3_bias_relu_plain(x, p.enc0.conv0.weight, p.enc0.conv0.bias)
    skip0, pooled = K.conv3x3_bias_relu_plain(h, p.enc0.conv1.weight, p.enc0.conv1.bias,
                                              fuse_pool=True)
    xm, skips = to_nchw(pooled.contiguous()), []
    for lvl in range(1, cfg.levels):
        if lvl > 1:
            xm = F.max_pool2d(xm, 2)
        blk = getattr(p, f"enc{lvl}")
        xm = conv(conv(xm, blk.conv0), blk.conv1)
        skips.append(xm)
    last = cfg.levels - 2
    for i in range(last):
        t = getattr(p, f"up{i}_tconv")
        xm = F.conv_transpose2d(xm, t.weight.to(xm.dtype), t.bias.to(xm.dtype), stride=2)
        skip_c = center_crop_nhwc(to_nhwc(skips[-(i + 2)]), xm.shape[2], xm.shape[3])
        d = getattr(p, f"dec{i}")
        xm = conv(conv(torch.cat([to_nchw(skip_c), xm], dim=1), d.conv0), d.conv1)
    t = getattr(p, f"up{last}_tconv")
    up = K.tconv2x2_bias_plain(to_nhwc(xm).contiguous(), t.weight, t.bias)
    d = getattr(p, f"dec{last}")
    offs = kernel_net._crop_offsets(skip0, up)
    y = K.dec_conv0_plain(skip0, up, d.conv0.weight, d.conv0.bias, *offs)
    return K.conv3x3_head_plain(y, d.conv1.weight, d.conv1.bias, p.outc.weight, p.outc.bias)


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("size", [188, 252])
def test_default_forward_equals_the_cudnn_style_composition(size, classes):
    """On the CPU the wrappers' plain versions are the replaced middle op
    for op, so the kernel forward's logits are its logits bit for bit."""
    cfg = ModelConfig(num_classes=classes, **BASE8)
    folded = fold_batchnorm(cfg, flax_to_state_dict(fast_random_variables(cfg, SEED + classes)))
    x = torch.from_numpy(_x(size + classes, 2, size, size, 1))
    with torch.inference_mode():
        got, want = folded_forward_kernels(folded, x), _cudnn_style_forward(folded, x)
    out = 4 if size == 188 else 68
    assert got.shape == (2, out, out, classes) and float(got.std()) > 1e-2
    assert torch.equal(got, want)
