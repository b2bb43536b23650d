"""The Hopper kernels against their plain versions on the card, at small
shapes that reach the edge cases: ragged tiles, odd sizes under the fused
pool, odd crop offsets, 3-class heads, several output-channel blocks; for
the train step's kernels odd sizes, batch 1, CI=1, crop offsets of either
parity, relu=False, wgrad determinism, wgrad tiles ragged on both edges,
a g smaller than one tile, 32- and 96-channel sources, two 128-channel
sources at odd offsets and more split-K chunks than tiles, the sampler's reflection and
rounding ties at sizes off the 32-pixel grid; the weighted CE at ragged
pixel counts, odd crop offsets, bf16 logits and three classes; the
min-plus product at sizes off its 128-tile, K = 1 and both shared-operand
patterns; the serving variants' kernels: the fused enc0 at odd sizes,
batch 1, one pooled row and over several bands and blocks (bit for bit
against the stem kernel chained with the wgmma conv and pool), the fused
decoder tail at odd crop offsets with 1-4 classes and over several bands
(bit for bit against the wgmma chain), the stem's TMA weight gradient at a 3 x
3 g, rows off the 16-byte pitch and CO 128 (the same bits twice), the cblock conv at
CI 1024 on a 6x6 input, the dense decoder entry at offset 41, the dense
conv on both conv paths; the tier-2 train kernels: the dense dgrad with
CI 64 out of CO 128 and CI 256, the dense wgrad at 128 -> 128 with ragged
last tiles, the dense two-source wgrad at odd (41, 41) and even offsets,
and the tier-2 Functions counting only under the dense wrappers; the
wgmma forward (csrc/conv_fwd_wgmma.cu) at the bottom of the U's widths
(36/38/70 outputs at 512-1024 input channels), at 64, 128, 192 and 256
output channels in its im2col and windowed forms, from 32- and
96-channel sources, with the pool on odd sizes, relu=False and tiles that
cross image edges, one tap at a time in both forms, from two sources
(64+32, 128+128, 32+96) at odd offsets, with the
same bits on a second launch; the default serving forward's middle
stages at both serving cells' shapes (conv3x3_bias_relu with and without
the pool, tconv2x2_bias at CI 256-1024, dec_conv0 at 128+128 to 512+512)
and the whole default forward against the plain fp32 and bf16 forwards,
batch-invariant bit for bit; the head conv on the wgmma forward's head
variant at 1-4 classes and ragged sizes; the streaming wgmma tconv with
each (dy, dx) tap alone at CO 128, ragged pixel counts, 32-, 96- and
256-channel inputs and three column groups; both with the same bits on a
second launch; the dgrad on the wgmma forward's kernels through both
wrappers at 64-, 128- and 256-channel dx from 1x1, 2x3 and odd g at batch
1 and 4 (the same bits twice); the stem's row kernel (the pool on odd and
1-row outputs, relu on and off, CO 128 and 192, ragged strips; the same
bits on a second launch); the wrappers' refusals; the pipeline command at
base 8 on the card; the full-width serving forward exported with a
symbolic batch and loaded on the card (batches 1, 3 and 5, bit for bit
against Predictor.probs) and on the CPU, and a pinned batch;
visualize-augmentation's deformation on the card; and the train step's
fused update at the full parameter tree for SGD, Adam and AdamW with the
EMA (bit for bit against the plain `_foreach` update), at 150 leaves of
ragged sizes read at misaligned addresses, and with no host sync; and the
train step's BatchNorm+ReLU (csrc/bn_relu.cu) at the recipe step's 18
shapes, with a masked item, exact ties, a group of equal ranks, a strided
activation and no host sync, the same bits on a second run.

Marked `cuda` and skipped without a card. The file imports no jax, so on a
GPU machine it runs without the JAX package:
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from unetseg_tpu_torch.models.unet import to_nchw, to_nhwc
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT
from unetseg_tpu_torch.ops.kernels import elastic as KE
from unetseg_tpu_torch.ops.kernels import minplus as KM
from unetseg_tpu_torch.ops.kernels import wce as KW

pytestmark = pytest.mark.cuda

# bf16 output rounding (2^-9 relative) plus f32 summation order
RTOL, ATOL = 1e-2, 1e-2
# the head kernel rounds its activation a to bf16 before the f32 head
# product; the fp32 reference does not: allow 2^-8 * sum_c |a_c| |k_c|
HEAD_SLACK = 2.0**-8


@pytest.fixture
def g():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _act(g, *shape):
    return torch.rand(*shape, generator=g, device="cuda").to(torch.bfloat16)


def _w(g, *shape, fan):
    w = torch.randn(*shape, generator=g, device="cuda") * (2.0 / fan) ** 0.5
    return w.to(torch.bfloat16).float()


def _b(g, n):
    return 0.1 * torch.randn(n, generator=g, device="cuda")


def _close(got, ref, slack=0.0):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    bound = ATOL + RTOL * ref.float().abs() + slack
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bound).all()), f"max err {err.max().item():.3e}, worst err/bound {(err / bound).max().item():.3f}"


@pytest.mark.parametrize("ci,co,h,w,pool", [
    (1, 64, 37, 45, True), (1, 128, 20, 19, False),
    (32, 64, 23, 35, True), (64, 128, 40, 18, True), (96, 64, 19, 50, False),
])
def test_conv3x3_bias_relu(g, ci, co, h, w, pool):
    x = _act(g, 2, h, w, ci)
    wt, b = _w(g, co, ci, 3, 3, fan=9 * co), _b(g, co)
    K.reset_launch_counts()
    got = K.conv3x3_bias_relu(x, wt, b, fuse_pool=pool)
    ref = K.conv3x3_bias_relu_plain(x.float(), wt, b, fuse_pool=pool)
    assert K.launch_counts()["conv3x3_bias_relu"] == 1
    for a, r in zip(got, ref) if pool else [(got, ref)]:
        assert a.shape == r.shape and a.dtype == torch.bfloat16
        _close(a, r)


@pytest.mark.parametrize("ci,co,h,w", [(128, 64, 13, 21), (64, 128, 5, 17)])
def test_tconv2x2_bias(g, ci, co, h, w):
    x = _act(g, 3, h, w, ci)
    wt, b = _w(g, ci, co, 2, 2, fan=4 * co), _b(g, co)
    got = K.tconv2x2_bias(x, wt, b)
    _close(got, K.tconv2x2_bias_plain(x.float(), wt, b))


@pytest.mark.parametrize("hs,ws,hu,wu,row_off,col_off", [
    (40, 40, 24, 24, 8, 8), (33, 31, 20, 18, 5, 7), (30, 30, 27, 19, 0, 11),
])
def test_dec_conv0(g, hs, ws, hu, wu, row_off, col_off):
    skip, up = _act(g, 2, hs, ws, 64), _act(g, 2, hu, wu, 32)
    wt, b = _w(g, 64, 96, 3, 3, fan=9 * 64), _b(g, 64)
    got = K.dec_conv0(skip, up, wt, b, row_off, col_off)
    _close(got, K.dec_conv0_plain(skip.float(), up.float(), wt, b, row_off, col_off))


@pytest.mark.parametrize("nc,h,w", [(2, 35, 22), (3, 18, 40), (1, 20, 20)])
def test_conv3x3_head(g, nc, h, w):
    x = _act(g, 2, h, w, 64)
    wt, b = _w(g, 64, 64, 3, 3, fan=9 * 64), _b(g, 64)
    kh, bh = _w(g, nc, 64, 1, 1, fan=nc), _b(g, nc)
    got = K.conv3x3_head(x, wt, b, kh, bh)
    assert got.dtype == torch.float32
    a = K.conv3x3_bias_relu_plain(x.float(), wt, b)
    slack = HEAD_SLACK * to_nhwc(torch.nn.functional.conv2d(to_nchw(a).abs(), kh.abs()))
    _close(got, K.conv3x3_head_plain(x.float(), wt, b, kh, bh), slack)


def test_wrappers_raise_on_shapes_the_kernels_do_not_take(g):
    x = _act(g, 1, 10, 10, 48)  # 48 channels: not a multiple of 32
    with pytest.raises(ValueError, match="multiple of 32"):
        K.conv3x3_bias_relu(x, _w(g, 64, 48, 3, 3, fan=9), _b(g, 64))
    with pytest.raises(TypeError, match="bfloat16"):
        K.conv3x3_bias_relu(x.float()[..., :32].contiguous(), _w(g, 64, 32, 3, 3, fan=9), _b(g, 64))
    with pytest.raises(ValueError, match="exactly 64"):
        K.conv3x3_head(_act(g, 1, 10, 10, 32), _w(g, 128, 32, 3, 3, fan=9), _b(g, 128),
                       _w(g, 2, 128, 1, 1, fan=2), _b(g, 2))


# ------------------------------------------------------ train-step kernels


def _g(g, *shape):
    return (torch.rand(*shape, generator=g, device="cuda") - 0.5).to(torch.bfloat16)


def _close_rel(got, ref):
    """Weight gradients sum thousands of products: hold them to 1e-2 of
    the reference's largest entry (bf16 inputs, f32 sums) plus 1e-2 rel."""
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    bound = 1e-2 * ref.float().abs().max() + 1e-2 * ref.float().abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bound).all()), f"worst err/bound {(err / bound).max().item():.3f}"


@pytest.mark.parametrize("ci,co,relu", [(1, 64, False), (64, 64, False), (32, 128, True)])
def test_forward_relu_flag(g, ci, co, relu):
    """relu=False keeps the negative pre-activations (stem and mma paths,
    and the decoder-entry conv)."""
    x = _g(g, 1, 19, 23, ci)
    wt, b = _w(g, co, ci, 3, 3, fan=9 * co), _b(g, co)
    got = K.conv3x3_bias_relu(x, wt, b, relu=relu)
    ref = K.conv3x3_bias_relu_plain(x.float(), wt, b, relu=relu)
    assert bool((got < 0).any()) != relu
    _close(got, ref)
    skip, up = _g(g, 1, 30, 31, 64), _g(g, 1, 20, 17, 64)
    wd, bd = _w(g, 64, 128, 3, 3, fan=9 * 64), _b(g, 64)
    _close(K.dec_conv0(skip, up, wd, bd, 5, 6, relu=relu),
           K.dec_conv0_plain(skip.float(), up.float(), wd, bd, 5, 6, relu=relu))


@pytest.mark.parametrize("b,hg,wg,co,ci", [(1, 17, 23, 64, 64), (2, 30, 9, 32, 128), (1, 5, 40, 64, 64)])
def test_dgrad(g, b, hg, wg, co, ci):
    gr = _g(g, b, hg, wg, co)
    wt = _w(g, co, ci, 3, 3, fan=9 * co)
    KT.conv3x3_dgrad.launches = 0
    got = KT.conv3x3_dgrad(gr, wt)
    assert KT.conv3x3_dgrad.launches == 1
    assert got.shape == (b, hg + 2, wg + 2, ci) and got.dtype == torch.bfloat16
    _close(got, KT.conv3x3_dgrad_plain(gr.float(), wt))


@pytest.mark.parametrize("b,h,w,ci,co", [(1, 19, 25, 1, 64), (2, 21, 17, 64, 64), (1, 12, 40, 32, 128)])
def test_wgrad(g, b, h, w, ci, co):
    x = _act(g, b, h, w, ci)
    gr = _g(g, b, h - 2, w - 2, co)
    got = KT.conv3x3_wgrad(x, gr)
    assert got.shape == (co, ci, 3, 3) and got.dtype == torch.float32
    _close_rel(got, KT.conv3x3_wgrad_plain(x.float(), gr.float()))


@pytest.mark.parametrize("row_off,col_off", [(3, 4), (4, 7), (0, 0), (5, 5)])
def test_dec0_wgrad(g, row_off, col_off):
    skip, up = _act(g, 2, 31, 33, 64), _act(g, 2, 21, 19, 64)
    gr = _g(g, 2, 19, 17, 64)
    got = KT.conv3x3_dec0_wgrad(skip, up, gr, row_off, col_off)
    ref = KT.conv3x3_dec0_wgrad_plain(skip.float(), up.float(), gr.float(), row_off, col_off)
    assert got.shape == (64, 128, 3, 3)
    _close_rel(got, ref)


@pytest.mark.parametrize("b,h,w,co", [
    (1, 5, 5, 64),      # one image, a 3 x 3 g: one tile, mostly past the edges
    (2, 37, 83, 64),    # rows of 83 values: no 16-byte row pitch, every row offset
    (3, 22, 141, 128),  # two 64-channel blocks, ragged last tile column
    (1, 70, 67, 128),
])
def test_wgrad_stem_edges(g, b, h, w, co):
    """The stem's TMA weight gradient (x with one channel) at edge shapes
    against the plain version, with the same bits on two launches."""
    x = _act(g, b, h, w, 1)
    gr = _g(g, b, h - 2, w - 2, co)
    KT.conv3x3_wgrad.launches = 0
    first, again = KT.conv3x3_wgrad(x, gr), KT.conv3x3_wgrad(x, gr)
    torch.cuda.synchronize()
    assert KT.conv3x3_wgrad.launches == 2
    assert first.shape == (co, 1, 3, 3) and first.dtype == torch.float32
    assert torch.equal(first, again)
    _close_rel(first, KT.conv3x3_wgrad_plain(x.float(), gr.float()))


def test_wgrad_is_deterministic(g):
    """Two-pass split-K: the same inputs give the same bits."""
    x, gr = _act(g, 2, 66, 70, 64), _g(g, 2, 64, 68, 64)
    a, b = KT.conv3x3_wgrad(x, gr), KT.conv3x3_wgrad(x, gr)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("b,h,w,ci,co", [
    (2, 25, 21, 96, 128),  # 23 x 19 outputs: 4x16 tiles ragged on both edges; 96 = 64 + 32
    (1, 5, 5, 64, 64),     # g 1x3x3: smaller than one tile
    (3, 7, 70, 160, 64),   # 5 x 68: one ragged tile row; 160 = 2 x 64 + 32
])
def test_wgrad_ragged_and_tiny(g, b, h, w, ci, co):
    """The copy's zero fill stands in for bounds checks: tiles past the
    output on either edge, a g smaller than one tile, channel slices past
    the source's channels."""
    x, gr = _act(g, b, h, w, ci), _g(g, b, h - 2, w - 2, co)
    got = KT.conv3x3_wgrad(x, gr)
    assert got.shape == (co, ci, 3, 3)
    _close_rel(got, KT.conv3x3_wgrad_plain(x.float(), gr.float()))


@pytest.mark.parametrize("cis,ciu,row_off,col_off", [(128, 128, 5, 7), (32, 32, 1, 2),
                                                     (64, 32, 3, 0)])
def test_dec0_wgrad_sources(g, cis, ciu, row_off, col_off):
    """Two sources: CI 256 at odd offsets, 32-channel sources (each its own
    zero-filled 64-channel slice), unequal widths."""
    skip, up = _act(g, 2, 45, 47, cis), _act(g, 2, 20, 23, ciu)
    gr = _g(g, 2, 18, 21, 128)
    got = KT.conv3x3_dec0_wgrad(skip, up, gr, row_off, col_off)
    assert got.shape == (128, cis + ciu, 3, 3)
    _close_rel(got, KT.conv3x3_dec0_wgrad_plain(skip.float(), up.float(), gr.float(),
                                                row_off, col_off))


def test_wgrad_more_chunks_than_tiles(g, monkeypatch):
    """A chunk count above the tile count: the empty chunks write zero
    partial sums, and the result still equals the plain version."""
    x, gr = _act(g, 1, 10, 20, 64), _g(g, 1, 8, 18, 64)  # 2 x 2 tiles
    monkeypatch.setattr(KT, "wgrad_chunks", lambda *a: 9)
    got = KT.conv3x3_wgrad(x, gr)
    _close_rel(got, KT.conv3x3_wgrad_plain(x.float(), gr.float()))


@pytest.mark.parametrize("b,h,w", [(1, 37, 45), (3, 64, 20)])
def test_sample_displaced(g, b, h, w):
    img = torch.rand(b, h, w, generator=g, device="cuda")
    lab = torch.randint(0, 9, (b, h, w), generator=g, device="cuda", dtype=torch.int32)
    d = 12.0
    yy = torch.arange(h, device="cuda", dtype=torch.float32)[None, :, None] + d * (
        torch.rand(b, h, w, generator=g, device="cuda") * 2 - 1)
    xx = torch.arange(w, device="cuda", dtype=torch.float32)[None, None, :] + d * (
        torch.rand(b, h, w, generator=g, device="cuda") * 2 - 1)
    yy[0, 0, :4] = torch.tensor([2.5, 3.5, -0.5, -7.25], device="cuda")  # ties, reflection
    yy, xx = yy.clamp(-d, h - 1 + d - 1.001), xx.clamp(-d, w - 1 + d - 1.001)
    got_i, got_m = KE.sample_displaced(img, lab, yy, xx)
    ref_i, ref_m = KE.sample_displaced_plain(img, lab, yy, xx)
    torch.cuda.synchronize()
    assert (got_i - ref_i).abs().max().item() <= 1e-5
    assert torch.equal(got_m, ref_m)


def test_train_wrappers_raise_on_what_the_kernels_do_not_take(g):
    gr = _g(g, 1, 10, 10, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        KT.conv3x3_dgrad(gr.float(), _w(g, 64, 64, 3, 3, fan=9))
    with pytest.raises(ValueError, match="multiple of 64"):
        KT.conv3x3_dgrad(gr, _w(g, 64, 32, 3, 3, fan=9))
    with pytest.raises(ValueError, match="contiguous"):
        KT.conv3x3_wgrad(_act(g, 1, 12, 12, 64).transpose(1, 2), gr)
    with pytest.raises(ValueError, match="multiple of 32"):
        KT.conv3x3_wgrad(_act(g, 1, 12, 12, 48), gr)
    with pytest.raises(ValueError, match="leaves skip"):
        KT.conv3x3_dec0_wgrad(_act(g, 1, 14, 14, 64), _act(g, 1, 12, 12, 64), gr, 3, 0)
    img = torch.rand(1, 8, 8, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        KE.sample_displaced(img, img, img, img)
    with pytest.raises(ValueError, match="contiguous"):
        KE.sample_displaced(img, img.int(), img.transpose(1, 2), img)


# ------------------------------------------------ weighted CE and min-plus


@pytest.mark.parametrize("b,h,w,c,dtype,row_off,col_off", [
    (1, 7, 9, 2, torch.float32, 0, 0), (3, 13, 17, 2, torch.float32, 5, 3),
    (2, 11, 6, 3, torch.float32, 1, 8), (2, 15, 15, 2, torch.bfloat16, 4, 7),
    (1, 5, 33, 3, torch.bfloat16, 2, 0),
])
def test_weighted_ce(g, b, h, w, c, dtype, row_off, col_off):
    """Forward and backward against the plain versions (the JAX step's
    default loss and its autograd): 1e-5 of the largest entry (f32
    arithmetic in another order; for bf16 logits the plain backward rounds
    its f32 gradient to bf16 as the kernel does, one bf16 ulp apart at most)."""
    ht, wt = h + row_off + 3, w + col_off + 2
    logits = (2 * torch.randn(b, h, w, c, generator=g, device="cuda")).to(dtype)
    t = torch.randint(0, c, (b, ht, wt), generator=g, device="cuda", dtype=torch.int32)
    wts = torch.rand(b, ht, wt, generator=g, device="cuda") * 3 + 0.5
    gin = torch.randn(b, h, w, generator=g, device="cuda")
    KW.weighted_ce_fwd.launches = KW.weighted_ce_bwd.launches = 0
    out = KW.weighted_ce_fwd(logits, t, wts, row_off, col_off)
    d = KW.weighted_ce_bwd(logits, t, wts, gin, row_off, col_off)
    assert KW.weighted_ce_fwd.launches == KW.weighted_ce_bwd.launches == 1
    ref = KW.weighted_ce_fwd_plain(logits, t, wts, row_off, col_off)
    dref = KW.weighted_ce_bwd_plain(logits, t, wts, gin, row_off, col_off)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and d.dtype == dtype and d.shape == logits.shape
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    ulp = 2.0**-8 if dtype == torch.bfloat16 else 1e-5
    assert (d.float() - dref.float()).abs().max().item() <= ulp * dref.float().abs().max().item()


@pytest.mark.parametrize("m,k,n,shared", [
    (1, 1, 1, None), (130, 200, 70, None), (37, 1, 129, "a"), (257, 45, 31, "b"),
    (128, 128, 128, "a"),
])
def test_minplus_equals_plain(g, m, k, n, shared):
    """Exact: one f32 add per candidate and an exact min."""
    def mat(*shape):
        x = torch.randint(0, 5000, shape, generator=g, device="cuda").float()
        return torch.where(torch.rand(shape, generator=g, device="cuda") < 0.2, 1e12, x)

    a = mat(m, k) if shared == "a" else mat(3, m, k) if shared else mat(m, k)
    bm = mat(k, n) if shared == "b" else mat(3, k, n) if shared else mat(k, n)
    KM.minplus.launches = 0
    got = KM.minplus(a, bm)
    ref = KM.minplus_plain(a, bm)
    torch.cuda.synchronize()
    assert KM.minplus.launches == 1 and got.shape == ref.shape
    assert torch.equal(got, ref)


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(g):
    lg = torch.randn(1, 4, 4, 2, device="cuda")
    t = torch.zeros(1, 6, 6, dtype=torch.int32, device="cuda")
    w = torch.ones(1, 6, 6, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        KW.weighted_ce_fwd(lg, t.long(), w)
    with pytest.raises(ValueError, match="leaves"):
        KW.weighted_ce_fwd(lg, t, w, 3, 0)
    with pytest.raises(ValueError, match="contiguous"):
        KW.weighted_ce_fwd(lg.transpose(1, 2), t, w)
    with pytest.raises(TypeError, match="float32"):
        KM.minplus(torch.ones(3, 4, device="cuda", dtype=torch.float64),
                   torch.ones(4, 5, device="cuda"))
    with pytest.raises(ValueError, match="batch sizes"):
        KM.minplus(torch.ones(2, 3, 4, device="cuda"), torch.ones(3, 4, 5, device="cuda"))


# ------------------------------------------------------ serving variants


# A rounding to bf16 moves a value v by at most 2^-8 |v|: the fused kernels
# round their intermediate where the chained kernels store it, the fp32
# reference does not, so a conv of it may move by 2^-8 sum |w| |v|.
ROUND = 2.0**-8


def _abs_conv(x, w):
    return to_nhwc(torch.nn.functional.conv2d(to_nchw(x).abs(), w.abs()))


@pytest.mark.parametrize("b,h,w", [(1, 37, 45), (2, 22, 53), (1, 7, 9), (3, 75, 70),
                                   (1, 101, 37), (2, 196, 200)])
def test_enc0_fused(g, b, h, w):
    """Odd sizes under the pool (floor), batch 1, a single pooled row (7 x 9
    -> 3 x 5), several bands (71 x 66 at batch 3: three bands, the last 7
    rows, 81 steps; 97 x 33: four bands, the last one row, 20 steps), and
    more steps than SMs (192 x 196 at batch 2: 300 steps, blocks walking two
    or three across band and image seams on both h tiles): the bits of the
    counted chain, the stem kernel then the wgmma conv with the pool, the
    same bits on a second launch, and the fp32 plain version within the
    stem's rounding."""
    x = _act(g, b, h, w, 1)
    w0, b0 = _w(g, 64, 1, 3, 3, fan=9 * 64), _b(g, 64)
    w1, b1 = _w(g, 64, 64, 3, 3, fan=9 * 64), _b(g, 64)
    K.reset_launch_counts()
    skip, pooled = K.enc0_fused(x, w0, b0, w1, b1)
    assert K.launch_counts()["enc0_fused"] == 1
    assert skip.shape == (b, h - 4, w - 4, 64) and pooled.shape == (b, (h - 4) // 2, (w - 4) // 2, 64)
    c_skip, c_pool = K.conv3x3_bias_relu(K.conv3x3_bias_relu(x, w0, b0), w1, b1, fuse_pool=True)
    torch.cuda.synchronize()
    assert torch.equal(skip, c_skip) and torch.equal(pooled, c_pool)
    again = K.enc0_fused(x, w0, b0, w1, b1)
    torch.cuda.synchronize()
    assert torch.equal(again[0], skip) and torch.equal(again[1], pooled)
    r_skip, r_pool = K.enc0_fused_plain(x.float(), w0, b0, w1, b1)
    slack = ROUND * _abs_conv(K.conv3x3_bias_relu_plain(x.float(), w0, b0), w1)
    _close(skip, r_skip, slack)
    _close(pooled, r_pool, to_nhwc(torch.nn.functional.max_pool2d(to_nchw(slack), 2)))


def _dec_tail_case(g, nc, b, hs, ws, hu, wu, row_off, col_off):
    """dec_tail on random inputs: the kernel against the wgmma chain
    dec_conv0 -> conv3x3_head bit for bit (the same slices, taps and k16
    steps per pixel), and against the fp32 plain version within both
    roundings."""
    skip, up = _act(g, b, hs, ws, 64), _act(g, b, hu, wu, 64)
    w0, b0 = _w(g, 64, 128, 3, 3, fan=9 * 64), _b(g, 64)
    w1, b1 = _w(g, 64, 64, 3, 3, fan=9 * 64), _b(g, 64)
    kh, bh = _w(g, nc, 64, 1, 1, fan=nc), _b(g, nc)
    K.reset_launch_counts()
    got = K.dec_tail(skip, up, w0, b0, w1, b1, kh, bh, row_off, col_off)
    assert K.launch_counts()["dec_tail"] == 1
    assert got.shape == (b, hu - 4, wu - 4, nc) and got.dtype == torch.float32
    wgmma_chain = K.conv3x3_head(K.dec_conv0(skip, up, w0, b0, row_off, col_off), w1, b1, kh, bh)
    torch.cuda.synchronize()
    assert K.launch_counts()["dec_tail"] == 1
    assert torch.equal(got, wgmma_chain)
    y = K.dec_conv0_plain(skip.float(), up.float(), w0, b0, row_off, col_off)
    a = K.conv3x3_bias_relu_plain(y, w1, b1)
    slack = HEAD_SLACK * _abs_conv(a, kh) + ROUND * _abs_conv(_abs_conv(y, w1), kh)
    _close(got, K.dec_tail_plain(skip.float(), up.float(), w0, b0, w1, b1, kh, bh, row_off,
                                 col_off), slack)


@pytest.mark.parametrize("nc,row_off,col_off", [(1, 3, 5), (2, 5, 2), (3, 0, 7), (4, 1, 1)])
def test_dec_tail(g, nc, row_off, col_off):
    """Odd crop offsets, 1-4 classes, one band ragged in both directions (23
    x 19 logits: 3 column steps, each block one step, all but the first of
    a band starting with a prime step)."""
    _dec_tail_case(g, nc, 2, 40, 38, 27, 23, row_off, col_off)


def test_dec_tail_bands(g):
    """Several bands and more steps than SMs: 196 x 199 logits are 7 bands
    (the last 16 rows) of 26 column steps, 182 steps, so blocks walk two
    steps across band seams, some from a prime step; the last step's
    columns and the last band's rows run past the image."""
    _dec_tail_case(g, 2, 1, 212, 215, 200, 203, 5, 7)


def test_conv3x3_cblock_deep(g):
    """enc4's width on a tiny input: CI 1024, a 4x4 output in one ragged
    tile, two output-channel blocks."""
    x = _act(g, 2, 6, 6, 1024)
    wt, b = _w(g, 128, 1024, 3, 3, fan=9 * 128), _b(g, 128)
    K.reset_launch_counts()
    got = K.conv3x3_cblock(x, wt, b)
    assert K.launch_counts() == {**{k: 0 for k in K.launch_counts()}, "conv3x3_cblock": 1}
    assert got.shape == (2, 4, 4, 128)
    _close(got, K.conv3x3_bias_relu_plain(x.float(), wt, b))
    with pytest.raises(ValueError, match="multiple of 128"):
        K.conv3x3_cblock(_act(g, 1, 8, 8, 64), _w(g, 64, 64, 3, 3, fan=9), _b(g, 64))


def test_dec_conv0_dense_offset_41(g):
    """The tier-2 decoder entry at 512^2 tiles reads skip1 at (41, 41)."""
    skip, up = _act(g, 2, 62, 63, 128), _act(g, 2, 20, 21, 128)
    wt, b = _w(g, 128, 256, 3, 3, fan=9 * 128), _b(g, 128)
    K.reset_launch_counts()
    got = K.dec_conv0_dense(skip, up, wt, b, 41, 41)
    assert K.launch_counts()["dec_conv0_dense"] == 1 and K.launch_counts()["dec_conv0"] == 0
    _close(got, K.dec_conv0_plain(skip.float(), up.float(), wt, b, 41, 41))


@pytest.mark.parametrize("ci,pool", [(1, True), (64, True), (32, False)])
def test_conv3x3_dense(g, ci, pool):
    """conv3x3_dense on both conv paths (the stem's row kernel, the wgmma
    forward), with and without the pool; it counts apart from
    conv3x3_bias_relu."""
    x = _g(g, 2, 19, 26, ci)
    wt, b = _w(g, 64, ci, 3, 3, fan=9 * 64), _b(g, 64)
    K.reset_launch_counts()
    got = K.conv3x3_dense(x, wt, b, fuse_pool=pool)
    assert K.launch_counts()["conv3x3_dense"] == 1 and K.launch_counts()["conv3x3_bias_relu"] == 0
    ref = K.conv3x3_bias_relu_plain(x.float(), wt, b, fuse_pool=pool)
    for a, r in zip(got, ref) if pool else [(got, ref)]:
        _close(a, r)


def test_variant_wrappers_raise_on_what_the_kernels_do_not_take(g):
    x = _act(g, 1, 20, 20, 1)
    w64 = _w(g, 64, 64, 3, 3, fan=9)
    with pytest.raises(ValueError, match="exactly 64"):
        K.enc0_fused(x, _w(g, 128, 1, 3, 3, fan=9), _b(g, 128),
                     _w(g, 128, 128, 3, 3, fan=9), _b(g, 128))
    with pytest.raises(ValueError, match="do not fit"):
        K.enc0_fused(_act(g, 1, 20, 20, 32), _w(g, 64, 32, 3, 3, fan=9), _b(g, 64), w64, _b(g, 64))
    skip, up = _act(g, 1, 30, 30, 64), _act(g, 1, 20, 20, 64)
    w0 = _w(g, 64, 128, 3, 3, fan=9)
    with pytest.raises(ValueError, match="leaves skip"):
        K.dec_tail(skip, up, w0, _b(g, 64), w64, _b(g, 64), _w(g, 2, 64, 1, 1, fan=2), _b(g, 2), 11, 0)
    with pytest.raises(ValueError, match="classes"):
        K.dec_tail(skip, up, w0, _b(g, 64), w64, _b(g, 64), _w(g, 5, 64, 1, 1, fan=2), _b(g, 5), 0, 0)


# ------------------------------------------------ the wgmma forward conv


@pytest.mark.parametrize("b,h,w,ci,co,pool,relu", [
    (2, 38, 38, 1024, 128, False, True),   # enc4c1's 36^2 outputs, 1024 channels (im2col)
    (2, 40, 40, 512, 256, True, True),     # enc4c0's 38^2, N = 128 twice (windowed)
    (1, 72, 72, 512, 64, True, True),      # dec0's 70^2, N = 64
    (3, 11, 21, 64, 192, True, False),     # 192 = 3 x 64; 6 units an image; odd pool
    (2, 21, 19, 96, 128, True, True),      # 96 channels: the second slice half zero-filled
    (4, 10, 10, 32, 256, False, False),    # 32 channels (im2col), 64 pixels an image
    (3, 11, 21, 96, 256, False, False),    # im2col: half-empty slice, tiles across images
    (1, 9, 9, 64, 128, False, True),       # im2col: 49 pixels, one short tile
    (2, 9, 13, 64, 64, False, True),       # N = 64 without the pool: windowed
])
def test_conv_fwd_wgmma_shapes(g, b, h, w, ci, co, pool, relu):
    """The wgmma forward at the bottom of the U's widths (36, 38, 70 outputs
    at 512-1024 input channels), every N choice (CO 64, 128, 192, 256), the
    im2col form (one source, no pool, N = 128) and the windowed one, 32- and
    96-channel sources, the pool on odd sizes, relu=False and tiles that
    cross rows and image edges."""
    x = _g(g, b, h, w, ci) if not relu else _act(g, b, h, w, ci)
    wt, bias = _w(g, co, ci, 3, 3, fan=9 * co), _b(g, co)
    K.reset_launch_counts()
    got = K.conv3x3_bias_relu(x, wt, bias, fuse_pool=pool, relu=relu)
    assert K.launch_counts() == _only(conv3x3_bias_relu=1)
    ref = K.conv3x3_bias_relu_plain(x.float(), wt, bias, fuse_pool=pool, relu=relu)
    for a, r in zip(got, ref) if pool else [(got, ref)]:
        assert a.shape == r.shape and a.dtype == torch.bfloat16
        _close(a, r)
    if not relu:
        assert bool(((got[0] if pool else got) < 0).any())


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("tap", range(9))
def test_conv_fwd_wgmma_each_tap(g, tap, pool):
    """One tap at a time (the others' weights zero). With the pool (the
    windowed form) each tap's A operand is the unit's window with its
    descriptor start moved by (10 ky + kx) rows of 128 bytes, off the 1 KB
    swizzle atom for most taps; without it (im2col) the tap is the copy's
    (kx, ky) offset."""
    x = _act(g, 2, 20, 27, 128)
    wt, bias = _w(g, 128, 128, 3, 3, fan=9 * 128), _b(g, 128)
    keep = torch.zeros(3, 3, device="cuda")
    keep[tap // 3, tap % 3] = 1.0
    wt = wt * keep
    got = K.conv3x3_bias_relu(x, wt, bias, fuse_pool=pool, relu=False)
    ref = K.conv3x3_bias_relu_plain(x.float(), wt, bias, fuse_pool=pool, relu=False)
    for a, r in zip(got, ref) if pool else [(got, ref)]:
        _close(a, r)


@pytest.mark.parametrize("cis,ciu,co,row_off,col_off", [
    (64, 32, 128, 5, 7), (128, 128, 192, 41, 39), (32, 96, 64, 0, 3),
])
def test_conv_fwd_wgmma_two_sources(g, cis, ciu, co, row_off, col_off):
    """The decoder entry through the wgmma forward: 64+32 and 128+128
    channels at odd crop offsets, slices past a source's channels, batch 2."""
    skip, up = _act(g, 2, 62, 63, cis), _act(g, 2, 19, 22, ciu)
    wt, bias = _w(g, co, cis + ciu, 3, 3, fan=9 * co), _b(g, co)
    K.reset_launch_counts()
    got = K.dec_conv0_dense(skip, up, wt, bias, row_off, col_off)
    assert K.launch_counts() == _only(dec_conv0_dense=1)
    _close(got, K.dec_conv0_plain(skip.float(), up.float(), wt, bias, row_off, col_off))


def test_conv_fwd_wgmma_repeats_its_bits(g):
    """No atomics, a fixed summation order: two launches give the same bits
    (cblock at enc3's width, a two-source entry at an odd offset)."""
    x = _act(g, 2, 30, 29, 256)
    wt, bias = _w(g, 256, 256, 3, 3, fan=9 * 256), _b(g, 256)
    assert torch.equal(K.conv3x3_cblock(x, wt, bias), K.conv3x3_cblock(x, wt, bias))
    skip, up = _act(g, 2, 40, 40, 64), _act(g, 2, 27, 25, 64)
    w0, b0 = _w(g, 64, 128, 3, 3, fan=9 * 64), _b(g, 64)
    first, again = K.dec_conv0(skip, up, w0, b0, 7, 5), K.dec_conv0(skip, up, w0, b0, 7, 5)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


# ------------------------------------------ the default serving forward's middle


def _middle_stages():
    """(id, wrapper, shape) of each middle stage of the default serving
    forward (base 64) in both serving cells, 16 tiles of 700^2 and 8 of
    512^2: enc{l} conv0 (B, S, CI, CO, pool=False) and conv1 (pool for
    l < 4), up{i} (B, S, CI, CO), dec{i} conv0 (B, skip S, up S, skip CI,
    up CI, offset) and conv1."""
    from unetseg_tpu_torch.models.shapes import unet_shapes

    out = []
    for cell, size, b in (("700x16", 700, 16), ("512x8", 512, 8)):
        enc = unet_shapes(size).encoder
        for lvl in range(1, 5):
            s, ci, co = enc[lvl - 1] // 2, 32 << lvl, 64 << lvl
            out.append((f"{cell}-enc{lvl}c0", "conv", (b, s, ci, co, False)))
            out.append((f"{cell}-enc{lvl}c1", "conv", (b, s - 2, co, co, lvl < 4)))
        s = enc[4]
        for i in range(3):
            ci = 1024 >> i
            up, skip = 2 * s, enc[3 - i]
            out.append((f"{cell}-up{i}", "tconv", (b, s, ci, ci // 2)))
            out.append((f"{cell}-dec{i}c0", "dec", (b, skip, up, ci // 2, ci // 2,
                                                    (skip - up) // 2)))
            out.append((f"{cell}-dec{i}c1", "conv", (b, up - 2, ci // 2, ci // 2, False)))
            s = up - 4
    return out


MIDDLE = _middle_stages()


@pytest.mark.parametrize("kind,shape", [c[1:] for c in MIDDLE], ids=[c[0] for c in MIDDLE])
def test_middle_stage_at_the_serving_cells_shapes(g, kind, shape):
    """Each middle stage's kernel at its shape in both serving cells against
    its plain version in fp32: conv3x3_bias_relu with and without the pool
    (the pool's floor at 512^2's 121-wide enc2 output), tconv2x2_bias at CI
    1024, 512 and 256, dec_conv0 at 512+512, 256+256 and 128+128 channels
    with the skip at its centre-crop offset (4, 16, 41 at 512^2; 4, 16, 40
    at 700^2); one launch each, counted under its wrapper."""
    K.reset_launch_counts()
    if kind == "conv":
        b, s, ci, co, pool = shape
        x = _act(g, b, s, s, ci)
        wt, bias = _w(g, co, ci, 3, 3, fan=9 * co), _b(g, co)
        got = K.conv3x3_bias_relu(x, wt, bias, fuse_pool=pool)
        ref = K.conv3x3_bias_relu_plain(x.float(), wt, bias, fuse_pool=pool)
        wrapper = "conv3x3_bias_relu"
    elif kind == "tconv":
        b, s, ci, co = shape
        x = _act(g, b, s, s, ci)
        wt, bias = _w(g, ci, co, 2, 2, fan=4 * co), _b(g, co)
        got, ref = K.tconv2x2_bias(x, wt, bias), K.tconv2x2_bias_plain(x.float(), wt, bias)
        wrapper = "tconv2x2_bias"
    else:
        b, hs, hu, cis, ciu, off = shape
        skip, up = _act(g, b, hs, hs, cis), _act(g, b, hu, hu, ciu)
        wt, bias = _w(g, ciu, cis + ciu, 3, 3, fan=9 * ciu), _b(g, ciu)
        got = K.dec_conv0(skip, up, wt, bias, off, off)
        ref = K.dec_conv0_plain(skip.float(), up.float(), wt, bias, off, off)
        wrapper = "dec_conv0"
    assert K.launch_counts() == _only(**{wrapper: 1})
    for a, r in zip(got, ref) if isinstance(got, tuple) else [(got, ref)]:
        assert a.shape == r.shape and a.dtype == torch.bfloat16
        _close(a, r)


@pytest.mark.parametrize("size,classes", [(252, 2), (512, 3)])
def test_default_forward_on_the_card(g, size, classes):
    """The whole default kernel forward at full width: 13 / 4 / 4 / 1
    launches, finite logits, their rms difference from the plain fp32
    forward (infer/folding.FoldedUNet, TF32 off) over its std at most 1.5
    times the plain bf16 forward's (cuDNN; both round the same activations
    to bf16, the kernels after the bias); a tile's logits in a batch of 3
    bit for bit its logits alone, since every kernel sums each output in
    one order whatever the batch."""
    import dataclasses

    from unetseg_tpu_torch.core.config import ModelConfig
    from unetseg_tpu_torch.infer.folding import FoldedUNet, fold_batchnorm
    from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels
    from unetseg_tpu_torch.models.fast_init import fast_random_variables
    from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict

    cfg = ModelConfig(num_classes=classes)
    net = fold_batchnorm(cfg, flax_to_state_dict(fast_random_variables(cfg, 5))).cuda()
    ref32 = FoldedUNet(dataclasses.replace(cfg, compute_dtype="float32")).cuda()
    ref32.load_state_dict(net.state_dict())
    x = torch.rand(3, size, size, 1, generator=g, device="cuda") * 2 - 1
    with torch.inference_mode():
        K.reset_launch_counts()
        got = folded_forward_kernels(net, x)
        torch.cuda.synchronize()
        assert K.launch_counts() == _only(conv3x3_bias_relu=13, tconv2x2_bias=4, dec_conv0=4,
                                          conv3x3_head=1)
        one = folded_forward_kernels(net, x[1:2])
        l32, l16 = ref32(x), net(x).float()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == l32.shape and bool(torch.isfinite(got).all())

    def rel(a):
        return ((a - l32).pow(2).mean().sqrt() / l32.std()).item()

    assert rel(got) <= 1.5 * rel(l16) < 0.05, (rel(got), rel(l16))
    assert torch.equal(one, got[1:2])


# ------------------------------------------------------ tier-2 train kernels


def _only(**want):
    """The launch counts, all zero but `want`."""
    return {**{k: 0 for k in K.launch_counts()}, **want}


@pytest.mark.parametrize("co,ci", [(128, 64), (128, 256)])
def test_dense_dgrad(g, co, ci):
    """enc1 conv0's input gradient (64 channels out of 128) and dec2
    conv0's into its 256-channel concat, at odd sizes; one launch, counted
    under the tier-2 wrapper and not under conv3x3_dgrad."""
    gr = _g(g, 2, 21, 13, co)
    wt = _w(g, co, ci, 3, 3, fan=9 * co)
    K.reset_launch_counts()
    got = KT.conv3x3_dense_dgrad(gr, wt)
    assert K.launch_counts() == _only(conv3x3_dense_dgrad=1)
    assert got.shape == (2, 23, 15, ci) and got.dtype == torch.bfloat16
    _close(got, KT.conv3x3_dgrad_plain(gr.float(), wt))


def test_dense_wgrad_ragged_tiles(g):
    """128 -> 128 over 21 x 37 outputs: the last 8x16 tile row and column
    are ragged (21 = 2*8 + 5, 37 = 2*16 + 5)."""
    x = _act(g, 2, 23, 39, 128)
    gr = _g(g, 2, 21, 37, 128)
    K.reset_launch_counts()
    got = KT.conv3x3_dense_wgrad(x, gr)
    assert K.launch_counts() == _only(conv3x3_dense_wgrad=1)
    assert got.shape == (128, 128, 3, 3) and got.dtype == torch.float32
    _close_rel(got, KT.conv3x3_wgrad_plain(x.float(), gr.float()))


@pytest.mark.parametrize("row_off,col_off", [(41, 41), (40, 42)])
def test_dec0_dense_wgrad(g, row_off, col_off):
    """The tier-2 decoder entry's weight gradient reads skip1 at (41, 41)
    at 512^2; an even pair beside it."""
    skip, up = _act(g, 2, 62, 63, 128), _act(g, 2, 20, 21, 128)
    gr = _g(g, 2, 18, 19, 128)
    K.reset_launch_counts()
    got = KT.conv3x3_dec0_dense_wgrad(skip, up, gr, row_off, col_off)
    assert K.launch_counts() == _only(conv3x3_dec0_dense_wgrad=1)
    assert got.shape == (128, 256, 3, 3)
    _close_rel(got, KT.conv3x3_dec0_wgrad_plain(skip.float(), up.float(), gr.float(),
                                                row_off, col_off))


def test_tier2_functions_count_under_the_dense_wrappers(g):
    """Conv3x3DenseTrain and DecConv0DenseTrain, forward and backward, each
    launch their forward, dgrad and wgrad once, all under the tier-2
    wrappers; their gradients match the plain versions'."""
    x = _act(g, 1, 20, 22, 64).requires_grad_(True)
    w, b = _w(g, 128, 64, 3, 3, fan=9 * 128).requires_grad_(True), _b(g, 128).requires_grad_(True)
    K.reset_launch_counts()
    z = KT.Conv3x3DenseTrain.apply(x, w, b)
    z.float().sum().backward()
    assert K.launch_counts() == _only(conv3x3_dense=1, conv3x3_dense_dgrad=1,
                                      conv3x3_dense_wgrad=1)
    ones = torch.ones_like(z)
    _close(x.grad, KT.conv3x3_dgrad_plain(ones.float(), w.detach()))
    _close_rel(w.grad, KT.conv3x3_wgrad_plain(x.detach().float(), ones.float()))

    skip, up = _act(g, 1, 30, 31, 128).requires_grad_(True), _act(g, 1, 20, 19, 128).requires_grad_(True)
    w0, b0 = _w(g, 128, 256, 3, 3, fan=9 * 128).requires_grad_(True), _b(g, 128).requires_grad_(True)
    K.reset_launch_counts()
    z = KT.DecConv0DenseTrain.apply(skip, up, w0, b0, 5, 7)
    z.float().sum().backward()
    assert K.launch_counts() == _only(dec_conv0_dense=1, conv3x3_dense_dgrad=1,
                                      conv3x3_dec0_dense_wgrad=1)
    dcat = KT.conv3x3_dgrad_plain(torch.ones_like(z).float(), w0.detach())
    _close(skip.grad[:, 5:25, 7:26], dcat[..., :128])
    assert not skip.grad[:, :5].any() and not skip.grad[:, 25:].any()
    _close(up.grad, dcat[..., 128:])


# ------------------------------------ the head conv and the tconv on wgmma


def _head_case(g, b, h, w, nc):
    x = _act(g, b, h, w, 64)
    wt, bias = _w(g, 64, 64, 3, 3, fan=9 * 64), _b(g, 64)
    return x, wt, bias, _w(g, nc, 64, 1, 1, fan=nc), _b(g, nc)


def _head_slack(x, wt, bias, kh):
    a = K.conv3x3_bias_relu_plain(x.float(), wt, bias)
    return HEAD_SLACK * to_nhwc(torch.nn.functional.conv2d(to_nchw(a).abs(), kh.abs()))


@pytest.mark.parametrize("nc,b,h,w", [(1, 2, 25, 21), (2, 1, 10, 10), (3, 3, 11, 30),
                                      (4, 2, 20, 13), (2, 1, 43, 9)])
def test_conv3x3_head_wgmma(g, nc, b, h, w):
    """The head variant of the wgmma forward at 1-4 classes: ragged 8x8
    units on both edges (23 x 19 logits), one unit, units across images, a
    last group short of units; f32 logits within the head's slack."""
    x, wt, bias, kh, bh = _head_case(g, b, h, w, nc)
    K.reset_launch_counts()
    got = K.conv3x3_head(x, wt, bias, kh, bh)
    assert K.launch_counts() == _only(conv3x3_head=1)
    assert got.shape == (b, h - 2, w - 2, nc) and got.dtype == torch.float32
    _close(got, K.conv3x3_head_plain(x.float(), wt, bias, kh, bh), _head_slack(x, wt, bias, kh))


@pytest.mark.parametrize("tap", range(4))
def test_tconv2x2_each_tap(g, tap):
    """One (dy, dx) tap at a time (the other taps' weights zero) at CO 128
    (two column groups, the weights streamed), ragged 11 x 13 input: each
    tap's columns land on output pixels (2r + dy, 2j + dx) only."""
    x = _act(g, 2, 11, 13, 64)
    wt, bias = _w(g, 64, 128, 2, 2, fan=4 * 128), _b(g, 128)
    keep = torch.zeros(2, 2, device="cuda")
    keep[tap // 2, tap % 2] = 1.0
    wt = wt * keep
    got = K.tconv2x2_bias(x, wt, bias)
    ref = K.tconv2x2_bias_plain(x.float(), wt, bias)
    _close(got, ref)
    dy, dx = tap // 2, tap % 2
    off = torch.ones(2, 2, dtype=torch.bool)
    off[dy, dx] = False
    rest = got.float().reshape(2, 11, 2, 13, 2, 128).permute(0, 1, 3, 2, 4, 5)[:, :, :, off]
    assert torch.equal(rest, bias.to(torch.bfloat16).float().expand_as(rest))


@pytest.mark.parametrize("b,h,w,ci,co", [
    (1, 1, 1, 32, 64),      # one pixel: one tile of 128 rows, 127 past the end
    (3, 7, 9, 128, 64),     # 189 pixels: a second tile of 61, resident weights
    (2, 13, 21, 64, 192),   # three column groups: weights streamed
    (1, 9, 15, 256, 64),    # four slices, more than the two weight stages: streamed
    (4, 16, 8, 96, 64),     # 96 channels: the second slice half zero-filled
    (2, 40, 33, 128, 64),   # ten tiles over rows and images
])
def test_tconv2x2_shapes(g, b, h, w, ci, co):
    """The streaming wgmma tconv at ragged pixel counts, 32/96/256 input
    channels, 64 and 192 output channels; one launch, counted."""
    x = _act(g, b, h, w, ci)
    wt, bias = _w(g, ci, co, 2, 2, fan=4 * co), _b(g, co)
    K.reset_launch_counts()
    got = K.tconv2x2_bias(x, wt, bias)
    assert K.launch_counts() == _only(tconv2x2_bias=1)
    assert got.shape == (b, 2 * h, 2 * w, co) and got.dtype == torch.bfloat16
    _close(got, K.tconv2x2_bias_plain(x.float(), wt, bias))


def test_head_and_tconv_repeat_their_bits(g):
    """No atomics, a fixed summation order: two launches of the head
    variant and of the tconv give the same bits."""
    x, wt, bias, kh, bh = _head_case(g, 2, 30, 27, 2)
    first, again = K.conv3x3_head(x, wt, bias, kh, bh), K.conv3x3_head(x, wt, bias, kh, bh)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    x = _act(g, 3, 17, 19, 128)
    wt, bias = _w(g, 128, 64, 2, 2, fan=4 * 64), _b(g, 64)
    first, again = K.tconv2x2_bias(x, wt, bias), K.tconv2x2_bias(x, wt, bias)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


# ----------------------------------- the dgrad on the wgmma forward's ring


@pytest.mark.parametrize("wrapper,b,hg,wg,co,ci", [
    ("conv3x3_dgrad", 1, 1, 1, 64, 64), ("conv3x3_dgrad", 4, 2, 3, 64, 128),
    ("conv3x3_dense_dgrad", 1, 2, 3, 128, 256), ("conv3x3_dgrad", 4, 13, 9, 64, 128),
    ("conv3x3_dense_dgrad", 1, 37, 21, 128, 256), ("conv3x3_dense_dgrad", 4, 17, 30, 128, 64),
    ("conv3x3_dense_dgrad", 1, 1, 1, 128, 128), ("conv3x3_dgrad", 4, 11, 6, 32, 256),
])
def test_dgrad_wgmma_shapes(g, wrapper, b, hg, wg, co, ci):
    """Both dgrad wrappers on the wgmma forward's kernels: dx of 64
    (windowed), 128 and 256 channels (im2col, its bounding box at (-2, -2)
    .. (0, 0)) from a 1x1 g, a 2x3 g, odd sizes whose 256-pixel tiles
    cross image edges, a 32-channel g, batch 1 and 4: held to the plain
    version, one launch counted under the wrapper alone, the same bits on
    a second launch."""
    gr = _g(g, b, hg, wg, co)
    wt = _w(g, co, ci, 3, 3, fan=9 * co)
    fn = getattr(KT, wrapper)
    K.reset_launch_counts()
    got = fn(gr, wt)
    assert K.launch_counts() == _only(**{wrapper: 1})
    assert got.shape == (b, hg + 2, wg + 2, ci) and got.dtype == torch.bfloat16
    _close(got, KT.conv3x3_dgrad_plain(gr.float(), wt))
    again = fn(gr, wt)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


# ------------------------------------------------- the stem's row kernel


@pytest.mark.parametrize("b,h,w,co,pool,relu", [
    (2, 37, 45, 64, True, True), (1, 20, 19, 128, False, True), (3, 9, 7, 64, True, False),
    (1, 3, 3, 64, True, True), (2, 140, 300, 64, True, True), (1, 4, 131, 192, True, False),
    (1, 35, 258, 64, False, False),
])
def test_stem_row_kernel(g, b, h, w, co, pool, relu):
    """The stem's row kernel at its edges: the pool on odd sizes (floor)
    and on a 1-row output (no pooled pixel), relu on and off, 64-192 output
    channels, outputs wider than one 128-column strip with a ragged last
    one; one launch counted, the same bits on a second launch, and the
    plain version within the bound."""
    x = _act(g, b, h, w, 1)
    wt, bias = _w(g, co, 1, 3, 3, fan=9 * co), _b(g, co)
    K.reset_launch_counts()
    got = K.conv3x3_bias_relu(x, wt, bias, fuse_pool=pool, relu=relu)
    assert K.launch_counts() == _only(conv3x3_bias_relu=1)
    again = K.conv3x3_bias_relu(x, wt, bias, fuse_pool=pool, relu=relu)
    torch.cuda.synchronize()
    pairs = list(zip(got, again)) if pool else [(got, again)]
    for a, r in pairs:
        assert a.shape == r.shape and torch.equal(a, r)
    if pool:
        assert got[1].shape == (b, (h - 2) // 2, (w - 2) // 2, co)
    # F.max_pool2d refuses a 1x1 map: the 1-row case's pool is held to its
    # (empty) shape above
    pool_plain = pool and h > 3 and w > 3
    plain = K.conv3x3_bias_relu_plain(x.float(), wt, bias, fuse_pool=pool_plain, relu=relu)
    for a, r in zip(got, plain) if pool_plain else [(got[0] if pool else got, plain)]:
        _close(a, r)


def _spiral(n):
    m = torch.zeros(n, n, dtype=torch.uint8)
    m[0, :] = m[:, -1] = m[-1, :] = 1
    m[2:, 0] = 1
    return m


def test_label_components_on_the_card_equal_the_cpu(g):
    """The label propagation on the card equals its CPU result bit for bit:
    random masks, an unconverged spiral at the cap and a converged one;
    Predictor.labels_device on the card is the propagation of its own
    thresholded probabilities."""
    from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
    from unetseg_tpu_torch.infer.engine import Predictor
    from unetseg_tpu_torch.models.fast_init import fast_random_variables
    from unetseg_tpu_torch.post.cc_device import label_components_device, propagate_labels

    masks = torch.rand(3, 130, 97, generator=g, device="cuda") > 0.55
    got = label_components_device(masks)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), label_components_device(masks.cpu()))
    spiral = _spiral(64)[None]
    for cap in (50, 4096):
        lab, iters = propagate_labels(spiral.cuda(), cap)
        lab_cpu, iters_cpu = propagate_labels(spiral, cap)
        assert torch.equal(lab.cpu(), lab_cpu) and iters == iters_cpu
    assert iters < 4096
    pred = Predictor(ModelConfig(), fast_random_variables(ModelConfig(), 0), InferConfig(),
                     "cuda")
    imgs = torch.rand(2, 252, 252, generator=g, device="cuda").cpu().numpy()
    fg = (pred.probs(imgs) > pred.cfg.threshold).cpu()
    assert torch.equal(torch.from_numpy(pred.labels_device(imgs)), label_components_device(fg))


def test_ensemble_vote_on_the_card(g):
    """A 3-member vote ensemble at full width on the card: each member
    through the default serving kernels (counted), the merged probabilities
    the strict majority of the members' thresholded probabilities, bit for
    bit, and masks_tiled through the same merge."""
    from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
    from unetseg_tpu_torch.infer.engine import Predictor
    from unetseg_tpu_torch.infer.tiling import extract_tiles, mirror_pad, plan_tiles
    from unetseg_tpu_torch.models.fast_init import fast_random_variables

    cfg = ModelConfig()
    icfg = InferConfig(ensemble_merge="vote", tile_input=252, tile_batch=2)
    members = [fast_random_variables(cfg, s) for s in (0, 1, 2)]
    ens = Predictor(cfg, members, icfg, "cuda")
    imgs = torch.rand(2, 252, 252, generator=g, device="cuda").cpu().numpy()
    K.reset_launch_counts()
    got = ens.probs(imgs)
    torch.cuda.synchronize()
    per_member = {"conv3x3_bias_relu": 13, "tconv2x2_bias": 4, "dec_conv0": 4, "conv3x3_head": 1}
    assert K.launch_counts() == _only(**{k: 3 * v for k, v in per_member.items()})
    votes = sum((Predictor(cfg, v, icfg, "cuda").probs(imgs) > icfg.threshold).int()
                for v in members)
    assert torch.equal(got, (votes * 2 > 3).float())
    frames = imgs[:, :68, :68]  # one 252^2 tile each, one chunk of two
    grid = plan_tiles(68, 68, 252)
    tiles = extract_tiles(mirror_pad(torch.from_numpy(frames), grid), grid)[:, 0]
    want = (ens.probs(tiles.numpy()) > icfg.threshold).to(torch.uint8).cpu().numpy()
    masks = ens.masks_tiled(frames)
    assert masks.shape == (2, 68, 68) and (masks == want).all() and 0 < masks.mean() < 1


def test_pipeline_on_the_card(g, tmp_path):
    """The pipeline command on the card at base 8 (the plain forward and
    train step on CUDA tensors; the elastic sampler and the weighted CE
    through their kernels) over chip_smoke's synthetic CTC sequence: exit
    code 0, its scores in [0, 1] and equal to the evaluate-ctc command's."""
    import contextlib
    import io
    import json
    import os

    import numpy as np

    from chip_smoke import ctc_sequence, write_ctc_root
    from unetseg_tpu_torch.cli.main import main

    frames, labels, rows = ctc_sequence(np.random.RandomState(3), 8, 252)
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    write_ctc_root(root, frames, labels, rows)
    conf = tmp_path / "tiny.json"
    conf.write_text(json.dumps({
        "model": {"base_features": 8},
        "train": {"num_epochs": 1, "batch_size": 2},
        "infer": {"tile_input": 252, "tile_batch": 4, "min_cell_size": 100},
    }))
    K.reset_launch_counts()
    assert main(["pipeline", "--config", str(conf), "--data-root", root, "--output-dir",
                 out]) == 0
    counts = K.launch_counts()
    # 8 frames leave no validation split: 4 steps of 2
    assert counts["sample_displaced"] == counts["weighted_ce_fwd"] == 4
    with open(os.path.join(out, "summary.json")) as fh:
        summary = json.load(fh)["01"]
    alone = {}
    for measure, sub in (("seg", "SEG"), ("tra", "TRA")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["evaluate-ctc", measure, "--gt-dir", os.path.join(root, "01_GT", sub),
                         "--res-dir", os.path.join(out, "01_CTC")]) == 0
        alone.update(json.loads(buf.getvalue().strip().splitlines()[-1]))
    for k in ("SEG", "TRA", "DET"):
        assert 0.0 <= summary[k] <= 1.0 and summary[k] == alone[k]


DP_WORKER = '''
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
from unetseg_tpu_torch.core import distributed as D
from unetseg_tpu_torch.core.config import InferConfig, MeshConfig, ModelConfig
from unetseg_tpu_torch.core.mesh import make_mesh
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.train.state import create_train_state
from unetseg_tpu_torch.train.steps import draw_augment, make_train_step

rank, work = int(sys.argv[2]), sys.argv[3]
D.maybe_initialize(f"file://{work}/rendezvous", 2, rank, local_device_ids=[0])
mesh = make_mesh(MeshConfig())
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True  # the doubled pair compares bits
dev, cfg = mesh.device, ModelConfig(base_features=8, compute_dtype="float32")
frames, labels = cs.cell_frames(np.random.RandomState(3), 4, 252, labels=True)
images, masks = torch.from_numpy(frames).to(dev), torch.from_numpy(labels).to(dev)
wts = torch.ones_like(images)
rows = mesh.batch_rows(4)
state = create_train_state(fast_random_variables(cfg, 0), cfg, cs.RECIPE_TRAIN, device=dev)
out = {"backend": torch.distributed.get_backend(), "device": str(dev)}
for i, (name, all_valid) in enumerate((("full", True), ("masked", False))):
    valid = torch.ones(4, dtype=torch.bool, device=dev)
    valid[-1] = all_valid
    draws = draw_augment(torch.Generator(device=dev).manual_seed(10 + i), images, True,
                         cs.RECIPE["aug_gamma"], cs.RECIPE["aug_illum"], cs.RECIPE["aug_noise"])
    local = (images[rows], masks[rows], wts[rows], valid[rows])
    step = make_train_step(cfg, assume_valid=all_valid, mesh=mesh, **cs.RECIPE)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    new, m = step(state, *local, draws=draws)
    torch.cuda.synchronize()
    rec = {"launches": {k: v for k, v in K.launch_counts().items() if v},
           "digest": D.tensor_digest(new.params)}
    _, _, grads = cs.dp_grads(cfg, state, *local, draws, False, mesh, kernels=False)
    if rank == 0:
        new1, m1 = make_train_step(cfg, assume_valid=all_valid, **cs.RECIPE)(
            state, images, masks, wts, valid, draws=draws)
        _, _, grads1 = cs.dp_grads(cfg, state, images, masks, wts, valid, draws, False, None,
                                   kernels=False)
        rec.update(cs.dp_compare(name, (float(m["loss"]), float(m["grad_norm"]), grads,
                                        new.batch_stats),
                                 (float(m1["loss"]), float(m1["grad_norm"]), grads1,
                                  new1.batch_stats)))
    # the same two items on both ranks: one process on them, bit for bit
    pair = (images[:2], masks[:2], wts[:2], valid[2:])
    new2, m2 = step(state, *pair, draws=cs.doubled(draws.rows(slice(0, 2))))
    rec["digest_doubled"] = D.tensor_digest(new2.params)
    if rank == 0:
        new1, m1 = make_train_step(cfg, assume_valid=all_valid, **cs.RECIPE)(
            state, *pair, draws=draws.rows(slice(0, 2)))
        assert float(m2["loss"]) == float(m1["loss"]) and cs.doubled_equal(new2, new1), name
    out[name] = rec
scfg = ModelConfig()  # the serving kernels take base 64 in bf16
variables = cs.plant_intensity_path(fast_random_variables(scfg, 0))
frames = cs.cell_frames(np.random.RandomState(0), 4, 120)
icfg = InferConfig(tile_input=252, tile_batch=8)
K.reset_launch_counts()
got = Predictor(scfg, variables, icfg, dev, mesh=mesh).masks_tiled(frames)
out["serving"] = {k: v for k, v in K.launch_counts().items() if v}
out["foreground"] = float(got.mean())
want = Predictor(scfg, variables, icfg, dev).masks_tiled(frames)
out["masks_differ"] = int((got != want).sum())
D.shutdown()
with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
'''


def test_data_parallel_on_the_card(g, tmp_path):
    """Two ranks on the one card over gloo (nccl refuses two ranks on one
    card) at base 8 in fp32, as chip_smoke.py's phase 12's fp32 step: the
    augmented data-parallel step (the plain forward; the elastic sampler
    and the weighted CE through their kernels on each rank's share, the
    update and the recipe's EMA through theirs on every rank), with
    every item valid and with [T, T, T, F], held to the single-process
    step on the card with the same draws by chip_smoke.dp_compare (loss
    and grad_norm 2e-3 relative, the whole gradient 1e-2 relative L2,
    statistics 1e-3), and, with the same two items on both ranks, equal
    to one process on those two items (chip_smoke.doubled_equal); both
    ranks' parameters bit for bit equal; and tile-sharded
    masks_tiled (4 frames of 120^2, 4 tiles of 252^2 a frame, chunks of 8
    split 4 + 4; the kernel forward, full width) equal to one rank's
    masks bit for bit (its kernels sum each output in one order whatever
    the batch)."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(DP_WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), repo, str(rank), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    res = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert res[0]["backend"] == "gloo" and res[0]["device"] == "cuda:0"
    for name in ("full", "masked"):
        for key in ("digest", "digest_doubled"):
            assert res[0][name][key] == res[1][name][key]
        for r in res:
            assert r[name]["launches"] == {"sample_displaced": 1, "weighted_ce_fwd": 1,
                                           "weighted_ce_bwd": 1, "fused_update": 1,
                                           "fused_ema": 2}
    per_rank = {"conv3x3_bias_relu": 26, "tconv2x2_bias": 8, "dec_conv0": 8, "conv3x3_head": 2}
    for r in res:
        assert r["masks_differ"] == 0 and 0 < r["foreground"] < 1
        assert r["serving"] == per_rank  # two chunks of 8, 4 tiles a rank


@pytest.mark.parametrize("image_size", [188, 252])
def test_export_and_load_on_the_card(g, tmp_path, image_size):
    """The full-width default serving forward exported on the card with a
    symbolic batch, loaded on the card and on the CPU: on the card each
    call at batches 1, 3 and 5 launches the four serving kernels (13, 4,
    4, 1) and equals Predictor.probs bit for bit; on the CPU the same
    artifact equals the CPU Predictor; a batch pinned to 2 refuses 3."""
    from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
    from unetseg_tpu_torch.infer.engine import Predictor
    from unetseg_tpu_torch.infer.export import export_inference, load_exported, save_exported
    from unetseg_tpu_torch.models.fast_init import fast_random_variables

    cfg, icfg = ModelConfig(), InferConfig(image_size=image_size)
    v = fast_random_variables(cfg, 4)
    path = str(tmp_path / "serving.pt2")
    save_exported(path, export_inference(cfg, v, icfg, device="cuda"))
    fn = load_exported(path, device="cuda")
    pred = Predictor(cfg, v, icfg, "cuda")
    imgs = torch.rand(5, image_size, image_size, generator=g, device="cuda").cpu().numpy()
    per_call = {"conv3x3_bias_relu": 13, "tconv2x2_bias": 4, "dec_conv0": 4, "conv3x3_head": 1}
    for b in (1, 3, 5):
        K.reset_launch_counts()
        got = fn(imgs[:b])
        torch.cuda.synchronize()
        assert K.launch_counts() == _only(**per_call)
        assert got.is_cuda and torch.equal(got, pred.probs(imgs[:b]))
    on_cpu = load_exported(path, device="cpu")
    assert torch.equal(on_cpu(imgs[:1]), Predictor(cfg, v, icfg, "cpu").probs(imgs[:1]))
    pinned = str(tmp_path / "pinned.pt2")
    save_exported(pinned, export_inference(cfg, v, icfg, batch=2, device="cuda"))
    fn2 = load_exported(pinned)
    assert torch.equal(fn2(imgs[:2]), pred.probs(imgs[:2]))
    with pytest.raises(Exception):
        fn2(imgs[:3])


def test_augmentation_arrays_on_the_card(g):
    """visualize-augmentation's deformation on the card: one
    sample_displaced launch, the image within 1e-5 of the plain sampler on
    the card's coordinates and the labels equal to its labels."""
    from unetseg_tpu_torch.cli.main import augmentation_arrays
    from unetseg_tpu_torch.ops.elastic import displaced_coords, draw_elastic

    img = torch.rand(97, 131, generator=g, device="cuda").cpu().numpy()
    lab = (torch.rand(97, 131, generator=g, device="cuda") * 5).int().cpu().numpy()
    K.reset_launch_counts()
    di, dm = augmentation_arrays(img, lab, 300.0, 8.0, 3, "cuda")
    torch.cuda.synchronize()
    assert K.launch_counts() == _only(sample_displaced=1)
    u = draw_elastic(torch.Generator().manual_seed(3), 1, 97, 131).cuda()
    yy, xx = displaced_coords(u, 300.0, 8.0)
    ref_img, ref_lab = KE.sample_displaced_plain(torch.from_numpy(img).cuda()[None],
                                                 torch.from_numpy(lab).cuda()[None], yy, xx)
    assert abs(di - ref_img[0].cpu().numpy()).max() <= 1e-5
    assert (dm == ref_lab[0].cpu().numpy()).all()


# ---- the train step's update (csrc/fused_update.cu)

UPDATE_KINDS = ("sgd", "adam", "adamw")


def _update_state(kind, cfg=None):
    """A state on the card with the kind's recipe and the EMA on."""
    from unetseg_tpu_torch.core.config import ModelConfig, TrainConfig
    from unetseg_tpu_torch.train.state import create_train_state

    tcfg = TrainConfig(optimizer=kind, learning_rate=0.01 if kind == "sgd" else 3e-4,
                       cosine_decay=kind != "sgd", num_epochs=80, ema_decay=0.999,
                       weight_decay=0.01 if kind == "adamw" else 0.0)
    return create_train_state(0, cfg or ModelConfig(), tcfg, steps_per_epoch=38, device="cuda")


def _update_feed(g, state, n):
    return [({k: torch.randn(v.shape, generator=g, device="cuda") * 1e-2
              for k, v in state.params.items()},
             {k: torch.rand(v.shape, generator=g, device="cuda")
              for k, v in state.batch_stats.items()}) for _ in range(n)]


def _run_updates(state, feed):
    from unetseg_tpu_torch.train.state import Gradients
    from unetseg_tpu_torch.train.steps import optax_global_norm

    states, norms = [], []
    for grads, stats in feed:
        gr = Gradients(grads)
        state = state.apply_gradients(gr, stats)
        states.append(state)
        norms.append(optax_global_norm(gr))
    torch.cuda.synchronize()
    return states, norms


def _state_trees(s):
    return {"params": s.params, "ema_params": s.ema_params, "ema_batch_stats": s.ema_batch_stats,
            **{m: s.opt_state[m] for m in s.tx.moments}}


@pytest.mark.parametrize("kind", UPDATE_KINDS)
def test_fused_update_equals_the_plain_update(g, kind, monkeypatch):
    """At the full unet-r15-c2 parameter tree (31,042,434 parameters, 82
    leaves), three steps with the EMA on: the kernels' parameters, moments
    and both shadows equal the plain `_foreach` path's on the card bit for
    bit, grad_norm within 1e-6 relative; one fused_update and two fused_ema
    launches a step, none on the plain path."""
    import unetseg_tpu_torch.train.state as S

    state0 = _update_state(kind)
    assert sum(v.numel() for v in state0.params.values()) == 31_042_434
    feed = _update_feed(g, state0, 3)
    K.reset_launch_counts()
    got, got_norms = _run_updates(state0, feed)
    assert K.launch_counts() == _only(fused_update=3, fused_ema=6)
    monkeypatch.setattr(S, "_flat_route", lambda tree: False)
    want, want_norms = _run_updates(state0, feed)
    assert K.launch_counts() == _only(fused_update=3, fused_ema=6)
    for i, (a, b) in enumerate(zip(got, want)):
        for name, tree in _state_trees(a).items():
            ref = _state_trees(b)[name]
            bad = [k for k in ref if not torch.equal(tree[k], ref[k])]
            assert not bad, f"{kind} step {i} {name}: {bad[:5]}"
    for a, b in zip(got_norms, want_norms):
        assert abs(a.item() - b.item()) <= 1e-6 * b.item()


@pytest.mark.parametrize("kind", UPDATE_KINDS)
def test_fused_update_edges(g, kind, monkeypatch):
    """150 leaves (two launches' tables), sizes off the float4 and block
    grids, an empty leaf, leaves over several blocks, gradients and EMA
    targets read at misaligned addresses: bit for bit against the plain
    path; a channels-last and a transposed gradient are made contiguous,
    counted, and give the bits of their contiguous copies."""
    import unetseg_tpu_torch.train.state as S
    from unetseg_tpu_torch.ops.kernels.update import fused_update, is_packed

    sizes = [(0,)] + [(int(n),) for n in torch.randint(1, 9000, (146,), generator=g,
                                                        device="cuda").tolist()]
    sizes += [(64, 32, 3, 3), (3,), (5, 7)]
    params = {f"l{i}": torch.randn(s, generator=g, device="cuda") for i, s in enumerate(sizes)}
    opt = S.Optimizer(kind, 1e-2, weight_decay=0.01 if kind == "adamw" else 0.0)
    state = opt.init(params)

    def misaligned(tree):
        """A copy of `tree` whose leaves lie one float apart in one buffer."""
        buf = torch.empty(sum(v.numel() + 1 for v in tree.values()) + 1, device="cuda")
        out, at = {}, 1
        for k, v in tree.items():
            out[k] = buf[at:at + v.numel()].view(v.shape).copy_(v)
            at += v.numel() + 1
        return out

    feed = [misaligned({k: torch.randn(v.shape, generator=g, device="cuda")
                        for k, v in params.items()}) for _ in range(2)]
    runs = {}
    for route in (True, False):
        monkeypatch.setattr(S, "_flat_route", lambda tree, route=route: route)
        p, st, shadow = params, state, {k: v.clone() for k, v in params.items()}
        for grads in feed:
            p, st = opt.apply(p, grads, st)
            shadow = S._ema(shadow, misaligned(p), 0.25)
        runs[route] = (p, st, shadow)
    torch.cuda.synchronize()
    assert is_packed(runs[True][0]) and not is_packed(runs[False][0])
    (kp, kst, ks), (pp, pst, ps) = runs[True], runs[False]
    for name, a, b in [("params", kp, pp), ("shadow", ks, ps),
                       *[(m, kst[m], pst[m]) for m in opt.moments]]:
        bad = [k for k in b if not torch.equal(a[k], b[k])]
        assert not bad, f"{kind} {name}: {bad[:5]}"

    monkeypatch.setattr(S, "_flat_route", lambda tree: True)
    grads = feed[0]
    strided = dict(grads, l147=grads["l147"].contiguous(memory_format=torch.channels_last),
                   l149=grads["l149"].t().contiguous().t())
    assert not strided["l149"].is_contiguous()
    before = fused_update.restrided
    a, _ = opt.apply(params, grads, state)
    b, _ = opt.apply(params, strided, state)
    torch.cuda.synchronize()
    assert fused_update.restrided == before + 2
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_update_makes_no_host_sync(g):
    """Packing a fresh state, then two steps of Adam with the EMA, under
    torch.cuda.set_sync_debug_mode("error"): nothing waits on the card."""
    from unetseg_tpu_torch.ops.kernels.build import library
    from unetseg_tpu_torch.train.state import Gradients
    from unetseg_tpu_torch.train.steps import optax_global_norm

    library()
    state = _update_state("adam")
    feed = _update_feed(g, state, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for grads, stats in feed:
            gr = Gradients(grads)
            state = state.apply_gradients(gr, stats)
            norm = optax_global_norm(gr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert norm.is_cuda and norm.dim() == 0 and state.step == 2
    assert torch.isfinite(norm).item()


# ---- the train step's BatchNorm+ReLU (csrc/bn_relu.cu)
# the recipe step's 18 BatchNorms at batch 4 and 512^2: (side, channels)
BN_SHAPES = [(510, 64), (508, 64), (252, 128), (250, 128), (123, 256), (121, 256),
             (58, 512), (56, 512), (26, 1024), (24, 1024), (46, 512), (44, 512),
             (86, 256), (84, 256), (166, 128), (164, 128), (326, 64), (324, 64)]
# Tolerances against the plain version run in f32 on the same bf16 inputs:
# the kernels round once, at the bf16 store (at most 2^-8 of the value); the
# f32 sums of the two routes are added in other orders (under 1e-6 of the
# sum of magnitudes at these sizes), which BN_SCALE of each element's
# magnitudes covers with room; where t = a z + b lies within that of 0 the
# ReLU's gate may fall either way (never at an exact 0: both give the tie
# there), and such elements (BN_GATE of the magnitudes, a few in 1e5) are
# counted, not compared.
BN_REL, BN_SCALE, BN_GATE, BN_SUMS = 2.0**-8, 2.0**-12, 2.0**-16, 1e-4


def _bn_inputs(g, b, side, c, mask=None):
    d = dict(device="cuda")
    mu, sd = torch.rand(c, generator=g, **d) * 2 - 1, torch.rand(c, generator=g, **d) * 1.5 + 0.5
    z = (mu + sd * torch.randn(b, side, side, c, generator=g, **d)).to(torch.bfloat16)
    gamma = torch.rand(c, generator=g, **d) + 0.5
    beta = torch.rand(c, generator=g, **d) - 0.5
    rm, rv = torch.rand(c, generator=g, **d), torch.rand(c, generator=g, **d) + 1.0
    gy = (0.1 * torch.randn(b, side, side, c, generator=g, **d)).to(torch.bfloat16)
    ct = 1e-3 * torch.randn(2, c, generator=g, **d)
    return z, gamma, beta, rm, rv, mask, gy, ct[0], ct[1]


def _bn_kernel(z, gamma, beta, rm, rv, mask, gy, ctm, ctv, group=None):
    from unetseg_tpu_torch.ops.kernels import bn_relu as BN

    y, nm, nv, saved = BN.bn_relu_fwd(z, gamma, beta, rm, rv, mask, 0.9, 1e-5, group)
    grads = BN.bn_relu_bwd(gy, z, gamma, mask, saved, ctm, ctv, 0.9, group)
    return (y, nm, nv, saved, *grads)


def _bn_plain(z, gamma, beta, rm, rv, mask, gy, ctm, ctv):
    from unetseg_tpu_torch.ops.kernels import bn_relu as BN

    y, nm, nv, saved = BN.bn_relu_fwd_plain(z, gamma, beta, rm, rv, mask, 0.9, 1e-5)
    return (y, nm, nv, saved,
            *BN.bn_relu_bwd_plain(gy, z, gamma, mask, saved, ctm, ctv, 0.9))


def _bn_check(z, gamma, beta, rm, rv, mask, gy, ctm, ctv):
    """The kernels against the plain version in f32 (BN_REL, BN_SCALE,
    BN_SUMS), no farther from it than the plain version in bf16, and the
    same bits on a second run."""
    from unetseg_tpu_torch.ops.kernels import bn_relu as BN

    args = (z, gamma, beta, rm, rv, mask, gy, ctm, ctv)
    k = _bn_kernel(*args)
    again = _bn_kernel(*args)
    f = _bn_plain(z.float(), gamma, beta, rm, rv, mask, gy.float(), ctm, ctv)
    p = _bn_plain(*args)
    torch.cuda.synchronize()
    names = ("y", "new_mean", "new_var", "saved", "dz", "dgamma", "dbeta", "d_mean", "d_var")
    assert all(torch.equal(a, b) for a, b in zip(k, again)), \
        [n for n, a, b in zip(names, k, again) if not torch.equal(a, b)]
    assert BN.bn_relu_fwd.launches > 0 and BN.bn_relu_bwd.launches > 0

    ref = dict(zip(BN.SAVED, f[3].unbind(0)))
    zf, gyf = z.float(), gy.float()
    t = torch.addcmul(ref["b"], zf, ref["a"])
    mag = (zf * ref["a"]).abs() + ref["b"].abs()
    gate = (t.abs() <= BN_GATE * mag) & (t != 0)
    assert gate.float().mean().item() < 1e-3, gate.float().mean().item()

    def close(name, got, want, scale, skip=None):
        err = (got.float() - want.float()).abs()
        bad = err > BN_REL * want.float().abs() + BN_SCALE * scale
        if skip is not None:
            bad &= ~skip
        assert not bad.any(), f"{name}: {int(bad.sum())} elements, worst {err.max().item():.3e}"

    close("y", k[0], f[0], mag, gate)
    gp = gyf * BN._tie(t)
    stat = (f[4] - gp * ref["a"]).abs().amax(dim=(0, 1, 2))
    close("dz", k[4], f[4], (gp * ref["a"]).abs() + stat, gate)
    dims = (0, 1, 2)
    g_abs = gyf.abs().sum(dims)
    gz_abs = ((gyf * zf).abs().sum(dims) + ref["mean"].abs() * g_abs) * ref["inv"]
    for name, got, want, scale in (("dbeta", k[6], f[6], g_abs), ("dgamma", k[5], f[5], gz_abs)):
        assert ((got - want).abs() <= BN_SUMS * scale).all(), name
    spread = ref["var_raw"].clamp_min(0).sqrt() + ref["mean"].abs() + 1
    for name, got, want in (("new_mean", k[1], f[1]), ("new_var", k[2], f[2]),
                            ("mean", k[3][2], ref["mean"]), ("a", k[3][0], ref["a"]),
                            ("b", k[3][1], ref["b"])):
        assert ((got - want).abs() <= 1e-5 * spread * (1 + want.abs())).all(), name
    assert torch.equal(k[7], f[7]) and torch.equal(k[8], f[8])  # 0.9 x the cotangents
    # closer to the f32 version than the plain version in bf16 is
    for i, name in ((0, "y"), (4, "dz"), (5, "dgamma"), (6, "dbeta")):
        assert (k[i].float() - f[i]).norm() <= (p[i].float() - f[i]).norm(), name
    return k


@pytest.mark.parametrize("side,c", BN_SHAPES, ids=[f"{s}x{c}" for s, c in BN_SHAPES])
def test_bn_relu_at_the_recipe_shapes(g, side, c):
    """The BatchNorm+ReLU kernels at each of the recipe step's 18 shapes
    against the plain version: y, the new running statistics, dz, dgamma,
    dbeta and the running statistics' cotangents; the same bits twice."""
    _bn_check(*_bn_inputs(g, 4, side, c))


def test_bn_relu_masked_item(g):
    """A masked item leaves the statistics, never multiplied: NaN there
    gives the same statistics, bit for bit, as finite values."""
    mask = torch.tensor([True, False, True, True], device="cuda")
    args = list(_bn_inputs(g, 4, 252, 128, mask))
    args[0][1] = (3 * args[0][1].float()).to(torch.bfloat16)
    k = _bn_check(*args)
    args[0] = args[0].clone()
    args[0][1] = float("nan")
    from unetseg_tpu_torch.ops.kernels import bn_relu as BN

    _, nm, nv, saved = BN.bn_relu_fwd(*args[:6], 0.9, 1e-5)
    assert torch.equal(nm, k[1]) and torch.equal(nv, k[2]) and torch.equal(saved, k[3])
    assert saved[BN.SAVED.index("n")][0].item() == 3 * 252 * 252


def test_bn_relu_exact_ties(g):
    """Exact zeros of t = a z + b take the tie (0.5) in both routes: a
    channel of zeros with beta 0 (zero variance too), and a channel of
    -1, 0, 1 whose mean is exactly 0, with beta 0."""
    z, gamma, beta, rm, rv, _, gy, ctm, ctv = _bn_inputs(g, 4, 60, 64)
    beta[:2] = 0
    z[..., 0] = 0
    v = torch.randint(-1, 2, (2, 60, 60), generator=g, device="cuda").to(torch.bfloat16)
    z[..., 1] = torch.cat([v, -v])
    k = _bn_check(z, gamma, beta, rm, rv, None, gy, ctm, ctv)
    from unetseg_tpu_torch.ops.kernels import bn_relu as BN

    assert k[3][BN.SAVED.index("var_raw")][0].item() == 0.0
    assert not k[0][..., 0].any()
    gyf, zf = gy.float(), z.float()
    tie = (zf[..., :2] > 0).float() + 0.5 * (zf[..., :2] == 0).float()
    want = (gyf[..., :2] * tie).sum((0, 1, 2))  # dbeta = sum gy x the ReLU's tie
    assert ((k[6][:2] - want).abs() <= BN_SUMS * gyf[..., :2].abs().sum((0, 1, 2))).all()


def test_bn_relu_group_of_equal_ranks(g, monkeypatch):
    """The group route (4 launches each way) where every rank holds the
    same items (the sum over the group stood in for by twice the value):
    the moments, y, dz, dgamma and dbeta bit for bit those of one process,
    the running variance apart by its unbiasing n / (n - 1) alone."""
    from unetseg_tpu_torch.ops.kernels import bn_relu as BN

    monkeypatch.setattr(BN, "all_reduce_sum", lambda t, group: 2 * t)
    for mask in (None, torch.tensor([True, True, False, True], device="cuda")):
        args = _bn_inputs(g, 4, 123, 256, mask)
        one = _bn_kernel(*args)
        two = _bn_kernel(*args, group="stand-in")
        for i in (0, 4, 5, 6, 7, 8):
            assert torch.equal(one[i], two[i]), i
        for row in ("a", "b", "mean", "inv", "var_raw"):
            j = BN.SAVED.index(row)
            assert torch.equal(one[3][j], two[3][j]), row
        n = one[3][BN.SAVED.index("n")][0].item()
        torch.testing.assert_close(two[3][BN.SAVED.index("n")], 2 * one[3][BN.SAVED.index("n")])
        var = one[3][BN.SAVED.index("var_raw")].clamp_min(0)
        torch.testing.assert_close(two[2], 0.9 * args[4] + 0.1 * var * 2 * n / (2 * n - 1))


def test_bn_relu_strided_and_refused_inputs(g):
    """A strided activation is copied (counted) and gives the same bits;
    what the kernels do not take raises."""
    from unetseg_tpu_torch.ops.kernels import bn_relu as BN

    z, gamma, beta, rm, rv, _, gy, ctm, ctv = _bn_inputs(g, 2, 20, 64)
    want = _bn_kernel(z, gamma, beta, rm, rv, None, gy, ctm, ctv)
    zs = z.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not zs.is_contiguous()
    before = BN.bn_relu_fwd.restrided
    got = _bn_kernel(zs, gamma, beta, rm, rv, None, gy, ctm, ctv)
    assert BN.bn_relu_fwd.restrided == before + 1
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    with pytest.raises(TypeError, match="bfloat16"):
        BN.bn_relu_fwd(z.float(), gamma, beta, rm, rv)
    with pytest.raises(ValueError, match="multiple of 8"):
        BN.bn_relu_fwd(z[..., :60], gamma[:60], beta[:60], rm[:60], rv[:60])
    with pytest.raises(ValueError, match="different devices"):
        BN.bn_relu_fwd(z, gamma, beta, rm, rv, torch.ones(2, dtype=torch.bool))


def test_bn_relu_makes_no_host_sync(g):
    """Forward and backward under set_sync_debug_mode("error"), masked and
    not: nothing waits on the card."""
    from unetseg_tpu_torch.ops.fused_bn import bn_relu_nhwc
    from unetseg_tpu_torch.ops.kernels.build import library

    library()
    for mask in (None, torch.tensor([True, False], device="cuda")):
        z, gamma, beta, rm, rv, _, gy, _, _ = _bn_inputs(g, 2, 30, 128)
        z.requires_grad_(True)
        gamma.requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, _, _ = bn_relu_nhwc(z, gamma, beta, rm, rv, 0.9, 1e-5, mask)
            dz, dgamma = torch.autograd.grad(y, (z, gamma), gy)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert dz.dtype == torch.bfloat16 and dgamma.dtype == torch.float32
        assert torch.isfinite(dz.float()).all() and torch.isfinite(dgamma).all()


# ------------------------------------------------- the gated net's gate kernels
def _gate_levels():
    """(id, (B, skip S, g h, F, offset)) of each gate of the gated serving
    forward at both serving cells' tile sizes (700^2: offsets 4, 16, 40,
    88; 512^2: 4, 16, 41, 90 over odd and ragged g sizes)."""
    from unetseg_tpu_torch.models.shapes import unet_shapes

    out = []
    for cell, size in (("700", 700), ("512", 512)):
        enc = unet_shapes(size).encoder
        h = enc[4]
        for i in range(4):
            skip, f = enc[3 - i], 512 >> i
            out.append((f"{cell}-gate{i}", (2, skip, h, f, (skip - 2 * h) // 2)))
            h = 2 * h - 4
    return out


# alpha: f32 sums of the same bf16 products in another order over K = 6F
# <= 3072 terms, then psi's f32 dot: ~1e-6 of alpha's range
ALPHA_ATOL = 1e-4


@pytest.mark.parametrize("shape", [c[1] for c in _gate_levels()],
                         ids=[c[0] for c in _gate_levels()])
def test_attn_gate_at_the_serving_shapes(g, shape):
    """The gate kernel at each level's published widths and the 700^2 and
    512^2 tile shapes against its plain version on the same bf16 operands
    (TF32 off): alpha within ALPHA_ATOL, with psi scaled so that alpha
    spreads over (0, 1); the apply kernel against the plain apply of the
    kernel's alpha within one bf16 step (2^-7 of the value: the bilinear
    weights' f32 products may round apart before the bf16 rounding); one
    launch each, the same bits twice."""
    from unetseg_tpu_torch.ops.kernels import attn_gate as G

    b, s, h, f, off = shape
    n = f // 2
    skip, gg = _act(g, b, s, s, f), _act(g, b, h, h, 2 * f)
    wx, wg = _w(g, n, f, 2, 2, fan=4 * n), _w(g, n, 2 * f, 1, 1, fan=n)
    bg = _b(g, n)
    psi = torch.randn(1, n, 1, 1, generator=g, device="cuda") * (0.5 / n**0.5)
    bpsi = torch.full((1,), 0.5, device="cuda")
    K.reset_launch_counts()
    alpha = G.attn_gate(skip, gg, wx, wg, bg, psi, bpsi, off, off)
    x_hat = G.attn_gate_apply(skip, alpha, off, off)
    torch.cuda.synchronize()
    assert K.launch_counts()["attn_gate"] == K.launch_counts()["attn_gate_apply"] == 1
    want = G.attn_gate_plain(skip, gg, wx, wg, bg, psi, bpsi, off, off)
    assert alpha.shape == (b, h, h) and bool(torch.isfinite(alpha).all())
    assert 0.02 < alpha.std().item(), "alpha saturated: the comparison would be blind"
    err = (alpha - want).abs().max().item()
    assert err <= ALPHA_ATOL, err
    ref = G.attn_gate_apply_plain(skip, alpha, off, off).float()
    assert x_hat.shape == (b, 2 * h, 2 * h, f) and x_hat.dtype == torch.bfloat16
    assert bool(((x_hat.float() - ref).abs() <= ref.abs() * 2.0**-7 + 1e-30).all())
    assert torch.equal(G.attn_gate(skip, gg, wx, wg, bg, psi, bpsi, off, off), alpha)
    assert torch.equal(G.attn_gate_apply(skip, alpha, off, off), x_hat)


def test_attn_gate_refuses_what_the_kernels_do_not_take(g):
    from unetseg_tpu_torch.ops.kernels import attn_gate as G

    f, n = 32, 16  # a width the kernel does not take
    skip, gg = _act(g, 1, 20, 20, f), _act(g, 1, 8, 8, 2 * f)
    args = (_w(g, n, f, 2, 2, fan=4), _w(g, n, 2 * f, 1, 1, fan=1), _b(g, n),
            torch.ones(1, n, 1, 1, device="cuda"), torch.zeros(1, device="cuda"))
    with pytest.raises(ValueError, match="skip channels"):
        G.attn_gate(skip, gg, *args, 2, 2)
    skip, gg = _act(g, 1, 20, 20, 64), _act(g, 1, 8, 8, 128)
    args = (_w(g, 32, 64, 2, 2, fan=4), _w(g, 32, 128, 1, 1, fan=1), _b(g, 32),
            torch.ones(1, 32, 1, 1, device="cuda"), torch.zeros(1, device="cuda"))
    with pytest.raises(ValueError, match="leaves skip"):
        G.attn_gate(skip, gg, *args, 5, 2)  # 5 + 16 > 20
    with pytest.raises(ValueError, match="leaves skip"):
        G.attn_gate_apply(skip, torch.rand(1, 8, 8, device="cuda"), 2, 5)


@pytest.mark.parametrize("size", [252, 512])
def test_gated_forward_on_the_card(g, size):
    """The gated net's kernel forward at full width: 13 / 4 / 4 / 1
    launches beside 4 + 4 of the gate kernels, finite logits, their rms
    difference from the plain fp32 forward (TF32 off) over its std at most
    1.5 times the plain bf16 forward's, and a tile's logits in a batch of 3
    bit for bit its logits alone."""
    import dataclasses

    from unetseg_tpu_torch.core.config import ModelConfig
    from unetseg_tpu_torch.infer.folding import FoldedUNet, fold_batchnorm
    from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels
    from unetseg_tpu_torch.models.fast_init import fast_random_variables
    from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict

    cfg = ModelConfig(skip_gates=True)
    v = fast_random_variables(cfg, 5)
    for i in range(4):  # psi at a scale that keeps alpha off 0 and 1
        v["params"][f"gate{i}"]["psi"]["kernel"] *= 0.05
    net = fold_batchnorm(cfg, flax_to_state_dict(v)).cuda()
    ref32 = FoldedUNet(dataclasses.replace(cfg, compute_dtype="float32")).cuda()
    ref32.load_state_dict(net.state_dict())
    x = torch.rand(3, size, size, 1, generator=g, device="cuda") * 2 - 1
    with torch.inference_mode():
        K.reset_launch_counts()
        got = folded_forward_kernels(net, x)
        torch.cuda.synchronize()
        assert K.launch_counts() == _only(conv3x3_bias_relu=13, tconv2x2_bias=4, dec_conv0=4,
                                          conv3x3_head=1, attn_gate=4, attn_gate_apply=4)
        one = folded_forward_kernels(net, x[1:2])
        l32, l16 = ref32(x), net(x).float()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == l32.shape and bool(torch.isfinite(got).all())

    def rel(a):
        return ((a - l32).pow(2).mean().sqrt() / l32.std()).item()

    print(f"gated forward {size}: kernels {rel(got):.4f}, plain bf16 {rel(l16):.4f}")
    assert rel(got) <= 1.5 * rel(l16) < 0.05, (rel(got), rel(l16))
    assert torch.equal(one, got[1:2])


# a leaf's gradient difference norm over its norm against the f32
# reference: the kernel path's within 1.5 times the plain bf16 path's
# (cuDNN, unet_train_forward) plus 0.02. bf16 alone moves these gradients
# by 1-11% at batch 1 (the gates' most, through the sigmoid), so one fixed
# bound would be loose for some leaves and tight for others
GATED_GRAD_RATIO, GATED_GRAD_SLACK = 1.5, 0.02


def test_gated_train_gradients_on_the_card(g):
    """One train step's forward and backward of the gated net at full width,
    batch 1 and 512^2 through the kernel train forward, and through the
    plain bf16 path, against the benchmark's plain reference
    (benchmark/reference/attn_unet.py, f32, TF32 off) in train mode, with
    the cross-entropy against a cell frame's cells: the losses within 1%,
    and each gate leaf's, the head's, dec3's and up3's gradient error
    within GATED_GRAD_RATIO of the plain bf16 path's plus GATED_GRAD_SLACK.
    Seeded weights with psi at 0.05 of its draw, so that no gate saturates:
    where alpha sits at 0 or 1, alpha (1 - alpha) leaves a gate's gradient
    to a few pixels and either bf16 path misses it by 50-90%."""
    import sys
    from pathlib import Path

    import torch.nn.functional as F

    bench = str(Path(__file__).resolve().parents[1] / "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import synth
    from reference import attn_unet as ref

    from unetseg_tpu_torch.core.config import ModelConfig
    from unetseg_tpu_torch.models.train_forward import train_forward
    from unetseg_tpu_torch.models.unet import split_state_dict, unet_train_forward
    from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict

    size = 512
    model = {"in_channels": 1, "num_classes": 2, "base_features": 64, "levels": 5}
    cfg = ModelConfig(skip_gates=True)
    v = synth.variables(ref, model, 2**31 + 27, "cuda")
    for i in range(4):
        v["params"][f"gate{i}"]["psi"]["kernel"] *= 0.05
    x, _ = synth.cell_frames(synth.generator(27, "frames", "cuda"), 1, size, "cuda")
    params, stats = split_state_dict(flax_to_state_dict(v))
    stats = {k: t.cuda() for k, t in stats.items()}
    watched = [k for k in params if k.endswith("weight")
               and k.startswith(("gate", "outc", "dec3.conv", "up3_tconv"))]

    def grads(forward):
        p = {k: t.cuda().requires_grad_() for k, t in params.items()}
        logits = forward(p, stats, x[..., None], cfg)[0].permute(0, 3, 1, 2)
        o = logits.shape[-1]
        c = (size - o) // 2
        loss = F.cross_entropy(logits.float(), (x[:, c:c + o, c:c + o] > 0.475).long())
        loss.backward()
        return loss.item(), {k: p[k].grad for k in watched}

    loss_k, got = grads(train_forward)
    loss_p, plain = grads(unet_train_forward)
    rp, rs = ref.to_tensors(v, "cuda")
    rp = {k: t.requires_grad_() for k, t in rp.items()}
    rl, _ = ref.forward(rp, rs, x[:, None], model, train=True)
    o = rl.shape[-1]
    c = (size - o) // 2
    rloss = F.cross_entropy(rl, (x[:, c:c + o, c:c + o] > 0.475).long())
    rloss.backward()
    torch.cuda.synchronize()
    assert abs(loss_k - rloss.item()) <= 0.01 * abs(rloss.item()), (loss_k, rloss.item())

    def err(grad, k):
        want = rp[ref.ref_key(k)].grad
        return ((grad - want).norm() / want.norm()).item()

    errs = {k: (round(err(got[k], k), 4), round(err(plain[k], k), 4)) for k in watched}
    print("gated grad errs (kernels, plain bf16)", errs, "losses", loss_k, loss_p, rloss.item())
    assert len(errs) == 12 + 4
    assert all(e <= GATED_GRAD_RATIO * p + GATED_GRAD_SLACK for e, p in errs.values()), errs
