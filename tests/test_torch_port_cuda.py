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
against the stem kernel chained with the wgmma conv and pool, its
mma.sync reference against the mma.sync chain), the fused decoder tail at
odd crop offsets with 1-4 classes and over several bands (bit for bit
against the wgmma chain, its mma.sync reference against the mma.sync
chain), the stem's TMA weight gradient at a 3 x
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
same bits on a second launch; the uncounted mma.sync reference, to which
the fused kernels' mma.sync references are held bit for bit (the head
through its MODE_HEAD); the head conv on the wgmma forward's head variant at 1-4
classes and ragged sizes; the streaming wgmma tconv with each (dy, dx) tap
alone at CO 128, ragged pixel counts, 32-, 96- and 256-channel inputs and
three column groups, and its mma.sync reference; both new kernels with the
same bits on a second launch; the dgrad on the wgmma forward's kernels
through both wrappers at 64-, 128- and 256-channel dx from 1x1, 2x3 and
odd g at batch 1 and 4 (the same bits twice), and its uncounted mma.sync
reference; the stem's row kernel bit for bit against the FMA kernel it
replaced (the pool on odd and 1-row outputs, relu on and off, CO 128 and
192, ragged strips); the wrappers' refusals; and the pipeline command at
base 8 on the card.

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
    against the plain version and the FMA kernel it replaced, with the same
    bits on two launches."""
    x = _act(g, b, h, w, 1)
    gr = _g(g, b, h - 2, w - 2, co)
    KT.conv3x3_wgrad.launches = 0
    first, again = KT.conv3x3_wgrad(x, gr), KT.conv3x3_wgrad(x, gr)
    old = KT.wgrad_stem_fma_reference(x, gr)
    torch.cuda.synchronize()
    assert KT.conv3x3_wgrad.launches == 2  # the reference is uncounted
    assert first.shape == (co, 1, 3, 3) and first.dtype == torch.float32
    assert torch.equal(first, again)
    ref = KT.conv3x3_wgrad_plain(x.float(), gr.float())
    _close_rel(first, ref)
    _close_rel(old, ref)


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


@pytest.mark.parametrize("b,h,w", [(1, 37, 45), (1, 7, 9), (3, 75, 70)])
def test_enc0_fused_mma_reference(g, b, h, w):
    """The mma.sync kernel the wgmma kernel replaced: the bits of the stem
    kernel chained with the mma.sync conv and its pool, and uncounted."""
    x = _act(g, b, h, w, 1)
    w0, b0 = _w(g, 64, 1, 3, 3, fan=9 * 64), _b(g, 64)
    w1, b1 = _w(g, 64, 64, 3, 3, fan=9 * 64), _b(g, 64)
    K.reset_launch_counts()
    skip, pooled = K.enc0_fused_mma_reference(x, w0, b0, w1, b1)
    assert K.launch_counts()["enc0_fused"] == 0
    c_skip, c_pool = K.conv3x3_mma_reference(K.conv3x3_bias_relu(x, w0, b0), w1, b1,
                                             fuse_pool=True)
    torch.cuda.synchronize()
    assert torch.equal(skip, c_skip) and torch.equal(pooled, c_pool)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        K.enc0_fused_mma_reference(x.cpu(), w0.cpu(), b0.cpu(), w1.cpu(), b1.cpu())


def _dec_tail_case(g, nc, b, hs, ws, hu, wu, row_off, col_off):
    """dec_tail on random inputs: the new kernel against the wgmma chain
    dec_conv0 -> conv3x3_head bit for bit (the same slices, taps and k16
    steps per pixel), dec_tail_mma_reference against the mma.sync chain bit
    for bit, and the kernel against the fp32 plain version within both
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
    old = K.dec_tail_mma_reference(skip, up, w0, b0, w1, b1, kh, bh, row_off, col_off)
    entry = K.conv3x3_mma_reference(skip, w0, b0, up=up, row_off=row_off, col_off=col_off)
    mma_chain = K.conv3x3_mma_reference(entry, w1, b1, k_head=kh, b_head=bh)
    torch.cuda.synchronize()
    assert K.launch_counts()["dec_tail"] == 1  # the reference is uncounted
    assert torch.equal(got, wgmma_chain)
    assert torch.equal(old, mma_chain)
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
    """conv3x3_dense on both conv paths (the stem's FMAs, the mma
    epilogue), with and without the pool; it counts apart from
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


def test_conv3x3_mma_reference(g):
    """The uncounted mma.sync forward against the plain version, with one
    source and the pool, and with two at an odd offset."""
    x = _act(g, 2, 21, 18, 64)
    wt, bias = _w(g, 128, 64, 3, 3, fan=9 * 128), _b(g, 128)
    K.reset_launch_counts()
    y, pooled = K.conv3x3_mma_reference(x, wt, bias, fuse_pool=True)
    for a, r in zip((y, pooled), K.conv3x3_bias_relu_plain(x.float(), wt, bias, fuse_pool=True)):
        _close(a, r)
    skip, up = _act(g, 1, 33, 31, 64), _act(g, 1, 20, 18, 32)
    w0, b0 = _w(g, 64, 96, 3, 3, fan=9 * 64), _b(g, 64)
    got = K.conv3x3_mma_reference(skip, w0, b0, relu=False, up=up, row_off=5, col_off=7)
    _close(got, K.dec_conv0_plain(skip.float(), up.float(), w0, b0, 5, 7, relu=False))
    assert K.launch_counts() == _only()


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


def test_conv3x3_head_mma_reference(g):
    """The uncounted mma.sync head (MODE_HEAD) against the plain version,
    and its refusals."""
    x, wt, bias, kh, bh = _head_case(g, 2, 27, 23, 3)
    K.reset_launch_counts()
    got = K.conv3x3_mma_reference(x, wt, bias, k_head=kh, b_head=bh)
    assert K.launch_counts() == _only()
    _close(got, K.conv3x3_head_plain(x.float(), wt, bias, kh, bh), _head_slack(x, wt, bias, kh))
    with pytest.raises(ValueError, match="both"):
        K.conv3x3_mma_reference(x, wt, bias, k_head=kh)
    with pytest.raises(ValueError, match="no pool"):
        K.conv3x3_mma_reference(x, wt, bias, fuse_pool=True, k_head=kh, b_head=bh)


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


def test_tconv2x2_mma_reference(g):
    """The uncounted mma.sync tconv against the plain version."""
    x = _act(g, 2, 13, 21, 128)
    wt, bias = _w(g, 128, 64, 2, 2, fan=4 * 64), _b(g, 64)
    K.reset_launch_counts()
    got = K.tconv2x2_mma_reference(x, wt, bias)
    assert K.launch_counts() == _only()
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


def test_dgrad_mma_reference(g):
    """The mma.sync dgrad kept for timings: the same function, uncounted."""
    gr = _g(g, 2, 13, 9, 64)
    wt = _w(g, 64, 128, 3, 3, fan=9 * 64)
    K.reset_launch_counts()
    got = KT.conv3x3_dgrad_mma_reference(gr, wt)
    assert K.launch_counts() == _only()
    _close(got, KT.conv3x3_dgrad_plain(gr.float(), wt))


# ------------------------------------------------- the stem's row kernel


@pytest.mark.parametrize("b,h,w,co,pool,relu", [
    (2, 37, 45, 64, True, True), (1, 20, 19, 128, False, True), (3, 9, 7, 64, True, False),
    (1, 3, 3, 64, True, True), (2, 140, 300, 64, True, True), (1, 4, 131, 192, True, False),
    (1, 35, 258, 64, False, False),
])
def test_stem_rows_equal_the_fma_kernel(g, b, h, w, co, pool, relu):
    """The stem's row kernel against the FMA kernel it replaced, bit for
    bit: the pool on odd sizes (floor) and on a 1-row output (no pooled
    pixel), relu on and off, 64-192 output channels, outputs wider than
    one 128-column strip with a ragged last one; one launch counted, none
    for the reference; and the plain version within the bound."""
    x = _act(g, b, h, w, 1)
    wt, bias = _w(g, co, 1, 3, 3, fan=9 * co), _b(g, co)
    K.reset_launch_counts()
    got = K.conv3x3_bias_relu(x, wt, bias, fuse_pool=pool, relu=relu)
    assert K.launch_counts() == _only(conv3x3_bias_relu=1)
    ref = K.stem_fma_reference(x, wt, bias, fuse_pool=pool, relu=relu)
    assert K.launch_counts() == _only(conv3x3_bias_relu=1)
    torch.cuda.synchronize()
    pairs = list(zip(got, ref)) if pool else [(got, ref)]
    for a, r in pairs:
        assert a.shape == r.shape and torch.equal(a, r)
    # F.max_pool2d refuses a 1x1 map: the 1-row case's pool is held to the
    # FMA kernel's (empty) bits above
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
    through the four serving kernels (counted), the merged probabilities
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
    per_member = {"conv3x3_bias_relu": 2, "tconv2x2_bias": 1, "dec_conv0": 1, "conv3x3_head": 1}
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
