"""The stem's TMA weight gradient (csrc/conv3x3_wgrad.cu) and the fused
decoder tail (dec_tail_kernel of csrc/conv_fwd_wgmma.cu) as
ops/kernels/conv3x3_train.py and ops/kernels/conv3x3.py mirror them, on the
CPU: the stem's split-K chunks against the card's waves and g's pixels, its
ring against shared memory, and an emulation of its GEMM view (g^T as A,
a 16-column im2col of the staged x rows as B) against conv3x3_wgrad_plain;
the tail's band walk against every logit, its recompute and shared memory,
and an emulation of the walk (conv0 over each step's window from the
cropped skip and up into a carried shared tile, conv1 and the head from
it) against dec_tail_plain. The kernels themselves are held to their plain
versions by tests/test_torch_port_cuda.py on the card. No jax.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unetseg_tpu_torch.models.unet import to_nchw, to_nhwc
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT

SMS = 132  # an H100 SXM's SMs


def _bf16_values(rs, *shape, scale=1.0):
    a = torch.from_numpy(rs.standard_normal(shape).astype(np.float32) * scale)
    return a.to(torch.bfloat16).float()


# ------------------------------------------------------- the stem's wgrad
@pytest.mark.parametrize("b,ho,wo,co", [(4, 510, 510, 64), (4, 510, 510, 128), (1, 3, 3, 64),
                                        (2, 35, 81, 64), (16, 698, 698, 64)])
def test_stem_wgrad_chunks_fill_whole_waves(b, ho, wo, co):
    """The stem's chunks times its 64-channel blocks fit one wave of the
    kernel's blocks per SM and fill at least 96% of it, or take every tile
    where there are fewer."""
    th, tw = KT.WGRAD_STEM_TILE
    tiles = b * -(-ho // th) * -(-wo // tw)
    chunks = KT.wgrad_chunks(b, ho, wo, (1,), co, SMS)
    wave = KT.WGRAD_STEM_BLOCKS_PER_SM * SMS
    assert chunks * (co // 64) <= wave
    assert chunks == tiles or chunks * (co // 64) >= 0.96 * wave, (chunks, tiles)


@pytest.mark.parametrize("b,ho,wo,nchunks", [(4, 510, 510, 132), (1, 3, 3, 1), (2, 35, 81, 132),
                                             (3, 20, 139, 7), (1, 8, 64, 9)])
def test_stem_wgrad_tiles_cover_every_g_pixel_once(b, ho, wo, nchunks):
    """The chunks' tile ranges, clipped to g, cover each g pixel once (more
    chunks than tiles leave some chunks empty)."""
    th, tw = KT.WGRAD_STEM_TILE
    seen = np.zeros((b, ho, wo), np.int32)
    walk = KT.wgrad_stem_tiles(b, ho, wo, nchunks)
    assert len(walk) == nchunks
    for rows in walk:
        for bi, y0, x0 in rows:
            seen[bi, y0:y0 + th, x0:x0 + tw] += 1
    assert (seen == 1).all()


def test_stem_wgrad_ring_fits_shared_memory():
    """Six stages, the warps' sums and the barriers fit the 227 KB a block
    can use; a staged row holds the tile's ST_W + 2 input values from the
    16-byte boundary at or before the first (up to 7 before it), and its
    copy's box is a multiple of 16 bytes within TMA's 256 values."""
    assert KT.wgrad_stem_smem_bytes() <= KT.SMEM_PER_BLOCK
    th, tw = KT.WGRAD_STEM_TILE
    assert tw % 16 == 0 and th == 4  # 16-pixel K steps; one consumer warp a tile row
    assert 7 + tw + 2 <= KT.WGRAD_STEM_XIN <= 256 and KT.WGRAD_STEM_XIN % 8 == 0


def _stem_wgrad_emulation(x, g, nchunks):
    """The kernel's arithmetic in f32 on the same values: per chunk, per
    tile, per tile row (consumer warp) and 16-pixel K step, A = g^T (co x
    16 pixels, zeros past g's edges) and B = the step's 16 x 16 im2col from
    the tile's staged x rows (each a 1-D copy of the flat input from the
    16-byte boundary at or before the row's first value, zeros past the
    input's end; columns 9-15 zero); the warps' sums added in order, the
    chunks' in order, the pad columns dropped."""
    bsz, h, w, _ = x.shape
    _, ho, wo, co = g.shape
    th, tw = KT.WGRAD_STEM_TILE
    flat = torch.cat([x.reshape(-1), torch.zeros((th + 2) * w + 2 * KT.WGRAD_STEM_XIN)])
    gp = F.pad(g, (0, 0, 0, tw, 0, th))  # zeros past g's edges
    taps = [(t // 3, t % 3) for t in range(9)]
    total = torch.zeros(co, 16)
    for rows in KT.wgrad_stem_tiles(bsz, ho, wo, nchunks):
        part = torch.zeros(th, co, 16)  # per consumer warp
        for bi, y0, x0 in rows:
            staged = []
            for r in range(th + 2):
                start = (bi * h + y0 + r) * w + x0
                s0 = start & ~7
                staged.append((flat[s0:s0 + KT.WGRAD_STEM_XIN], start - s0))
            for wr in range(th):
                for st in range(tw // 16):
                    a = gp[bi, y0 + wr, x0 + st * 16:x0 + st * 16 + 16].t()  # co x 16
                    bm = torch.zeros(16, 16)
                    for n, (ky, kx) in enumerate(taps):
                        vals, d = staged[wr + ky]
                        bm[:, n] = vals[d + st * 16 + kx:d + st * 16 + kx + 16]
                    part[wr] += a @ bm
        total += part.sum(0)
    return total[:, :9].reshape(co, 1, 3, 3)


@pytest.mark.parametrize("b,h,w,co,nchunks", [(2, 9, 21, 64, 3), (1, 5, 5, 64, 1),
                                               (1, 11, 83, 128, 4)])
def test_stem_wgrad_gemm_emulation_equals_plain(b, h, w, co, nchunks):
    """The emulated GEMM view equals conv3x3_wgrad_plain at CI = 1 (f32, up
    to summation order): rows of 21, 5 and 83 values start off the 16-byte
    boundary, and rows past an image's edge run into the next image or past
    the input's end where g is zero."""
    rs = np.random.RandomState(h * w + co)
    x = _bf16_values(rs, b, h, w, 1)
    g = _bf16_values(rs, b, h - 2, w - 2, co)
    got = _stem_wgrad_emulation(x, g, nchunks)
    ref = KT.conv3x3_wgrad_plain(x, g)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


# ------------------------------------------------------- the decoder tail
@pytest.mark.parametrize("b,ho,wo,sms", [(16, 516, 516, SMS), (2, 23, 19, SMS), (1, 196, 199, SMS),
                                         (3, 7, 6, 5), (2, 66, 41, 7)])
def test_dec_tail_steps_cover_every_logit_once(b, ho, wo, sms):
    """Every logit is stored by exactly one step; a stored step inside a
    band follows, in its block, the step before it (stored or the block's
    prime step), which left the carry's two conv0 columns."""
    plan = K.dec_tail_plan(b, ho, wo, sms)
    seen = np.zeros((b, ho, wo), np.int32)
    walk = K.dec_tail_steps(plan)
    assert len(walk) == plan.grid and sum(int(r[:, 3].sum()) for r in walk) == plan.steps
    for rows in walk:
        for i, (bi, band, j, stores) in enumerate(rows):
            if not stores:
                assert i == 0 and j + 1 == rows[1][2]  # only a prime step, first
                continue
            if j > 0:
                assert i > 0 and tuple(rows[i - 1][:3]) == (bi, band, j - 1)
            y0, x0 = band * K.TAIL_OUT, max(0, K.TAIL_STEP * j - 2)
            seen[bi, y0:y0 + K.TAIL_OUT, x0:K.TAIL_STEP * j + K.TAIL_STEP - 2] += 1
    assert (seen == 1).all()


def test_dec_tail_plan_recompute_and_shared_memory():
    """At the serving shape (16 x 516^2 logits) conv0 computes at most 1.15x
    the conv0 pixels the logits need (32 rows per 30-row band, the image's
    edge and the prime steps included); the block's shared memory fits the
    227 KB; 516 + 2 conv0 columns take 65 steps."""
    plan = K.dec_tail_plan(16, 516, 516, SMS)
    assert plan.recompute <= 1.15, plan
    assert (plan.nbands, plan.nj, plan.steps, plan.grid) == (18, 65, 18720, SMS)
    assert plan.smem <= K.SMEM_PER_BLOCK


def _window(src, bi, y, x, rows, cols):
    """src[bi, y:y + rows, x:x + cols] as channels-first, zeros outside
    src: a TMA box at (x, y)."""
    _, hs, ws, c = src.shape
    out = torch.zeros(c, rows, cols)
    ys, xs = max(y, 0), max(x, 0)
    ye, xe = min(y + rows, hs), min(x + cols, ws)
    if ye > ys and xe > xs:
        out[:, ys - y:ye - y, xs - x:xe - x] = src[bi, ys:ye, xs:xe].permute(2, 0, 1)
    return out


def _tail_emulation(skip, up, w0, b0, w1, b1, kh, bh, row_off, col_off, sms, rnd):
    """The kernel's walk on the same values: per block a fresh conv0 tile h
    of TAIL_OUT + 4 rows x TAIL_STEP + 2 columns holding NaN (shared memory
    it never wrote); per step conv0 over the step's window (the skip at its
    crop offset, up at (0, 0), zeros past their edges), `rnd`-rounded, the
    carry (columns 8, 9 -> 0, 1 of the computed rows), the new columns into
    2..9; for a stored step conv1 + bias + ReLU from h, `rnd`-rounded, the
    1x1 head in f32, and the band's valid logits stored."""
    bsz, hu, wu, _ = up.shape
    ho, wo = hu - 4, wu - 4
    rows, pitch = K.TAIL_OUT + 2, K.TAIL_STEP + 2
    out = torch.full((bsz, ho, wo, kh.shape[0]), float("nan"))
    plan = K.dec_tail_plan(bsz, ho, wo, sms)
    for walk in K.dec_tail_steps(plan):
        h = torch.full((w0.shape[0], rows + 2, pitch), float("nan"))
        for bi, band, j, stores in walk:
            y0, x0 = band * K.TAIL_OUT, K.TAIL_STEP * j
            win = torch.cat([_window(skip, bi, y0 + row_off, x0 + col_off, rows + 2, pitch),
                             _window(up, bi, y0, x0, rows + 2, pitch)])
            c0 = rnd(F.relu(F.conv2d(win[None], w0, b0)[0]))  # (co, rows, TAIL_STEP)
            h[:, :rows, 0:2] = h[:, :rows, K.TAIL_STEP:pitch].clone()
            h[:, :rows, 2:] = c0
            if not stores:
                continue
            a = rnd(F.relu(F.conv2d(h[None], w1, b1)[0]))  # (co, rows, TAIL_STEP)
            lg = F.conv2d(a[None], kh, bh)[0].permute(1, 2, 0)  # (rows, TAIL_STEP, nc)
            for r in range(min(K.TAIL_OUT, ho - y0)):
                for c in range(K.TAIL_STEP):
                    if 0 <= x0 - 2 + c < wo:
                        assert torch.isnan(out[bi, y0 + r, x0 - 2 + c]).all()  # stored once
                        out[bi, y0 + r, x0 - 2 + c] = lg[r, c]
    return out


@pytest.mark.parametrize("b,hs,ws,hu,wu,row_off,col_off,sms", [
    (2, 40, 38, 27, 23, 3, 5, SMS),  # one band, blocks of one step, most from a prime step
    (1, 78, 52, 70, 45, 4, 1, 5),    # three bands (the last 6 rows), blocks across band seams
])
@pytest.mark.parametrize("bf16", [False, True])
def test_dec_tail_walk_emulation_equals_plain(b, hs, ws, hu, wu, row_off, col_off, sms, bf16):
    """The emulated walk equals dec_tail_plain: in f32 to summation order,
    and with conv0's output and conv1's activation rounded to bf16 where the
    kernel rounds them against dec_tail_plain on bf16 tensors (which rounds
    in the same places) within a rounding's slack. No logit reads the NaN
    of an h row or carry that no step wrote."""
    rs = np.random.RandomState(hu * wu + sms)
    skip, up = _bf16_values(rs, b, hs, ws, 64), _bf16_values(rs, b, hu, wu, 64)
    w0, b0 = _bf16_values(rs, 64, 128, 3, 3, scale=0.04), _bf16_values(rs, 64, scale=0.1)
    w1, b1 = _bf16_values(rs, 64, 64, 3, 3, scale=0.06), _bf16_values(rs, 64, scale=0.1)
    kh, bh = _bf16_values(rs, 2, 64, 1, 1, scale=0.2), _bf16_values(rs, 2, scale=0.1)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    got = _tail_emulation(skip, up, w0, b0, w1, b1, kh, bh, row_off, col_off, sms, rnd)
    assert bool(torch.isfinite(got).all())
    if not bf16:
        ref = K.dec_tail_plain(skip, up, w0, b0, w1, b1, kh, bh, row_off, col_off)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        return
    bf = torch.bfloat16
    ref = K.dec_tail_plain(skip.to(bf), up.to(bf), w0, b0, w1, b1, kh, bh, row_off, col_off)
    y = K.dec_conv0_plain(skip, up, w0, b0, row_off, col_off)
    a = K.conv3x3_bias_relu_plain(y, w1, b1)

    def abs_conv(t, w):
        return to_nhwc(F.conv2d(to_nchw(t).abs(), w.abs()))

    # one bf16 rounding of the activation, and of conv0 carried through conv1
    slack = 2.0**-8 * (abs_conv(a, kh) + abs_conv(abs_conv(y, w1), kh))
    assert bool(((got - ref).abs() <= 1e-5 + slack).all())
