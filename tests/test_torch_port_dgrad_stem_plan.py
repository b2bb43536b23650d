"""The launch plans of the two kernels redesigned on the card, as the port
mirrors them on the CPU (no jax):

- the input gradient (csrc/conv3x3_dgrad.cu) runs the wgmma forward's
  kernels on g read at (-2, -2) with the flipped, transposed weights of
  `dgrad_weights`: the forward conv of g zero-padded by 2 with those
  weights equals the plain dgrad; at every dgrad of the tier-1 and tier-2
  train steps the plan's form (windowed at 64 dx channels, im2col at 128
  and 256 with the bounding box moved by the offset), its shared memory,
  its N tiles over the dx channels and its units over every dx pixel;
- the stem's row kernel (csrc/conv3x3_bias_relu.cu, CI == 1): its strips
  cover every output row once per channel block, its store boxes tile
  each output and pooled row exactly, its TMA boxes and shared memory fit.

The kernels themselves are held to their plain versions by
tests/test_torch_port_cuda.py on the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unetseg_tpu_torch.models.shapes import unet_shapes
from unetseg_tpu_torch.models.unet import to_nchw, to_nhwc
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT

SMS = 132  # an H100 SXM's SMs


def _dgrad_as_forward(g, w):
    """What the dgrad kernels compute: the forward valid 3x3 conv of g read
    at (-2, -2) with zero fill (g padded by 2) with the wrapper's weights
    wt (CI, 3, 3, CO) as an OHWI kernel, O = dx channels, I = g channels."""
    wt = KT.dgrad_weights(w).to(g.dtype)
    return to_nhwc(F.conv2d(F.pad(to_nchw(g), (2, 2, 2, 2)), wt.permute(0, 3, 1, 2)))


@pytest.mark.parametrize("co,ci", [(64, 64), (64, 128), (128, 64), (128, 128), (128, 256),
                                   (32, 128)])
@pytest.mark.parametrize("b,hg,wg", [(2, 7, 5), (1, 1, 1), (1, 2, 3)])
def test_dgrad_is_the_forward_conv_of_g_read_at_minus_two(b, hg, wg, co, ci):
    """At the tier-1 (g of 64 channels into dx of 64 or 128) and tier-2 (g
    of 128 into dx of 64, 128 or 256) channel counts and a 32-channel g,
    at small sides down to a 1x1 g: the forward conv of g read at (-2,
    -2) equals conv3x3_dgrad_plain (float64, weights holding bf16 values,
    so the bf16 re-layout is exact)."""
    rs = np.random.RandomState(b * 100 + hg * 10 + wg + co + ci)
    g = torch.from_numpy(rs.standard_normal((b, hg, wg, co)))
    w = torch.from_numpy(rs.standard_normal((co, ci, 3, 3)).astype(np.float32))
    w = w.to(torch.bfloat16).double()
    got = _dgrad_as_forward(g, w)
    ref = KT.conv3x3_dgrad_plain(g, w)
    assert got.shape == ref.shape == (b, hg + 2, wg + 2, ci)
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_dgrad_weights_layout():
    """wt[ci, ky, kx, co] = w[co, ci, 2 - ky, 2 - kx], contiguous bf16."""
    w = torch.arange(2 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 3)
    wt = KT.dgrad_weights(w)
    assert wt.shape == (3, 3, 3, 2) and wt.dtype == torch.bfloat16 and wt.is_contiguous()
    for co in range(2):
        for ci in range(3):
            for ky in range(3):
                for kx in range(3):
                    assert wt[ci, ky, kx, co] == w[co, ci, 2 - ky, 2 - kx]


def _dgrad_shapes():
    """(name, batch, g side, g channels, dx channels) of every dgrad of the
    tier-1 train step (enc0 conv1, dec3 conv1, dec3 conv0 into its concat)
    and of tier 2 (enc1 conv0 and conv1, dec2 conv0 into its concat, dec2
    conv1), batch 4 at 512^2, base 64."""
    sh = unet_shapes(512)
    e0, u, d2 = sh.encoder[0], sh.crops[-1], sh.crops[-2]
    p0 = e0 // 2
    return [("enc0_conv1", 4, e0, 64, 64), ("dec3_conv1", 4, u - 4, 64, 64),
            ("dec3_conv0", 4, u - 2, 64, 128), ("dense_enc1_conv0", 4, p0 - 2, 128, 64),
            ("dense_enc1_conv1", 4, p0 - 4, 128, 128), ("dense_dec2_conv0", 4, d2 - 2, 128, 256),
            ("dense_dec2_conv1", 4, d2 - 4, 128, 128)]


DGRAD = _dgrad_shapes()


@pytest.mark.parametrize("name,bsz,side,co,ci", DGRAD, ids=[s[0] for s in DGRAD])
def test_dgrad_plan_at_the_train_steps(name, bsz, side, co, ci):
    """The dgrad's plan over dx (bsz, side + 2, side + 2, ci): windowed at
    N = 64 for 64 dx channels, im2col at N = 128 for 128 and 256 (the
    (-2, -2) offset moves the im2col bounding box, it changes no form);
    the ring fits a block's shared memory; the N tiles cover the dx
    channels exactly; the units cover every dx pixel once per N block."""
    plan = KT.dgrad_plan(bsz, side, side, ci, SMS)
    ho = side + 2
    assert plan == K.fwd_plan(bsz, ho, ho, ci, SMS)
    assert plan.mode == ("im2col" if ci % 128 == 0 else "window")
    assert plan.n == (128 if ci % 128 == 0 else 64)
    assert plan.smem <= K.SMEM_PER_BLOCK
    upb = K.FWD_CONSUMERS * K.FWD_UPW
    nb = plan.tiles // -(-plan.units // upb)
    assert nb * plan.n == ci
    rows = np.concatenate(K.fwd_tile_units(plan, bsz, ho, ho))
    count = np.zeros((bsz * ho * ho, nb), np.int64)
    if plan.mode == "im2col":
        for _, p0, n0 in rows:
            assert p0 < bsz * ho * ho
            count[p0:p0 + 64, n0 // plan.n] += 1
    else:
        grid = np.zeros((bsz, ho + 8, ho + 8, nb), np.int64)
        for _, bi, uy, ux, n0 in rows:
            grid[bi, uy:uy + 8, ux:ux + 8, n0 // plan.n] += 1
        count = grid[:, :ho, :ho].reshape(-1, nb)
    assert (count == 1).all()


@pytest.mark.parametrize("name,bsz,side,co,ci", DGRAD, ids=[s[0] for s in DGRAD])
def test_dgrad_im2col_corners(name, bsz, side, co, ci):
    """The im2col map's bounding box for g (side x side) read at (-2, -2)
    over the (side + 2)^2 outputs: corners (-2, -2) and (0, 0), inside the
    [-128, 127] a 4-D map takes, spanning exactly the output positions;
    the forward's (offset 0, Ho = H - 2) stays (0, 0) and (-2, -2)."""
    lower, upper = K.im2col_corners(side, side, side + 2, side + 2, -2, -2)
    assert lower == (-2, -2) and upper == (0, 0)
    assert all(-128 <= c <= 127 for c in lower + upper)
    # the box spans [lower, dim + upper) in each of (w, h): the outputs
    assert side + upper[0] - lower[0] == side + 2
    assert K.im2col_corners(side + 2, side + 2, side, side, 0, 0) == ((0, 0), (-2, -2))


# ------------------------------------------------------------------- stem


# (name, batch, output rows, output columns, channels): the serving stem
# (16 tiles of 700^2), the train step's (batch 4 at 512^2), odd sizes
STEM = [("serving", 16, 698, 698, 64), ("train", 4, 510, 510, 64), ("odd", 3, 9, 7, 64),
        ("one_row", 1, 1, 1, 64), ("ragged_co192", 1, 2, 129, 192),
        ("wide_co128", 2, 17, 298, 128), ("exact_strip", 1, 6, 256, 64)]


@pytest.mark.parametrize("name,bsz,ho,wo,co", STEM, ids=[s[0] for s in STEM])
def test_stem_strips_cover_every_output_row_once(name, bsz, ho, wo, co):
    """Over the persistent grid's blocks each strip comes once, and its
    store box (rows 2 qy, 2 qy + 1 x STEM_SW columns x 64 channels,
    clipped to the output) and pool box (pooled row qy x STEM_SW / 2
    columns) together write every output and pooled element exactly
    once."""
    plan = K.stem_plan(bsz, ho, wo, co, SMS, pool=True)
    assert plan.grid == min(plan.strips, plan.per_sm * SMS)
    rows = np.concatenate(K.stem_strips(plan))
    assert len(rows) == plan.strips == bsz * -(-ho // 2) * -(-wo // K.STEM_SW) * (co // 64)
    keys = {tuple(r) for r in rows.tolist()}
    assert len(keys) == len(rows)
    out = np.zeros((bsz, ho, wo, co // 64), np.int64)
    pooled = np.zeros((bsz, ho // 2, wo // 2, co // 64), np.int64)
    for b, qy, c0, cb in rows:
        assert c0 % K.STEM_SW == 0 and c0 < wo and 2 * qy < ho
        out[b, 2 * qy:2 * qy + 2, c0:c0 + K.STEM_SW, cb] += 1
        pooled[b, qy:qy + 1, c0 // 2:c0 // 2 + K.STEM_SW // 2, cb] += 1
    assert (out == 1).all()
    assert (pooled == 1).all()


@pytest.mark.parametrize("name,bsz,ho,wo,co", STEM, ids=[s[0] for s in STEM])
def test_stem_store_boxes_tile_each_row(name, bsz, ho, wo, co):
    """Each output row's store boxes are the column segments [c0, c0 +
    STEM_SW) clipped to the width: they tile [0, wo) with no gap and no
    overlap, and the last is the only one the clip shortens; the input a
    strip reads (STEM_IN values from the 16-byte boundary at or before
    c0's value, up to 7 values early) covers every column its quads read
    (2q .. 2q + 3 for q < STEM_SW / 2)."""
    plan = K.stem_plan(bsz, ho, wo, co, SMS)
    segs = sorted({int(c0) for c0 in np.concatenate(K.stem_strips(plan))[:, 2]})
    spans = [(c0, min(c0 + K.STEM_SW, wo)) for c0 in segs]
    assert spans[0][0] == 0 and spans[-1][1] == wo
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0 and a1 - a0 == K.STEM_SW
    assert K.STEM_IN >= 7 + K.STEM_SW + 2 and K.STEM_IN % 8 == 0


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("co", [64, 128, 192, 1024])
def test_stem_fits_shared_memory_and_tma_boxes(co, pool):
    """The plan's blocks per SM fit an H100 SM's shared memory (each with
    its 1 KB reserve): STEM_BLOCKS_PER_SM of them at the U-Net's 64
    channels without the pool tiles (the serving and train stems), two
    with them, one at 1024 channels; the
    input rows' 1-D box is a 16-byte multiple of at most 256 values, the
    store boxes at most 256 pixels wide, each staged input row 128-byte
    aligned."""
    plan = K.stem_plan(16, 698, 698, co, SMS, pool=pool)
    assert plan.smem == K.stem_smem_bytes(co, pool) <= K.SMEM_PER_BLOCK
    assert plan.per_sm * (plan.smem + 1024) <= K.SM_SHARED
    assert plan.grid == min(plan.strips, plan.per_sm * SMS)
    if co == 64:
        assert plan.per_sm == (2 if pool else K.STEM_BLOCKS_PER_SM)
    assert K.STEM_IN <= K.TMA_BOX_MAX and (K.STEM_IN * 2) % 16 == 0
    assert K.STEM_SW <= K.TMA_BOX_MAX and K.STEM_SW % 2 == 0
    assert K.STEM_IN_ROW % 128 == 0 and K.STEM_IN_ROW >= 2 * K.STEM_IN
