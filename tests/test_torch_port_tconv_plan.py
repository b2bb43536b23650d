"""The streaming wgmma tconv (csrc/tconv2x2_bias.cu) as
ops/kernels/conv3x3.py mirrors it, on the CPU: its tiles against the pixel
count, its ring against shared memory, the pixel-shuffle store map against
the output, and an emulation of its GEMM view (the wrapper's (dy, dx, co)
weight re-layout, a product of bf16 values in f32 per tile and column
group, the epilogue's bias and stores) against tconv2x2_bias_plain. The
kernel itself is held to its plain version by tests/test_torch_port_cuda.py
on the card.
"""

import numpy as np
import pytest
import torch

from unetseg_tpu_torch.ops.kernels import conv3x3 as K

SMS = 132  # an H100 SXM's SMs


def _walk(plan):
    """(tile, first pixel, first column) in the persistent grid's order:
    block i takes tiles i, i + grid, ...; tile t is column group t % nb of
    pixel tile t // nb."""
    for blk in range(plan.grid):
        for t in range(blk, plan.tiles, plan.grid):
            yield t, (t // plan.nb) * K.TCONV_MT, (t % plan.nb) * K.TCONV_NG


def _bf16_values(rs, *shape, scale=1.0):
    a = torch.from_numpy(rs.standard_normal(shape).astype(np.float32) * scale)
    return a.to(torch.bfloat16).float()


@pytest.mark.parametrize("b,h,w,ci,co", [
    (2, 13, 21, 128, 64),   # 546 pixels: a short last tile, resident weights
    (3, 5, 17, 64, 128),    # two column groups
    (1, 1, 1, 32, 64),      # one pixel, 32 channels
    (2, 9, 7, 96, 192),     # three column groups, 96 channels
])
def test_tconv_gemm_emulation_equals_plain(b, h, w, ci, co):
    """The kernel's GEMM view on seeded bf16 values, tile by tile in the
    grid's order, stores through tconv_store_offsets: every output element
    written once, and the result equal to the plain transposed conv (f32,
    up to summation order)."""
    rs = np.random.RandomState(ci + co + h)
    x = _bf16_values(rs, b, h, w, ci)
    wt = _bf16_values(rs, ci, co, 2, 2, scale=0.1)
    bias = torch.from_numpy(rs.standard_normal(co).astype(np.float32) * 0.1)
    plan = K.tconv_plan(b, h, w, ci, co, SMS)
    wk = K._tconv_weights(wt).float()  # (4 co, ci), what the kernel's weight map views
    assert wk.shape == (4 * co, ci)
    a = x.reshape(-1, ci)
    npix = a.shape[0]
    offsets = torch.from_numpy(K.tconv_store_offsets(b, h, w, co))
    y = torch.zeros(b * 2 * h * 2 * w * co)
    written = torch.zeros_like(y, dtype=torch.int32)
    lanes = torch.arange(64)
    for _, p0, n0 in _walk(plan):
        rows = torch.arange(p0, min(p0 + K.TCONV_MT, npix))
        cols = torch.arange(n0, n0 + K.TCONV_NG)
        acc = a[rows] @ wk[cols].t()  # the tile's 128 x 256 GEMM, f32 sums
        for c in range(K.TCONV_NG // 64):  # the epilogue's 64-column chunks
            col = n0 + 64 * c
            out = acc[:, 64 * c:64 * c + 64] + bias[(col % co) + lanes][None, :]
            at = offsets[rows, col // 64][:, None] + lanes[None, :]
            y[at.reshape(-1)] = out.reshape(-1)
            written[at.reshape(-1)] += 1
    assert (written == 1).all()
    ref = K.tconv2x2_bias_plain(x, wt, bias)
    torch.testing.assert_close(y.reshape(b, 2 * h, 2 * w, co), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,ci,co,resident", [
    (16, 260, 260, 128, 64, True),   # serving: up3 at 16 tiles of 700^2
    (4, 164, 164, 128, 64, True),    # the train step's up3 at 512^2
    (3, 13, 21, 128, 64, True),
    (3, 5, 17, 64, 128, False),      # two column groups: streamed weights
    (1, 9, 15, 256, 64, False),      # four slices, two weight stages
    (1, 1, 1, 32, 64, True),
])
def test_tconv_plan_tiles_cover_the_pixels(b, h, w, ci, co, resident):
    """Pixel tiles of 128 cover the B h w input pixels with less than one
    tile to spare, the column groups the 4 co GEMM columns exactly, the
    persistent grid walks every tile once, and the ring fits a block."""
    plan = K.tconv_plan(b, h, w, ci, co, SMS)
    npix = b * h * w
    assert (plan.mtiles - 1) * K.TCONV_MT < npix <= plan.mtiles * K.TCONV_MT
    assert plan.nb * K.TCONV_NG == 4 * co
    assert plan.slices * 64 >= ci > (plan.slices - 1) * 64
    assert plan.resident == resident
    assert plan.grid == min(plan.tiles, SMS) and plan.tiles == plan.mtiles * plan.nb
    seen = sorted(t for t, _, _ in _walk(plan))
    assert seen == list(range(plan.tiles))
    assert plan.smem <= K.SMEM_PER_BLOCK


@pytest.mark.parametrize("b,h,w", [(16, 260, 260), (4, 164, 164)])
def test_tconv_store_offsets_cover_the_output_once(b, h, w):
    """At the serving and train shapes (co 64): every store is 64 whole
    channels (128 bytes) at a 64-aligned offset, no two stores meet, and
    together they fill the (b, 2h, 2w, 64) output."""
    off = K.tconv_store_offsets(b, h, w, 64).ravel()
    numel = b * 2 * h * 2 * w * 64
    assert off.size * 64 == numel
    assert (off % 64 == 0).all() and off.min() == 0 and off.max() == numel - 64
    assert np.unique(off).size == off.size
