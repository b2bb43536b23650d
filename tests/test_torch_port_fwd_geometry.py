"""The launch plan of the wgmma forward conv (csrc/conv_fwd_wgmma.cu), as
ops/kernels/conv3x3.py mirrors it, at every shape the serving path (16
tiles of 700^2) and the train step (batch 4 at 512^2) launch it with, in
its two forms (im2col for one source without the pool, windowed 8x8 units
otherwise): the ring fits a block's shared memory, the N tiles cover the
output channels exactly, the units of the persistent grid cover every
output pixel once per N block, and the tile fill the plan predicts; the
head variant (conv3x3_head: windowed, N = 64, the 1x1 weights in shared
memory) at the serving path's 516^2 logits and at ragged sizes; and every
constant the kernels' Python plans mirror against its CUDA source. CPU only:
the kernel itself is held to its plain version by
tests/test_torch_port_cuda.py on the card.
"""

import numpy as np
import pytest

from unetseg_tpu_torch.models.shapes import unet_shapes
from unetseg_tpu_torch.ops.kernels import build
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT

SMS = 132  # an H100 SXM's SMs


def _fwd_shapes():
    """(name, batch, output side, output channels, pool, sources) of every
    launch of the wgmma forward: on the serving path (any variant: enc0
    conv1 + pool, the dec3 entry, the tier-2 and cblock convs) and in the
    train step (tier 1's enc0 conv1 and dec3 convs, tier 2's enc1 and dec2
    convs, none with the pool), base 64."""
    serve, train = unet_shapes(700), unet_shapes(512)
    out = [("serve_enc0c1_pool", 16, serve.encoder[0], 64, True, 1),
           ("serve_dec3c0", 16, serve.crops[-1] - 2, 64, False, 2),
           ("serve_dec2c0", 16, serve.crops[-2] - 2, 128, False, 2),
           ("serve_dec2c1", 16, serve.crops[-2] - 4, 128, False, 1),
           ("serve_enc1c1_pool", 16, serve.encoder[1], 128, True, 1)]
    for lvl in range(1, len(serve.encoder)):
        out.append((f"serve_enc{lvl}c0", 16, serve.encoder[lvl] + 2, 64 << lvl, False, 1))
        out.append((f"serve_enc{lvl}c1", 16, serve.encoder[lvl], 64 << lvl, False, 1))
    for i in range(2):  # dec0 and dec1 conv1 (cblock)
        out.append((f"serve_dec{i}c1", 16, serve.crops[i] - 4, 64 << (3 - i), False, 1))
    enc, crops = train.encoder, train.crops
    out += [("train_enc0c1", 4, enc[0], 64, False, 1),
            ("train_dec3c0", 4, crops[-1] - 2, 64, False, 2),
            ("train_dec3c1", 4, crops[-1] - 4, 64, False, 1),
            ("train_enc1c0", 4, enc[1] + 2, 128, False, 1),
            ("train_enc1c1", 4, enc[1], 128, False, 1),
            ("train_dec2c0", 4, crops[-2] - 2, 128, False, 2),
            ("train_dec2c1", 4, crops[-2] - 4, 128, False, 1)]
    return out


SHAPES = _fwd_shapes()
IDS = [s[0] for s in SHAPES]


def _plan(bsz, side, co, pool, sources):
    return K.fwd_plan(bsz, side, side, co, SMS, pool=pool, sources=sources)


@pytest.mark.parametrize("name,bsz,side,co,pool,sources", SHAPES, ids=IDS)
def test_fwd_ring_fits_shared_memory(name, bsz, side, co, pool, sources):
    """The plan's ring fits the 232,448 bytes an H100 block can use, at one
    block per SM: im2col stages of 256 pixels x 128 bytes and the N x 64
    weight tile, or window stages of four 1 KB-aligned 10x10x64 windows and
    weight stages of N x 64; a 16 x 64 epilogue tile per consumer warp and
    two mbarriers a stage."""
    plan = _plan(bsz, side, co, pool, sources)
    assert plan.mode == ("im2col" if sources == 1 and not pool and co % 128 == 0 else "window")
    if plan.mode == "im2col":
        (st,) = plan.stages
        assert plan.smem == 1024 + st * (256 * 128 + plan.n * 128) + 8 * 16 * 128 + 16 * st
        assert st >= 4  # four (tap, slice) stages in flight
    else:
        wst, bst = plan.stages
        assert plan.smem == (1024 + wst * 4 * 13312 + bst * plan.n * 128 + 8 * 16 * 128
                             + 16 * (wst + bst))
        assert wst >= 2 and bst >= 6  # the next slice's window, two thirds of its taps
    assert plan.smem <= K.SMEM_PER_BLOCK


def test_fwd_every_configuration_fits():
    """Both N of the windowed form and the im2col form (N = 128) fit, and
    the window stages are 1 KB aligned for the 128-byte swizzle."""
    assert K.FWD_WIN_SLOT == 13312 and K.FWD_WIN_SLOT % 1024 == 0
    for n in K.FWD_STAGES:
        assert K.fwd_smem_bytes(n) <= K.SMEM_PER_BLOCK, n
    assert K.fwd_smem_bytes(128, "im2col") <= K.SMEM_PER_BLOCK


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("co,n", [(64, 64), (128, 128), (192, 64), (256, 128), (320, 64),
                                  (512, 128), (1024, 128)])
def test_fwd_n_tiles_cover_co_exactly(co, n, pool):
    """N = 128 where it divides CO, else 64 (CO is a multiple of 64), in
    both forms: the N blocks tile CO with no partial block, 192 and 320
    included."""
    plan = K.fwd_plan(2, 20, 20, co, SMS, pool=pool)
    assert plan.n == n and co % plan.n == 0
    nb = plan.tiles // -(-plan.units // 4)
    assert nb * plan.n == co


def _pixel_counts(plan, bsz, ho, wo, co):
    """How often the plan's units cover each output pixel, per N block."""
    rows = np.concatenate(K.fwd_tile_units(plan, bsz, ho, wo))
    nb = co // plan.n
    if plan.mode == "im2col":
        count = np.zeros((bsz * ho * wo + 64, nb), int)
        for _, p0, n0 in rows:
            count[p0:p0 + 64, n0 // plan.n] += 1
        return rows, count[:bsz * ho * wo]
    count = np.zeros((bsz, ho + 8, wo + 8, nb), int)
    for _, bi, uy, ux, n0 in rows:
        count[bi, uy:uy + 8, ux:ux + 8, n0 // plan.n] += 1
    return rows, count[:, :ho, :wo]


@pytest.mark.parametrize("name,bsz,side,co,pool,sources", SHAPES, ids=IDS)
def test_fwd_units_cover_every_output_pixel(name, bsz, side, co, pool, sources):
    """Over the persistent grid's blocks, each (unit, N block) comes once
    and every output pixel lies in exactly one unit per N block."""
    plan = _plan(bsz, side, co, pool, sources)
    rows = np.concatenate(K.fwd_tile_units(plan, bsz, side, side))
    if plan.mode == "window":
        b, uy, ux, n0 = rows[:, 1:].T.astype(np.int64)
        key = ((b * 4096 + uy) * 4096 + ux) * 4096 + n0
        nu = -(-side // 8)
        mask = np.zeros((bsz, nu, 8, nu, 8), bool)
        first = n0 == 0
        mask[b[first], uy[first] // 8, :, ux[first] // 8, :] = True
        assert mask.reshape(bsz, nu * 8, nu * 8)[:, :side, :side].all()
        assert uy.max() < side and ux.max() < side
    else:
        p0, n0 = rows[:, 1].astype(np.int64), rows[:, 2].astype(np.int64)
        key = p0 * 4096 + n0
        # 64-pixel units from 0 on, with none past the last pixel
        assert set(p0[n0 == 0].tolist()) == set(range(0, plan.units * 64, 64))
        assert plan.units * 64 - 64 < bsz * side * side <= plan.units * 64
    assert len(np.unique(key)) == len(key) == plan.units * (co // plan.n)
    assert plan.grid == min(plan.tiles, SMS)


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("b,ho,wo,co", [(3, 9, 11, 192), (2, 36, 36, 1024), (1, 5, 70, 64),
                                        (4, 8, 8, 256)])
def test_fwd_units_cover_ragged_and_small_outputs(b, ho, wo, co, pool):
    """Non-square and ragged outputs, a last group short of units, and
    grids of fewer tiles than SMs, in both forms: each output pixel in
    exactly one unit per N block."""
    plan = K.fwd_plan(b, ho, wo, co, SMS, pool=pool)
    _, count = _pixel_counts(plan, b, ho, wo, co)
    assert (count == 1).all()


@pytest.mark.parametrize("name,bsz,side,co,pool,sources", SHAPES, ids=IDS)
def test_fwd_tile_fill(name, bsz, side, co, pool, sources):
    """Neither form wastes more than the 16x16 tiles of the mma.sync kernel
    did, at every shape; the im2col form only the last tile's rest."""
    plan = _plan(bsz, side, co, pool, sources)
    tile16 = (side / (-(-side // 16) * 16)) ** 2
    if plan.mode == "im2col":
        assert plan.fill == pytest.approx(bsz * side * side / (-(-bsz * side * side // 256) * 256))
        assert plan.fill > 0.99
    else:
        assert plan.fill == pytest.approx((side / (-(-side // 8) * 8)) ** 2)
    assert plan.fill >= tile16 - 1e-12


def test_fwd_fill_at_the_bottom_of_the_u():
    """Where the mma.sync kernel's 16x16 tiles wasted most (36^2 at enc4c1:
    0.5625, 38^2 0.6267, 82^2 0.7297, 68^2 0.7225): the windowed 8x8 units
    fill 0.81, 0.9025, 0.868 and 0.892, and the im2col form that these
    cblock convs take fills 1.0 (16 x 36^2 = 81 tiles of 256 pixels) or
    within one tile's rest."""
    for side, fill in ((36, 0.81), (38, 0.9025), (82, (82 / 88) ** 2), (68, (68 / 72) ** 2),
                       (696, 1.0), (80, 1.0)):
        assert K.fwd_plan(16, side, side, 1024, SMS, pool=True).fill == pytest.approx(fill)
        npix = 16 * side * side
        assert K.fwd_plan(16, side, side, 1024, SMS).fill >= npix / (npix + 255)


@pytest.mark.parametrize("b,side,co,pool,sources,tiles,grid", [
    (16, 36, 1024, False, 1, 648, 132), (16, 36, 1024, True, 1, 800, 132),
    (4, 166, 128, False, 2, 441, 132), (16, 696, 64, True, 1, 30276, 132),
    (2, 9, 128, False, 1, 1, 1), (1, 70, 192, False, 1, 63, 63),
])
def test_fwd_plan_tiles_and_grid(b, side, co, pool, sources, tiles, grid):
    """Tiles of four units times the N blocks, at most one block per SM:
    enc4c1's 20,736 pixels in 81 im2col tiles x 8 N blocks (the windowed
    form would take 100 x 8 for 400 units), tier 2's dec2 entry at 512^2
    in 441 windowed tiles, enc0 conv1's 121,104 units in 30,276 groups, a
    grid of one block for one tile, N = 64 in the windowed form."""
    plan = K.fwd_plan(b, side, side, co, SMS, pool=pool, sources=sources)
    assert (plan.tiles, plan.grid) == (tiles, grid)


# ------------------------------------------------------------ the head variant


@pytest.mark.parametrize("b,ho,wo", [(16, 516, 516), (2, 23, 19), (1, 5, 70), (3, 9, 11),
                                     (1, 1, 1)])
def test_head_plan_covers_every_logit_pixel(b, ho, wo):
    """The head variant's plan (windowed 8x8 units, N = 64, one N block)
    puts every logit pixel in exactly one unit: the serving path's 16 x
    516^2, ragged units on both edges, a last group short of units, one
    pixel."""
    plan = K.fwd_plan(b, ho, wo, 64, SMS, head=True)
    assert (plan.mode, plan.n, plan.stages) == ("window", 64, K.FWD_STAGES[64])
    _, count = _pixel_counts(plan, b, ho, wo, 64)
    assert (count == 1).all()
    assert plan.grid == min(plan.tiles, SMS)


def test_head_plan_fits_shared_memory():
    """The head variant's ring, epilogue tiles and its MAX_HEAD_CLASSES x 64
    f32 head weights fit a block, 1 KB more than the plain N = 64 ring; at
    the serving path's 516^2 logits the 8x8 units fill 0.985 of 65 x 65
    units an image."""
    plan = K.fwd_plan(16, 516, 516, 64, SMS, head=True)
    assert plan.smem == K.fwd_smem_bytes(64) + K.MAX_HEAD_CLASSES * 64 * 4
    assert plan.smem <= K.SMEM_PER_BLOCK
    assert plan.units == 16 * 65 * 65 and plan.tiles == 16900
    assert plan.fill == pytest.approx((516 / 520) ** 2)
    with pytest.raises(ValueError, match="head variant"):
        K.fwd_plan(16, 516, 516, 128, SMS, head=True)


# ------------------------------------------------- the mirrors of the sources

# the lines of csrc/ that hold each constant the Python plans mirror
MIRRORS = {
    "tconv_stages": ("tconv2x2_bias.cu", [
        f"constexpr int AST = {K.TCONV_STAGES[0]}, WST = {K.TCONV_STAGES[1]};"]),
    "tconv_tile": ("tconv2x2_bias.cu", [
        f"constexpr int MT = {K.TCONV_MT};", f"constexpr int NG = {K.TCONV_NG};"]),
    "fwd_window_n64": ("conv_fwd_wgmma.cu", [f"launch<64, {K.FWD_STAGES[64][0]}, "
                                             f"{K.FWD_STAGES[64][1]}>("]),
    "fwd_window_n128": ("conv_fwd_wgmma.cu", [f"launch<128, {K.FWD_STAGES[128][0]}, "
                                              f"{K.FWD_STAGES[128][1]}>("]),
    "fwd_im2col": ("conv_fwd_wgmma.cu", [f"launch_im2col<128, {K.FWD_IM2COL_STAGES}>("]),
    "head_classes": ("conv_fwd_wgmma.cuh", [f"constexpr int MAX_NC = {K.MAX_HEAD_CLASSES};"]),
    "dec_tail": ("conv_fwd_wgmma.cu", [
        f"constexpr int TB_OUT = {K.TAIL_OUT}, ",
        f"constexpr int TB_WST = {K.TAIL_STAGES[0]}, TB_BST = {K.TAIL_STAGES[1]};"]),
    "stem_rows": ("conv3x3_bias_relu.cu", [
        f"constexpr int STEM_SW = {K.STEM_SW};", f"constexpr int STEM_TILES = {K.STEM_TILES};",
        f"constexpr int STEM_BLOCKS_PER_SM = {K.STEM_BLOCKS_PER_SM};"]),
    "wgrad_stages": ("conv3x3_wgrad.cu", [
        f"constexpr int STAGES = {KT.WGRAD_STAGES};",
        f"constexpr int GT_H = {KT.WGRAD_TILE[0]}, GT_W = {KT.WGRAD_TILE[1]};"]),
    "wgrad_stem": ("conv3x3_wgrad.cu", [
        f"constexpr int ST_H = {KT.WGRAD_STEM_TILE[0]}, ST_W = {KT.WGRAD_STEM_TILE[1]};",
        f"constexpr int ST_STAGES = {KT.WGRAD_STEM_STAGES};"]),
}


@pytest.mark.parametrize("name", sorted(MIRRORS))
def test_plans_mirror_the_cuda_constants(name):
    """Each constant that a Python plan mirrors (stages, tiles, launch
    configurations, head classes) is the one its CUDA source holds: a plan
    that drifted from its kernel would pass the geometry tests above and
    say nothing of the kernel."""
    src, lines = MIRRORS[name]
    text = (build.CSRC / src).read_text()
    for line in lines:
        assert line in text, line
