"""The serving forward's convolution kernels: wrappers, plain versions and
launch counters (counterpart of unetseg_tpu/ops/pallas/conv3x3.py and
ops/pallas/conv_cblock.py).

Each wrapper takes NHWC activations and torch-layout weights (Conv2d
OIHW, ConvTranspose2d (CI, CO, kH, kW)). Routing is by the tensor's
device: a CPU tensor runs the plain PyTorch version beside the wrapper; a
CUDA tensor launches the hand-written Hopper kernel (csrc/*.cu, built by
build.py) on the current stream, or raises. There is no fallback from a
failed check, build or launch. Each wrapper counts its kernel launches in
its `launches` attribute (ops/kernels/launches.py).

`conv3x3_bias_relu` and `dec_conv0` take `relu=False` for the train
step, which needs the pre-BatchNorm z = conv + bias. The TPU kernels'
per-channel `scale` is not taken: every ported path folds it into the
weights and passes ones.

The TPU needed a kernel per layout (2-phase lanes, dense lanes, NHWC
blocks) for one function; on NHWC the three layouts' convs launch one
CUDA kernel each, through wrappers of their own so that each TPU
kernel's counterpart counts its launches apart:

| wrapper            | CUDA source                 | TPU kernel it replaces (ops/pallas/) | plain version           |
|--------------------|-----------------------------|--------------------------------------|-------------------------|
| conv3x3_bias_relu  | csrc/conv3x3_bias_relu.cu   | conv3x3.py:conv3x3_phase2            | conv3x3_bias_relu_plain |
| conv3x3_dense      | csrc/conv3x3_bias_relu.cu   | conv3x3.py:conv3x3_lanes             | conv3x3_bias_relu_plain |
| conv3x3_cblock     | csrc/conv3x3_bias_relu.cu   | conv_cblock.py:conv3x3_cblock        | conv3x3_bias_relu_plain |
| enc0_fused         | csrc/enc0_fused.cu          | conv3x3.py:enc0_fused_phase2         | enc0_fused_plain        |
| tconv2x2_bias      | csrc/tconv2x2_bias.cu       | conv3x3.py:tconv2x2_phase2           | tconv2x2_bias_plain     |
| dec_conv0          | csrc/dec_conv0.cu           | conv3x3.py:dec_conv0_phase2          | dec_conv0_plain         |
| dec_conv0_dense    | csrc/dec_conv0.cu           | conv3x3.py:dec_conv0_lanes           | dec_conv0_plain         |
| conv3x3_head       | csrc/conv3x3_head.cu        | conv3x3.py:conv3x3_head_phase2       | conv3x3_head_plain      |
| dec_tail           | csrc/dec_tail.cu            | conv3x3.py:dec_tail_phase2           | dec_tail_plain          |

With one input channel (the stem), conv3x3_bias_relu and conv3x3_dense
launch a row-streaming FMA kernel (csrc/conv3x3_bias_relu.cu): strips of
two output rows through shared memory, written by TMA tensor stores;
`stem_plan` and `stem_strips` mirror its launch.

With more than one input channel, conv3x3_bias_relu, conv3x3_dense,
conv3x3_cblock, dec_conv0 and dec_conv0_dense launch csrc/conv_fwd_wgmma.cu
(wgmma fed by a TMA ring, in an im2col form for one source without the
pool at N = 128 and a windowed form otherwise), and conv3x3_head its
windowed form at N = 64 with the 1x1 head in the epilogue; `fwd_plan`
mirrors its launch plan. tconv2x2_bias launches a streaming wgmma GEMM
with resident weights (csrc/tconv2x2_bias.cu); `tconv_plan` and
`tconv_store_offsets` mirror its tiles and its pixel-shuffle stores.
dec_tail launches the wgmma forward's fused-tail kernel (bands of 30
logits rows walked 8 columns a step, conv0's tile kept in shared memory),
whose bits are the chain dec_conv0 -> conv3x3_head; `dec_tail_plan` and
`dec_tail_steps` mirror its walk. enc0_fused (csrc/enc0_fused.cu)
launches the wgmma forward's fused-enc0 kernel (bands of 32 output rows
walked 8 columns a step; a stem warpgroup fills one of two shared h tiles
on the FMA units, carrying the two halo columns from the step before,
while two consumer warpgroups run conv1 from the other as the tail's
transposed product with resident weights; the pool from registers), whose
bits are the chain conv3x3_bias_relu -> conv3x3_bias_relu(fuse_pool=True);
`enc0_fused_plan` and `enc0_fused_steps` mirror its walk.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from unetseg_tpu_torch.models.unet import to_nchw, to_nhwc
from unetseg_tpu_torch.ops.kernels.build import library
from unetseg_tpu_torch.ops.kernels.launches import (  # noqa: F401 (re-exported)
    counted,
    launch_counts,
    reset_launch_counts,
)

MAX_HEAD_CLASSES = 4  # csrc/conv_fwd_wgmma.cuh MAX_NC
CBLOCK_CO = 128  # conv_cblock.py asserts CO % 128 == 0

# csrc/conv_fwd_wgmma.cu's launch plan, mirrored for the CPU geometry tests
# (tests/test_torch_port_fwd_geometry.py). N output channels a block: 128
# where it divides CO, else 64; two consumer warpgroups of two m64 units;
# a 16 x 64 bf16 epilogue tile per consumer warp; one block per SM, a
# persistent grid of at most one block per SM. Two forms:
# - "im2col" (one source, no pool, N = 128): a unit is 64 consecutive
#   output pixels, a tile 256 across rows and images; per (tap, slice) a
#   stage of the tile's 256 x 64-channel A and the N x 64 weight tile;
# - "window" (the pool, two sources, or N = 64): a unit is 8x8 output
#   pixels with a 10x10-pixel window of 64 channels (128 bytes a pixel,
#   1 KB aligned); window stages per slice, weight stages per (tap, slice).
FWD_UNIT, FWD_WIN, FWD_SLICE, FWD_CONSUMERS, FWD_UPW = 8, 10, 64, 2, 2
FWD_WIN_SLOT = -(-FWD_WIN * FWD_WIN * 2 * FWD_SLICE // 1024) * 1024
FWD_EPI_BYTES = FWD_CONSUMERS * 4 * 16 * 2 * FWD_SLICE
FWD_STAGES = {64: (2, 13), 128: (2, 6)}  # window: (window stages, weight stages)
FWD_IM2COL_STAGES = 4  # at N = 128
FWD_HEAD_BYTES = MAX_HEAD_CLASSES * FWD_SLICE * 4  # the head variant's f32 1x1 weights
SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block can use

# csrc/tconv2x2_bias.cu's launch plan: tiles of TCONV_MT consecutive input
# pixels x TCONV_NG of the GEMM's 4 CO columns ((dy, dx, co) order), two
# consumer warpgroups of 64 pixels, an A ring of TCONV_STAGES[0] stages of
# 128 pixels x 64 channels, a weight ring of TCONV_STAGES[1] stages of 256
# columns x 64 channels (resident where one column group has at most that
# many slices), a 16 x 64 bf16 epilogue tile per consumer warp.
TCONV_MT, TCONV_NG, TCONV_STAGES = 128, 256, (4, 2)


# csrc/conv_fwd_wgmma.cu's fused decoder tail (dec_tail_kernel): bands of
# TAIL_OUT logits rows (TAIL_OUT + 2 conv0 rows, 16 a consumer warpgroup)
# walked TAIL_STEP columns a step; a step's conv0 window and h tile are
# TAIL_OUT + 4 rows of TAIL_STEP + 2 pixels. Ring: TAIL_STAGES = (window
# stages, weight stages of one 64 x 64 (tap, slice) tile); conv1's taps
# stream through the weight ring. The transposed product's head tile: a
# warpgroup's 128 pixels of 128 bytes. One block per SM, each a contiguous
# range of the steps in (image, band, column step) order.
TAIL_OUT, TAIL_STEP, TAIL_STAGES = 30, 8, (2, 8)
TAIL_EPI_BYTES = FWD_CONSUMERS * 2 * TAIL_STEP * TAIL_STEP * 2 * FWD_SLICE


class TailPlan(NamedTuple):
    nbands: int  # bands of TAIL_OUT logits rows
    nj: int  # column steps a band: step j stores logits columns 8j - 2 .. 8j + 5
    steps: int  # (image, band, step) steps
    grid: int  # blocks of the persistent grid
    smem: int  # dynamic shared memory bytes of a block
    recompute: float  # conv0 pixels computed (prime steps included) / conv0 pixels needed


def dec_tail_smem_bytes() -> int:
    """1 KB of alignment slack, the window stages (TAIL_OUT + 4 rows of
    TAIL_STEP + 2 pixels, 128 bytes a pixel, each rounded up to 1 KB), the
    weight stages (64 x 128 bytes), the h tile (as a window), the head's
    activation tiles, a full and an empty mbarrier per stage, the head's f32
    weights."""
    win = (TAIL_OUT + 4) * (TAIL_STEP + 2) * 2 * FWD_SLICE
    wst, bst = TAIL_STAGES
    return (1024 + wst * -(-win // 1024) * 1024 + bst * FWD_SLICE * 2 * FWD_SLICE + win
            + TAIL_EPI_BYTES + 2 * (wst + bst) * 8 + FWD_HEAD_BYTES)


def dec_tail_plan(bsz: int, ho: int, wo: int, sm_count: int) -> TailPlan:
    """The launch plan of dec_tail_kernel for logits (bsz, ho, wo, .)."""
    nbands, nj = -(-ho // TAIL_OUT), -(-(wo + 2) // TAIL_STEP)
    steps = bsz * nbands * nj
    grid = min(steps, sm_count)
    primes = sum(1 for blk in range(grid) if (steps * blk // grid) % nj)
    computed = (steps + primes) * (TAIL_OUT + 2) * TAIL_STEP
    return TailPlan(nbands, nj, steps, grid, dec_tail_smem_bytes(),
                    computed / (bsz * (ho + 2) * (wo + 2)))


def dec_tail_steps(plan: TailPlan) -> List[np.ndarray]:
    """Per block of the plan's grid, its steps in the kernel's order as rows
    (b, band, j, stores): a range that starts inside a band begins with the
    step before it (stores 0: conv0 only, the carry's two columns)."""
    out = []
    for blk in range(plan.grid):
        t = np.arange(plan.steps * blk // plan.grid, plan.steps * (blk + 1) // plan.grid)
        j = t % plan.nj
        band = (t // plan.nj) % plan.nbands
        b = t // (plan.nj * plan.nbands)
        rows = np.stack([b, band, j, np.ones_like(t)], axis=1)
        if len(t) and j[0] > 0:
            rows = np.concatenate([[[b[0], band[0], j[0] - 1, 0]], rows])
        out.append(rows)
    return out


# csrc/conv_fwd_wgmma.cu's fused enc0 (enc0_fused_kernel): bands of ENC0_OUT
# output rows (16 a consumer warpgroup) walked ENC0_STEP columns a step, a
# contiguous range of the (image, band, column step) steps per block of a
# persistent grid of at most one block per SM: two consumer warpgroups
# (conv1, the epilogue) and a stem warpgroup. The stem fills ENC0_H_ROWS
# rows x ENC0_STEP + 2 columns of h a step (the ENC0_OUT + 2 rows conv1
# reads, then padding; ENC0_NSEG segments of ENC0_SEG rows a column), 128
# bytes a pixel, in one of two 1 KB-aligned h tiles, from ENC0_X_ROWS rows of
# x (ENC0_X_CHUNKS 16-byte loads a row, ENC0_X_ROW bytes apart, two stages):
# where the block's step before is the same band's column step j - 1 it
# carries columns 0, 1 from that step's 8, 9 and computes 2..9, else all
# ten. conv1's nine 64 x 64 weight taps stay resident; a consumer warpgroup
# stores a 16 x 8 skip0 tile and an 8 x 4 pooled tile. Bands start at
# multiples of ENC0_OUT and a warpgroup's half at multiples of 16, so
# every 2x2 pool window lies inside one warpgroup.
ENC0_OUT, ENC0_STEP = 32, 8
assert ENC0_OUT % 2 == 0 and (ENC0_OUT // 2) % 2 == 0 and ENC0_STEP % 2 == 0, \
    "the 2x2 pool needs even rows and columns a warpgroup"
ENC0_SEG, ENC0_NSEG, ENC0_X_CHUNKS, ENC0_X_ROW = 9, 4, 3, 128
ENC0_H_ROWS = ENC0_NSEG * ENC0_SEG
ENC0_X_ROWS = ENC0_H_ROWS + 2


class Enc0Plan(NamedTuple):
    nbands: int  # bands of ENC0_OUT output rows
    nj: int  # column steps of ENC0_STEP a band
    steps: int  # (image, band, step) steps
    grid: int  # blocks of the persistent grid
    smem: int  # dynamic shared memory bytes of a block
    fill: float  # skip0 pixels / pixels conv1 computes
    recompute: float  # stem pixels computed (padding included, the carry not) / pixels conv1 needs


def enc0_fused_smem_bytes() -> int:
    """1 KB of alignment slack, conv1's nine resident weight taps (64 x 128
    bytes each), two h tiles (ENC0_H_ROWS rows of ENC0_STEP + 2 pixels of
    128 bytes, each rounded up to 1 KB), each warpgroup's skip0 and pooled
    tiles, two x stages, five mbarriers (the weights; h full and h empty
    per stage)."""
    row = 2 * FWD_SLICE
    h = -(-ENC0_H_ROWS * (ENC0_STEP + 2) * row // 1024) * 1024
    tile = ENC0_OUT // 2 * ENC0_STEP * row
    ptile = ENC0_OUT // 4 * ENC0_STEP // 2 * row
    return (1024 + 9 * FWD_SLICE * row + 2 * h + FWD_CONSUMERS * (tile + ptile)
            + 2 * ENC0_X_ROWS * ENC0_X_ROW + 5 * 8)


def enc0_fused_plan(bsz: int, ho: int, wo: int, sm_count: int) -> Enc0Plan:
    """The launch plan of enc0_fused_kernel for skip0 (bsz, ho, wo, 64)."""
    nbands, nj = -(-ho // ENC0_OUT), -(-wo // ENC0_STEP)
    steps = bsz * nbands * nj
    grid = min(steps, sm_count)
    # a step carries its first two h columns unless it is j == 0 or its
    # block's first
    carries = np.arange(steps) % nj != 0
    carries[np.arange(grid) * steps // grid] = False
    carried = int(np.count_nonzero(carries))
    computed = ENC0_H_ROWS * ((steps - carried) * (ENC0_STEP + 2) + carried * ENC0_STEP)
    return Enc0Plan(nbands, nj, steps, grid, enc0_fused_smem_bytes(),
                    bsz * ho * wo / (steps * ENC0_OUT * ENC0_STEP),
                    computed / (bsz * (ho + 2) * (wo + 2)))


def enc0_fused_steps(plan: Enc0Plan) -> List[np.ndarray]:
    """Per block of the plan's grid, its steps in the kernel's order as rows
    (b, band, j, carry): block i takes steps steps * i // grid .. steps *
    (i + 1) // grid - 1. Step (b, band, j) stores skip0 rows ENC0_OUT band
    .. ENC0_OUT (band + 1) - 1 and columns ENC0_STEP j .. ENC0_STEP (j + 1)
    - 1, and the pooled pixels of half those, each clipped to the output;
    carry 1 where its stem takes h columns 0, 1 from the step before (the
    block's, at j - 1)."""
    out = []
    for blk in range(plan.grid):
        t = np.arange(plan.steps * blk // plan.grid, plan.steps * (blk + 1) // plan.grid)
        j = t % plan.nj
        carry = (j > 0) & (np.arange(len(t)) > 0)
        out.append(np.stack([t // (plan.nj * plan.nbands), (t // plan.nj) % plan.nbands, j,
                             carry.astype(t.dtype)], axis=1))
    return out


class FwdPlan(NamedTuple):
    mode: str  # "im2col" or "window"
    n: int  # output channels a block
    stages: Tuple[int, ...]  # window: (window, weight) stages; im2col: (stages,)
    smem: int  # dynamic shared memory bytes of a block
    units: int  # m64 units over all images (64 pixels or 8x8 pixels)
    tiles: int  # (group of four units, N block) tiles
    grid: int  # blocks of the persistent grid
    fill: float  # output pixels / pixels the tiles compute


def fwd_smem_bytes(n: int, mode: str = "window", head: bool = False) -> int:
    """1 KB of alignment slack, the stages, the epilogue tiles and a full
    and an empty mbarrier per stage (and the head variant's 1x1 weights).
    A window stage holds one 1 KB-aligned window per unit, a weight stage
    n rows of 128 bytes; an im2col stage holds 256 pixels of 128 bytes and
    the n x 64 weight tile."""
    row = 2 * FWD_SLICE
    if mode == "im2col":
        st = FWD_IM2COL_STAGES
        return (1024 + st * (FWD_CONSUMERS * FWD_UPW * 64 * row + n * row) + FWD_EPI_BYTES
                + 2 * st * 8)
    wst, bst = FWD_STAGES[n]
    return (1024 + wst * FWD_CONSUMERS * FWD_UPW * FWD_WIN_SLOT + bst * n * row
            + FWD_EPI_BYTES + 2 * (wst + bst) * 8 + (FWD_HEAD_BYTES if head else 0))


def fwd_plan(bsz: int, ho: int, wo: int, co: int, sm_count: int, pool: bool = False,
             sources: int = 1, head: bool = False) -> FwdPlan:
    """The launch plan of csrc/conv_fwd_wgmma.cu for outputs (bsz, ho, wo,
    co) from `sources` inputs, with or without the fused 2x2 pool; `head`
    is conv3x3_head's variant (co 64: windowed, the logits of (ho, wo)).
    A source's offset (the dgrad reads g at (-2, -2)) changes no form: the
    im2col map's bounding box moves with it."""
    n = 128 if co % 128 == 0 else 64
    if head and (co != 64 or pool or sources != 1):
        raise ValueError("the head variant has one source, no pool and 64 channels")
    upb = FWD_CONSUMERS * FWD_UPW
    if sources == 1 and not pool and n == 128:
        units = -(-bsz * ho * wo // 64)
        tiles = -(-units // upb) * (co // n)
        return FwdPlan("im2col", n, (FWD_IM2COL_STAGES,), fwd_smem_bytes(n, "im2col"), units,
                       tiles, min(tiles, sm_count), bsz * ho * wo / (-(-units // upb) * upb * 64))
    units = bsz * -(-ho // FWD_UNIT) * -(-wo // FWD_UNIT)
    tiles = -(-units // upb) * (co // n)
    return FwdPlan("window", n, FWD_STAGES[n], fwd_smem_bytes(n, head=head), units, tiles,
                   min(tiles, sm_count), bsz * ho * wo / (units * FWD_UNIT * FWD_UNIT))


# csrc/conv3x3_bias_relu.cu's stem (CI == 1) launch plan: a strip is two
# output rows x STEM_SW columns of one 64-channel block (a TMA store box of
# 64 x STEM_SW x 2, the pool's 64 x STEM_SW / 2 x 1); its four input rows
# of STEM_IN values each, copied from the 16-byte boundary at or before
# the row's first value, sit STEM_IN_ROW bytes apart; STEM_TILES output
# (and, when pooled, pool) tiles, two input stages; up to
# STEM_BLOCKS_PER_SM blocks of 256 threads per SM, as many as fit.
STEM_SW, STEM_TILES, STEM_BLOCKS_PER_SM, TMA_BOX_MAX = 128, 2, 3, 256
STEM_IN = STEM_SW + 16
STEM_IN_ROW = -(-STEM_IN * 2 // 128) * 128
SM_SHARED = 233_472  # shared memory of an H100 SM, 1 KB of it reserved per block


class StemPlan(NamedTuple):
    nq: int  # quad rows: output rows 2 qy, 2 qy + 1
    nseg: int  # column segments of STEM_SW
    ncb: int  # 64-channel blocks
    strips: int  # (image, quad row, segment, channel block)
    per_sm: int  # blocks resident on an SM
    grid: int  # blocks of the persistent grid
    smem: int  # dynamic shared memory bytes of a block


def stem_smem_bytes(co: int, pool: bool = False) -> int:
    """1 KB of alignment slack, the output tiles (2 x STEM_SW pixels x 128
    bytes each), the pool tiles when pooled, two input stages of four rows,
    the f32 weights (9 x co) and bias (co), two mbarriers."""
    tile, ptile = 2 * STEM_SW * 128, STEM_SW // 2 * 128
    return (1024 + STEM_TILES * (tile + (ptile if pool else 0)) + 2 * 4 * STEM_IN_ROW
            + 10 * co * 4 + 16)


def stem_plan(bsz: int, ho: int, wo: int, co: int, sm_count: int, pool: bool = False) -> StemPlan:
    """The launch plan of the stem's row kernel for outputs (bsz, ho, wo,
    co): as many blocks per SM as the shared memory holds, up to
    STEM_BLOCKS_PER_SM (the kernel asks the occupancy API, which also
    counts registers: 72 a thread on an H100, not the limit at three
    blocks); block i walks strips i, i + grid, ..."""
    nq, nseg, ncb = -(-ho // 2), -(-wo // STEM_SW), co // 64
    strips = bsz * nq * nseg * ncb
    smem = stem_smem_bytes(co, pool)
    per_sm = max(1, min(STEM_BLOCKS_PER_SM, SM_SHARED // (smem + 1024)))
    return StemPlan(nq, nseg, ncb, strips, per_sm, min(strips, per_sm * sm_count), smem)


def stem_strips(plan: StemPlan) -> List[np.ndarray]:
    """Per block of the plan's grid, its strips in the kernel's order: rows
    (b, qy, c0, cb), strip i in (image, quad row, column segment, channel
    block) order. The strip's store box covers output rows 2 qy, 2 qy + 1
    and columns c0 .. c0 + STEM_SW - 1 of channels 64 cb .. 64 cb + 63,
    clipped to the output; its pool box pooled row qy, columns c0 / 2 ..
    c0 / 2 + STEM_SW / 2 - 1."""
    out = []
    for blk in range(plan.grid):
        i = np.arange(blk, plan.strips, plan.grid)
        i, cb = np.divmod(i, plan.ncb)
        i, seg = np.divmod(i, plan.nseg)
        b, qy = np.divmod(i, plan.nq)
        out.append(np.stack([b, qy, seg * STEM_SW, cb], axis=1))
    return out


def im2col_corners(h: int, w: int, ho: int, wo: int, off_y: int, off_x: int):
    """The bounding box of csrc/hopper.cuh nhwc_im2col_map for a source (h,
    w) read at (off_y, off_x) by (ho, wo) outputs: ((lower w, lower h),
    (upper w, upper h)), the box spanning [lower, dim + upper) in each."""
    return (off_x, off_y), (off_x + wo - w, off_y + ho - h)


class TconvPlan(NamedTuple):
    nb: int  # column groups of TCONV_NG
    slices: int  # 64-channel slices of CI
    resident: bool  # the weights loaded once per block
    mtiles: int  # tiles of TCONV_MT input pixels
    tiles: int  # (pixel tile, column group) tiles
    grid: int  # blocks of the persistent grid
    smem: int  # dynamic shared memory bytes of a block


def tconv_plan(bsz: int, h: int, w: int, ci: int, co: int, sm_count: int) -> TconvPlan:
    """The launch plan of csrc/tconv2x2_bias.cu for x (bsz, h, w, ci) and
    co output channels: block i walks tiles i, i + grid, ...; tile t is
    column group t % nb of pixel tile t // nb."""
    nb, slices = 4 * co // TCONV_NG, -(-ci // FWD_SLICE)
    mtiles = -(-bsz * h * w // TCONV_MT)
    ast, wst = TCONV_STAGES
    row = 2 * FWD_SLICE
    smem = (1024 + ast * TCONV_MT * row + wst * TCONV_NG * row + FWD_EPI_BYTES
            + 2 * (ast + wst) * 8)
    return TconvPlan(nb, slices, nb == 1 and slices <= wst, mtiles, mtiles * nb,
                     min(mtiles * nb, sm_count), smem)


def tconv_store_offsets(bsz: int, h: int, w: int, co: int) -> np.ndarray:
    """(B h w, 4 co / 64) int64: where csrc/tconv2x2_bias.cu's epilogue
    stores GEMM row p (input pixel (b, r, j)) and its 64 columns 64 k ..
    64 k + 63: the flat offset in y (bsz, 2h, 2w, co) of those 64
    contiguous channels, output pixel (2r + dy, 2j) plus `off` channels
    (the columns' (dy, dx, co) order puts dx co + co there)."""
    p = np.arange(bsz * h * w, dtype=np.int64)[:, None]
    col = np.arange(0, 4 * co, FWD_SLICE, dtype=np.int64)[None, :]
    b, rem = np.divmod(p, h * w)
    r, j = np.divmod(rem, w)
    dy = col // (2 * co)
    off = col - dy * 2 * co
    return ((b * 2 * h + 2 * r + dy) * 2 * w + 2 * j) * co + off


def fwd_tile_units(plan: FwdPlan, bsz: int, ho: int, wo: int) -> List[np.ndarray]:
    """Per block of the plan's grid, its tiles' units in the kernel's
    order: block i walks tiles i, i + grid, ...; tile t is N block t % nb
    of unit group t // nb; units past the last are dropped (the kernel
    computes them and stores nothing). Rows (tile, b, uy, ux, n0) of 8x8
    units for "window", (tile, first pixel, n0) of 64-pixel units for
    "im2col"."""
    upb = FWD_CONSUMERS * FWD_UPW
    nb = plan.tiles // -(-plan.units // upb)
    out = []
    for blk in range(plan.grid):
        t = np.arange(blk, plan.tiles, plan.grid)
        ui = ((t // nb)[:, None] * upb + np.arange(upb)[None, :]).ravel()
        tt = np.repeat(t, upb)
        keep = ui < plan.units
        ui, tt = ui[keep], tt[keep]
        if plan.mode == "im2col":
            out.append(np.stack([tt, ui * 64, (tt % nb) * plan.n], axis=1))
            continue
        nuy, nux = -(-ho // FWD_UNIT), -(-wo // FWD_UNIT)
        b, r = np.divmod(ui, nuy * nux)
        out.append(np.stack([tt, b, (r // nux) * FWD_UNIT, (r % nux) * FWD_UNIT,
                             (tt % nb) * plan.n], axis=1))
    return out


# ------------------------------------------------------------ plain versions
def conv3x3_bias_relu_plain(x, w, b, fuse_pool=False, relu=True):
    y = F.conv2d(to_nchw(x), w.to(x.dtype), b.to(x.dtype))
    if relu:
        y = F.relu(y)
    if fuse_pool:
        return to_nhwc(y), to_nhwc(F.max_pool2d(y, 2))
    return to_nhwc(y)


def tconv2x2_bias_plain(x, w, b):
    y = F.conv_transpose2d(to_nchw(x), w.to(x.dtype), b.to(x.dtype), stride=2)
    return to_nhwc(y)


def dec_conv0_plain(skip, up, w, b, row_off, col_off, relu=True):
    hu, wu = up.shape[1], up.shape[2]
    crop = skip[:, row_off : row_off + hu, col_off : col_off + wu, :]
    xc = torch.cat([crop, up], dim=-1)
    return conv3x3_bias_relu_plain(xc, w, b, relu=relu)


def conv3x3_head_plain(x, w, b, k_head, b_head):
    y = conv3x3_bias_relu_plain(x, w, b)  # rounded to x.dtype, as stored
    kh = k_head.to(x.dtype).float()
    return to_nhwc(F.conv2d(to_nchw(y).float(), kh, b_head.float()))


def enc0_fused_plain(x, w0, b0, w1, b1):
    h = conv3x3_bias_relu_plain(x, w0, b0)  # the stem, rounded to x.dtype
    return conv3x3_bias_relu_plain(h, w1, b1, fuse_pool=True)


def dec_tail_plain(skip, up, w0, b0, w1, b1, k_head, b_head, row_off, col_off):
    y = dec_conv0_plain(skip, up, w0, b0, row_off, col_off)  # rounded to up.dtype
    return conv3x3_head_plain(y, w1, b1, k_head, b_head)


# ------------------------------------------------------------------ helpers
def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True routes to the plain version; False means launch the kernel.
    Raises for mixed devices and for devices with no kernel."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    return False


def _check_act(name: str, t: torch.Tensor, channels_multiple: int = 32) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bfloat16, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous NHWC tensor, got {tuple(t.shape)}")
    c = t.shape[3]
    if c % channels_multiple:
        raise ValueError(f"{name}: channels {c} not a multiple of {channels_multiple}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data not 16-byte aligned")


def _check_co(co: int, exact: Optional[int] = None) -> None:
    if exact is not None and co != exact:
        raise ValueError(f"kernel needs exactly {exact} output channels, got {co}")
    if co % 64:
        raise ValueError(f"kernel needs output channels a multiple of 64, got {co}")


def _check_crop(skip: torch.Tensor, up: torch.Tensor, row_off: int, col_off: int) -> None:
    hs, ws, hu, wu = skip.shape[1], skip.shape[2], up.shape[1], up.shape[2]
    if row_off < 0 or col_off < 0 or row_off + hu > hs or col_off + wu > ws:
        raise ValueError(f"crop ({row_off}, {col_off}) + {hu}x{wu} leaves skip {hs}x{ws}")
    if skip.shape[0] != up.shape[0]:
        raise ValueError(f"skip batch {skip.shape[0]} != up batch {up.shape[0]}")
    if up.dtype != skip.dtype:
        raise TypeError(f"skip {skip.dtype} and up {up.dtype} differ")
    _check_act("skip", skip)
    _check_act("up", up)


def _ohwi(w: torch.Tensor) -> torch.Tensor:
    """(CO, CI, 3, 3) -> contiguous bf16 (CO, 3, 3, CI)."""
    return w.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _tconv_weights(w: torch.Tensor) -> torch.Tensor:
    """(CI, CO, 2, 2) -> contiguous bf16 (4 CO, CI), GEMM column (2 dy +
    dx) CO + co: the (dy, dx, co) order that makes 2 CO columns of one dy
    one contiguous run of output pixels (2r + dy, 2j) and (2r + dy, 2j + 1)."""
    ci, co = w.shape[0], w.shape[1]
    return w.to(torch.bfloat16).permute(2, 3, 1, 0).reshape(4 * co, ci).contiguous()


def _head(k_head: torch.Tensor, b_head: torch.Tensor, co: int):
    """The head's (NC, CO) kernel as bf16-rounded f32 values, and its bias."""
    nc = k_head.shape[0]
    if tuple(k_head.shape) != (nc, co, 1, 1) or tuple(b_head.shape) != (nc,):
        raise ValueError(f"head {tuple(k_head.shape)} / {tuple(b_head.shape)} does not fit "
                         f"{co} channels")
    if not 1 <= nc <= MAX_HEAD_CLASSES:
        raise ValueError(f"head kernel takes 1..{MAX_HEAD_CLASSES} classes, got {nc}")
    return k_head.reshape(nc, co).to(torch.bfloat16).float().contiguous(), _f32(b_head)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _launch_conv3x3(name, x, w, b, fuse_pool, relu):
    """csrc/conv3x3_bias_relu.cu on CUDA tensors, for the wrappers that
    launch it; the caller counts the launch."""
    bsz, h, wd, ci = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, ci, 3, 3) or tuple(b.shape) != (co,):
        raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} do not fit x {tuple(x.shape)}")
    _check_act("x", x, channels_multiple=1 if ci == 1 else 32)
    _check_co(co)
    ho, wo = h - 2, wd - 2
    if ho < 1 or wo < 1:
        raise ValueError(f"input {h}x{wd} too small for a valid 3x3 conv")
    y = torch.empty((bsz, ho, wo, co), dtype=x.dtype, device=x.device)
    pooled = (
        torch.empty((bsz, ho // 2, wo // 2, co), dtype=x.dtype, device=x.device)
        if fuse_pool else None
    )
    wk, bk = _ohwi(w), _f32(b)
    err = library().conv3x3_bias_relu_bf16(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
        pooled.data_ptr() if fuse_pool else None,
        bsz, h, wd, ci, co, int(relu), _stream(x),
    )
    _raise_on(err, name)
    return (y, pooled) if fuse_pool else y


def _launch_dec_conv0(name, skip, up, w, b, row_off, col_off, relu):
    """csrc/dec_conv0.cu on CUDA tensors, for the wrappers that launch it;
    the caller counts the launch."""
    bsz, hs, ws, cis = skip.shape
    _, hu, wu, ciu = up.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, cis + ciu, 3, 3) or tuple(b.shape) != (co,):
        raise ValueError(
            f"skip {tuple(skip.shape)}, up {tuple(up.shape)}, weight "
            f"{tuple(w.shape)}, bias {tuple(b.shape)} do not fit together"
        )
    _check_crop(skip, up, row_off, col_off)
    _check_co(co)
    y = torch.empty((bsz, hu - 2, wu - 2, co), dtype=up.dtype, device=up.device)
    wk, bk = _ohwi(w), _f32(b)
    err = library().dec_conv0_bf16(
        skip.data_ptr(), hs, ws, cis, row_off, col_off,
        up.data_ptr(), hu, wu, ciu, wk.data_ptr(), bk.data_ptr(),
        y.data_ptr(), bsz, co, int(relu), _stream(up),
    )
    _raise_on(err, name)
    return y


# ----------------------------------------------------------------- wrappers
@counted
def conv3x3_bias_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, fuse_pool: bool = False,
    relu: bool = True,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """ReLU(valid 3x3 conv(x, w) + b), NHWC (without the ReLU when relu is
    False).

    x (B,H,W,CI), w (CO,CI,3,3), b (CO,) -> (B,H-2,W-2,CO) in x's dtype;
    with fuse_pool also the 2x2 max-pool (B,(H-2)//2,(W-2)//2,CO), floor
    on odd sizes. The kernel takes CI == 1 (the stem) or CI % 32 == 0."""
    if _on_cpu(x, w, b):
        return conv3x3_bias_relu_plain(x, w, b, fuse_pool, relu)
    out = _launch_conv3x3("conv3x3_bias_relu", x, w, b, fuse_pool, relu)
    conv3x3_bias_relu.launches += 1
    return out


@counted
def conv3x3_dense(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, fuse_pool: bool = False,
    relu: bool = True,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The tier-2 convs (enc1 conv0, enc1 conv1 with the pool, dec2 conv1):
    conv3x3_bias_relu's function, counted as the counterpart of the TPU's
    dense-lanes kernel."""
    if _on_cpu(x, w, b):
        return conv3x3_bias_relu_plain(x, w, b, fuse_pool, relu)
    out = _launch_conv3x3("conv3x3_dense", x, w, b, fuse_pool, relu)
    conv3x3_dense.launches += 1
    return out


@counted
def conv3x3_cblock(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True,
) -> torch.Tensor:
    """A middle conv routed by the cblock option: ReLU(valid 3x3 conv(x, w)
    + b), NHWC. Output channels must be a multiple of 128, as the TPU
    kernel asserts, on either device."""
    if w.shape[0] % CBLOCK_CO:
        raise ValueError(
            f"conv3x3_cblock needs output channels a multiple of {CBLOCK_CO}, got {w.shape[0]}"
        )
    if _on_cpu(x, w, b):
        return conv3x3_bias_relu_plain(x, w, b, relu=relu)
    out = _launch_conv3x3("conv3x3_cblock", x, w, b, False, relu)
    conv3x3_cblock.launches += 1
    return out


@counted
def enc0_fused(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
    b1: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stem, enc0 conv1 and the 2x2 max-pool in one kernel:
    h = ReLU(conv(x, w0) + b0) rounded to x's dtype, skip0 = ReLU(conv(h,
    w1) + b1), pooled = maxpool2x2(skip0), floor on odd sizes.

    x (B,H,W,1), w0 (F,1,3,3), w1 (F,F,3,3), b0 and b1 (F,) -> (skip0
    (B,H-4,W-4,F), pooled (B,(H-4)//2,(W-4)//2,F)). The kernel needs F == 64;
    on a CUDA tensor its bits are those of conv3x3_bias_relu (the stem)
    chained with conv3x3_bias_relu(..., fuse_pool=True)."""
    if _on_cpu(x, w0, b0, w1, b1):
        return enc0_fused_plain(x, w0, b0, w1, b1)
    bsz, h, wd, ci = x.shape
    f = w0.shape[0]
    if (ci != 1 or tuple(w0.shape) != (f, 1, 3, 3) or tuple(w1.shape) != (f, f, 3, 3)
            or tuple(b0.shape) != (f,) or tuple(b1.shape) != (f,)):
        raise ValueError(f"stem {tuple(w0.shape)} / conv1 {tuple(w1.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    _check_act("x", x, channels_multiple=1)
    _check_co(f, exact=64)
    ho, wo = h - 4, wd - 4
    if ho < 1 or wo < 1:
        raise ValueError(f"input {h}x{wd} too small for two valid 3x3 convs")
    y = torch.empty((bsz, ho, wo, f), dtype=x.dtype, device=x.device)
    pooled = torch.empty((bsz, ho // 2, wo // 2, f), dtype=x.dtype, device=x.device)
    w0k, w1k, b0k, b1k = _ohwi(w0), _ohwi(w1), _f32(b0), _f32(b1)
    err = library().enc0_fused_bf16(
        x.data_ptr(), w0k.data_ptr(), b0k.data_ptr(), w1k.data_ptr(), b1k.data_ptr(),
        y.data_ptr(), pooled.data_ptr(), bsz, h, wd, _stream(x),
    )
    _raise_on(err, "enc0_fused")
    enc0_fused.launches += 1
    return y, pooled


@counted
def tconv2x2_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transposed conv + b, NHWC: x (B,h,w,CI), w (CI,CO,2,2)
    (torch ConvTranspose2d layout), b (CO,) -> (B,2h,2w,CO)."""
    if _on_cpu(x, w, b):
        return tconv2x2_bias_plain(x, w, b)
    bsz, h, wd, ci = x.shape
    co = w.shape[1]
    if tuple(w.shape) != (ci, co, 2, 2) or tuple(b.shape) != (co,):
        raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    _check_act("x", x)
    _check_co(co)
    y = torch.empty((bsz, 2 * h, 2 * wd, co), dtype=x.dtype, device=x.device)
    wk, bk = _tconv_weights(w), _f32(b)
    err = library().tconv2x2_bias_bf16(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(), bsz, h, wd, ci, co, _stream(x),
    )
    _raise_on(err, "tconv2x2_bias")
    tconv2x2_bias.launches += 1
    return y


@counted
def dec_conv0(
    skip: torch.Tensor, up: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    row_off: int, col_off: int, relu: bool = True,
) -> torch.Tensor:
    """ReLU(conv3x3(concat(skip[:, row_off:row_off+Hu, col_off:col_off+Wu],
    up)) + b), NHWC, without materialising the crop or the concat (without
    the ReLU when relu is False).

    skip (B,Hs,Ws,CIs), up (B,Hu,Wu,CIu), w (CO,CIs+CIu,3,3) skip channels
    first, b (CO,) -> (B,Hu-2,Wu-2,CO). Any offsets, odd ones included."""
    if _on_cpu(skip, up, w, b):
        return dec_conv0_plain(skip, up, w, b, row_off, col_off, relu)
    out = _launch_dec_conv0("dec_conv0", skip, up, w, b, row_off, col_off, relu)
    dec_conv0.launches += 1
    return out


@counted
def dec_conv0_dense(
    skip: torch.Tensor, up: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    row_off: int, col_off: int, relu: bool = True,
) -> torch.Tensor:
    """The tier-2 decoder entry (dec2 conv0, skip1 at its centre-crop
    offset): dec_conv0's function, counted as the counterpart of the TPU's
    dense-lanes kernel."""
    if _on_cpu(skip, up, w, b):
        return dec_conv0_plain(skip, up, w, b, row_off, col_off, relu)
    out = _launch_dec_conv0("dec_conv0_dense", skip, up, w, b, row_off, col_off, relu)
    dec_conv0_dense.launches += 1
    return out


@counted
def conv3x3_head(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    k_head: torch.Tensor, b_head: torch.Tensor,
) -> torch.Tensor:
    """1x1 head over ReLU(valid 3x3 conv(x, w) + b), NHWC.

    x (B,H,W,CI), w (CO,CI,3,3), b (CO,), k_head (NC,CO,1,1), b_head (NC,)
    -> f32 logits (B,H-2,W-2,NC). The activation is rounded to x's dtype
    and the head kernel to x's dtype before the f32 head product, as the
    unfused path stores and reads them. The kernel needs CO == 64."""
    if _on_cpu(x, w, b, k_head, b_head):
        return conv3x3_head_plain(x, w, b, k_head, b_head)
    bsz, h, wd, ci = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, ci, 3, 3) or tuple(b.shape) != (co,):
        raise ValueError("head conv weights do not fit x")
    kh, bh = _head(k_head, b_head, co)
    _check_act("x", x)
    _check_co(co, exact=64)
    if h < 3 or wd < 3:
        raise ValueError(f"input {h}x{wd} too small for a valid 3x3 conv")
    logits = torch.empty((bsz, h - 2, wd - 2, kh.shape[0]), dtype=torch.float32, device=x.device)
    wk, bk = _ohwi(w), _f32(b)
    err = library().conv3x3_head_bf16(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), kh.data_ptr(), bh.data_ptr(),
        logits.data_ptr(), bsz, h, wd, ci, kh.shape[0], _stream(x),
    )
    _raise_on(err, "conv3x3_head")
    conv3x3_head.launches += 1
    return logits


@counted
def dec_tail(
    skip: torch.Tensor, up: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor, k_head: torch.Tensor, b_head: torch.Tensor,
    row_off: int, col_off: int,
) -> torch.Tensor:
    """The decoder tail in one kernel: dec_conv0 (skip read at (row_off,
    col_off)), its output rounded to up's dtype, then conv3x3_head.

    skip (B,Hs,Ws,CIs), up (B,Hu,Wu,CIu), w0 (CO,CIs+CIu,3,3), w1
    (CO,CO,3,3), b0 and b1 (CO,), k_head (NC,CO,1,1), b_head (NC,) -> f32
    logits (B,Hu-4,Wu-4,NC). The kernel needs CO == 64."""
    if _on_cpu(skip, up, w0, b0, w1, b1, k_head, b_head):
        return dec_tail_plain(skip, up, w0, b0, w1, b1, k_head, b_head, row_off, col_off)
    bsz, hs, ws, cis = skip.shape
    _, hu, wu, ciu = up.shape
    co = w0.shape[0]
    if (tuple(w0.shape) != (co, cis + ciu, 3, 3) or tuple(w1.shape) != (co, co, 3, 3)
            or tuple(b0.shape) != (co,) or tuple(b1.shape) != (co,)):
        raise ValueError(f"skip {tuple(skip.shape)}, up {tuple(up.shape)}, conv0 "
                         f"{tuple(w0.shape)}, conv1 {tuple(w1.shape)} do not fit together")
    kh, bh = _head(k_head, b_head, co)
    _check_crop(skip, up, row_off, col_off)
    _check_co(co, exact=64)
    if hu < 5 or wu < 5:
        raise ValueError(f"up {hu}x{wu} too small for two valid 3x3 convs")
    logits = torch.empty((bsz, hu - 4, wu - 4, kh.shape[0]), dtype=torch.float32,
                         device=up.device)
    w0k, w1k, b0k, b1k = _ohwi(w0), _ohwi(w1), _f32(b0), _f32(b1)
    err = library().dec_tail_bf16(
        skip.data_ptr(), hs, ws, cis, row_off, col_off, up.data_ptr(), hu, wu, ciu,
        w0k.data_ptr(), b0k.data_ptr(), w1k.data_ptr(), b1k.data_ptr(),
        kh.data_ptr(), bh.data_ptr(), kh.shape[0], logits.data_ptr(), bsz, _stream(up),
    )
    _raise_on(err, "dec_tail")
    dec_tail.launches += 1
    return logits
