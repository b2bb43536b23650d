"""The train step's convolution kernels and the autograd Functions around
them (counterpart of unetseg_tpu/ops/pallas/conv3x3_train.py).

| wrapper                  | CUDA source                         | TPU kernel it replaces (ops/pallas/conv3x3_train.py) |
|--------------------------|-------------------------------------|------------------------------------------------------|
| conv3x3_dgrad            | csrc/conv3x3_dgrad.cu               | conv3x3_phase2_dx                                    |
| conv3x3_wgrad            | csrc/conv3x3_wgrad.cu               | conv3x3_phase2_dw                                    |
| conv3x3_dec0_wgrad       | csrc/conv3x3_wgrad.cu (two sources) | conv3x3_dec0_dw                                      |
| conv3x3_dense_dgrad      | csrc/conv3x3_dgrad.cu               | conv3x3_dense_dx                                     |
| conv3x3_dense_wgrad      | csrc/conv3x3_wgrad.cu               | conv3x3_dense_dw                                     |
| conv3x3_dec0_dense_wgrad | csrc/conv3x3_wgrad.cu (two sources) | conv3x3_dec0_dense_dw                                |

Both dgrad wrappers launch the wgmma forward's kernels (csrc/
conv_fwd_wgmma.cu under the names conv_dgrad_kernel and
conv_dgrad_im2col_kernel) on g read at (-2, -2) with the flipped,
transposed weights of `dgrad_weights`; `dgrad_plan` is their launch plan.
The wgrad wrappers launch the split-K wgmma kernel of
csrc/conv3x3_wgrad.cu, or for one input channel (the stem) its TMA +
mma.sync kernel; `wgrad_chunks` and `wgrad_stem_tiles` mirror their split.

The TPU needed one kernel per layout (2-phase lanes for tier 1, dense
lanes for tier 2's enc1 and dec2); on NHWC the two layouts' gradients are
one function each, so the dense wrappers launch the same CUDA kernels and
count apart. Routing as in ops/kernels/conv3x3.py: a CPU tensor runs the
plain PyTorch version beside the wrapper, a CUDA tensor the Hopper kernel
or a raise; each wrapper counts its launches.

The Functions are the custom VJPs of the JAX package without its lanes
layout (activations NHWC, weights in torch's layouts):
  Conv3x3Train        make_conv_p2_train: forward conv3x3_bias_relu
                      (relu=False), backward dgrad + wgrad, db = sum g in
                      fp32;
  Conv3x3DenseTrain   make_conv_dense_train: the same through conv3x3_dense,
                      conv3x3_dense_dgrad and conv3x3_dense_wgrad;
  DecConv0Train       make_dec0_p2_train: forward dec_conv0(relu=False),
                      backward dgrad into the concat gradient, split into
                      the crop's (scattered into a zero skip-frame
                      gradient) and up's, then the two-source wgrad;
  DecConv0DenseTrain  make_dec0_dense_train: the same through
                      dec_conv0_dense, conv3x3_dense_dgrad and
                      conv3x3_dec0_dense_wgrad;
  TConv2x2Train       lanes_train.make_tconv_p2_train: forward
                      tconv2x2_bias, backward plain channel contractions
                      (the JAX backward is XLA dot_generals, not a kernel).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from unetseg_tpu_torch.models.unet import to_nchw, to_nhwc
from unetseg_tpu_torch.ops.kernels.build import library
from unetseg_tpu_torch.ops.kernels.conv3x3 import (
    _check_act,
    _check_co,
    _on_cpu,
    _raise_on,
    _stream,
    conv3x3_bias_relu,
    conv3x3_dense,
    dec_conv0,
    dec_conv0_dense,
    fwd_plan,
    tconv2x2_bias,
)
from unetseg_tpu_torch.ops.kernels.launches import counted

# csrc/conv3x3_wgrad.cu's block geometry, mirrored for the split-K chunk
# count and the shared-memory check (tests/test_torch_port_tier2_kernels.py,
# tests/test_torch_port_wgrad_tail_plan.py). The wgmma kernel: 4x16-pixel
# tiles, 64-channel ci slices and co blocks, a ring of 8 stages (g tile + x
# window, each stage 1 KB aligned), one block per SM. The stem's TMA kernel
# (ci == 1): tiles of 4 x 64 g pixels, a ring of 6 stages (the g tile and
# the tile's 6 x rows of WGRAD_STEM_XIN values, 1 KB aligned), four
# consumer warps, one block per SM.
WGRAD_TILE, WGRAD_CHANNELS, WGRAD_STAGES, WGRAD_BLOCKS_PER_SM = (4, 16), 64, 8, 1
WGRAD_STEM_TILE, WGRAD_STEM_STAGES, WGRAD_STEM_BLOCKS_PER_SM = (4, 64), 6, 1
WGRAD_STEM_XIN = WGRAD_STEM_TILE[1] + 16
SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block can use


# ------------------------------------------------------------ plain versions
def conv3x3_dgrad_plain(g, w):
    b, hg, wg, _ = g.shape
    dx = torch.nn.grad.conv2d_input((b, w.shape[1], hg + 2, wg + 2),
                                    w.to(g.dtype), to_nchw(g))
    return to_nhwc(dx)


def conv3x3_wgrad_plain(x, g):
    co, ci = g.shape[3], x.shape[3]
    return torch.nn.grad.conv2d_weight(to_nchw(x), (co, ci, 3, 3), to_nchw(g)).float()


def conv3x3_dec0_wgrad_plain(skip, up, g, row_off, col_off):
    hu, wu = up.shape[1], up.shape[2]
    crop = skip[:, row_off : row_off + hu, col_off : col_off + wu, :]
    return conv3x3_wgrad_plain(torch.cat([crop, up], dim=-1), g)


def dgrad_weights(w: torch.Tensor) -> torch.Tensor:
    """(CO, CI, 3, 3) -> contiguous bf16 wt (CI, 3, 3, CO), wt[ci, ky, kx,
    co] = w[co, ci, 2-ky, 2-kx]: flipped, CI <-> CO. The forward's OHWI
    layout with O = dx channels and I = g channels, so the dgrad is the
    forward conv of g read at (-2, -2) with these weights."""
    return w.to(torch.bfloat16).flip(2, 3).permute(1, 2, 3, 0).contiguous()


def dgrad_plan(bsz: int, hg: int, wg: int, ci: int, sm_count: int):
    """The launch plan of csrc/conv3x3_dgrad.cu for g (bsz, hg, wg, .) and
    ci dx channels: the wgmma forward's (ops/kernels/conv3x3.py fwd_plan)
    for one source without the pool over the (hg + 2, wg + 2) outputs; the
    source's (-2, -2) offset changes no form."""
    return fwd_plan(bsz, hg + 2, wg + 2, ci, sm_count)


# ------------------------------------------------------------------ launches
def _launch_dgrad(name, g, w):
    """csrc/conv3x3_dgrad.cu on CUDA tensors, for the wrappers that launch
    it; the caller counts the launch."""
    bsz, hg, wg, co = g.shape
    ci = w.shape[1]
    if tuple(w.shape) != (co, ci, 3, 3):
        raise ValueError(f"weight {tuple(w.shape)} does not fit g {tuple(g.shape)}")
    _check_act("g", g)
    _check_co(ci)
    dx = torch.empty((bsz, hg + 2, wg + 2, ci), dtype=g.dtype, device=g.device)
    wt = dgrad_weights(w)
    err = library().conv3x3_dgrad_bf16(
        g.data_ptr(), wt.data_ptr(), dx.data_ptr(), bsz, hg, wg, co, ci, _stream(g),
    )
    _raise_on(err, name)
    return dx


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def wgrad_smem_bytes() -> int:
    """Dynamic shared memory of one wgmma block: 1 KB of alignment slack,
    the stages (g's tile and the (th+2) x (tw+2) x window, 128 bytes a
    pixel, each rounded up to 1 KB) and a full and an empty mbarrier per
    stage."""
    th, tw = WGRAD_TILE
    row = 2 * WGRAD_CHANNELS
    x_slot = -(-(th + 2) * (tw + 2) * row // 1024) * 1024
    return 1024 + WGRAD_STAGES * (th * tw * row + x_slot) + 2 * WGRAD_STAGES * 8


def wgrad_stem_smem_bytes() -> int:
    """Dynamic shared memory of one stem block: 1 KB of alignment slack,
    the stages (the g tile at 128 bytes a pixel and the tile's th + 2 x rows
    of WGRAD_STEM_XIN bf16 values, each row 128-byte aligned, rounded up to
    1 KB), the four consumer
    warps' 64 x 9 f32 sums, a full and an empty mbarrier per stage."""
    th, tw = WGRAD_STEM_TILE
    x_row = -(-WGRAD_STEM_XIN * 2 // 128) * 128  # a copy's destination is 128-byte aligned
    x_slot = -(-(th + 2) * x_row // 1024) * 1024
    return (1024 + WGRAD_STEM_STAGES * (th * tw * 2 * WGRAD_CHANNELS + x_slot)
            + th * 64 * 9 * 4 + 2 * WGRAD_STEM_STAGES * 8)


def wgrad_stem_tiles(bsz: int, ho: int, wo: int, nchunks: int) -> list:
    """The stem kernel's split-K walk over g (bsz, ho, wo, .): per chunk
    (block) its tiles in order as rows (b, y0, x0), tile i of the chunk
    range [T c / n, T (c + 1) / n) in (image, tile row, tile column) order."""
    th, tw = WGRAD_STEM_TILE
    nty, ntx = -(-ho // th), -(-wo // tw)
    ntiles = bsz * nty * ntx
    out = []
    for c in range(nchunks):
        t = np.arange(ntiles * c // nchunks, ntiles * (c + 1) // nchunks)
        b, r = np.divmod(t, nty * ntx)
        out.append(np.stack([b, (r // ntx) * th, (r % ntx) * tw], axis=1))
    return out


def wgrad_chunks(bsz: int, ho: int, wo: int, cis: tuple, co: int, sm_count: int) -> int:
    """Split-K chunks of one csrc/conv3x3_wgrad.cu launch over g (bsz, ho,
    wo, co) and sources of `cis` channels each: a chunk is one block per
    64-channel slice of each source (one for the stem, cis == (1,)) and per
    64 output channels, and the chunks fill one wave of the kernel's blocks
    per SM. Rounding up would leave a tail wave of a few blocks that
    doubles the time (17 chunks of 16 blocks at ci 256, co 128 made 272
    blocks against the 264 an H100 held at two blocks per SM)."""
    if tuple(cis) == (1,):
        (th, tw), per_sm, slices = WGRAD_STEM_TILE, WGRAD_STEM_BLOCKS_PER_SM, 1
    else:
        (th, tw), per_sm = WGRAD_TILE, WGRAD_BLOCKS_PER_SM
        slices = sum(-(-c // WGRAD_CHANNELS) for c in cis)
    tiles = bsz * -(-ho // th) * -(-wo // tw)
    per_chunk = slices * (co // 64)
    return max(1, min(tiles, per_sm * sm_count // per_chunk))


def _wgrad_launch(name, s0, off0, s1, g):
    """One launch of csrc/conv3x3_wgrad.cu: dw (CO, C0+C1, 3, 3) f32 from
    source s0 read at off0 = (row, col) and optional s1 at (0, 0); the
    caller counts the launch."""
    bsz, ho, wo, co = g.shape
    c0, c1 = s0.shape[3], (s1.shape[3] if s1 is not None else 0)
    ci = c0 + c1
    _check_act("g", g)
    _check_co(co)
    if c0 == 1 and s1 is None:
        _check_act("x", s0, channels_multiple=1)
    else:
        _check_act("x", s0)
        if s1 is not None:
            _check_act("up", s1)
    nchunks = wgrad_chunks(bsz, ho, wo, (c0, c1) if c1 else (c0,), co,
                           _sm_count(g.device.index or 0))
    partial = torch.empty((nchunks, co, 9, ci), dtype=torch.float32, device=g.device)
    dw = torch.empty((co, ci, 3, 3), dtype=torch.float32, device=g.device)
    h1, w1 = (s1.shape[1], s1.shape[2]) if s1 is not None else (0, 0)
    err = library().conv3x3_wgrad_bf16(
        s0.data_ptr(), s0.shape[1], s0.shape[2], c0, off0[0], off0[1],
        s1.data_ptr() if s1 is not None else None, h1, w1, c1,
        g.data_ptr(), bsz, ho, wo, co, nchunks, partial.data_ptr(), dw.data_ptr(),
        _stream(g),
    )
    _raise_on(err, name)
    return dw


def _launch_wgrad(name, x, g):
    if x.shape[0] != g.shape[0] or (x.shape[1] - 2, x.shape[2] - 2) != tuple(g.shape[1:3]):
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} do not fit a valid 3x3 conv")
    return _wgrad_launch(name, x, (0, 0), None, g)


def _launch_dec0_wgrad(name, skip, up, g, row_off, col_off):
    bsz, hs, ws, _ = skip.shape
    hu, wu = up.shape[1], up.shape[2]
    if up.shape[0] != bsz or g.shape[0] != bsz or tuple(g.shape[1:3]) != (hu - 2, wu - 2):
        raise ValueError(f"skip {tuple(skip.shape)}, up {tuple(up.shape)} and g "
                         f"{tuple(g.shape)} do not fit together")
    if row_off < 0 or col_off < 0 or row_off + hu > hs or col_off + wu > ws:
        raise ValueError(f"crop ({row_off}, {col_off}) + {hu}x{wu} leaves skip {hs}x{ws}")
    return _wgrad_launch(name, skip, (row_off, col_off), up, g)


# ------------------------------------------------------------------ wrappers
@counted
def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of a valid 3x3 conv: g (B,Hg,Wg,CO) NHWC, w
    (CO,CI,3,3) -> dx (B,Hg+2,Wg+2,CI) in g's dtype. The kernel needs
    CO % 32 == 0 and CI % 64 == 0."""
    if _on_cpu(g, w):
        return conv3x3_dgrad_plain(g, w)
    dx = _launch_dgrad("conv3x3_dgrad", g, w)
    conv3x3_dgrad.launches += 1
    return dx


@counted
def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of a valid 3x3 conv: x (B,H,W,CI), g (B,H-2,W-2,CO)
    NHWC -> dw (CO,CI,3,3) f32, summed in fp32. The kernel takes CI == 1
    (the stem) or CI % 32 == 0, and CO % 64 == 0; its split-K sum is
    two-pass and deterministic."""
    if _on_cpu(x, g):
        return conv3x3_wgrad_plain(x, g)
    dw = _launch_wgrad("conv3x3_wgrad", x, g)
    conv3x3_wgrad.launches += 1
    return dw


@counted
def conv3x3_dec0_wgrad(
    skip: torch.Tensor, up: torch.Tensor, g: torch.Tensor, row_off: int, col_off: int,
) -> torch.Tensor:
    """Weight gradient of the decoder-entry conv over concat(skip cropped
    at (row_off, col_off) to up's size, up) without materialising either:
    skip (B,Hs,Ws,CIs), up (B,Hu,Wu,CIu), g (B,Hu-2,Wu-2,CO) -> dw
    (CO,CIs+CIu,3,3) f32, skip channels first."""
    if _on_cpu(skip, up, g):
        return conv3x3_dec0_wgrad_plain(skip, up, g, row_off, col_off)
    dw = _launch_dec0_wgrad("conv3x3_dec0_wgrad", skip, up, g, row_off, col_off)
    conv3x3_dec0_wgrad.launches += 1
    return dw


@counted
def conv3x3_dense_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tier-2 input gradients (enc1 conv0 and conv1, dec2 conv0 into
    its concat, dec2 conv1): conv3x3_dgrad's function, counted as the
    counterpart of the TPU's dense-lanes kernel."""
    if _on_cpu(g, w):
        return conv3x3_dgrad_plain(g, w)
    dx = _launch_dgrad("conv3x3_dense_dgrad", g, w)
    conv3x3_dense_dgrad.launches += 1
    return dx


@counted
def conv3x3_dense_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The tier-2 weight gradients (enc1 conv0 and conv1, dec2 conv1):
    conv3x3_wgrad's function, counted as the counterpart of the TPU's
    dense-lanes kernel."""
    if _on_cpu(x, g):
        return conv3x3_wgrad_plain(x, g)
    dw = _launch_wgrad("conv3x3_dense_wgrad", x, g)
    conv3x3_dense_wgrad.launches += 1
    return dw


@counted
def conv3x3_dec0_dense_wgrad(
    skip: torch.Tensor, up: torch.Tensor, g: torch.Tensor, row_off: int, col_off: int,
) -> torch.Tensor:
    """The tier-2 decoder entry's weight gradient (dec2 conv0, skip1 at its
    center-crop offset, odd at 512^2): conv3x3_dec0_wgrad's function,
    counted as the counterpart of the TPU's dense-lanes kernel."""
    if _on_cpu(skip, up, g):
        return conv3x3_dec0_wgrad_plain(skip, up, g, row_off, col_off)
    dw = _launch_dec0_wgrad("conv3x3_dec0_dense_wgrad", skip, up, g, row_off, col_off)
    conv3x3_dec0_dense_wgrad.launches += 1
    return dw


# ------------------------------------------------------- autograd Functions
def _db(g: torch.Tensor) -> torch.Tensor:
    return g.sum((0, 1, 2), dtype=torch.float32)


def _conv_forward(ctx, conv, x, w, b):
    ctx.save_for_backward(x, w)
    return conv(x, w, b, relu=False)


def _conv_backward(ctx, gz, dgrad, wgrad):
    x, w = ctx.saved_tensors
    g = gz.contiguous()
    # the stem's input needs no gradient: skip its dgrad
    dx = dgrad(g, w) if ctx.needs_input_grad[0] else None
    dw = wgrad(x, g) if ctx.needs_input_grad[1] else None
    return dx, dw, _db(g)


def _dec0_forward(ctx, conv, skip, up, w, b, row_off, col_off):
    ctx.save_for_backward(skip, up, w)
    ctx.offs = (row_off, col_off)
    return conv(skip, up, w, b, row_off, col_off, relu=False)


def _dec0_backward(ctx, gz, dgrad, wgrad):
    skip, up, w = ctx.saved_tensors
    row_off, col_off = ctx.offs
    g = gz.contiguous()
    hu, wu, cis = up.shape[1], up.shape[2], skip.shape[3]
    dcat = dgrad(g, w)  # (B, Hu, Wu, CIs + CIu)
    d_skip = skip.new_zeros(skip.shape)
    d_skip[:, row_off : row_off + hu, col_off : col_off + wu] = dcat[..., :cis]
    d_up = dcat[..., cis:]
    dw = wgrad(skip, up, g, row_off, col_off)
    return d_skip, d_up, dw, _db(g), None, None


class Conv3x3Train(torch.autograd.Function):
    """z = valid 3x3 conv(x, w) + b, NHWC, no ReLU (the pre-BN z)."""

    @staticmethod
    def forward(ctx, x, w, b):
        return _conv_forward(ctx, conv3x3_bias_relu, x, w, b)

    @staticmethod
    def backward(ctx, gz):
        return _conv_backward(ctx, gz, conv3x3_dgrad, conv3x3_wgrad)


class Conv3x3DenseTrain(torch.autograd.Function):
    """Conv3x3Train's function for tier 2's enc1 and dec2 convs, through
    the dense wrappers."""

    @staticmethod
    def forward(ctx, x, w, b):
        return _conv_forward(ctx, conv3x3_dense, x, w, b)

    @staticmethod
    def backward(ctx, gz):
        return _conv_backward(ctx, gz, conv3x3_dense_dgrad, conv3x3_dense_wgrad)


class DecConv0Train(torch.autograd.Function):
    """z = valid 3x3 conv(concat(crop(skip), up), w) + b, NHWC, no ReLU;
    the crop is skip[:, row_off:row_off+Hu, col_off:col_off+Wu]."""

    @staticmethod
    def forward(ctx, skip, up, w, b, row_off, col_off):
        return _dec0_forward(ctx, dec_conv0, skip, up, w, b, row_off, col_off)

    @staticmethod
    def backward(ctx, gz):
        return _dec0_backward(ctx, gz, conv3x3_dgrad, conv3x3_dec0_wgrad)


class DecConv0DenseTrain(torch.autograd.Function):
    """DecConv0Train's function for tier 2's dec2 entry, through the dense
    wrappers."""

    @staticmethod
    def forward(ctx, skip, up, w, b, row_off, col_off):
        return _dec0_forward(ctx, dec_conv0_dense, skip, up, w, b, row_off, col_off)

    @staticmethod
    def backward(ctx, gz):
        return _dec0_backward(ctx, gz, conv3x3_dense_dgrad, conv3x3_dec0_dense_wgrad)


class TConv2x2Train(torch.autograd.Function):
    """y = 2x2 stride-2 transposed conv(x, w) + b, NHWC, w in torch's
    ConvTranspose2d layout (CI, CO, 2, 2)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return tconv2x2_bias(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        bsz, h, wd, ci = x.shape
        co = w.shape[1]
        # y[b, 2r+dy, 2j+dx, co] = sum_ci x[b, r, j, ci] w[ci, co, dy, dx]:
        # both gradients are contractions over (dy, dx, co) per input pixel
        g4 = (gy.reshape(bsz, h, 2, wd, 2, co).permute(0, 1, 3, 2, 4, 5)
              .reshape(bsz * h * wd, 4 * co).to(x.dtype))
        wm = w.to(x.dtype).permute(0, 2, 3, 1).reshape(ci, 4 * co)
        dx = (g4 @ wm.t()).reshape(bsz, h, wd, ci)
        dwm = x.reshape(-1, ci).t() @ g4  # (ci, 4*co), rounded to x's dtype
        dw = dwm.float().reshape(ci, 2, 2, co).permute(0, 3, 1, 2)
        return dx, dw, _db(gy)
