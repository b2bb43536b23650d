"""The train step's convolution kernels and the autograd Functions around
them (counterpart of unetseg_tpu/ops/pallas/conv3x3_train.py).

| wrapper            | CUDA source                         | TPU kernel it replaces                        |
|--------------------|-------------------------------------|-----------------------------------------------|
| conv3x3_dgrad      | csrc/conv3x3_dgrad.cu               | ops/pallas/conv3x3_train.py:conv3x3_phase2_dx |
| conv3x3_wgrad      | csrc/conv3x3_wgrad.cu               | ops/pallas/conv3x3_train.py:conv3x3_phase2_dw |
| conv3x3_dec0_wgrad | csrc/conv3x3_wgrad.cu (two sources) | ops/pallas/conv3x3_train.py:conv3x3_dec0_dw   |

Routing as in ops/kernels/conv3x3.py: a CPU tensor runs the plain PyTorch
version beside the wrapper, a CUDA tensor the Hopper kernel or a raise;
each wrapper counts its launches.

The Functions are the custom VJPs of the JAX package without its lanes
layout (activations NHWC, weights in torch's layouts):
  Conv3x3Train   make_conv_p2_train: forward conv3x3_bias_relu(relu=False),
                 backward dgrad + wgrad, db = sum g in fp32;
  DecConv0Train  make_dec0_p2_train: forward dec_conv0(relu=False),
                 backward dgrad into the concat gradient, split into the
                 crop's (scattered into a zero skip-frame gradient) and
                 up's, then the two-source wgrad;
  TConv2x2Train  lanes_train.make_tconv_p2_train: forward tconv2x2_bias,
                 backward plain channel contractions (the JAX backward is
                 XLA dot_generals, not a kernel).
"""

from __future__ import annotations

import functools

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
    dec_conv0,
    tconv2x2_bias,
)
from unetseg_tpu_torch.ops.kernels.launches import counted

WGRAD_BLOCKS_PER_SM = 2  # split-K chunks aim at this many blocks per SM


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


# ------------------------------------------------------------------ wrappers
@counted
def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of a valid 3x3 conv: g (B,Hg,Wg,CO) NHWC, w
    (CO,CI,3,3) -> dx (B,Hg+2,Wg+2,CI) in g's dtype. The kernel needs
    CO % 32 == 0 and CI % 64 == 0."""
    if _on_cpu(g, w):
        return conv3x3_dgrad_plain(g, w)
    bsz, hg, wg, co = g.shape
    ci = w.shape[1]
    if tuple(w.shape) != (co, ci, 3, 3):
        raise ValueError(f"weight {tuple(w.shape)} does not fit g {tuple(g.shape)}")
    _check_act("g", g)
    _check_co(ci)
    dx = torch.empty((bsz, hg + 2, wg + 2, ci), dtype=g.dtype, device=g.device)
    # wt[ci, ky, kx, co] = w[co, ci, 2-ky, 2-kx]: flipped, CI <-> CO
    wt = w.to(torch.bfloat16).flip(2, 3).permute(1, 2, 3, 0).contiguous()
    err = library().conv3x3_dgrad_bf16(
        g.data_ptr(), wt.data_ptr(), dx.data_ptr(), bsz, hg, wg, co, ci, _stream(g),
    )
    _raise_on(err, "conv3x3_dgrad")
    conv3x3_dgrad.launches += 1
    return dx


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _wgrad_launch(s0, off0, s1, g):
    """One launch of csrc/conv3x3_wgrad.cu: dw (CO, C0+C1, 3, 3) f32 from
    source s0 read at off0 = (row, col) and optional s1 at (0, 0)."""
    bsz, ho, wo, co = g.shape
    c0, c1 = s0.shape[3], (s1.shape[3] if s1 is not None else 0)
    ci = c0 + c1
    _check_act("g", g)
    _check_co(co)
    if c0 == 1 and s1 is None:
        _check_act("x", s0, channels_multiple=1)
        slices = 1
    else:
        _check_act("x", s0)
        if s1 is not None:
            _check_act("up", s1)
        slices = ci // 32
    tiles = bsz * -(-ho // 8) * -(-wo // 16)
    blocks = WGRAD_BLOCKS_PER_SM * _sm_count(g.device.index or 0)
    nchunks = max(1, min(tiles, -(-blocks // (slices * (co // 64)))))
    partial = torch.empty((nchunks, co, 9, ci), dtype=torch.float32, device=g.device)
    dw = torch.empty((co, ci, 3, 3), dtype=torch.float32, device=g.device)
    h1, w1 = (s1.shape[1], s1.shape[2]) if s1 is not None else (0, 0)
    err = library().conv3x3_wgrad_bf16(
        s0.data_ptr(), s0.shape[1], s0.shape[2], c0, off0[0], off0[1],
        s1.data_ptr() if s1 is not None else None, h1, w1, c1,
        g.data_ptr(), bsz, ho, wo, co, nchunks, partial.data_ptr(), dw.data_ptr(),
        _stream(g),
    )
    return err, dw


@counted
def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of a valid 3x3 conv: x (B,H,W,CI), g (B,H-2,W-2,CO)
    NHWC -> dw (CO,CI,3,3) f32, summed in fp32. The kernel takes CI == 1
    (the stem) or CI % 32 == 0, and CO % 64 == 0; its split-K sum is
    two-pass and deterministic."""
    if _on_cpu(x, g):
        return conv3x3_wgrad_plain(x, g)
    if x.shape[0] != g.shape[0] or (x.shape[1] - 2, x.shape[2] - 2) != tuple(g.shape[1:3]):
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} do not fit a valid 3x3 conv")
    err, dw = _wgrad_launch(x, (0, 0), None, g)
    _raise_on(err, "conv3x3_wgrad")
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
    bsz, hs, ws, _ = skip.shape
    hu, wu = up.shape[1], up.shape[2]
    if up.shape[0] != bsz or g.shape[0] != bsz or tuple(g.shape[1:3]) != (hu - 2, wu - 2):
        raise ValueError(f"skip {tuple(skip.shape)}, up {tuple(up.shape)} and g "
                         f"{tuple(g.shape)} do not fit together")
    if row_off < 0 or col_off < 0 or row_off + hu > hs or col_off + wu > ws:
        raise ValueError(f"crop ({row_off}, {col_off}) + {hu}x{wu} leaves skip {hs}x{ws}")
    err, dw = _wgrad_launch(skip, (row_off, col_off), up, g)
    _raise_on(err, "conv3x3_dec0_wgrad")
    conv3x3_dec0_wgrad.launches += 1
    return dw


# ------------------------------------------------------- autograd Functions
def _db(g: torch.Tensor) -> torch.Tensor:
    return g.sum((0, 1, 2), dtype=torch.float32)


class Conv3x3Train(torch.autograd.Function):
    """z = valid 3x3 conv(x, w) + b, NHWC, no ReLU (the pre-BN z)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv3x3_bias_relu(x, w, b, relu=False)

    @staticmethod
    def backward(ctx, gz):
        x, w = ctx.saved_tensors
        g = gz.contiguous()
        # the stem's input needs no gradient: skip its dgrad
        dx = conv3x3_dgrad(g, w) if ctx.needs_input_grad[0] else None
        dw = conv3x3_wgrad(x, g) if ctx.needs_input_grad[1] else None
        return dx, dw, _db(g)


class DecConv0Train(torch.autograd.Function):
    """z = valid 3x3 conv(concat(crop(skip), up), w) + b, NHWC, no ReLU;
    the crop is skip[:, row_off:row_off+Hu, col_off:col_off+Wu]."""

    @staticmethod
    def forward(ctx, skip, up, w, b, row_off, col_off):
        ctx.save_for_backward(skip, up, w)
        ctx.offs = (row_off, col_off)
        return dec_conv0(skip, up, w, b, row_off, col_off, relu=False)

    @staticmethod
    def backward(ctx, gz):
        skip, up, w = ctx.saved_tensors
        row_off, col_off = ctx.offs
        g = gz.contiguous()
        hu, wu, cis = up.shape[1], up.shape[2], skip.shape[3]
        dcat = conv3x3_dgrad(g, w)  # (B, Hu, Wu, CIs + CIu)
        d_skip = skip.new_zeros(skip.shape)
        d_skip[:, row_off : row_off + hu, col_off : col_off + wu] = dcat[..., :cis]
        d_up = dcat[..., cis:]
        dw = conv3x3_dec0_wgrad(skip, up, g, row_off, col_off)
        return d_skip, d_up, dw, _db(g), None, None


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
