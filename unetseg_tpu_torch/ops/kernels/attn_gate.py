"""The attention gate of the gated net's serving path (ModelConfig.skip_gates;
Oktay et al., arXiv:1804.03999): wrappers, plain versions and launch
counters. No TPU kernel is replaced: the JAX package has no gated net.

| wrapper          | CUDA source (kernel)                       | plain version          |
|------------------|--------------------------------------------|------------------------|
| attn_gate        | csrc/attn_gate.cu (attn_gate_kernel)       | attn_gate_plain        |
| attn_gate_apply  | csrc/attn_gate.cu (attn_gate_apply_kernel) | attn_gate_apply_plain  |

`attn_gate` computes alpha (B, h, w) f32 at g's grid from the skip read at
its centre-crop offset and from g, the up-conv's input: one GEMM over K =
[the skip's 2x2 patch, g] into F / 2 outputs with bg, ReLU, the dot with
psi, bpsi and the sigmoid in its epilogue (models/unet.gate_alpha).
`attn_gate_apply` writes x_hat = upsample2x(alpha) * crop as a compact
(B, 2h, 2w, F) tensor, which the decoder entry reads at offset (0, 0)
(models/unet.upsample_alpha: bilinear, align_corners=False). Routing and
counting as ops/kernels/conv3x3.py: a CPU tensor runs the plain version, a
CUDA tensor the kernel or raises; each launch adds one to `launches`.
`tile_count` mirrors the gate kernel's grid of 8 x 16-pixel tiles.
"""

from __future__ import annotations

import torch

from unetseg_tpu_torch.models.unet import gate_alpha, to_nchw, to_nhwc, upsample_alpha
from unetseg_tpu_torch.ops.kernels.build import library
from unetseg_tpu_torch.ops.kernels.conv3x3 import _check_act, _f32, _on_cpu, _raise_on, _stream
from unetseg_tpu_torch.ops.kernels.launches import counted

GATE_TILE = (8, 16)  # csrc/attn_gate.cu TH, TW: rows x columns of g's grid a tile
GATE_WIDTHS = (64, 128, 256, 512)  # skip channels F the kernel takes (N = F / 2 <= 256)


def tile_count(bsz: int, h: int, w: int) -> int:
    """Tiles of csrc/attn_gate.cu's grid walk for g (bsz, h, w, 2F)."""
    th, tw = GATE_TILE
    return bsz * -(-h // th) * -(-w // tw)


def _crop(skip: torch.Tensor, h: int, w: int, row_off: int, col_off: int) -> torch.Tensor:
    return skip[:, row_off:row_off + 2 * h, col_off:col_off + 2 * w, :]


# ------------------------------------------------------------ plain versions
def attn_gate_plain(skip, g, wx, wg, bg, psi, bpsi, row_off, col_off):
    h, w = g.shape[1], g.shape[2]
    x = to_nchw(_crop(skip, h, w, row_off, col_off))
    return gate_alpha(x, to_nchw(g), wx, wg, bg, psi, bpsi)[:, 0]


def attn_gate_apply_plain(skip, alpha, row_off, col_off):
    h, w = alpha.shape[1], alpha.shape[2]
    x = _crop(skip, h, w, row_off, col_off)
    a = to_nhwc(upsample_alpha(alpha[:, None].float()))
    return (a * x.float()).to(x.dtype).contiguous()


# ------------------------------------------------------------------ helpers
def _check_gate_crop(skip: torch.Tensor, h: int, w: int, row_off: int, col_off: int) -> None:
    hs, ws = skip.shape[1], skip.shape[2]
    if row_off < 0 or col_off < 0 or row_off + 2 * h > hs or col_off + 2 * w > ws:
        raise ValueError(f"crop ({row_off}, {col_off}) + {2 * h}x{2 * w} leaves skip {hs}x{ws}")


def _gate_weights(wx: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """wx (N, F, 2, 2), wg (N, 2F, 1, 1) -> contiguous bf16 (N, 6F): row n
    = [wx[n, :, dy, dx] for (dy, dx) in raster order, wg[n, :]], the K order
    of csrc/attn_gate.cu (the patch's 4F, then g's 2F)."""
    n, f = wx.shape[0], wx.shape[1]
    return torch.cat([wx.permute(0, 2, 3, 1).reshape(n, 4 * f), wg.reshape(n, 2 * f)],
                     dim=1).to(torch.bfloat16).contiguous()


# ----------------------------------------------------------------- wrappers
@counted
def attn_gate(
    skip: torch.Tensor, g: torch.Tensor, wx: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor,
    psi: torch.Tensor, bpsi: torch.Tensor, row_off: int, col_off: int,
) -> torch.Tensor:
    """alpha = sigmoid(psi . ReLU(wx * crop + wg * g + bg) + bpsi), NHWC.

    skip (B,Hs,Ws,F) read at (row_off, col_off) over (2h, 2w) pixels, g
    (B,h,w,2F), wx (F/2,F,2,2) (a 2x2 stride-2 conv, no bias), wg
    (F/2,2F,1,1), bg (F/2,), psi (1,F/2,1,1), bpsi (1,) -> (B,h,w) f32. The
    products take skip, g, wx and wg in bf16 and sum in f32. The kernel
    takes F in GATE_WIDTHS."""
    if _on_cpu(skip, g, wx, wg, bg, psi, bpsi):
        return attn_gate_plain(skip, g, wx, wg, bg, psi, bpsi, row_off, col_off)
    bsz, hs, ws, f = skip.shape
    _, h, w, cg = g.shape
    n = f // 2
    if (tuple(wx.shape) != (n, f, 2, 2) or tuple(wg.shape) != (n, 2 * f, 1, 1)
            or tuple(bg.shape) != (n,) or tuple(psi.shape) != (1, n, 1, 1)
            or tuple(bpsi.shape) != (1,) or cg != 2 * f or g.shape[0] != bsz):
        raise ValueError(f"skip {tuple(skip.shape)}, g {tuple(g.shape)}, wx {tuple(wx.shape)}, "
                         f"wg {tuple(wg.shape)} do not fit together")
    if f not in GATE_WIDTHS:
        raise ValueError(f"attn_gate takes skip channels in {GATE_WIDTHS}, got {f}")
    _check_gate_crop(skip, h, w, row_off, col_off)
    _check_act("skip", skip)
    _check_act("g", g)
    alpha = torch.empty((bsz, h, w), dtype=torch.float32, device=g.device)
    wk, bk, pk, bpk = _gate_weights(wx, wg), _f32(bg), _f32(psi.reshape(n)), _f32(bpsi)
    err = library().attn_gate_bf16(
        skip.data_ptr(), hs, ws, f, row_off, col_off, g.data_ptr(), bsz, h, w,
        wk.data_ptr(), bk.data_ptr(), pk.data_ptr(), bpk.data_ptr(), alpha.data_ptr(), _stream(g),
    )
    _raise_on(err, "attn_gate")
    attn_gate.launches += 1
    return alpha


@counted
def attn_gate_apply(skip: torch.Tensor, alpha: torch.Tensor, row_off: int,
                    col_off: int) -> torch.Tensor:
    """x_hat = upsample2x(alpha) * skip[:, row_off:row_off+2h,
    col_off:col_off+2w] (bilinear, align_corners=False), product in f32,
    rounded to skip's dtype: skip (B,Hs,Ws,F), alpha (B,h,w) f32 ->
    contiguous (B,2h,2w,F)."""
    if _on_cpu(skip, alpha):
        return attn_gate_apply_plain(skip, alpha, row_off, col_off)
    bsz, hs, ws, f = skip.shape
    h, w = alpha.shape[1], alpha.shape[2]
    if alpha.dim() != 3 or alpha.shape[0] != bsz or alpha.dtype != torch.float32:
        raise ValueError(f"alpha {tuple(alpha.shape)} {alpha.dtype} does not fit skip "
                         f"{tuple(skip.shape)}")
    _check_gate_crop(skip, h, w, row_off, col_off)
    _check_act("skip", skip)
    y = torch.empty((bsz, 2 * h, 2 * w, f), dtype=skip.dtype, device=skip.device)
    a = alpha.contiguous()
    err = library().attn_gate_apply_bf16(
        skip.data_ptr(), hs, ws, f, row_off, col_off, a.data_ptr(), bsz, h, w,
        y.data_ptr(), _stream(skip),
    )
    _raise_on(err, "attn_gate_apply")
    attn_gate_apply.launches += 1
    return y
