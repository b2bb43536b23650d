"""Kernel forward of the folded U-Net (counterpart of
unetseg_tpu/infer/lanes_net.py:folded_forward_tier1 with the NHWC middle:
the options tier2, fused_enc0, dec_fuse and cblock; the HCNW middle is a
TPU layout and has no counterpart).

The same stages as the JAX forward, without its lanes layouts, on
contiguous NHWC tensors from the stem to the head. The defaults are the
JAX Predictor's (dec_fuse="head", the rest off):

    stem             conv3x3_bias_relu             (B,S,S,1) -> (B,S-2,S-2,f0)
    enc{l} conv0     conv3x3_bias_relu             l = 1..4
    enc{l} conv1     conv3x3_bias_relu(fuse_pool)  -> skip l and enc{l+1}'s input,
                                                   l = 0..3
    enc4 conv1       conv3x3_bias_relu
    up{i}            tconv2x2_bias                 (B,h,w,2f) -> (B,2h,2w,f), i = 0..3
    dec{i} conv0     dec_conv0                     skip 3-i read at its centre-crop
                                                   offset: no crop or concat is written
    dec{i} conv1     conv3x3_bias_relu             i = 0..2
    dec3 conv1+head  conv3x3_head                  -> f32 logits (B,s',s',NC)

A gated net (ModelConfig.skip_gates, the port's own) adds before each
decoder entry, inside a `serve.gate` span (utils/profiling.annotate):

    gate{i}          attn_gate        alpha (B,h,w) f32 from skip 3-i at its crop
                                      offset and g, up{i}'s input
                     attn_gate_apply  x_hat (B,2h,2w,f) = upsample2x(alpha) * crop
    dec{i} conv0     reads x_hat at offset (0, 0), as do the options' entries
                     (tier2's dec_conv0_dense, dec_fuse="tail"'s dec_tail)

The JAX package leaves the middle (enc1..enc4, up0..up2, dec0..dec2) to
XLA, which fuses each bias, ReLU and pool into its conv; here the same
kernels as at the net's ends carry them in their epilogues.

The options change these stages, as in lanes_net.py:250-500:

    fused_enc0   stem + enc0 conv1 + pool0 in one kernel, enc0_fused
    tier2        enc1 conv0 and conv1 (+ pool1) through conv3x3_dense on the
                 pooled enc0 output; dec2 through dec_conv0_dense (skip1 at
                 its centre-crop offset: 40 at 700^2 tiles, 41 at 512^2) and
                 conv3x3_dense
    dec_fuse     "head": dec3 conv1 and the head in one kernel (the default);
                 "tail": dec3 conv0, conv1 and the head in one kernel,
                 dec_tail. The JAX "none" (the head as a plain product
                 outside the kernels) ports no kernel and is refused
    cblock       middle convs named in it ("all", enc{l}c{i}, dec{i}c1) with
                 output channels a multiple of 128 run conv3x3_cblock, a
                 routed enc{l}c1 with its pool as a separate max_pool2d; the
                 decoder entries stay dec_conv0 (fused in JAX, not routed)

On a CUDA device the kernels run the hand-written Hopper kernels; on the
CPU their plain versions, which is what the CPU tests compare with the
JAX package. The default path's wrappers are called as the custom
operators of ops/kernels/library.py (torch.ops.unetseg.*), so that
torch.export can trace the forward (infer/export.py); the variants'
wrappers are called directly.
"""

from __future__ import annotations

from typing import Collection, FrozenSet

import torch
import torch.nn.functional as F

from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.infer.folding import FoldedUNet
from unetseg_tpu_torch.models.shapes import center_crop_bounds
from unetseg_tpu_torch.models.unet import compute_dtype, to_nchw, to_nhwc
from unetseg_tpu_torch.ops.kernels import library as ops
from unetseg_tpu_torch.ops.kernels.conv3x3 import (
    CBLOCK_CO,
    MAX_HEAD_CLASSES,
    conv3x3_cblock,
    conv3x3_dense,
    dec_conv0_dense,
    dec_tail,
    enc0_fused,
)
from unetseg_tpu_torch.utils.profiling import annotate

DEC_FUSE = ("head", "tail")


def supports(model_cfg: ModelConfig, device: torch.device) -> bool:
    """True when the kernel forward runs this net on this device: the
    5-level transposed-conv U-Net with a 1-channel input, as on the TPU,
    gated or not; on a CUDA device also the kernels' widths and dtype
    (bf16, 64 base features, at most MAX_HEAD_CLASSES classes)."""
    if model_cfg.levels != 5 or model_cfg.bilinear or model_cfg.in_channels != 1:
        return False
    if torch.device(device).type == "cuda":
        return (
            model_cfg.compute_dtype == "bfloat16"
            and model_cfg.base_features == 64
            and model_cfg.num_classes <= MAX_HEAD_CLASSES
        )
    return True


def supports_tier2(model_cfg: ModelConfig, device: torch.device) -> bool:
    """True when the kernel forward runs tier 2 for this net on this
    device. The JAX package's supports_tier2 checks the lanes layout's
    strides; NHWC has none, so this is wherever the kernel forward runs."""
    return supports(model_cfg, device)


def cblock_names(levels: int) -> FrozenSet[str]:
    """The names the cblock option takes: "all", the middle encoder convs
    enc{l}c{i} (l >= 1) and the middle decoder convs dec{i}c1."""
    enc = {f"enc{lvl}c{i}" for lvl in range(1, levels) for i in (0, 1)}
    dec = {f"dec{i}c1" for i in range(levels - 2)}
    return frozenset(enc | dec | {"all"})


def check_options(
    model_cfg: ModelConfig, dec_fuse: str, cblock: Collection[str]
) -> FrozenSet[str]:
    """Raise ValueError for an unknown dec_fuse or cblock name; return the
    cblock names as a set."""
    if dec_fuse not in DEC_FUSE:
        raise ValueError(f"dec_fuse={dec_fuse!r}; expected one of {list(DEC_FUSE)}")
    names = frozenset(cblock)
    unknown = names - cblock_names(model_cfg.levels)
    if unknown:
        raise ValueError(f"unknown cblock conv names {sorted(unknown)}; expected some of "
                         f"{sorted(cblock_names(model_cfg.levels))}")
    return names


def _middle_conv(x, conv, routed, pool=False):
    """ReLU(conv + bias) of a contiguous NHWC tensor, and with `pool` also
    its 2x2 max-pool, as (y, pooled): conv3x3_cblock when routed and the
    output channels are a multiple of CBLOCK_CO, the pool apart; else
    conv3x3_bias_relu, the pool in its epilogue."""
    if routed and conv.weight.shape[0] % CBLOCK_CO == 0:
        y = conv3x3_cblock(x, conv.weight, conv.bias)
        return (y, to_nhwc(F.max_pool2d(to_nchw(y), 2)).contiguous()) if pool else y
    if pool:
        return ops.conv3x3_bias_relu_pool(x, conv.weight, conv.bias)
    return ops.conv3x3_bias_relu(x, conv.weight, conv.bias)


def _crop_offsets(skip, up):
    return (center_crop_bounds(skip.shape[1], up.shape[1])[0],
            center_crop_bounds(skip.shape[2], up.shape[2])[0])


def _entry_skip(folded: FoldedUNet, i: int, skip, g, up):
    """(the skip as decoder entry i reads it, row offset, column offset):
    skip at its crop offset, or for a gated net x_hat at (0, 0) through the
    gate kernels, g being up{i}'s input."""
    row_off, col_off = _crop_offsets(skip, up)
    if not folded.cfg.skip_gates:
        return skip, row_off, col_off
    gate = getattr(folded, f"gate{i}")
    with annotate("serve.gate"):
        alpha = ops.attn_gate(skip, g, gate.wx.weight, gate.wg.weight, gate.wg.bias,
                              gate.psi.weight, gate.psi.bias, row_off, col_off)
        return ops.attn_gate_apply(skip, alpha, row_off, col_off), 0, 0


def folded_forward_kernels(
    folded: FoldedUNet,
    x: torch.Tensor,
    tier2: bool = False,
    fused_enc0: bool = False,
    dec_fuse: str = "head",
    cblock: Collection[str] = (),
) -> torch.Tensor:
    """(B, H, W, 1) -> (B, h', w', num_classes) f32 logits through the
    serving kernels; `folded` is infer/folding.FoldedUNet. The options are
    described in the module docstring."""
    cfg = folded.cfg
    cblock = check_options(cfg, dec_fuse, cblock)
    dtype = compute_dtype(cfg)
    p = folded

    def routed(name):
        return "all" in cblock or name in cblock

    x = x.to(dtype).contiguous()
    e0 = p.enc0
    if fused_enc0:
        skip0, pooled = enc0_fused(x, e0.conv0.weight, e0.conv0.bias,
                                   e0.conv1.weight, e0.conv1.bias)
    else:
        h = ops.conv3x3_bias_relu(x, e0.conv0.weight, e0.conv0.bias)
        skip0, pooled = ops.conv3x3_bias_relu_pool(h, e0.conv1.weight, e0.conv1.bias)

    # ---- tier 2: enc1 through the kernels, on the pooled enc0 output
    xm, start, skips = pooled, 1, [skip0]
    if tier2:
        e1 = p.enc1
        h1 = conv3x3_dense(pooled, e1.conv0.weight, e1.conv0.bias)
        skip1, xm = conv3x3_dense(h1, e1.conv1.weight, e1.conv1.bias, fuse_pool=True)
        start, skips = 2, [skip0, skip1]

    # ---- middle encoder: each pool in the epilogue of the conv before it
    for lvl in range(start, cfg.levels):
        blk = getattr(p, f"enc{lvl}")
        xm = _middle_conv(xm, blk.conv0, routed(f"enc{lvl}c0"))
        if lvl < cfg.levels - 1:
            skip, xm = _middle_conv(xm, blk.conv1, routed(f"enc{lvl}c1"), pool=True)
            skips.append(skip)
        else:
            xm = _middle_conv(xm, blk.conv1, routed(f"enc{lvl}c1"))

    # ---- middle decoder: the skip read at its crop offset by the entry
    last = cfg.levels - 2  # the decoder level the tail kernels run (dec3)
    for i in range(last):
        t = getattr(p, f"up{i}_tconv")
        up = ops.tconv2x2_bias(xm, t.weight, t.bias)
        skip, row_off, col_off = _entry_skip(p, i, skips[last - i], xm, up)
        d = getattr(p, f"dec{i}")
        if tier2 and i == last - 1:
            y = dec_conv0_dense(skip, up, d.conv0.weight, d.conv0.bias, row_off, col_off)
            xm = conv3x3_dense(y, d.conv1.weight, d.conv1.bias)
        else:
            y = ops.dec_conv0(skip, up, d.conv0.weight, d.conv0.bias, row_off, col_off)
            xm = _middle_conv(y, d.conv1, routed(f"dec{i}c1"))

    # ---- last decoder level + head: kernels
    t = getattr(p, f"up{last}_tconv")
    up = ops.tconv2x2_bias(xm, t.weight, t.bias)
    skip, row_off, col_off = _entry_skip(p, last, skip0, xm, up)
    d = getattr(p, f"dec{last}")
    if dec_fuse == "tail":
        return dec_tail(skip, up, d.conv0.weight, d.conv0.bias, d.conv1.weight,
                        d.conv1.bias, p.outc.weight, p.outc.bias, row_off, col_off)
    y = ops.dec_conv0(skip, up, d.conv0.weight, d.conv0.bias, row_off, col_off)
    return ops.conv3x3_head(y, d.conv1.weight, d.conv1.bias, p.outc.weight, p.outc.bias)
