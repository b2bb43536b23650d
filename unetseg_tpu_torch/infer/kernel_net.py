"""Kernel forward of the folded U-Net (counterpart of
unetseg_tpu/infer/lanes_net.py:folded_forward_tier1 with the NHWC middle:
the options tier2, fused_enc0, dec_fuse and cblock; the HCNW middle is a
TPU layout and has no counterpart).

The same stages as the JAX forward, without its lanes layouts. The
defaults are the JAX Predictor's (dec_fuse="head", the rest off):

    stem             conv3x3_bias_relu             (B,S,S,1)  -> (B,S-2,S-2,f0)
    enc0 conv1+pool0 conv3x3_bias_relu(fuse_pool)  -> skip0 (B,S-4,S-4,f0), pooled
    middle           plain PyTorch (enc1..enc4, pools, up0..up2, dec0..dec2),
                     as the JAX package leaves these stages to XLA
    up3              tconv2x2_bias                 -> (B,c,c,f0), c = crops[-1]
    dec3 conv0       dec_conv0, skip0 read at its center-crop offset
    dec3 conv1+head  conv3x3_head                  -> f32 logits (B,s',s',NC)

The options change these stages, as in lanes_net.py:250-500:

    fused_enc0   stem + enc0 conv1 + pool0 in one kernel, enc0_fused
    tier2        enc1 conv0 and conv1 (+ pool1) through conv3x3_dense on the
                 pooled enc0 output; the plain middle runs enc2..enc4 and
                 dec0..dec1; up2 stays plain (XLA's in JAX); dec2 through
                 dec_conv0_dense (skip1 at its centre-crop offset: 40 at
                 700^2 tiles, 41 at 512^2) and conv3x3_dense
    dec_fuse     "head": dec3 conv1 and the head in one kernel (the default);
                 "tail": dec3 conv0, conv1 and the head in one kernel,
                 dec_tail. The JAX "none" (the head as a plain product
                 outside the kernels) ports no kernel and is refused
    cblock       middle convs named in it ("all", enc{l}c{i}, dec{i}c1) with
                 output channels a multiple of 128 run conv3x3_cblock; the
                 decoder entries stay plain (fused in JAX, not routed there)

On a CUDA device the kernels run the hand-written Hopper kernels; on the
CPU their plain versions, which is what the CPU tests compare with the
JAX package. The default path's four wrappers are called as the custom
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
from unetseg_tpu_torch.models.unet import (
    center_crop_nhwc,
    compute_dtype,
    to_nchw,
    to_nhwc,
)
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

DEC_FUSE = ("head", "tail")


def supports(model_cfg: ModelConfig, device: torch.device) -> bool:
    """True when the kernel forward runs this net on this device: the
    5-level transposed-conv U-Net with a 1-channel input, as on the TPU;
    on a CUDA device also the kernels' widths and dtype (bf16, 64 base
    features, at most MAX_HEAD_CLASSES classes)."""
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


def _middle_conv(x, conv, routed):
    """ReLU(conv + bias) of an NCHW view of channels_last storage:
    conv3x3_cblock when routed and the output channels are a multiple of
    CBLOCK_CO, else cuDNN."""
    if routed and conv.weight.shape[0] % CBLOCK_CO == 0:
        return to_nchw(conv3x3_cblock(to_nhwc(x).contiguous(), conv.weight, conv.bias))
    return F.relu(F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype)))


def _plain_tconv(x, t):
    return F.conv_transpose2d(x, t.weight.to(x.dtype), t.bias.to(x.dtype), stride=2)


def _crop_offsets(skip, up):
    return (center_crop_bounds(skip.shape[1], up.shape[1])[0],
            center_crop_bounds(skip.shape[2], up.shape[2])[0])


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
    xm, start = pooled, 1
    if tier2:
        e1 = p.enc1
        h1 = conv3x3_dense(pooled, e1.conv0.weight, e1.conv0.bias)
        skip1, xm = conv3x3_dense(h1, e1.conv1.weight, e1.conv1.bias, fuse_pool=True)
        start = 2

    # ---- middle: plain PyTorch on NCHW views of channels_last storage
    # (cuDNN's NHWC kernels; the concat is two strided copies, 1.5x faster
    # on an H100 than torch.cat on the NHWC channel axis), cblock convs
    # through the kernel
    xm = to_nchw(xm)
    skips = []
    for lvl in range(start, cfg.levels):
        if lvl > start:
            xm = F.max_pool2d(xm, 2)
        blk = getattr(p, f"enc{lvl}")
        xm = _middle_conv(xm, blk.conv0, routed(f"enc{lvl}c0"))
        xm = _middle_conv(xm, blk.conv1, routed(f"enc{lvl}c1"))
        skips.append(xm)
    last = cfg.levels - 2  # the decoder level the tail kernels run (dec3)
    for i in range(last - 1 if tier2 else last):
        xm = _plain_tconv(xm, getattr(p, f"up{i}_tconv"))
        skip_c = center_crop_nhwc(to_nhwc(skips[-(i + 2)]), xm.shape[2], xm.shape[3])
        d = getattr(p, f"dec{i}")
        xm = _middle_conv(torch.cat([to_nchw(skip_c), xm], dim=1), d.conv0, False)
        xm = _middle_conv(xm, d.conv1, routed(f"dec{i}c1"))
    xm = to_nhwc(xm)

    # ---- tier 2: dec2 through the kernels, up2 plain
    if tier2:
        up2 = to_nhwc(_plain_tconv(to_nchw(xm), getattr(p, f"up{last - 1}_tconv"))).contiguous()
        d = getattr(p, f"dec{last - 1}")
        y2 = dec_conv0_dense(skip1, up2, d.conv0.weight, d.conv0.bias, *_crop_offsets(skip1, up2))
        xm = conv3x3_dense(y2, d.conv1.weight, d.conv1.bias)

    # ---- last decoder level + head: kernels
    t = getattr(p, f"up{last}_tconv")
    up = ops.tconv2x2_bias(xm.contiguous(), t.weight, t.bias)
    row_off, col_off = _crop_offsets(skip0, up)
    d = getattr(p, f"dec{last}")
    if dec_fuse == "tail":
        return dec_tail(skip0, up, d.conv0.weight, d.conv0.bias, d.conv1.weight,
                        d.conv1.bias, p.outc.weight, p.outc.bias, row_off, col_off)
    y = ops.dec_conv0(skip0, up, d.conv0.weight, d.conv0.bias, row_off, col_off)
    return ops.conv3x3_head(y, d.conv1.weight, d.conv1.bias, p.outc.weight, p.outc.bias)
