"""Kernel forward of the folded U-Net (counterpart of
unetseg_tpu/infer/lanes_net.py:folded_forward_tier1 in its default
configuration: dec_fuse="head", no tier 2, no HCNW middle, no fused enc0,
no cblock).

The same stages as the JAX default, without its lanes layout:

    stem             conv3x3_bias_relu             (B,S,S,1)  -> (B,S-2,S-2,f0)
    enc0 conv1+pool0 conv3x3_bias_relu(fuse_pool)  -> skip0 (B,S-4,S-4,f0), pooled
    middle           plain PyTorch (enc1..enc4, pools, up0..up2, dec0..dec2),
                     as the JAX package leaves these stages to XLA
    up3              tconv2x2_bias                 -> (B,c,c,f0), c = crops[-1]
    dec3 conv0       dec_conv0, skip0 read at its center-crop offset
    dec3 conv1+head  conv3x3_head                  -> f32 logits (B,s',s',NC)

On a CUDA device the four kernels run the hand-written Hopper kernels; on
the CPU their plain versions, which is what the CPU tests compare with the
JAX package.
"""

from __future__ import annotations

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
from unetseg_tpu_torch.ops.kernels.conv3x3 import (
    MAX_HEAD_CLASSES,
    conv3x3_bias_relu,
    conv3x3_head,
    dec_conv0,
    tconv2x2_bias,
)


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


def folded_forward_kernels(folded: FoldedUNet, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) -> (B, h', w', num_classes) f32 logits through the four
    serving-path kernels; `folded` is infer/folding.FoldedUNet."""
    cfg = folded.cfg
    dtype = compute_dtype(cfg)
    p = folded

    x = x.to(dtype).contiguous()
    h = conv3x3_bias_relu(x, p.enc0.conv0.weight, p.enc0.conv0.bias)
    skip0, pooled = conv3x3_bias_relu(
        h, p.enc0.conv1.weight, p.enc0.conv1.bias, fuse_pool=True
    )

    # ---- middle: plain PyTorch, NCHW views of NHWC (channels_last) storage
    xm = to_nchw(pooled)
    skips = []
    for lvl in range(1, cfg.levels):
        if lvl > 1:
            xm = F.max_pool2d(xm, 2)
        xm = getattr(p, f"enc{lvl}")(xm)
        skips.append(xm)
    xm = skips[-1]
    last = cfg.levels - 2  # the decoder level the kernels run (dec3)
    for i in range(last):
        t = getattr(p, f"up{i}_tconv")
        xm = F.conv_transpose2d(xm, t.weight.to(dtype), t.bias.to(dtype), stride=2)
        skip = skips[-(i + 2)]
        skip_c = center_crop_nhwc(to_nhwc(skip), xm.shape[2], xm.shape[3])
        xm = torch.cat([to_nchw(skip_c), xm], dim=1)
        xm = getattr(p, f"dec{i}")(xm)

    # ---- last decoder level + head: kernels
    t = getattr(p, f"up{last}_tconv")
    up = tconv2x2_bias(to_nhwc(xm).contiguous(), t.weight, t.bias)
    row_off = center_crop_bounds(skip0.shape[1], up.shape[1])[0]
    col_off = center_crop_bounds(skip0.shape[2], up.shape[2])[0]
    d = getattr(p, f"dec{last}")
    y = dec_conv0(skip0, up, d.conv0.weight, d.conv0.bias, row_off, col_off)
    return conv3x3_head(y, d.conv1.weight, d.conv1.bias, p.outc.weight, p.outc.bias)
