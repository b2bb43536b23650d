"""Kernel train forward of the U-Net (counterpart of
unetseg_tpu/models/lanes_train.py:train_forward_lanes in its default
configuration: fused dec0, fused BN, stop-gradient on the middle's pre-BN
conv biases; tier 1, or tier 2 with `tier2=True`). The same stages, NHWC
instead of the lanes layout:

    enc0      stem and conv1 through Conv3x3Train (conv3x3_bias_relu with
              relu=False forward, dgrad/wgrad backward), each followed by
              the fused BN+ReLU; 2x2 max-pool
    enc1      tier 2 only: conv0 and conv1 through Conv3x3DenseTrain
              (conv3x3_dense forward, the dense dgrad/wgrad backward), each
              with the fused BN+ReLU; their biases get their gradient
              (lanes_train.py:451-476, conv3x3_train.py:458)
    middle    enc1 (tier 1) or enc2 (tier 2) .. enc4, then up0.. and
              dec0.. up to dec2 (tier 1) or dec1 (tier 2), as plain
              PyTorch (cuDNN) convs with the fused BN+ReLU, the pre-BN conv
              biases detached as at lanes_train.py:309-318 (their true
              gradient is exactly 0: BN's mean subtraction removes any
              shift)
    dec2      tier 2 only: up2 a plain transposed conv (lanes_train.py:517,
              outside any kernel); conv0 through DecConv0DenseTrain
              (dec_conv0_dense, skip1 read at its center-crop offset, 41 at
              512^2), conv1 through Conv3x3DenseTrain, each with the fused
              BN+ReLU; biases as enc1's
    up3       TConv2x2Train (tconv2x2_bias forward, plain backward)
    dec3      conv0 through DecConv0Train (dec_conv0 with relu=False, skip0
              read at its center-crop offset; dgrad + two-source wgrad),
              conv1 through Conv3x3Train, each with the fused BN+ReLU
    head      1x1 conv in f32, plain PyTorch
    gates     a gated net's (ModelConfig.skip_gates) before every decoder
              entry: models/unet.gate_from, plain PyTorch with autograd
              (f32 sums of compute-dtype products); the kernel entries read
              x_hat, the compact gated crop, at offset (0, 0)

On a CUDA tensor the Functions launch the hand-written kernels; on the CPU
their plain versions, which is what the CPU tests compare with the JAX
package. Parameters and statistics use the state-dict names of
models/unet.UNet; returns (f32 NHWC logits, new batch stats, detached).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.models.shapes import center_crop_bounds, unet_shapes
from unetseg_tpu_torch.models.unet import (
    center_crop_nhwc,
    compute_dtype,
    gate_from,
    to_nchw,
    to_nhwc,
)
from unetseg_tpu_torch.ops.fused_bn import bn_relu_nhwc
from unetseg_tpu_torch.ops.kernels.conv3x3_train import (
    Conv3x3DenseTrain,
    Conv3x3Train,
    DecConv0DenseTrain,
    DecConv0Train,
    TConv2x2Train,
)


def supports(model_cfg: ModelConfig, input_size: int, device) -> bool:
    """True when the kernel train forward runs this net at this input size
    on this device: the 5-level transposed-conv U-Net with one input
    channel at a valid input size; on a CUDA device also the kernels'
    dtype and widths (bf16, base features a multiple of 64)."""
    cfg = model_cfg
    if cfg.levels != 5 or cfg.bilinear or cfg.in_channels != 1:
        return False
    try:
        unet_shapes(input_size, cfg.levels)
    except ValueError:
        return False
    if torch.device(device).type == "cuda":
        return cfg.compute_dtype == "bfloat16" and cfg.base_features % 64 == 0
    return True


def supports_tier2(model_cfg: ModelConfig, input_size: int, device) -> bool:
    """True when the kernel train forward runs tier 2 for this net at this
    input size on this device. The JAX package's supports_tier2 checks the
    lanes layout's strides and crop parity; NHWC has neither, and the
    kernels take enc1's and dec2's widths wherever they take enc0's, so
    this is wherever the kernel train forward runs
    (infer/kernel_net.supports_tier2 says the same for serving)."""
    return supports(model_cfg, input_size, device)


def train_forward(
    params: Mapping[str, torch.Tensor], batch_stats: Mapping[str, torch.Tensor],
    x: torch.Tensor, cfg: ModelConfig, item_mask: Optional[torch.Tensor] = None,
    tier2: bool = False, group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, S, 1) -> (f32 logits (B, s', s', num_classes), new batch
    stats); the same values and gradients as models/unet.unet_train_forward
    up to summation order, except the middle's pre-BN conv biases, whose
    gradient is dropped. `tier2` runs enc1 and dec2 through the kernels.
    With a process `group` every BatchNorm takes the group's global
    moments (the data-parallel step; JAX train_forward_lanes' axis_name)."""
    dtype = compute_dtype(cfg)
    new_stats: Dict[str, torch.Tensor] = {}

    def bn(z: torch.Tensor, name: str) -> torch.Tensor:  # z NHWC
        y, nm, nv = bn_relu_nhwc(
            z, params[f"{name}.weight"], params[f"{name}.bias"],
            batch_stats[f"{name}.running_mean"], batch_stats[f"{name}.running_var"],
            cfg.bn_momentum, cfg.bn_epsilon, item_mask, group,
        )
        new_stats[f"{name}.running_mean"] = nm.detach()
        new_stats[f"{name}.running_var"] = nv.detach()
        return y

    def kconv(h: torch.Tensor, name: str, fn=Conv3x3Train) -> torch.Tensor:
        return fn.apply(h, params[f"{name}.weight"], params[f"{name}.bias"])

    def kdec(skip: torch.Tensor, up: torch.Tensor, i: int, g: torch.Tensor, entry,
             conv) -> torch.Tensor:
        """Decoder block i through the kernels, NHWC: the entry conv reads
        skip at its center-crop offset, or a gated net's x_hat (from g, the
        up-conv's NCHW input) at (0, 0)."""
        name = f"dec{i}"
        row_off = center_crop_bounds(skip.shape[1], up.shape[1])[0]
        col_off = center_crop_bounds(skip.shape[2], up.shape[2])[0]
        if cfg.skip_gates:
            crop = to_nchw(center_crop_nhwc(skip, up.shape[1], up.shape[2]))
            skip, row_off, col_off = to_nhwc(gate_from(params, i, crop, g)).contiguous(), 0, 0
        z = entry.apply(skip, up, params[f"{name}.conv0.weight"],
                        params[f"{name}.conv0.bias"], row_off, col_off)
        h = bn(z, f"{name}.bn0")
        return bn(kconv(h, f"{name}.conv1", conv), f"{name}.bn1")

    def middle_block(h: torch.Tensor, name: str) -> torch.Tensor:  # NCHW views
        for i in range(2):
            c = f"{name}.conv{i}"
            z = F.conv2d(h, params[f"{c}.weight"].to(dtype),
                         params[f"{c}.bias"].detach().to(dtype))
            h = to_nchw(bn(to_nhwc(z), f"{name}.bn{i}"))
        return h

    def up_plain(i: int, h: torch.Tensor) -> torch.Tensor:  # NCHW views
        t = f"up{i}_tconv"
        return F.conv_transpose2d(h, params[f"{t}.weight"].to(dtype),
                                  params[f"{t}.bias"].to(dtype), stride=2)

    # ---- enc0: kernels
    x = x.to(dtype).contiguous()
    h = bn(kconv(x, "enc0.conv0"), "enc0.bn0")
    skip0 = bn(kconv(h, "enc0.conv1"), "enc0.bn1")

    # ---- encoder: enc1 through the kernels on tier 2, the rest plain
    # PyTorch on NCHW views of NHWC storage
    xm, skips = to_nchw(skip0), []
    for lvl in range(1, cfg.levels):
        xm = F.max_pool2d(xm, 2)
        if tier2 and lvl == 1:
            h = bn(kconv(to_nhwc(xm).contiguous(), "enc1.conv0", Conv3x3DenseTrain), "enc1.bn0")
            xm = to_nchw(bn(kconv(h, "enc1.conv1", Conv3x3DenseTrain), "enc1.bn1"))
        else:
            xm = middle_block(xm, f"enc{lvl}")
        skips.append(xm)

    # ---- decoder: plain PyTorch up to dec2 (tier 1) or dec1 (tier 2)
    last = cfg.levels - 2  # the decoder level the kernels run (dec3)
    for i in range(last - 1 if tier2 else last):
        g, xm = xm, up_plain(i, xm)
        skip_c = to_nchw(center_crop_nhwc(to_nhwc(skips[-(i + 2)]), xm.shape[2], xm.shape[3]))
        if cfg.skip_gates:
            skip_c = gate_from(params, i, skip_c, g)
        xm = middle_block(torch.cat([skip_c, xm], dim=1), f"dec{i}")
    if tier2:  # dec2 through the kernels after a plain up2
        up = to_nhwc(up_plain(last - 1, xm)).contiguous()
        xm = to_nchw(kdec(to_nhwc(skips[0]), up, last - 1, xm,
                          DecConv0DenseTrain, Conv3x3DenseTrain))

    # ---- up3 + dec3: kernels
    t = f"up{last}_tconv"
    up = TConv2x2Train.apply(to_nhwc(xm).contiguous(), params[f"{t}.weight"],
                             params[f"{t}.bias"])
    h = kdec(skip0, up, last, xm, DecConv0Train, Conv3x3Train)

    # ---- 1x1 head in f32
    k = params["outc.weight"]
    logits = h.float() @ k.reshape(k.shape[0], -1).t() + params["outc.bias"]
    return logits, new_stats
