"""BatchNorm folding for inference (counterpart of unetseg_tpu/infer/folding.py).

In eval mode BatchNorm is a per-channel affine transform, so it folds into
the preceding convolution, in fp32:

    W' = W * gamma / sqrt(var + eps)        (per output channel)
    b' = (b - mean) * gamma / sqrt(var + eps) + beta

`FoldedUNet` holds the folded fp32 parameters under the unfolded
module names (enc0.conv0.weight, up0_tconv.weight, outc.weight, ...). Its
`forward` is the plain PyTorch network of unetseg_tpu's FoldedUNet:
conv + bias + ReLU in the compute dtype, and a 1x1 head reading the
compute-dtype activation with f32 accumulation and f32 logits. The kernel
forward of the serving path (infer/kernel_net.py) reads the same
parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.models.unet import (
    add_blocks,
    compute_dtype,
    to_nchw,
    to_nhwc,
    trunk,
)


def fold_batchnorm(
    model_cfg: ModelConfig, state: Mapping[str, torch.Tensor]
) -> "FoldedUNet":
    """FoldedUNet from a `models.unet.UNet` state dict (fp32 folding)."""
    eps = model_cfg.bn_epsilon
    folded: Dict[str, torch.Tensor] = {}
    for key, t in state.items():
        block = key.split(".")[0]
        if not block.startswith(("enc", "dec")):  # outc, up{i}_tconv: no BN
            folded[key] = t.float()
            continue
        if ".conv" not in key or not key.endswith(".weight"):
            continue
        prefix = key[: -len(".weight")]
        bn = prefix.replace(".conv", ".bn")
        inv = state[f"{bn}.weight"].float() / torch.sqrt(
            state[f"{bn}.running_var"].float() + eps
        )
        folded[f"{prefix}.weight"] = t.float() * inv[:, None, None, None]
        folded[f"{prefix}.bias"] = (
            state[f"{prefix}.bias"].float() - state[f"{bn}.running_mean"].float()
        ) * inv + state[f"{bn}.bias"].float()
    model = FoldedUNet(model_cfg)
    model.load_state_dict(folded)
    return model


class FoldedDoubleConv(nn.Module):
    """(valid 3x3 conv -> ReLU) x2 with BN folded into the weights."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, features, 3)
        self.conv1 = nn.Conv2d(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x NCHW
        for conv in (self.conv0, self.conv1):
            x = F.relu(F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype)))
        return x


class FoldedUNet(nn.Module):
    """Inference-only U-Net with folded parameters; NHWC in, f32 NHWC logits out."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        add_blocks(self, FoldedDoubleConv)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(self.cfg)
        x = trunk(self, to_nchw(x.to(dtype)))
        # compute-dtype activation and head kernel, f32 products, sums and logits
        logits = F.conv2d(x.float(), self.outc.weight.to(dtype).float(), self.outc.bias)
        return to_nhwc(logits)
