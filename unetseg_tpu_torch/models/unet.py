"""Eval-mode valid-convolution U-Net (counterpart of unetseg_tpu/models/unet.py).

Same topology and parameter tree as the Flax `UNet`: per level a
`DoubleConv` of two (valid 3x3 conv -> BatchNorm -> ReLU), 2x2 max-pool
between encoder levels, a k=2 s=2 transposed conv (or bilinear
align-corners upsampling) up path, the skip center-cropped with
`center_crop_bounds` and concatenated skip-first, and a 1x1 head with f32
logits. Module names follow the Flax names (`enc0.conv0`, `enc0.bn0`,
`up0_tconv`, `outc`) so utils/flax_bridge.py maps one tree onto the other
by name.

Only inference is ported: BatchNorm normalises with its running statistics.
The masked train-mode BatchNorm comes with the train step.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.models.shapes import center_crop_bounds

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last storage when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def center_crop_nhwc(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Center-crop an NHWC tensor to (th, tw) with the reference's bounds
    (start = max(0, (s - t) // 2))."""
    h0, h1 = center_crop_bounds(x.shape[1], th)
    w0, w1 = center_crop_bounds(x.shape[2], tw)
    return x[:, h0:h1, w0:w1, :]


def upsample_bilinear_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling of an NHWC tensor, align_corners=True."""
    y = F.interpolate(
        to_nchw(x), scale_factor=2, mode="bilinear", align_corners=True
    )
    return to_nhwc(y)


class BatchNorm(nn.Module):
    """BatchNorm over channels, normalising with the running statistics.

    Matches MaskedBatchNorm(use_running_average=True): fp32 statistics
    folded into one per-channel multiply-add, applied in the input dtype."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x NCHW
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported; call .eval()"
            )
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * a
        return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


class DoubleConv(nn.Module):
    """(valid 3x3 conv -> BN -> ReLU) x2."""

    def __init__(self, cin: int, features: int, eps: float):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, features, 3)
        self.bn0 = BatchNorm(features, eps)
        self.conv1 = nn.Conv2d(features, features, 3)
        self.bn1 = BatchNorm(features, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x NCHW
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            x = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))
            x = F.relu(bn(x))
        return x


class UNet(nn.Module):
    """Input NHWC (N, H, W, in_channels); output f32 logits
    (N, H', W', num_classes) with H' = H - margin(H)."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        add_blocks(self, lambda cin, f: DoubleConv(cin, f, cfg.bn_epsilon))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = trunk(self, to_nchw(x.to(compute_dtype(self.cfg))))
        logits = F.conv2d(x.float(), self.outc.weight, self.outc.bias)
        return to_nhwc(logits)


def add_blocks(net: nn.Module, make_block: Callable[[int, int], nn.Module]) -> None:
    """Give `net` (with a ModelConfig `net.cfg`) the U-Net's modules under
    the Flax names: enc{k} and dec{i} from make_block(in_channels,
    features), up{i}_tconv, outc."""
    cfg = net.cfg
    feats = [cfg.base_features * 2**i for i in range(cfg.levels)]
    cin = cfg.in_channels
    for lvl, f in enumerate(feats):
        net.add_module(f"enc{lvl}", make_block(cin, f))
        cin = f
    for i, skip_f in enumerate(reversed(feats[:-1])):
        in_f = feats[-1 - i]
        up_f = in_f if cfg.bilinear else in_f // 2
        if not cfg.bilinear:
            net.add_module(f"up{i}_tconv", nn.ConvTranspose2d(in_f, up_f, 2, stride=2))
        net.add_module(f"dec{i}", make_block(skip_f + up_f, skip_f))
    net.outc = nn.Conv2d(feats[0], cfg.num_classes, 1)


def trunk(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Encoder and decoder of a U-Net module with blocks enc{k}, up{i}_tconv
    and dec{i} (UNet or infer.folding.FoldedUNet): NCHW input in the compute
    dtype -> the last decoder block's NCHW output, before the head."""
    cfg = net.cfg
    dtype = x.dtype
    skips = []
    for lvl in range(cfg.levels):
        if lvl > 0:
            x = F.max_pool2d(x, 2)  # floors odd sizes
        x = getattr(net, f"enc{lvl}")(x)
        skips.append(x)

    x = skips[-1]
    for i, skip in enumerate(reversed(skips[:-1])):
        if cfg.bilinear:
            x = to_nchw(upsample_bilinear_align_corners(to_nhwc(x)))
        else:
            t = getattr(net, f"up{i}_tconv")
            x = F.conv_transpose2d(x, t.weight.to(dtype), t.bias.to(dtype), stride=2)
        skip_c = center_crop_nhwc(to_nhwc(skip), x.shape[2], x.shape[3])
        # skip first, as the reference concatenates
        x = torch.cat([to_nchw(skip_c), x], dim=1)
        x = getattr(net, f"dec{i}")(x)
    return x
