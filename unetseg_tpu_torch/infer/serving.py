"""The serving function of one folded net: input normalisation, the
forward and the probabilities. infer/engine.Predictor runs it for each
member, and infer/export.py exports it, so the exported artifact computes
what `Predictor.probs` computes for one member.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from unetseg_tpu_torch.core.config import InferConfig
from unetseg_tpu_torch.infer.folding import FoldedUNet
from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels
from unetseg_tpu_torch.ops.losses import binary_probs_from_logits


def normalize_input(x: torch.Tensor, cfg: InferConfig) -> torch.Tensor:
    """(B, H, W) f32 -> the net's input: per-frame z-score (cfg.standardize)
    or (x - normalize_mean) / normalize_std (cfg.normalize), else x."""
    if cfg.standardize:
        mu = x.mean(dim=(-2, -1), keepdim=True)
        sd = x.std(dim=(-2, -1), keepdim=True, correction=0).clamp_min(1e-6)
        return (x - mu) / sd
    if cfg.normalize:
        return (x - cfg.normalize_mean) / cfg.normalize_std
    return x


def member_probs(net: FoldedUNet, x: torch.Tensor, kernels: bool,
                 options: Mapping[str, Any]) -> torch.Tensor:
    """Normalised (B, H, W) -> (B, h', w') foreground probability, or
    (B, h', w', 3) class probabilities for a 3-class head; through the
    kernel forward (with the serving variants `options`) when `kernels`,
    else the folded net's plain forward."""
    if kernels:
        logits = folded_forward_kernels(net, x[..., None], **options)
    else:
        logits = net(x[..., None])
    if logits.shape[-1] == 3:
        # 3-class (bg / interior / border) head: all probabilities; the
        # sequence path splits instances from interior markers
        return torch.softmax(logits.float(), dim=-1)
    return binary_probs_from_logits(logits)


class ServingFn(torch.nn.Module):
    """images (b, S, S) f32 in [0, 1] -> member_probs of one folded net,
    the normalisation of `cfg` applied first; the default kernel forward
    (no serving variant) when `kernels`."""

    def __init__(self, net: FoldedUNet, cfg: InferConfig, kernels: bool):
        super().__init__()
        self.net = net
        self.cfg = cfg
        self.kernels = kernels

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = normalize_input(images.float(), self.cfg)
        return member_probs(self.net, x, self.kernels, {})
