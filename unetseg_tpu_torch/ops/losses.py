"""Losses and probability heads (counterpart of unetseg_tpu/ops/losses.py):
the center crop of NHW targets, the per-pixel softmax cross-entropy the
train step weights and averages, and the inference head."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unetseg_tpu_torch.models.shapes import center_crop_bounds


def center_crop_nhw(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Center-crop a (N, H, W) or (N, H, W, C) tensor to (th, tw) spatially,
    with the reference's crop bounds (scripts/train.py:39-51)."""
    h0, h1 = center_crop_bounds(x.shape[1], th)
    w0, w1 = center_crop_bounds(x.shape[2], tw)
    return x[:, h0:h1, w0:w1, ...]


def per_pixel_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax cross-entropy: logits (N, H, W, C) of any float
    dtype, promoted to fp32; targets (N, H, W) int class indices -> (N, H, W)
    fp32, as torch CrossEntropyLoss(reduction='none') on NHWC."""
    logz = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logz, -1, targets[..., None].long())[..., 0]


def binary_probs_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Foreground probability map from NHWC logits.

    2-channel logits -> softmax channel 1 (reference: scripts/predict.py:84-86);
    1-channel logits -> sigmoid (reference: scripts/inference.py:85).
    """
    if logits.shape[-1] == 2:
        return torch.softmax(logits.float(), dim=-1)[..., 1]
    if logits.shape[-1] == 1:
        return torch.sigmoid(logits.float())[..., 0]
    raise ValueError(f"expected 1 or 2 channels, got {logits.shape[-1]}")
