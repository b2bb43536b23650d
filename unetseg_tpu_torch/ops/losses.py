"""Losses and probability heads (counterpart of unetseg_tpu/ops/losses.py
and of the entry points of unetseg_tpu/ops/pallas/wce.py): the center
crop of NHW targets, the per-pixel softmax cross-entropy, the fused
weighted cross-entropy the train step averages, and the inference head."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from unetseg_tpu_torch.models.shapes import center_crop_bounds
from unetseg_tpu_torch.ops.kernels.wce import WeightedCE


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


def weighted_ce_pixels(
    logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
    row_off: int = 0, col_off: int = 0,
) -> torch.Tensor:
    """(N, H, W, C) logits, (N, Ht, Wt) int targets and weights read at
    (row_off, col_off) -> (N, H, W) per-pixel weighted CE in fp32,
    differentiable in the logits (wce.py:95 weighted_ce_pixels; on a CUDA
    tensor the fused kernel pair of ops/kernels/wce.py)."""
    return WeightedCE.apply(logits.contiguous(), targets.to(torch.int32).contiguous(),
                            weights.float().contiguous(), row_off, col_off)


def weighted_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Scalar mean of weighted_ce_pixels over same-size targets and weights
    (wce.py:141 weighted_cross_entropy_pallas)."""
    return weighted_ce_pixels(logits, targets, weights).mean()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Unweighted mean CE, the reference's validation loss
    (scripts/train.py:143; unetseg_tpu/ops/losses.py:64)."""
    return per_pixel_ce(logits, targets).mean()


def cropped_weighted_ce(
    logits: torch.Tensor, full_targets: torch.Tensor, full_weights: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Center-crop (N, Hf, Wf) targets and weights to the NHWC logits'
    window: (loss, cropped targets, cropped weights); the unweighted CE
    and None without weights."""
    th, tw = logits.shape[1], logits.shape[2]
    t = center_crop_nhw(full_targets, th, tw)
    if full_weights is None:
        return cross_entropy(logits, t), t, None
    w = center_crop_nhw(full_weights, th, tw)
    return weighted_cross_entropy(logits, t, w), t, w


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
