"""Probability heads (counterpart of unetseg_tpu/ops/losses.py). Only the
inference head is ported; the losses come with the train step."""

from __future__ import annotations

import torch


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
