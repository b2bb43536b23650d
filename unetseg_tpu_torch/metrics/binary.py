"""Binary segmentation metrics: IoU and Dice (a copy of
unetseg_tpu/metrics/binary.py).

Equivalent of the reference's calculate_iou (reference: utils/metrics.py:6-37
— inputs coerced to binary via > 0, empty-vs-empty = 1.0) and the Dice score
added by evaluate1.py (reference: scripts/evaluate1.py:36-70). Takes numpy
arrays: a caller holding a tensor passes `.cpu().numpy()`.
"""

from __future__ import annotations

import numpy as np


def _to_binary_np(x: np.ndarray) -> np.ndarray:
    return (np.asarray(x) > 0)


def iou(predicted: np.ndarray, target: np.ndarray) -> float:
    """Intersection over union of the foregrounds; 1.0 when both empty
    (reference: utils/metrics.py:35-37)."""
    p = _to_binary_np(predicted)
    t = _to_binary_np(target)
    union = np.logical_or(p, t).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(p, t).sum() / union)


def dice(predicted: np.ndarray, target: np.ndarray) -> float:
    """Dice coefficient 2|P∩T| / (|P| + |T|); 1.0 when both empty."""
    p = _to_binary_np(predicted)
    t = _to_binary_np(target)
    denom = p.sum() + t.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * np.logical_and(p, t).sum() / denom)


def batch_mean_iou(predicted: np.ndarray, target: np.ndarray) -> float:
    """Mean per-item IoU over a (N, H, W) batch — the reference's
    evaluate.py averages per-sample IoU (reference: scripts/evaluate.py:100-126)."""
    p = _to_binary_np(predicted)
    t = _to_binary_np(target)
    vals = [iou(p[i], t[i]) for i in range(p.shape[0])]
    return float(np.mean(vals)) if vals else 0.0
