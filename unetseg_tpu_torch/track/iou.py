"""Vectorized pairwise IoU between two instance-labeled masks (a copy of
unetseg_tpu/track/iou.py).

The reference computes each (prev, curr) pair's IoU by rasterizing both
objects' pixel-coordinate sets into full (H, W) boolean masks — O(P*C*H*W)
per frame pair, the tracker's hot loop (reference: scripts/track.py:73-100,
161-173; SURVEY.md §3.3). Here one joint histogram over the two label images
yields every intersection at once (O(H*W)), and areas come from bincounts;
the resulting IoU matrix is numerically identical.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def pairwise_iou(
    prev_mask: np.ndarray, curr_mask: np.ndarray, return_areas: bool = False
):
    """IoU matrix between all labeled objects of two masks.

    Returns (iou (P, C) float64, prev_labels, curr_labels), labels sorted
    ascending (np.unique order, matching the reference's
    get_mask_properties iteration order, reference: scripts/track.py:53-54).
    With return_areas, appends the per-object pixel areas
    (prev_areas (P,), curr_areas (C,)) and the exact integer intersection
    matrix (inter (P, C) float64 of pixel counts) — free by-products of the
    joint histogram, used by the tracker's division area gate and
    daughter-cover test (reconstructing the intersection from the rounded
    IoU put float error exactly at the cover decision boundary).
    """
    p = np.asarray(prev_mask).ravel()
    c = np.asarray(curr_mask).ravel()

    p_labels = np.unique(p)
    p_labels = p_labels[p_labels != 0]
    c_labels = np.unique(c)
    c_labels = c_labels[c_labels != 0]
    np_, nc = len(p_labels), len(c_labels)
    if np_ == 0 or nc == 0:
        empty = (np.zeros((np_, nc)), list(p_labels), list(c_labels))
        if return_areas:
            return empty + (np.zeros(np_), np.zeros(nc), np.zeros((np_, nc)))
        return empty

    # dense index encoding: 0 = background, 1..n = object index
    p_idx = np.searchsorted(p_labels, p)
    p_enc = np.where(np.isin(p, p_labels), p_idx + 1, 0)
    c_idx = np.searchsorted(c_labels, c)
    c_enc = np.where(np.isin(c, c_labels), c_idx + 1, 0)

    joint = np.bincount(
        p_enc * (nc + 1) + c_enc, minlength=(np_ + 1) * (nc + 1)
    ).reshape(np_ + 1, nc + 1)
    inter = joint[1:, 1:].astype(np.float64)
    area_p = joint[1:, :].sum(axis=1, keepdims=True)
    area_c = joint[:, 1:].sum(axis=0, keepdims=True)
    union = area_p + area_c - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    out = (iou, [int(x) for x in p_labels], [int(x) for x in c_labels])
    if return_areas:
        return out + (area_p[:, 0], area_c[0, :], inter)
    return out
