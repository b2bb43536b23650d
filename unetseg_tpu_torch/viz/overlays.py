"""Visualization: instance/track overlays, prediction panels, augmentation
panels (a copy of unetseg_tpu/viz/overlays.py; matplotlib is imported,
with the Agg backend, by the functions that draw, not at module import,
since a machine may serve without it).

Covers the reference's three visualizers (reference: scripts/visualize.py,
visualize_prediction.py, visualize_augmentation.py) with one improvement the
reference explicitly could not offer: its overlay shows per-frame instance
labels because res_track.txt lacks the (frame, instance) -> track mapping
(reference: scripts/visualize.py:100-172 and its long comment block); our
Tracker returns that mapping, so overlays can show stable track ids.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _distinct_colors(n: int, seed: int = 7) -> np.ndarray:
    rs = np.random.RandomState(seed)
    cols = rs.rand(max(n, 1), 3) * 0.7 + 0.3
    return cols


def centroids(instance_mask: np.ndarray) -> Dict[int, Tuple[float, float]]:
    """Label -> (row, col) centroid (replaces skimage.regionprops usage,
    reference: scripts/visualize.py:126-140)."""
    out = {}
    labels = np.unique(instance_mask)
    for lab in labels[labels != 0]:
        ys, xs = np.nonzero(instance_mask == lab)
        out[int(lab)] = (float(ys.mean()), float(xs.mean()))
    return out


def overlay_instances(
    image: np.ndarray,
    instance_mask: np.ndarray,
    ids: Optional[Dict[int, int]] = None,
    alpha: float = 0.45,
) -> np.ndarray:
    """RGB overlay of colored instances on a grayscale image; `ids` remaps
    instance labels to display ids (e.g. track ids)."""
    img = np.asarray(image, np.float32)
    if img.max() > 1.0:
        img = img / 255.0
    rgb = np.stack([img] * 3, axis=-1)
    labels = np.unique(instance_mask)
    labels = labels[labels != 0]
    colors = _distinct_colors(int(instance_mask.max()) + 1)
    for lab in labels:
        m = instance_mask == lab
        color = colors[int(lab) % len(colors)]
        rgb[m] = (1 - alpha) * rgb[m] + alpha * color
    return np.clip(rgb, 0, 1)


def save_frame_overlay(
    path: str,
    image: np.ndarray,
    instance_mask: np.ndarray,
    track_ids: Optional[Dict[int, int]] = None,
    title: Optional[str] = None,
) -> None:
    """Overlay + id text at centroids -> PNG (reference:
    scripts/visualize.py:76-194 writes vis_frame_{NNN}.png)."""
    plt = _pyplot()
    rgb = overlay_instances(image, instance_mask, track_ids)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(rgb)
    for lab, (cy, cx) in centroids(instance_mask).items():
        shown = track_ids.get(lab, lab) if track_ids else lab
        ax.text(cx, cy, str(shown), color="yellow", fontsize=9,
                ha="center", va="center")
    if title:
        ax.set_title(title)
    ax.axis("off")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def save_prediction_panel(
    path: str,
    image: np.ndarray,
    gt_mask: Optional[np.ndarray],
    pred_mask: np.ndarray,
) -> None:
    """3-panel original / GT / prediction figure (reference:
    scripts/visualize_prediction.py:61-91)."""
    plt = _pyplot()
    panels = [("input", image), ("ground truth", gt_mask), ("prediction", pred_mask)]
    panels = [(t, p) for t, p in panels if p is not None]
    fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 5))
    if len(panels) == 1:
        axes = [axes]
    for ax, (t, p) in zip(axes, panels):
        ax.imshow(np.asarray(p), cmap="gray")
        ax.set_title(t)
        ax.axis("off")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def save_augmentation_panel(
    path: str,
    image: np.ndarray,
    mask: np.ndarray,
    deformed_image: np.ndarray,
    deformed_mask: np.ndarray,
) -> None:
    """Original vs elastically deformed panel (reference:
    scripts/visualize_augmentation.py:52-91)."""
    plt = _pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(10, 10))
    for ax, (t, p) in zip(
        axes.ravel(),
        [
            ("image", image),
            ("mask", mask),
            ("deformed image", deformed_image),
            ("deformed mask", deformed_mask),
        ],
    ):
        ax.imshow(np.asarray(p), cmap="gray")
        ax.set_title(t)
        ax.axis("off")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
