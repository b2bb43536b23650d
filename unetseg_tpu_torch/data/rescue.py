"""Faint-cell label rescue: gold-TRA-marker-seeded training labels (a copy
of unetseg_tpu/data/rescue.py).

The silver-truth training labels (``{seq}_ST/SEG``) miss the faint,
optically-flat cells entirely (16 marker-frames in seq 01, 42 in seq 02 of
DIC-C2DH-HeLa) — and those cells are the dominant FN term of the tracking
error budget: a model trained on silver labels alone assigns them ~0
probability (docs/RESULTS.md round-7 FN analysis; 57/60 seq-02 detection
FNs were never segmented at any threshold). The reference trains on the
silver labels verbatim (reference: utils/dataset.py:30-44) and inherits the
deficiency.

This module *rescues* those cells with the gold tracking markers
(``{seq}_GT/TRA/man_track*.tif``) as seeds:

- a marker whose pixels are <50% covered by any silver label is *missing*;
- its **positive core** — the marker dilated to ``core_radius`` px, minus
  existing silver labels — joins the label image as a new instance (large
  enough that predictions trained to its scale survive the
  ``min_cell_size`` post-filter and cover the gold marker for DET/TRA);
- an **ignore annulus** out to ``ignore_radius`` gets loss weight 0: the
  true extent of these flattened cells is ambiguous even visually, so the
  model is told "there is a cell here" without being graded on the
  boundary we cannot draw.

Weight maps for rescued frames are regenerated from the rescued labels
with the standard formula (ops/weight_maps.py) and then the annulus is
zeroed and the core boosted (``core_weight``) — a handful of rescued
instances must outweigh 150 frames teaching "flat = background".

Leakage discipline: training labels seeded from a sequence's OWN gold
markers leak into that sequence's CTC evaluation. `build_overlay_root`
therefore rescues the *other* sequence(s): evaluate seq 02 with a model
trained on rescued-01 + silver-02, and vice versa (the rescued sequence's
own gold is never touched). Cross-sequence transfer is the mechanism under
test: the faint-cell visual category is shared between the sequences.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from unetseg_tpu_torch.data.io import SequencePaths, file_number_str, read_image


@dataclass
class RescueStats:
    frames_seen: int = 0
    frames_rescued: int = 0
    markers_missing: int = 0
    core_px: int = 0
    ignore_px: int = 0


def rescue_frame(
    silver: np.ndarray,
    markers: np.ndarray,
    cover_thresh: float = 0.5,
    core_radius: float = 30.0,
    ignore_radius: float = 70.0,
):
    """(rescued_mask, ignore_mask, n_missing) for one frame.

    rescued_mask: silver labels + one new instance id per missing marker
    (its dilated core, clipped against real silver labels). ignore_mask:
    bool, the annulus between core and ignore_radius (minus silver), to be
    zero-weighted in the loss."""
    from scipy.ndimage import distance_transform_edt

    silver = np.asarray(silver)
    markers = np.asarray(markers)
    out = silver.copy()
    ignore = np.zeros(silver.shape, bool)
    next_id = int(silver.max()) + 1
    n_missing = 0
    fg = silver > 0
    for lab in np.unique(markers):
        if lab == 0:
            continue
        m = markers == lab
        if (silver[m] > 0).mean() >= cover_thresh:
            continue
        n_missing += 1
        # distance from the marker: one EDT serves both radii
        d = distance_transform_edt(~m)
        core = (d <= core_radius) & ~fg & (out == silver)  # don't overwrite
        ring = (d <= ignore_radius) & ~core & ~fg
        out[core] = next_id
        ignore |= ring
        next_id += 1
    # cores always win over ignore rings (they carry supervision); the
    # ring never overlaps any labeled pixel
    ignore &= ~(out > 0)
    return out, ignore, n_missing


def build_overlay_root(
    data_root: str,
    out_root: str,
    rescue_sequences: List[str],
    passthrough_sequences: Optional[List[str]] = None,
    cover_thresh: float = 0.5,
    core_radius: float = 30.0,
    ignore_radius: float = 70.0,
    core_weight: float = 3.0,
    w0: float = 10.0,
    sigma: float = 5.0,
    weight_map_mode: str = "reference",
) -> Dict[str, RescueStats]:
    """Materialize a parallel data root with rescued labels.

    For each sequence in `rescue_sequences`: images dir symlinked, every
    frame's mask/weight-map either rescued (regenerated weight map, zeroed
    annulus, boosted core) or hardlink/copied verbatim. Sequences in
    `passthrough_sequences` are symlinked wholesale. The result trains via
    ``--data-root out_root`` with zero loader changes."""
    from unetseg_tpu_torch.ops.weight_maps import weight_map_np

    os.makedirs(out_root, exist_ok=True)
    stats: Dict[str, RescueStats] = {}

    def link(src, dst):
        if os.path.islink(dst) or os.path.exists(dst):
            return
        os.symlink(os.path.abspath(src), dst)

    for seq in passthrough_sequences or []:
        for suffix in ("", "_ST", "_GT"):
            src = os.path.join(data_root, seq + suffix)
            if os.path.isdir(src):
                link(src, os.path.join(out_root, seq + suffix))

    for seq in rescue_sequences:
        st = stats[seq] = RescueStats()
        paths = SequencePaths(data_root, seq)
        tra_dir = os.path.join(data_root, f"{seq}_GT", "TRA")
        link(paths.images_dir, os.path.join(out_root, seq))
        gt_src = os.path.join(data_root, f"{seq}_GT")
        if os.path.isdir(gt_src):
            link(gt_src, os.path.join(out_root, f"{seq}_GT"))
        seg_out = os.path.join(out_root, f"{seq}_ST", "SEG")
        wm_out = os.path.join(out_root, f"{seq}_ST", "WEIGHT_MAPS")
        os.makedirs(seg_out, exist_ok=True)
        os.makedirs(wm_out, exist_ok=True)
        for img in paths.image_files():
            num = file_number_str(img)
            mask_path = paths.mask_path(num)
            if not os.path.exists(mask_path):
                continue
            st.frames_seen += 1
            tra_path = os.path.join(tra_dir, f"man_track{num}.tif")
            silver = read_image(mask_path)
            dst_mask = os.path.join(seg_out, f"man_seg{num}.tif")
            dst_wm = os.path.join(wm_out, f"weight_map_{num}.npy")
            rescued = None
            if os.path.exists(tra_path):
                markers = read_image(tra_path)
                out, ignore, n = rescue_frame(
                    silver, markers, cover_thresh=cover_thresh,
                    core_radius=core_radius, ignore_radius=ignore_radius,
                )
                if n:
                    rescued = (out, ignore, n)
            if rescued is None:
                # verbatim passthrough (hardlink when possible, else copy)
                for src, dst in ((mask_path, dst_mask),
                                 (paths.weight_map_path(num), dst_wm)):
                    if os.path.exists(dst) or not os.path.exists(src):
                        continue
                    try:
                        os.link(src, dst)
                    except OSError:
                        shutil.copy2(src, dst)
                continue
            out, ignore, n = rescued
            st.frames_rescued += 1
            st.markers_missing += n
            st.core_px += int(((out > 0) & ~(silver > 0)).sum())
            st.ignore_px += int(ignore.sum())
            wm = weight_map_np(out, w0=w0, sigma=sigma, mode=weight_map_mode)
            core = (out > 0) & ~(silver > 0)
            wm = wm.astype(np.float64)
            wm[core] = np.maximum(wm[core], core_weight)
            wm[ignore] = 0.0
            from PIL import Image

            Image.fromarray(out.astype(np.uint16)).save(dst_mask)
            np.save(dst_wm, wm)
    return stats
