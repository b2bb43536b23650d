"""Temporal-marker watershed: split under-segmented frames with yesterday's
instances (a copy of unetseg_tpu/post/temporal.py).

The dominant residual error of distance-transform watershed on DIC-C2DH-HeLa
is under-segmentation (CTC "NS" splits): two touching cells whose contact is
wide have a single distance peak, so no marker-threshold can separate them —
the boundary is simply invisible to the distance transform. But cells move
slowly between frames (the tracker matches at IoU >= 0.3), so the PREVIOUS
frame's instance map knows where the boundary was. Whenever one current
foreground component substantially overlaps more previous instances than the
distance markers would split it into, the watershed for that component is
re-seeded from the previous instances' cores instead.

Measured on round-2 predictions (84 frames x 2 sequences) against plain
distance-marker watershed: NS 63->26 / 128->32, SEG 0.859->0.879 /
0.739->0.842, TRA 0.927->0.951 / 0.836->0.906 (docs/RESULTS.md).

The reference has no equivalent — its post-processing is connected
components + small-object removal only (reference: utils/metrics.py:42).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import ndimage as ndi

from unetseg_tpu_torch.post.cc import label_components, relabel_sequential, remove_small
from unetseg_tpu_torch.post.watershed import distance_markers, watershed


def instance_cores(inst: np.ndarray, core_frac: float = 0.5) -> np.ndarray:
    """Per-instance cores: pixels whose in-instance distance transform
    exceeds core_frac of that instance's maximum. Used as next-frame
    watershed seeds — cores are robust to small cell motion."""
    inst = np.asarray(inst)
    if inst.max() == 0:
        return np.zeros_like(inst, bool)
    dist = ndi.distance_transform_edt(inst > 0).astype(np.float32)
    mx = ndi.maximum(dist, labels=inst, index=np.arange(1, inst.max() + 1))
    thr = np.zeros(inst.max() + 1, np.float32)
    thr[1:] = np.asarray(mx, np.float32) * core_frac
    return (dist >= thr[inst]) & (inst > 0)


def temporal_instance_masks(
    binary_mask: np.ndarray,
    prev_inst: Optional[np.ndarray],
    min_size: int = 1500,
    marker_frac: float = 0.5,
    smooth_sigma: float = 2.0,
    core_frac: float = 0.5,
    min_overlap: int = 500,
    area_guard: float = 0.3,
    backend: str = "native",
) -> np.ndarray:
    """Instances for one frame; `prev_inst` is the previous frame's result
    (None for the first frame — then identical to
    get_instance_masks_watershed).

    `area_guard` prunes re-split fragments: a sub-instance produced by the
    temporal re-seeding whose area is below ``area_guard`` x its seeding
    previous instance's area is treated as a watershed fragment, its seed is
    dropped, and the component's sub-watershed is re-run with the surviving
    seeds (so fragment pixels flood into their real neighbor instead of
    becoming a spurious instance). Cells persist frame-to-frame at roughly
    constant area on this dataset, so a legitimate re-split piece stays near
    its seed's area; 0 disables the guard."""
    binary = np.asarray(binary_mask) > 0
    markers, dist = distance_markers(binary, marker_frac, smooth_sigma)
    labels = watershed(-dist, markers, binary, backend=backend)
    if prev_inst is not None and prev_inst.max() > 0:
        prev_inst = np.asarray(prev_inst)
        prev_areas = np.bincount(prev_inst.ravel())
        comp, n = label_components(binary)
        cores = instance_cores(prev_inst, core_frac)
        for ci in range(1, n + 1):
            region = comp == ci
            overl = np.bincount((prev_inst * region).ravel())
            prev_ids = [
                i for i in range(1, len(overl)) if overl[i] >= min_overlap
            ]
            cur_ids = np.unique(labels[region])
            cur_ids = cur_ids[cur_ids > 0]
            # count only sub-labels that will SURVIVE the min_size filter:
            # a watershed fragment (e.g. 630 px next to a 16.7k px body,
            # seq-02 frame 51) used to satisfy "already split here", the
            # fragment then died in remove_small, and two tracked cells
            # merged for the rest of the sequence — the round-5 seq-02
            # mid-sequence NS signature (GT 13/14 at IoU 0.38-0.46).
            cur_areas = np.bincount(labels[region].ravel())
            cur_sig = [
                c for c in cur_ids
                if c < len(cur_areas) and cur_areas[c] >= min_size
            ]
            if len(prev_ids) >= 2 and len(prev_ids) > len(cur_sig):
                seed = np.where(
                    region & cores & np.isin(prev_inst, prev_ids),
                    prev_inst, 0,
                ).astype(np.uint16)
                if len(np.unique(seed)) - 1 >= 2:
                    sub = watershed(
                        -dist, seed, region.astype(np.uint8), backend=backend
                    )
                    if area_guard > 0:
                        sub_areas = np.bincount(sub.ravel())
                        keep = [
                            s for s in prev_ids
                            if s < len(sub_areas)
                            and sub_areas[s]
                            >= area_guard * prev_areas[s]
                        ]
                        if len(keep) < 2:
                            continue  # split degenerates; keep markers' labels
                        if len(keep) < len(prev_ids):
                            seed = np.where(
                                np.isin(seed, keep), seed, 0
                            ).astype(np.uint16)
                            sub = watershed(
                                -dist, seed, region.astype(np.uint8),
                                backend=backend,
                            )
                    base = int(labels.max())
                    labels = np.where(
                        region & (sub > 0),
                        sub.astype(np.int64) + base,
                        labels,
                    ).astype(np.uint16)
    labels = remove_small(labels.astype(np.int64), min_size)
    return relabel_sequential(labels).astype(np.uint16)


def _adopt_more_split(
    binary: np.ndarray, base: np.ndarray, cand: np.ndarray
) -> np.ndarray:
    """Per foreground component, keep `base`'s labels unless `cand` splits
    that component into MORE instances — then adopt cand's pieces there
    (renumbered past base's labels). Strictly-more-pieces is the only
    adoption rule, so a backward pass can never merge or erode a forward
    split, only refine under-segmentation."""
    comp, n = label_components(np.asarray(binary) > 0)
    out = base.astype(np.int64).copy()
    nxt = int(base.max()) + 1
    for ci in range(1, n + 1):
        region = comp == ci
        nb = np.unique(base[region])
        nc = np.unique(cand[region])
        if len(nc[nc > 0]) > len(nb[nb > 0]):
            # coverage guard: adopting must not zero pixels base labeled
            # (cand's min_size pruning can drop a small piece, which would
            # desynchronize the instance masks from the binary masks)
            if np.any((cand == 0) & region & (base > 0)):
                continue
            sub = np.where(region, cand.astype(np.int64), 0)
            ids = np.unique(sub)
            ids = ids[ids > 0]
            remap = np.zeros(int(sub.max()) + 1, np.int64)
            for k, i in enumerate(ids):
                remap[i] = nxt + k
            nxt += len(ids)
            out = np.where(region, np.where(sub > 0, remap[sub], 0), out)
    return relabel_sequential(out).astype(np.uint16)


def refine_backward(
    binaries,
    insts,
    min_size: int = 1500,
    marker_frac: float = 0.5,
    smooth_sigma: float = 2.0,
    core_frac: float = 0.5,
    min_overlap: int = 500,
    area_guard: float = 0.3,
    backend: str = "native",
    max_frames: Optional[int] = 8,
):
    """Backward temporal sweep over a whole sequence's instance maps.

    The forward pass (temporal_instance_masks frame by frame) cannot split
    under-segmented EARLY frames — frame 0 has no history, so touching
    cells that only separate later stay merged for the first few frames
    (the residual NS ops cluster there: e.g. seed-0 seq-02 has one 28k-px
    component covering two GT markers for frames 0-3). This sweep runs the
    same temporal re-seeding in reverse, seeding frame t from the already-
    refined frame t+1, and adopts a component's new labels only when they
    split it into strictly more pieces (_adopt_more_split) — so the pass
    is monotone: splits propagate backward, merges never do.

    `max_frames` bounds the sweep to the first that-many frames. Running it
    over the WHOLE sequence is a measured negative: walking backward
    through a division turns the single pre-division parent into two false
    pieces seeded by its daughters (seed-0 A/B: seq-01 SEG 0.877 -> 0.855,
    FP +47 on seq 02), while the NS the sweep exists to fix clusters in
    the first few frames. None sweeps everything.
    """
    out = list(insts)
    kw = dict(
        min_size=min_size, marker_frac=marker_frac,
        smooth_sigma=smooth_sigma, core_frac=core_frac,
        min_overlap=min_overlap, area_guard=area_guard, backend=backend,
    )
    start = len(out) - 2
    if max_frames is not None:
        start = min(start, max_frames - 1)
    for t in range(start, -1, -1):
        cand = temporal_instance_masks(binaries[t], out[t + 1], **kw)
        out[t] = _adopt_more_split(binaries[t], out[t], cand)
    return out
