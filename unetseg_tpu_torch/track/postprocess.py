"""Track post-processing: gap closing and division pruning (a copy of
unetseg_tpu/track/postprocess.py).

The greedy frame-to-frame matcher fragments lineages whenever segmentation
drops a cell for a frame or two (the reference's output is the extreme case:
10,807 mostly single-frame tracks). Gap closing links a track that ends at
frame t to a parentless track that starts at t+1..t+max_gap whose first
object overlaps the ended track's last object — a standard tracklet-stitching
pass the reference lacks entirely.

Works on the tracker's outputs (tracks + per-frame label->track assignments)
plus the instance masks, and returns updated tracks/assignments with merged
ids, ready for `relabel_by_track`.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Sequence, Tuple

import numpy as np

from unetseg_tpu_torch.track.iou import pairwise_iou
from unetseg_tpu_torch.track.tracker import CellTrack


def close_gaps(
    masks: Sequence[np.ndarray],
    frame_nums: Sequence[int],
    tracks: List[CellTrack],
    assignments: List[Dict[int, int]],
    max_gap: int = 2,
    iou_threshold: float = 0.2,
) -> Tuple[List[CellTrack], List[Dict[int, int]]]:
    """Link (ended track) -> (later-starting parentless track) pairs.

    Greedy, highest IoU first, each endpoint used once. The child track's
    vertices are relabeled to the parent id; its own children re-parent.
    """
    frame_index = {f: i for i, f in enumerate(frame_nums)}
    by_id = {t.label: t for t in tracks}
    has_children = {t.parent_label for t in tracks if t.parent_label > 0}

    # object pixel label of track `tid` in a given frame
    label_in_frame: Dict[Tuple[int, int], int] = {}
    for idx, assignment in enumerate(assignments):
        for lab, tid in assignment.items():
            label_in_frame[(idx, tid)] = lab

    candidates = []
    ends = [t for t in tracks if t.label not in has_children]
    starts_by_frame: Dict[int, List[CellTrack]] = {}
    for t in tracks:
        if t.parent_label == 0:
            starts_by_frame.setdefault(t.start_frame, []).append(t)

    for a in ends:
        end_idx = frame_index.get(a.end_frame)
        if end_idx is None:
            continue
        a_lab = label_in_frame.get((end_idx, a.label))
        if a_lab is None:
            continue
        for gap in range(1, max_gap + 1):
            sf = a.end_frame + gap
            for b in starts_by_frame.get(sf, []):
                if b.label == a.label:
                    continue
                s_idx = frame_index.get(sf)
                if s_idx is None:
                    continue
                b_lab = label_in_frame.get((s_idx, b.label))
                if b_lab is None:
                    continue
                iou_m, pl, cl = pairwise_iou(
                    (np.asarray(masks[end_idx]) == a_lab).astype(np.uint16),
                    (np.asarray(masks[s_idx]) == b_lab).astype(np.uint16),
                )
                if iou_m.size and iou_m[0, 0] >= iou_threshold:
                    candidates.append((float(iou_m[0, 0]), a.label, b.label))

    candidates.sort(reverse=True)
    used_ends: set = set()
    used_starts: set = set()
    merge_into: Dict[int, int] = {}  # child track id -> surviving id
    for iou_v, a_id, b_id in candidates:
        # follow prior merges of the end side
        while a_id in merge_into:
            a_id = merge_into[a_id]
        if a_id in used_ends or b_id in used_starts or a_id == b_id:
            continue
        a, b = by_id[a_id], by_id[b_id]
        if b.start_frame <= a.end_frame:
            continue
        merge_into[b_id] = a_id
        used_ends.add(a_id)
        used_starts.add(b_id)
        by_id[a_id] = replace(a, end_frame=b.end_frame)

    def resolve(tid: int) -> int:
        while tid in merge_into:
            tid = merge_into[tid]
        return tid

    new_tracks = []
    for t in tracks:
        if t.label in merge_into:
            continue
        t = by_id[t.label]
        parent = resolve(t.parent_label) if t.parent_label > 0 else 0
        new_tracks.append(replace(t, parent_label=parent))
    new_assignments = [
        {lab: resolve(tid) for lab, tid in a.items()} for a in assignments
    ]
    return new_tracks, new_assignments


def prune_short_divisions(
    masks: Sequence[np.ndarray],
    frame_nums: Sequence[int],
    tracks: List[CellTrack],
    assignments: List[Dict[int, int]],
    min_child_frames: int = 3,
) -> Tuple[List[CellTrack], List[Dict[int, int]]]:
    """Revoke divisions whose daughters do not persist.

    A real division produces two daughters that both live on; a watershed
    fragment produces a 'daughter' that disappears within a frame or two. For
    each division event where a childless daughter lives < `min_child_frames`
    frames (and does not run to the end of the sequence, which is censoring,
    not evidence), the division is revoked: the daughter that best continues
    the parent (IoU of the parent's last object vs each daughter's first
    object) is merged back into the parent track, and the other daughter
    becomes a parentless track. Temporal-persistence gate the reference's
    division rule (reference: scripts/track.py:198-243) lacks entirely.
    """
    frame_index = {f: i for i, f in enumerate(frame_nums)}
    last_frame = max(frame_nums) if len(frame_nums) else -1
    by_id = {t.label: t for t in tracks}
    children_of: Dict[int, List[CellTrack]] = {}
    for t in tracks:
        if t.parent_label > 0:
            children_of.setdefault(t.parent_label, []).append(t)

    label_in_frame: Dict[Tuple[int, int], int] = {}
    for idx, assignment in enumerate(assignments):
        for lab, tid in assignment.items():
            label_in_frame[(idx, tid)] = lab

    def object_iou(tid_a: int, fidx_a: int, tid_b: int, fidx_b: int) -> float:
        lab_a = label_in_frame.get((fidx_a, tid_a))
        lab_b = label_in_frame.get((fidx_b, tid_b))
        if lab_a is None or lab_b is None:
            return 0.0
        m, _, _ = pairwise_iou(
            (np.asarray(masks[fidx_a]) == lab_a).astype(np.uint16),
            (np.asarray(masks[fidx_b]) == lab_b).astype(np.uint16),
        )
        return float(m[0, 0]) if m.size else 0.0

    merge_into: Dict[int, int] = {}  # daughter track id -> parent id
    orphaned: set = set()

    for parent_id, kids in children_of.items():
        if len(kids) != 2 or parent_id not in by_id:
            continue
        parent = by_id[parent_id]

        def is_short(k: CellTrack) -> bool:
            return (
                k.end_frame - k.start_frame + 1 < min_child_frames
                and k.label not in children_of
                and k.end_frame < last_frame
            )

        if not any(is_short(k) for k in kids):
            continue
        # revoke: the daughter continuing the parent is the one with the
        # higher IoU against the parent's final object
        p_idx = frame_index.get(parent.end_frame)
        ious = []
        for k in kids:
            k_idx = frame_index.get(k.start_frame)
            v = (
                object_iou(parent_id, p_idx, k.label, k_idx)
                if p_idx is not None and k_idx is not None
                else 0.0
            )
            ious.append((v, k.end_frame - k.start_frame + 1, k.label))
        keep = by_id[max(ious)[2]]
        drop = kids[0] if kids[1].label == keep.label else kids[1]
        merge_into[keep.label] = parent_id
        by_id[parent_id] = replace(parent, end_frame=keep.end_frame)
        orphaned.add(drop.label)

    if not merge_into:
        return tracks, assignments

    def resolve(tid: int) -> int:
        while tid in merge_into:
            tid = merge_into[tid]
        return tid

    new_tracks = []
    for t in tracks:
        if t.label in merge_into:
            continue
        t = by_id[t.label]
        parent = t.parent_label
        if t.label in orphaned:
            parent = 0
        elif parent > 0:
            parent = resolve(parent)
        new_tracks.append(replace(t, parent_label=parent))
    new_assignments = [
        {lab: resolve(tid) for lab, tid in a.items()} for a in assignments
    ]
    return new_tracks, new_assignments
