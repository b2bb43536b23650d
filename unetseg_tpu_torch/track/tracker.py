"""IoU/Hungarian cell tracker with division detection (a copy of
unetseg_tpu/track/tracker.py).

Algorithm-equivalent rebuild of the reference tracker
(reference: scripts/track.py:103-275):

frame 0: every object starts a track. frame t: Hungarian assignment
(scipy linear_sum_assignment) on cost 1 - IoU (cost 1000 for non-overlapping
pairs, reference :164-173), matches accepted at IoU >= `iou_threshold_track`
(0.3); a division is an unmatched-but-active previous object overlapping
exactly 2 unmatched current objects at IoU >= `iou_threshold_division` (0.1)
— the parent track ends at t-1, the children start with parent links
(reference :198-243); remaining unmatched current objects start new tracks.
Output rows are "L B E P" sorted by (start, label) with E >= B
(reference :264-272).

The pairwise-IoU hot loop is replaced by one joint-histogram pass
(see track/iou.py); the matching semantics are unchanged.

**Deliberate divergence** (SURVEY.md 'Known defects'): the reference's
active-label map keeps stale entries from disappeared objects, so a later
frame whose connected-component labeling happens to reuse the same label id
silently extends a long-dead track. By default the map is rebuilt every frame
from the objects actually present (`faithful_active_map=False`);
set it True to reproduce the reference's behavior exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from unetseg_tpu_torch.core.config import TrackConfig
from unetseg_tpu_torch.track.iou import pairwise_iou

_NO_OVERLAP_COST = 1000.0


@dataclass
class CellTrack:
    """One lineage-tree node (reference: scripts/track.py:27-36)."""

    label: int
    start_frame: int
    end_frame: int
    parent_label: int = 0  # 0 = no parent, CTC convention

    def row(self) -> str:
        return f"{self.label} {self.start_frame} {max(self.start_frame, self.end_frame)} {self.parent_label}"


@dataclass
class TrackerState:
    tracks: Dict[int, CellTrack] = field(default_factory=dict)
    next_id: int = 1
    # object label in the *latest processed frame* -> track id
    active: Dict[int, int] = field(default_factory=dict)
    prev_mask: Optional[np.ndarray] = None
    frame_assignments: List[Dict[int, int]] = field(default_factory=list)


class Tracker:
    """Feed frames one at a time; collect CTC tracks + per-frame
    (object label -> track id) assignments (the mapping the reference's
    visualizer lacks, reference: scripts/visualize.py:100-172)."""

    def __init__(
        self,
        cfg: Optional[TrackConfig] = None,
        faithful_active_map: bool = False,
    ):
        self.cfg = cfg or TrackConfig()
        self.faithful = faithful_active_map
        self.state = TrackerState()

    # ------------------------------------------------------------------ API
    def update(self, mask: np.ndarray, frame_num: int) -> Dict[int, int]:
        """Process one instance mask; returns {object label: track id}."""
        st = self.state
        cfg = self.cfg

        if st.prev_mask is None:
            labels = np.unique(mask)
            assignment = {}
            for lab in labels[labels != 0]:
                assignment[int(lab)] = self._new_track(frame_num)
            self._finish_frame(mask, assignment)
            return assignment

        iou, prev_labels, curr_labels, prev_areas, curr_areas, inter_m = (
            pairwise_iou(st.prev_mask, mask, return_areas=True)
        )
        n_prev, n_curr = len(prev_labels), len(curr_labels)

        def area_gate_ok(i: int, child_js) -> bool:
            """Every daughter >= division_min_child_frac of the parent's
            area (improvement over the reference, disabled in faithful
            mode — watershed fragments are far smaller than real
            daughters)."""
            frac = cfg.division_min_child_frac
            if self.faithful or frac <= 0:
                return True
            return all(
                curr_areas[j] >= frac * prev_areas[i] for j in child_js
            )
        def division_candidate(i: int, j: int) -> bool:
            """Current object j can be a daughter of prev i: IoU above the
            division threshold (reference rule), or — non-faithful only —
            parent covers >= division_child_cover of the daughter's area.
            IoU under-measures daughters (half the parent's size caps IoU
            near 0.5 even fully contained); the asymmetric cover recovers
            divisions whose second daughter lands mostly outside the
            parent (observed at IoU 0.074, cover 0.26)."""
            if not self.faithful and cfg.division_min_child_frac > 0:
                # apply the per-daughter area gate AT candidate time: the
                # exact-count windows below (== max_children - 1,
                # <= max_children) would otherwise let one >=min_cell_size
                # fragment (high cover, sub-daughter area) push a true
                # 2-daughter division past the window and suppress it
                if curr_areas[j] < (
                    cfg.division_min_child_frac * prev_areas[i]
                ):
                    return False
            if iou[i, j] >= cfg.iou_threshold_division:
                return True
            cov = cfg.division_child_cover
            if self.faithful or cov <= 0 or curr_areas[j] == 0:
                return False
            # exact pixel intersection from the joint histogram — not the
            # float-roundtripped iou*(A+B)/(1+iou) reconstruction
            return inter_m[i, j] / curr_areas[j] >= cov

        assignment: Dict[int, int] = {}
        matched_prev: set = set()
        matched_curr: set = set()

        # In faithful mode additions go into the live dict immediately, like
        # the reference, whose matching loop mutates active_tracks_by_obj_label
        # as it walks the assignment pairs (reference: scripts/track.py:186-192)
        # — so a later pair whose prev label collides with a just-added curr
        # label silently follows the new entry. Default mode defers additions
        # to the end of the frame, which uses only prev-frame labels.
        interleave = self.faithful

        matched_pairs = []  # (i, j, track id) accepted 1-to-1 matches
        if n_prev > 0 and n_curr > 0:
            cost = np.where(iou > 0, 1.0 - iou, _NO_OVERLAP_COST)
            rows, cols = linear_sum_assignment(cost)
            for i, j in zip(rows, cols):
                pair_iou = 1.0 - cost[i, j]
                if pair_iou >= cfg.iou_threshold_track:
                    p_lab = prev_labels[i]
                    if p_lab in st.active:
                        tid = st.active.pop(p_lab)
                        st.tracks[tid].end_frame = frame_num
                        assignment[curr_labels[j]] = tid
                        if interleave:
                            st.active[curr_labels[j]] = tid
                        matched_prev.add(i)
                        matched_curr.add(j)
                        matched_pairs.append((i, j, tid))

        # ---------------------------------- division from a matched parent
        # (improvement over the reference, see TrackConfig.division_from_matched)
        if cfg.division_from_matched and not self.faithful:
            for i, j, tid in matched_pairs:
                if iou[i, j] > cfg.matched_division_iou_cap:
                    continue
                extras = [
                    j2 for j2 in range(n_curr)
                    if j2 not in matched_curr and division_candidate(i, j2)
                ]
                if len(extras) == cfg.max_children - 1 and area_gate_ok(
                    i, [j] + extras
                ):
                    # reinterpret the 1-to-1 match as a division
                    st.tracks[tid].end_frame = frame_num - 1
                    del assignment[curr_labels[j]]
                    for jc in [j] + extras:
                        child = self._new_track(frame_num, parent=tid)
                        assignment[curr_labels[jc]] = child
                        matched_curr.add(jc)

        # ------------------------------------------------ division detection
        unmatched_prev = [i for i in range(n_prev) if i not in matched_prev]
        unmatched_curr = [j for j in range(n_curr) if j not in matched_curr]
        for i in unmatched_prev:
            p_lab = prev_labels[i]
            if p_lab not in st.active:
                continue
            children = [
                j for j in unmatched_curr if division_candidate(i, j)
            ]
            if 2 <= len(children) <= cfg.max_children and area_gate_ok(
                i, children
            ):
                parent_tid = st.active.pop(p_lab)
                st.tracks[parent_tid].end_frame = frame_num - 1
                for j in children:
                    tid = self._new_track(frame_num, parent=parent_tid)
                    assignment[curr_labels[j]] = tid
                    if interleave:
                        st.active[curr_labels[j]] = tid
                    matched_curr.add(j)
                # NOTE: like the reference (:207,218), the unmatched_curr list
                # is not rebuilt between parents; matched_curr gates below.

        # -------------------------------------------------------- new tracks
        for j in range(n_curr):
            if j not in matched_curr:
                tid = self._new_track(frame_num)
                assignment[curr_labels[j]] = tid
                if interleave:
                    st.active[curr_labels[j]] = tid

        self._finish_frame(mask, assignment)
        return assignment

    def track_arrays(self, masks: Sequence[np.ndarray], frame_nums: Optional[Sequence[int]] = None) -> List[CellTrack]:
        nums = frame_nums if frame_nums is not None else range(len(masks))
        for mask, num in zip(masks, nums):
            self.update(np.asarray(mask), int(num))
        return self.tracks()

    def tracks(self) -> List[CellTrack]:
        """All tracks sorted by (start_frame, label) like the reference
        (:267)."""
        return sorted(
            self.state.tracks.values(), key=lambda t: (t.start_frame, t.label)
        )

    def assignments(self) -> List[Dict[int, int]]:
        return self.state.frame_assignments

    # -------------------------------------------------------------- helpers
    def _new_track(self, frame_num: int, parent: int = 0) -> int:
        st = self.state
        tid = st.next_id
        st.next_id += 1
        st.tracks[tid] = CellTrack(tid, frame_num, frame_num, parent)
        return tid

    def _finish_frame(self, mask: np.ndarray, assignment: Dict[int, int]) -> None:
        st = self.state
        if self.faithful:
            # entries were interleaved into st.active during the frame, and
            # stale keys linger forever (the reference never clears
            # disappeared objects). For frame 0 nothing was added yet.
            if st.prev_mask is None:
                st.active.update(assignment)
        else:
            st.active = dict(assignment)
        st.prev_mask = np.asarray(mask)
        st.frame_assignments.append(dict(assignment))


def track_sequence_masks(
    masks: Sequence[np.ndarray],
    frame_nums: Optional[Sequence[int]] = None,
    cfg: Optional[TrackConfig] = None,
    faithful_active_map: bool = False,
) -> List[CellTrack]:
    """One-shot convenience over Tracker (reference: scripts/track.py:103)."""
    tr = Tracker(cfg, faithful_active_map=faithful_active_map)
    return tr.track_arrays(masks, frame_nums)
