"""Division-event recall/precision against CTC ground-truth lineage (a copy
of unetseg_tpu/metrics/divisions.py).

The CTC TRA measure prices division errors only indirectly (ED/EC edge
costs); this gives the direct biological question an answer: of the
divisions in the GT lineage, how many did the tracker find?

A GT division is a parent track with >=2 children in man_track.txt. A
result division matches it when the result parent's final mask contains
the GT parent's final marker (majority of the marker's pixels — TRA GT
masks are small markers, so IoU would be meaningless) within a +-frame
tolerance. Greedy one-to-one matching over result divisions.

The reference has no equivalent tooling (its tracker also only finds 2/8
of seq 01's divisions; scripts/track.py:198-243).
"""

from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from unetseg_tpu_torch.data.io import frame_number, read_image, sorted_frames


def read_track_file(path: str) -> List[Tuple[int, int, int, int]]:
    """Rows (label, begin, end, parent) of a man_track.txt / res_track.txt."""
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 4:
                rows.append(tuple(int(v) for v in p[:4]))
    return rows


def divisions_of(rows) -> Dict[int, List[int]]:
    """parent label -> child labels, for parents with >= 2 children."""
    children = defaultdict(list)
    for lab, _b, _e, par in rows:
        if par > 0:
            children[par].append(lab)
    return {p: c for p, c in children.items() if len(c) >= 2}


@dataclass
class DivisionReport:
    n_gt: int
    n_res: int
    matched: int
    details: List[dict] = field(default_factory=list)

    @property
    def recall(self) -> float:
        return self.matched / self.n_gt if self.n_gt else 1.0

    @property
    def precision(self) -> float:
        return self.matched / self.n_res if self.n_res else 1.0


def _frames_by_number(directory: str, pattern: str) -> Dict[int, str]:
    return {frame_number(f): f for f in sorted_frames(directory, pattern)}


def division_report(
    gt_tra_dir: str,
    res_dir: str,
    res_track_path: Optional[str] = None,
    frame_tolerance: int = 2,
    marker_containment: float = 0.5,
) -> DivisionReport:
    """Match result divisions to GT divisions.

    gt_tra_dir: {seq}_GT/TRA (man_track.txt + man_track{NNN}.tif markers).
    res_dir:    CTC result dir (mask{NNN}.tif labeled by track id).
    """
    gt_rows = read_track_file(os.path.join(gt_tra_dir, "man_track.txt"))
    res_track_path = res_track_path or os.path.join(res_dir, "res_track.txt")
    res_rows = read_track_file(res_track_path)
    gt_divs = divisions_of(gt_rows)
    res_divs = divisions_of(res_rows)
    gt_end = {lab: e for lab, _b, e, _p in gt_rows}
    res_end = {lab: e for lab, _b, e, _p in res_rows}
    gt_frames = _frames_by_number(gt_tra_dir, "man_track*.tif")
    res_frames = _frames_by_number(res_dir, "mask*.tif")

    used: set = set()
    matched = 0
    details = []
    res_cache: Dict[int, np.ndarray] = {}
    for gpar in sorted(gt_divs):
        te = gt_end[gpar]
        hit = None
        if te in gt_frames:
            gmask = read_image(gt_frames[te]) == gpar
            g_area = int(gmask.sum())
            for rpar in sorted(res_divs):
                if rpar in used:
                    continue
                tr = res_end.get(rpar)
                if tr is None or abs(tr - te) > frame_tolerance:
                    continue
                if tr not in res_frames:
                    continue
                if tr not in res_cache:
                    res_cache[tr] = read_image(res_frames[tr])
                inter = int((res_cache[tr][gmask] == rpar).sum())
                if g_area and inter / g_area > marker_containment:
                    hit = rpar
                    break
        if hit is not None:
            used.add(hit)
            matched += 1
        details.append({
            "gt_parent": int(gpar), "gt_frame": int(te),
            "res_parent": int(hit) if hit is not None else None,
        })
    return DivisionReport(
        n_gt=len(gt_divs), n_res=len(res_divs), matched=matched,
        details=details,
    )
