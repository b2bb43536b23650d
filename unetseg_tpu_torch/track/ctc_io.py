"""CTC track-file IO: res_track.txt / man_track.txt ("L B E P" rows); a
copy of unetseg_tpu/track/ctc_io.py.

The reference writes res_track.txt with parent -1 for parentless tracks
(reference: scripts/track.py:28,272 and the shipped artifact
data/raw/processed/predictions/DIC-C2DH-HeLa/01/res_track.txt), which is
invalid CTC format — the challenge (and its measures) use parent 0; the
author's own evaluation logged parent/child inconsistencies for this
(reference: images/old readme unet.txt 'Key Warnings'). The writer defaults
to the valid 0 convention; `parent_none=-1` reproduces the reference's files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

from unetseg_tpu_torch.track.tracker import CellTrack


def write_res_track(
    path: str,
    tracks: Sequence[CellTrack],
    parent_none: int = 0,
) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for t in tracks:
            parent = t.parent_label if t.parent_label > 0 else parent_none
            end = max(t.start_frame, t.end_frame)
            f.write(f"{t.label} {t.start_frame} {end} {parent}\n")


def read_track_file(path: str) -> List[CellTrack]:
    """Parse res_track.txt / man_track.txt. Parent -1 (reference convention)
    and 0 (CTC convention) both mean 'no parent' and normalize to 0."""
    tracks: List[CellTrack] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            lab, b, e, p = (int(x) for x in parts[:4])
            tracks.append(CellTrack(lab, b, e, max(p, 0)))
    return tracks


def tracks_by_label(tracks: Sequence[CellTrack]) -> Dict[int, CellTrack]:
    return {t.label: t for t in tracks}


def relabel_by_track(mask, assignment: Dict[int, int]):
    """Rewrite a per-frame instance mask so each object's pixel value is its
    TRACK id — the labeling CTC requires of result images (TRA/DET match
    res_track.txt rows against pixel labels). The reference never does this:
    its m{NNN}.tif keep per-frame component labels, one reason its own
    evaluation failed (SURVEY.md §2 'Known defects'). `assignment` is the
    tracker's per-frame {instance label -> track id} map."""
    import numpy as np

    mask = np.asarray(mask)
    out = np.zeros_like(mask, dtype=np.uint16)
    for inst_label, track_id in assignment.items():
        out[mask == inst_label] = track_id
    return out
