"""The port's track/ (iou, tracker, postprocess, ctc_io) against the JAX
package's on the same seeded inputs: chip_smoke's synthetic CTC sequence
(a planted division, a cell that leaves the frame) and a gap/fragment case
(per-frame label permutations as connected components give them, a cell
missing for one frame, a cell split in two for one frame). Equality, not a
tolerance: IoU matrices and integer intersections, tracks, assignments and
res_track.txt bytes; and the known answer SEG = TRA = DET = 1.0 with both
trackers."""

import dataclasses

import numpy as np
import pytest

from chip_smoke import ctc_sequence
from unetseg_tpu.core.config import TrackConfig as JaxTrackConfig
from unetseg_tpu.metrics import ctc as jax_ctc
from unetseg_tpu.track import ctc_io as jax_io
from unetseg_tpu.track import postprocess as jax_post
from unetseg_tpu.track.iou import pairwise_iou as jax_pairwise_iou
from unetseg_tpu.track.tracker import Tracker as JaxTracker
from unetseg_tpu_torch.core.config import TrackConfig
from unetseg_tpu_torch.metrics import ctc
from unetseg_tpu_torch.track import ctc_io, postprocess
from unetseg_tpu_torch.track.iou import pairwise_iou
from unetseg_tpu_torch.track.tracker import CellTrack, Tracker, track_sequence_masks

FRAMES, SIZE = 20, 252


@pytest.fixture(scope="module")
def sequence():
    """(GT labels, man_track rows) of the synthetic sequence."""
    _, labels, rows = ctc_sequence(np.random.RandomState(7), FRAMES, SIZE)
    return [lab for lab in labels], rows


@pytest.fixture(scope="module")
def fragmented(sequence):
    """The sequence's labels as a segmenter might give them: each frame's
    labels permuted, one cell missing from frame 8, one cell cut in two
    halves 2 px apart in frame 12 only."""
    labels, rows = sequence
    rs = np.random.RandomState(1)
    out = []
    for t, lab in enumerate(labels):
        lab = lab.copy()
        if t == 8:
            lab[lab == 5] = 0
        if t == 12:
            ys, xs = np.nonzero(lab == 6)
            mid = int(np.median(xs))
            lab[(lab == 6) & (np.arange(SIZE)[None, :] > mid + 1)] = 200
            lab[(lab == 6) & (np.abs(np.arange(SIZE)[None, :] - mid - 1) <= 1)] = 0
        ids = np.unique(lab[lab > 0])
        perm = np.zeros(int(lab.max()) + 1, np.uint16)
        perm[ids] = rs.permutation(len(ids)) + 1 + rs.randint(0, 3)
        out.append(perm[lab])
    return out


def _rows(tracks):
    return [(t.label, t.start_frame, t.end_frame, t.parent_label) for t in tracks]


@pytest.mark.parametrize("case", ["random", "sequence", "empty"])
def test_pairwise_iou_equals_jax(sequence, case):
    rs = np.random.RandomState(4)
    if case == "random":
        a, b = ((rs.rand(40, 40) * 6).astype(np.uint16) for _ in range(2))
    elif case == "sequence":
        a, b = sequence[0][5], sequence[0][6]  # across the division
    else:
        a, b = np.zeros((8, 8), np.uint16), sequence[0][0][:8, :8] * 0 + 3
    got = pairwise_iou(a, b, return_areas=True)
    want = jax_pairwise_iou(a, b, return_areas=True)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert type(g) is type(w)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    got3, want3 = pairwise_iou(a, b), jax_pairwise_iou(a, b)
    assert len(got3) == 3 and all(np.array_equal(np.asarray(g), np.asarray(w))
                                   for g, w in zip(got3, want3))


MODES = {
    "default": ({}, {}),
    "faithful": ({}, {"faithful_active_map": True}),
    "unmatched_only": ({"division_from_matched": False}, {}),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", ["sequence", "fragmented"])
def test_tracker_equals_jax(sequence, fragmented, tmp_path, case, mode):
    masks = sequence[0] if case == "sequence" else fragmented
    cfg_kw, kw = MODES[mode]
    ours = Tracker(TrackConfig(**cfg_kw), **kw)
    theirs = JaxTracker(JaxTrackConfig(**cfg_kw), **kw)
    nums = list(range(3, 3 + FRAMES))  # frame numbers need not start at 0
    tracks = ours.track_arrays(masks, nums)
    want = theirs.track_arrays(masks, nums)
    assert _rows(tracks) == _rows(want)
    assert ours.assignments() == theirs.assignments()
    for parent_none in (0, -1):
        a, b = tmp_path / f"port{parent_none}.txt", tmp_path / f"jax{parent_none}.txt"
        ctc_io.write_res_track(str(a), tracks, parent_none=parent_none)
        jax_io.write_res_track(str(b), want, parent_none=parent_none)
        assert a.read_bytes() == b.read_bytes()
    n_div = sum(1 for t in tracks if t.parent_label) // 2
    assert n_div >= 1  # the planted division, and the fragment's in the default modes
    assert _rows(track_sequence_masks(masks, nums, TrackConfig(**cfg_kw), **kw)) == _rows(tracks)


@pytest.mark.parametrize("step", ["close_gaps", "prune_short_divisions", "both"])
def test_postprocess_equals_jax(fragmented, step):
    tr, jtr = Tracker(), JaxTracker()
    tracks, want = tr.track_arrays(fragmented), jtr.track_arrays(fragmented)
    asg, jasg = tr.assignments(), jtr.assignments()
    nums = list(range(FRAMES))
    before = len(tracks)
    if step in ("close_gaps", "both"):
        tracks, asg = postprocess.close_gaps(fragmented, nums, tracks, asg, max_gap=2)
        want, jasg = jax_post.close_gaps(fragmented, nums, want, jasg, max_gap=2)
        assert len(tracks) < before  # the missing frame is bridged
    if step in ("prune_short_divisions", "both"):
        n_div = sum(1 for t in tracks if t.parent_label)
        tracks, asg = postprocess.prune_short_divisions(fragmented, nums, tracks, asg,
                                                        min_child_frames=3)
        want, jasg = jax_post.prune_short_divisions(fragmented, nums, want, jasg,
                                                    min_child_frames=3)
        assert sum(1 for t in tracks if t.parent_label) < n_div  # the fragment revoked
    assert _rows(tracks) == _rows(want)
    assert asg == jasg


def test_ctc_io_roundtrip_and_relabel(sequence, tmp_path):
    labels, rows = sequence
    tracks = [CellTrack(*r) for r in rows] + [CellTrack(99, 4, 2, 0)]  # end below start
    for parent_none in (0, -1):
        path = tmp_path / f"res{parent_none}.txt"
        ctc_io.write_res_track(str(path), tracks, parent_none=parent_none)
        assert ctc_io.read_track_file(str(path)) == [
            dataclasses.replace(t, end_frame=max(t.start_frame, t.end_frame)) for t in tracks]
        assert _rows(ctc_io.read_track_file(str(path))) == _rows(jax_io.read_track_file(str(path)))
    assert {k: _rows([v]) for k, v in ctc_io.tracks_by_label(tracks).items()} == \
        {k: _rows([v]) for k, v in jax_io.tracks_by_label(tracks).items()}
    tr = Tracker()
    tr.track_arrays(labels)
    for m, a in zip(labels, tr.assignments()):
        got = ctc_io.relabel_by_track(m, a)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, jax_io.relabel_by_track(m, a))
    partial = {k: v for k, v in list(tr.assignments()[0].items())[1:]}
    np.testing.assert_array_equal(ctc_io.relabel_by_track(labels[0], partial),
                                  jax_io.relabel_by_track(labels[0], partial))


@pytest.mark.parametrize("tracker", ["port", "jax"])
def test_known_answer(sequence, tracker):
    """The GT labels tracked and relabelled by track id score 1.0 against
    themselves, and the planted division is found."""
    labels, rows = sequence
    tr = Tracker() if tracker == "port" else JaxTracker()
    tracks = tr.track_arrays(labels)
    res = [ctc_io.relabel_by_track(m, a) for m, a in zip(labels, tr.assignments())]
    t_div = min(r[1] for r in rows if r[3])
    kids = [t.start_frame for t in tracks if t.parent_label]
    assert kids == [t_div, t_div]
    gt_tracks = [CellTrack(*r) for r in rows]
    for backend in ctc.BACKENDS:
        seg = ctc.seg_measure_arrays(labels, res, backend=backend)
        tra = ctc.tra_det_arrays(labels, res, gt_tracks, tracks, backend=backend)
        jtra = jax_ctc.tra_det_arrays(labels, res, gt_tracks, tracks, backend=backend)
        assert (seg.value, tra.tra, tra.det) == (1.0, 1.0, 1.0)
        assert (jtra.tra, jtra.det) == (1.0, 1.0)
        assert tra.counts["E_gt"] == sum(r[2] - r[1] for r in rows) + 2  # two parent links
