"""The port's metrics/ (binary, rand, divisions, ctc) against the JAX
package's on the same seeded inputs. The CTC measures by arrays and by
files with both backends, each against JAX's same backend: equal counts,
values within 1e-12; the native backend against the python one; the
synthetic cases of tests/test_ctc_measures.py; the golden cases of the
reference's evaluation software where its data is mounted; and the
native build: into the port's own directory, and a failed build raises
where no python result may stand in."""

import os

import numpy as np
import pytest

from chip_smoke import ctc_sequence, write_ctc_root
from tests.conftest import REFERENCE_ROOT, requires_reference_data
from unetseg_tpu.metrics import binary as jax_binary
from unetseg_tpu.metrics import ctc as jax_ctc
from unetseg_tpu.metrics import divisions as jax_divisions
from unetseg_tpu.metrics import rand as jax_rand
from unetseg_tpu_torch.data.io import write_mask_u16
from unetseg_tpu_torch.metrics import binary, ctc, divisions, rand
from unetseg_tpu_torch.track.ctc_io import relabel_by_track, write_res_track
from unetseg_tpu_torch.track.tracker import CellTrack, Tracker

TD = os.path.join(REFERENCE_ROOT, "EvaluationSoftware", "testing_dataset")
BACKENDS = ("native", "python")
FRAMES, SIZE = 12, 252


@pytest.fixture(scope="module")
def scored():
    """A synthetic sequence's GT and a result that misses, splits, merges
    and adds cells: (gt frames, res frames, gt tracks, res tracks)."""
    _, gt, rows = ctc_sequence(np.random.RandomState(5), FRAMES, SIZE)
    rs = np.random.RandomState(2)
    res = []
    for t, lab in enumerate(gt):
        r = lab.copy()
        r[rs.rand(*r.shape) < 0.02] = 0  # ragged edges
        if t % 3 == 1:
            r[r == 5] = 0  # a missed cell (FN, edges to add)
        if t == 6:
            r[r == 6] = 7  # two cells merged into one object
        if t == 9:
            ys, xs = np.nonzero(r == 8)
            r[(r == 8) & (np.arange(SIZE)[:, None] > np.median(ys))] = 300  # a split
        r[5:15, 5:15] = 400 + t  # a false positive
        res.append(r)
    tr = Tracker()
    tracks = tr.track_arrays(res)
    res = [relabel_by_track(m, a) for m, a in zip(res, tr.assignments())]
    return list(gt), res, [CellTrack(*r) for r in rows], tracks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_equals_jax(seed):
    rs = np.random.RandomState(seed)
    p = (rs.rand(3, 30, 30) > 0.5) * 255
    t = (rs.rand(3, 30, 30) * 4).astype(np.int32)
    if seed == 2:
        p[:], t[:] = 0, 0  # empty against empty: 1.0
    for fn in ("iou", "dice"):
        assert getattr(binary, fn)(p[0], t[0]) == getattr(jax_binary, fn)(p[0], t[0])
    assert binary.batch_mean_iou(p, t) == jax_binary.batch_mean_iou(p, t)
    assert binary.batch_mean_iou(p[:0], t[:0]) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_rand_equals_jax(seed):
    rs = np.random.RandomState(seed)
    a = (rs.rand(40, 40) * 5).astype(np.int32)
    b = (rs.rand(40, 40) * 7).astype(np.int32) + 10 * seed
    np.testing.assert_array_equal(rand.contingency_table(a, b),
                                  jax_rand.contingency_table(a, b))
    assert rand.rand_index_and_error(a, b) == jax_rand.rand_index_and_error(a, b)
    assert rand.rand_index_and_error(a[:1, :1], b[:1, :1]) == (1.0, 0.0)
    with pytest.raises(ValueError, match="shape"):
        rand.contingency_table(a, b[:3])


@pytest.mark.parametrize("backend", BACKENDS)
def test_ctc_arrays_equal_jax(scored, backend):
    gt, res, gt_tracks, tracks = scored
    seg = ctc.seg_measure_arrays(gt, res, backend=backend)
    jseg = jax_ctc.seg_measure_arrays(gt, res, backend=backend)
    assert seg.n_objects == jseg.n_objects > 0
    np.testing.assert_allclose(seg.per_object, jseg.per_object, rtol=0, atol=1e-12)
    assert abs(seg.value - jseg.value) < 1e-12
    tra = ctc.tra_det_arrays(gt, res, gt_tracks, tracks, backend=backend)
    jtra = jax_ctc.tra_det_arrays(gt, res, gt_tracks, tracks, backend=backend)
    assert {k: float(v) for k, v in tra.counts.items()} == \
        {k: float(v) for k, v in jtra.counts.items()}
    for key in ("tra", "det", "det_without_fp_penalty", "aogm", "aogm0"):
        assert abs(getattr(tra, key) - getattr(jtra, key)) < 1e-12
    # the result's faults all cost something
    assert 0 < tra.tra < 1 and 0 < tra.det < 1 and 0 < seg.value < 1
    assert all(tra.counts[k] > 0 for k in ("NS", "FN", "FP", "EA"))


def test_ctc_native_equals_python(scored):
    gt, res, gt_tracks, tracks = scored
    sn, sp = (ctc.seg_measure_arrays(gt, res, backend=b) for b in BACKENDS)
    np.testing.assert_allclose(sn.per_object, sp.per_object, rtol=0, atol=1e-12)
    tn, tp = (ctc.tra_det_arrays(gt, res, gt_tracks, tracks, backend=b) for b in BACKENDS)
    assert {k: float(v) for k, v in tn.counts.items()} == \
        {k: float(v) for k, v in tp.counts.items()}
    assert abs(tn.tra - tp.tra) < 1e-12 and abs(tn.det - tp.det) < 1e-12


@pytest.fixture(scope="module")
def ctc_dirs(scored, tmp_path_factory):
    """The scored sequence on disk: a CTC data root (GT SEG every 4th
    frame) and a result dir of mask{T}.tif with res_track.txt."""
    gt, res, gt_tracks, tracks = scored
    root = tmp_path_factory.mktemp("ctc")
    rows = [(t.label, t.start_frame, t.end_frame, t.parent_label) for t in gt_tracks]
    write_ctc_root(str(root / "data"), np.zeros((len(gt), 4, 4)), gt, rows)
    out = root / "res"
    out.mkdir()
    for t, r in enumerate(res):
        write_mask_u16(str(out / f"mask{t:03d}.tif"), r)
    write_res_track(str(out / "res_track.txt"), tracks)
    return str(root / "data"), str(out)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ctc_files_equal_jax(ctc_dirs, backend):
    data, out = ctc_dirs
    seg_gt, tra_gt = (os.path.join(data, "01_GT", d) for d in ("SEG", "TRA"))
    seg = ctc.seg_measure(seg_gt, out, backend=backend)
    jseg = jax_ctc.seg_measure(seg_gt, out, backend=backend)
    assert seg.n_objects == jseg.n_objects and abs(seg.value - jseg.value) < 1e-12
    tra = ctc.tra_measure(tra_gt, out, backend=backend)
    jtra = jax_ctc.tra_measure(tra_gt, out, backend=backend)
    assert {k: float(v) for k, v in tra.counts.items()} == \
        {k: float(v) for k, v in jtra.counts.items()}
    assert abs(tra.tra - jtra.tra) < 1e-12 and abs(tra.det - jtra.det) < 1e-12
    with pytest.raises(FileNotFoundError):
        ctc.seg_measure(seg_gt, os.path.join(data, "01"))


def test_pair_by_number_takes_either_naming(tmp_path):
    gt = [str(tmp_path / f"man_seg{t:03d}.tif") for t in (0, 4)]
    for name in ("mask000.tif", "m004.tif", "m000.tif"):
        (tmp_path / name).write_bytes(b"")
    want = jax_ctc._pair_by_number(gt, str(tmp_path))
    assert ctc._pair_by_number(gt, str(tmp_path)) == want
    assert [os.path.basename(r) for _, r in want] == ["mask000.tif", "m004.tif"]


# ---- the synthetic cases of tests/test_ctc_measures.py, held to JAX too
def _square(label, y, x, size=4, shape=(32, 32)):
    m = np.zeros(shape, np.uint16)
    m[y : y + size, x : x + size] = label
    return m


def _half(extra):
    res = np.zeros((32, 32), np.uint16)
    res[0:2, 0:4] = 3  # exactly 8 of 16 GT pixels: not a strict majority
    if extra:
        res[2, 0] = 3  # 9 of 16
    return res


def _split():
    gt = np.zeros((32, 32), np.uint16)
    gt[4:8, 4:8] = 1
    gt[4:8, 10:14] = 2
    res = np.zeros((32, 32), np.uint16)
    res[4:8, 4:14] = 9
    return gt, res


SEG_CASES = {
    "perfect": ([_square(1, 4, 4)], [_square(7, 4, 4)], 1.0),
    "half_fails": ([_square(1, 0, 0)], [_half(False)], 0.0),
    "majority": ([_square(1, 0, 0)], [_half(True)], 9 / 16),
}
TRA_CASES = {
    "perfect": ([_square(1, 4, 4), _square(1, 5, 4)], [_square(2, 4, 4), _square(2, 5, 4)],
                [CellTrack(1, 0, 1, 0)], [CellTrack(2, 0, 1, 0)],
                dict(FN=0, EA=0), 0.0),
    "missed_cell": ([_square(1, 4, 4), _square(1, 5, 4)],
                    [_square(2, 4, 4), np.zeros((32, 32), np.uint16)],
                    [CellTrack(1, 0, 1, 0)], [CellTrack(2, 0, 0, 0)],
                    dict(FN=1, EA=1), 10 + 1.5),
    "division_edge": ([_square(1, 4, 4), _square(2, 4, 4)], [_square(1, 4, 4)] * 2,
                      [CellTrack(1, 0, 0, 0), CellTrack(2, 1, 1, 1)], [CellTrack(1, 0, 1, 0)],
                      dict(EC=1, EA=0, ED=0), 1.0),
    "split_ns": ([_split()[0]], [_split()[1]], [CellTrack(1, 0, 0, 0), CellTrack(2, 0, 0, 0)],
                 [CellTrack(9, 0, 0, 0)], dict(NS=1, FP=0, FN=0), 5.0),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_synthetic_cases(case, backend):
    gt, res, want = SEG_CASES[case]
    r = ctc.seg_measure_arrays(gt, res, backend=backend)
    assert r.value == pytest.approx(want) and r.n_objects == 1
    assert r.value == jax_ctc.seg_measure_arrays(gt, res, backend=backend).value


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(TRA_CASES))
def test_tra_synthetic_cases(case, backend):
    gt, res, gt_tracks, res_tracks, counts, aogm = TRA_CASES[case]
    r = ctc.tra_det_arrays(gt, res, gt_tracks, res_tracks, backend=backend)
    assert {k: r.counts[k] for k in counts} == counts and r.aogm == aogm
    j = jax_ctc.tra_det_arrays(gt, res, gt_tracks, res_tracks, backend=backend)
    assert (r.tra, r.det, r.aogm0) == (j.tra, j.det, j.aogm0)


def test_empty_and_unknown_backend():
    assert ctc.seg_measure_arrays([], []).value == 0.0
    with pytest.raises(ValueError, match="frame counts"):
        ctc.seg_measure_arrays([_square(1, 0, 0)], [])
    with pytest.raises(ValueError, match="backend"):
        ctc.seg_measure_arrays([_square(1, 0, 0)], [_square(1, 0, 0)], backend="official")


# ---- the reference's golden values, where its evaluation data is mounted
@requires_reference_data
@pytest.mark.parametrize("backend", BACKENDS)
def test_seg_golden_seq01(backend):
    r = ctc.seg_measure(os.path.join(TD, "01_GT", "SEG"), os.path.join(TD, "01_RES"),
                        backend=backend)
    assert abs(r.value - 0.232874) < 5e-7, r.value


@requires_reference_data
@pytest.mark.parametrize("backend", BACKENDS)
def test_tra_det_golden_seq03(backend):
    r = ctc.tra_measure(os.path.join(TD, "03_GT", "TRA"), os.path.join(TD, "03_RES"),
                        backend=backend)
    assert abs(r.tra - 0.622980) < 5e-7 and abs(r.det - 0.688000) < 5e-7
    assert abs(r.det_without_fp_penalty - 0.700000) < 5e-7
    assert {k: r.counts[k] for k in ("NS", "FN", "FP", "ED", "EA", "EC", "V_gt", "E_gt")} == \
        dict(NS=5, FN=5, FP=3, ED=1, EA=16, EC=2, V_gt=25, E_gt=19)
    assert (r.aogm, r.aogm0) == (105.0, 278.5)


# ---- the native build
def test_native_builds_into_the_port():
    so = ctc.build_native()
    assert so.parent == ctc._PKG / "build" / "native" and so.name.startswith("libctc_measures-")
    assert ctc.native_available()


@pytest.mark.parametrize("fault", ["bad_source", "missing_compiler"])
def test_native_build_failure_raises(monkeypatch, tmp_path, fault):
    """A failed build raises under backend="native"; nothing falls back to
    the python backend."""
    if fault == "bad_source":
        bad = tmp_path / "ctc_measures.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(ctc, "_SRC", bad)
        err, match = RuntimeError, "g\\+\\+ failed"
    else:
        monkeypatch.setattr(ctc, "_CXX", "no-such-compiler-unetseg")
        monkeypatch.setattr(ctc, "_CXX_FLAGS", ("-O1",))  # a new key, so a new build
        err, match = FileNotFoundError, "no-such-compiler"
    monkeypatch.setattr(ctc, "_BUILD", tmp_path / "build")
    ctc._load.cache_clear()
    try:
        with pytest.raises(err, match=match):
            ctc.seg_measure_arrays([_square(1, 4, 4)], [_square(1, 4, 4)])
        with pytest.raises(err, match=match):
            ctc.tra_det_arrays([_square(1, 4, 4)], [_square(1, 4, 4)], [CellTrack(1, 0, 0, 0)],
                               [CellTrack(1, 0, 0, 0)])
        assert not ctc.native_available()
        assert ctc.seg_measure_arrays([_square(1, 4, 4)], [_square(1, 4, 4)],
                                      backend="python").value == 1.0
        assert not any(p.suffix == ".so" for p in (tmp_path / "build").glob("*"))
    finally:
        ctc._load.cache_clear()


# ---- divisions
def _stage_divisions(tmp_path):
    """GT: track 1 divides into 2 and 3; RES: track 5 divides over it into
    6 and 7, and track 8 fake-divides elsewhere (tests/test_divisions.py)."""
    gt, res = tmp_path / "GT_TRA", tmp_path / "RES"
    gt.mkdir()
    res.mkdir()
    (gt / "man_track.txt").write_text("1 0 1 0\n2 2 3 1\n3 2 3 1\n9 0 3 0\n")
    (res / "res_track.txt").write_text(
        "5 0 1 0\n6 2 3 5\n7 2 3 5\n8 0 1 0\n10 2 3 8\n11 2 3 8\n")
    for t in range(4):
        g = np.zeros((32, 32), np.uint16)
        r = np.zeros((32, 32), np.uint16)
        if t <= 1:
            g[8:12, 8:12] = 1
            r[6:14, 6:14] = 5
            r[24:28, 2:6] = 8
        else:
            g[4:8, 4:8], g[12:16, 12:16] = 2, 3
            r[4:8, 4:8], r[12:16, 12:16] = 6, 7
        g[20:24, 20:24] = 9
        write_mask_u16(str(gt / f"man_track{t:03d}.tif"), g)
        write_mask_u16(str(res / f"mask{t:03d}.tif"), r)
    return str(gt), str(res)


@pytest.mark.parametrize("kw", [{}, dict(frame_tolerance=0, marker_containment=0.99),
                                dict(marker_containment=1.0)])
def test_division_report_equals_jax(tmp_path, kw):
    gt, res = _stage_divisions(tmp_path)
    r, j = divisions.division_report(gt, res, **kw), jax_divisions.division_report(gt, res, **kw)
    assert (r.n_gt, r.n_res, r.matched, r.details, r.recall, r.precision) == \
        (j.n_gt, j.n_res, j.matched, j.details, j.recall, j.precision)
    assert r.n_gt == 1 and r.n_res == 2
    rows = divisions.read_track_file(os.path.join(res, "res_track.txt"))
    assert divisions.divisions_of(rows) == jax_divisions.divisions_of(rows) == \
        {5: [6, 7], 8: [10, 11]}



def test_scoring_modules_import_no_jax_nor_pil():
    """track/, metrics/ and data/rescue.py import neither the JAX package
    nor Pillow (Pillow only inside the functions that read files)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import unetseg_tpu_torch.track, unetseg_tpu_torch.track.postprocess\n"
        "import unetseg_tpu_torch.metrics, unetseg_tpu_torch.metrics.divisions\n"
        "import unetseg_tpu_torch.data.rescue\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'unetseg_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
