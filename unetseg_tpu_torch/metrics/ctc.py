"""CTC SEG / TRA / DET measures (a copy of unetseg_tpu/metrics/ctc.py, with
its own build of the native library): ctypes binding to the native C++
library plus a pure-numpy implementation of the identical algorithm.

The reference only ships the official binaries for macOS/Windows
(reference: EvaluationSoftware/, SURVEY.md §2 C15); this module is the Linux
implementation, validated against the golden values and the complete op-count
log in EvaluationSoftware/testing_dataset (see native/ctc_measures.cpp for
the measure definitions).

The native library is `unetseg_tpu_torch/native/ctc_measures.cpp`, compiled
with g++ at first use into `unetseg_tpu_torch/build/native/`, keyed by a
hash of the source and the flags. A build or load failure raises under
`backend="native"`; the numpy implementation runs only when a caller asks
for it with `backend="python"`.

Directory layout handled (the official CLI's `<dir> <seq> <num_digits>`
convention): SEG compares `{seq}_GT/SEG/man_seg{T}.tif` against the result
frame with the same number; TRA/DET compare `{seq}_GT/TRA/man_track{T}.tif`
+ `man_track.txt` against result label images + `res_track.txt`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from unetseg_tpu_torch.data.io import frame_number, read_image, sorted_frames
from unetseg_tpu_torch.track.ctc_io import read_track_file

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "ctc_measures.cpp"
_BUILD = _PKG / "build" / "native"
_CXX, _CXX_FLAGS = "g++", ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
BACKENDS = ("native", "python")


# ----------------------------------------------------------------- native lib
def build_native() -> Path:
    """Compile the shared library unless this source and these flags are
    built already; returns its path. A failed build raises."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libctc_measures-{digest}.so"
    if not so.is_file():
        _BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=_BUILD, suffix=".so")
        os.close(fd)
        try:
            res = subprocess.run([_CXX, *_CXX_FLAGS, "-o", tmp, str(_SRC)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{_CXX} failed ({res.returncode}) on {_SRC}:\n{res.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The native measures, built on first use; a build or load failure raises."""
    lib = ctypes.CDLL(str(build_native()))
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ctc_seg.restype = ctypes.c_double
    lib.ctc_seg.argtypes = [
        u16p, u16p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, dp, i64p,
    ]
    lib.ctc_tra.restype = ctypes.c_int
    lib.ctc_tra.argtypes = [
        u16p, u16p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        i64p, ctypes.c_int, i64p, ctypes.c_int, dp,
    ]
    return lib


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"CTC measure backend {backend!r}; expected one of {list(BACKENDS)}")


def _as_u16_stack(frames: Sequence[np.ndarray]) -> np.ndarray:
    arrs = [np.ascontiguousarray(np.asarray(f), dtype=np.uint16) for f in frames]
    return np.ascontiguousarray(np.stack(arrs))


def _tracks_to_rows(tracks) -> np.ndarray:
    rows = np.zeros((len(tracks), 4), np.int64)
    for i, t in enumerate(tracks):
        rows[i] = (t.label, t.start_frame, max(t.start_frame, t.end_frame), t.parent_label)
    return np.ascontiguousarray(rows)


# -------------------------------------------------------------------- results
@dataclass
class SegResult:
    value: float
    per_object: np.ndarray

    @property
    def n_objects(self) -> int:
        return len(self.per_object)


@dataclass
class TraResult:
    tra: float
    det: float
    det_without_fp_penalty: float
    aogm: float
    aogm0: float
    counts: Dict[str, float] = field(default_factory=dict)


# ---------------------------------------------------------------- array APIs
def seg_measure_arrays(
    gt_frames: Sequence[np.ndarray],
    res_frames: Sequence[np.ndarray],
    backend: str = "native",
) -> SegResult:
    if len(gt_frames) != len(res_frames):
        raise ValueError("gt/res frame counts differ")
    _check_backend(backend)
    if not gt_frames:
        return SegResult(0.0, np.zeros((0,)))
    if backend == "python":
        return _seg_py(gt_frames, res_frames)
    lib = _load()
    gt = _as_u16_stack(gt_frames)
    res = _as_u16_stack(res_frames)
    if gt.shape != res.shape:
        raise ValueError(f"shape mismatch {gt.shape} vs {res.shape}")
    nf, h, w = gt.shape
    n_obj = ctypes.c_int64(0)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    # first call sizes the per-object buffer
    lib.ctc_seg(
        gt.ctypes.data_as(u16p), res.ctypes.data_as(u16p), nf, h, w, None,
        ctypes.byref(n_obj),
    )
    per = np.zeros((n_obj.value,), np.float64)
    val = lib.ctc_seg(
        gt.ctypes.data_as(u16p), res.ctypes.data_as(u16p), nf, h, w,
        per.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.byref(n_obj),
    )
    return SegResult(float(val), per)


def tra_det_arrays(
    gt_frames: Sequence[np.ndarray],
    res_frames: Sequence[np.ndarray],
    gt_tracks,
    res_tracks,
    backend: str = "native",
) -> TraResult:
    _check_backend(backend)
    if backend == "python":
        return _tra_py(gt_frames, res_frames, gt_tracks, res_tracks)
    lib = _load()
    gt = _as_u16_stack(gt_frames)
    res = _as_u16_stack(res_frames)
    if gt.shape != res.shape:
        raise ValueError(f"shape mismatch {gt.shape} vs {res.shape}")
    nf, h, w = gt.shape
    gt_rows = _tracks_to_rows(gt_tracks)
    res_rows = _tracks_to_rows(res_tracks)
    out = np.zeros((14,), np.float64)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.ctc_tra(
        gt.ctypes.data_as(u16p), res.ctypes.data_as(u16p), nf, h, w,
        gt_rows.ctypes.data_as(i64p), len(gt_rows),
        res_rows.ctypes.data_as(i64p), len(res_rows),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise RuntimeError(f"ctc_tra failed with {rc}")
    return TraResult(
        tra=float(out[0]),
        det=float(out[1]),
        det_without_fp_penalty=float(out[2]),
        aogm=float(out[3]),
        aogm0=float(out[4]),
        counts={
            "NS": out[5], "FN": out[6], "FP": out[7],
            "ED": out[8], "EA": out[9], "EC": out[10],
            "V_gt": out[11], "E_gt": out[12], "AOGM_D": out[13],
        },
    )


# ------------------------------------------------------------ directory APIs
def _pair_by_number(gt_files: List[str], res_dir: str) -> List[Tuple[str, str]]:
    """Pair GT frames with result frames sharing the frame number; result
    files may be mask{T}.tif (CTC convention) or m{T}.tif (the reference's
    instance-mask naming, scripts/predict.py:110)."""
    res_by_num: Dict[int, str] = {}
    for pat in ("mask*.tif", "m*.tif", "mask*.png"):
        for f in sorted_frames(res_dir, pat):
            res_by_num.setdefault(frame_number(f), f)
    pairs = []
    for g in gt_files:
        num = frame_number(g)
        if num not in res_by_num:
            raise FileNotFoundError(f"no result frame for GT frame {num} in {res_dir}")
        pairs.append((g, res_by_num[num]))
    return pairs


def seg_measure(gt_seg_dir: str, res_dir: str, backend: str = "native") -> SegResult:
    """SEG for a sequence. Handles both GT conventions:

    - 2D: man_seg{T}.tif vs result frame T;
    - 3D sparse-slice: man_seg_{T}_{Z}.tif vs slice Z of the (multi-page)
      result frame T (the official tool's convention for 3D datasets, as in
      the reference's testing_dataset/02_GT).
    """
    import re

    gt_files = sorted_frames(gt_seg_dir, "man_seg*.tif")
    if not gt_files:
        raise FileNotFoundError(f"no man_seg*.tif under {gt_seg_dir}")

    slice_re = re.compile(r"man_seg_(\d+)_(\d+)\.tif$")
    slice_files = [
        (f, slice_re.search(os.path.basename(f))) for f in gt_files
    ]
    if all(m is not None for _, m in slice_files):
        # 3D sparse-slice convention
        from PIL import Image

        res_by_num: Dict[int, str] = {}
        for pat in ("mask*.tif", "m*.tif"):
            for f in sorted_frames(res_dir, pat):
                res_by_num.setdefault(frame_number(f), f)
        gt_frames, res_frames = [], []
        for f, m in slice_files:
            t, z = int(m.group(1)), int(m.group(2))
            if t not in res_by_num:
                raise FileNotFoundError(f"no result frame {t} in {res_dir}")
            img = Image.open(res_by_num[t])
            img.seek(z)
            gt_frames.append(read_image(f))
            res_frames.append(np.array(img))
        return seg_measure_arrays(gt_frames, res_frames, backend=backend)

    pairs = _pair_by_number(gt_files, res_dir)
    gt_frames = [read_image(g) for g, _ in pairs]
    res_frames = [read_image(r) for _, r in pairs]
    return seg_measure_arrays(gt_frames, res_frames, backend=backend)


def tra_measure(
    gt_tra_dir: str,
    res_dir: str,
    res_track_path: Optional[str] = None,
    backend: str = "native",
) -> TraResult:
    gt_files = sorted_frames(gt_tra_dir, "man_track*.tif")
    if not gt_files:
        raise FileNotFoundError(f"no man_track*.tif under {gt_tra_dir}")
    pairs = _pair_by_number(gt_files, res_dir)
    gt_frames = [read_image(g) for g, _ in pairs]
    res_frames = [read_image(r) for _, r in pairs]
    gt_tracks = read_track_file(os.path.join(gt_tra_dir, "man_track.txt"))
    res_track_path = res_track_path or os.path.join(res_dir, "res_track.txt")
    res_tracks = read_track_file(res_track_path)
    # frame indices are positions in the paired list (CTC frames are dense)
    return tra_det_arrays(gt_frames, res_frames, gt_tracks, res_tracks, backend=backend)


# ------------------------------------------------------ python implementation
def _frame_overlap(g: np.ndarray, r: np.ndarray):
    g = np.asarray(g).astype(np.int64).ravel()
    r = np.asarray(r).astype(np.int64).ravel()
    gmax, rmax = int(g.max(initial=0)), int(r.max(initial=0))
    joint = np.zeros((gmax + 1, rmax + 1), np.int64)
    np.add.at(joint, (g, r), 1)
    return joint


def _majority_match_py(joint: np.ndarray) -> Dict[int, int]:
    gt_sizes = joint.sum(axis=1)
    match = {}
    for gl in range(1, joint.shape[0]):
        if gt_sizes[gl] == 0:
            continue
        best = np.argmax(joint[gl, 1:]) + 1 if joint.shape[1] > 1 else 0
        if best and 2 * joint[gl, best] > gt_sizes[gl]:
            match[gl] = int(best)
    return match


def _seg_py(gt_frames, res_frames) -> SegResult:
    per = []
    for g, r in zip(gt_frames, res_frames):
        joint = _frame_overlap(g, r)
        gt_sizes = joint.sum(axis=1)
        res_sizes = joint.sum(axis=0)
        match = _majority_match_py(joint)
        for gl in range(1, joint.shape[0]):
            if gt_sizes[gl] == 0:
                continue
            if gl in match:
                rl = match[gl]
                inter = joint[gl, rl]
                union = gt_sizes[gl] + res_sizes[rl] - inter
                per.append(inter / union)
            else:
                per.append(0.0)
    per = np.asarray(per, np.float64)
    return SegResult(float(per.mean()) if len(per) else 0.0, per)


def _build_graph_py(tracks, present: List[set]):
    vertices: set = set()
    edges: Dict[Tuple[Tuple[int, int], Tuple[int, int]], int] = {}
    appearances: Dict[int, List[int]] = {}
    nf = len(present)
    for t in tracks:
        app = [
            f for f in range(max(0, t.start_frame), min(nf - 1, max(t.start_frame, t.end_frame)) + 1)
            if t.label in present[f]
        ]
        appearances[t.label] = app
        for f in app:
            vertices.add((f, t.label))
        for a, b in zip(app, app[1:]):
            edges[((a, t.label), (b, t.label))] = 0
    for t in tracks:
        if t.parent_label > 0:
            pa = appearances.get(t.parent_label, [])
            ca = appearances.get(t.label, [])
            if pa and ca and pa[-1] < ca[0]:
                edges[((pa[-1], t.parent_label), (ca[0], t.label))] = 1
    return vertices, edges


def _tra_py(gt_frames, res_frames, gt_tracks, res_tracks) -> TraResult:
    nf = len(gt_frames)
    gt_present: List[set] = []
    res_present: List[set] = []
    res_matches: Dict[Tuple[int, int], List[int]] = {}
    NS = FN = FP = 0.0
    for f in range(nf):
        joint = _frame_overlap(gt_frames[f], res_frames[f])
        gt_sizes = joint.sum(axis=1)
        res_sizes = joint.sum(axis=0)
        gt_present.append({l for l in range(1, joint.shape[0]) if gt_sizes[l] > 0})
        res_present.append({l for l in range(1, joint.shape[1]) if res_sizes[l] > 0})
        match = _majority_match_py(joint)
        k: Dict[int, int] = {}
        for gl, rl in match.items():
            k[rl] = k.get(rl, 0) + 1
            res_matches.setdefault((f, rl), []).append(gl)
        FN += len(gt_present[-1]) - len(match)
        for rl in res_present[-1]:
            if rl not in k:
                FP += 1
            elif k[rl] > 1:
                NS += k[rl] - 1
    gt_vertices, gt_edges = _build_graph_py(gt_tracks, gt_present)
    res_vertices, res_edges = _build_graph_py(res_tracks, res_present)

    # ED only between detected endpoints (FP vertex deletion removes its
    # incident edges for free) — see native/ctc_measures.cpp.
    ED = EC = 0.0
    covered = set()
    for (u, v), etype in res_edges.items():
        mu = res_matches.get(u, [])
        mv = res_matches.get(v, [])
        if not mu or not mv:
            continue  # FP endpoint: edge vanishes with the vertex
        if len(mu) != 1 or len(mv) != 1:
            continue  # split endpoint: resolved by the splitting op
        gu, gv = (u[0], mu[0]), (v[0], mv[0])
        if (gu, gv) in gt_edges:
            covered.add((gu, gv))
            if gt_edges[(gu, gv)] != etype:
                EC += 1
        else:
            ED += 1
    EA = len(gt_edges) - len(covered)

    aogm = 10 * FN + 5 * NS + FP + ED + 1.5 * EA + EC
    aogm0 = 10 * len(gt_vertices) + 1.5 * len(gt_edges)
    aogmd = 10 * FN + 5 * NS + FP
    aogmd0 = 10 * len(gt_vertices)
    return TraResult(
        tra=1 - min(aogm, aogm0) / aogm0 if aogm0 else 0.0,
        det=1 - min(aogmd, aogmd0) / aogmd0 if aogmd0 else 0.0,
        det_without_fp_penalty=(
            1 - min(10 * FN + 5 * NS, aogmd0) / aogmd0 if aogmd0 else 0.0
        ),
        aogm=aogm,
        aogm0=aogm0,
        counts={
            "NS": NS, "FN": FN, "FP": FP, "ED": ED, "EA": EA, "EC": EC,
            "V_gt": float(len(gt_vertices)), "E_gt": float(len(gt_edges)),
            "AOGM_D": aogmd,
        },
    )
