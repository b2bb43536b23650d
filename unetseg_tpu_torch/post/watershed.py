"""Watershed instance splitting (a copy of unetseg_tpu/post/watershed.py,
with its own build of the native flood).

Plain connected components merge touching cells (the measured NS=453
splitting errors on seq 01); this splits each foreground component at the
ridges of its distance transform: distance-peak markers per component, then
marker-based watershed on the negated distance (native C++ priority-flood,
or a pure-Python heapq flood when asked for). The reference has no
equivalent — its post-processing is CC + small-object removal only
(utils/metrics.py:42).

The native flood is `unetseg_tpu_torch/native/watershed.cpp`, compiled with
g++ at first use into `unetseg_tpu_torch/build/native/`, keyed by a hash of
the source and the flags. Where the JAX package falls back to the Python
flood when the build or the load fails, `backend="native"` here raises:
the Python flood is orders of magnitude slower, and a caller chooses it
with `backend="python"`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import heapq
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np
from scipy import ndimage as ndi

from unetseg_tpu_torch.post.cc import _STRUCT8, label_components, relabel_sequential, remove_small

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "watershed.cpp"
_BUILD = _PKG / "build" / "native"
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The native flood, built on first use; a build or load failure raises."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libwatershed-{digest}.so"
    if not so.is_file():
        _BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=_BUILD, suffix=".so")
        os.close(fd)
        try:
            res = subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, str(_SRC)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed ({res.returncode}) on {_SRC}:\n{res.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(so))
    lib.watershed.restype = ctypes.c_int
    lib.watershed.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ]
    return lib


def watershed(
    elevation: np.ndarray,
    markers: np.ndarray,
    mask: np.ndarray,
    connectivity: int = 8,
    backend: str = "native",
) -> np.ndarray:
    """Flood `markers` over `mask` ascending `elevation`; returns uint16
    labels. Ties resolve FIFO (stable fronts). `backend` is "native" or
    "python"."""
    elevation = np.ascontiguousarray(elevation, np.float32)
    mask8 = np.ascontiguousarray((np.asarray(mask) > 0), np.uint8)
    labels = np.ascontiguousarray(np.asarray(markers), np.uint16).copy()
    h, w = elevation.shape
    if backend == "python":
        return _watershed_py(elevation, mask8, labels, connectivity)
    if backend != "native":
        raise ValueError(f"watershed backend {backend!r}; expected 'native' or 'python'")
    rc = _load().watershed(
        elevation.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h, w, connectivity,
    )
    if rc != 0:
        raise RuntimeError(f"native watershed returned {rc}")
    return labels


def _watershed_py(elevation, mask8, labels, connectivity) -> np.ndarray:
    h, w = elevation.shape
    if connectivity == 8:
        nbrs = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)]
    else:
        nbrs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    heap = []
    order = 0
    ys, xs = np.nonzero((labels > 0) & (mask8 > 0))
    for y, x in zip(ys.tolist(), xs.tolist()):
        heapq.heappush(heap, (float(elevation[y, x]), order, y, x))
        order += 1
    queued = (labels > 0) & (mask8 > 0)
    while heap:
        elev, _, y, x = heapq.heappop(heap)
        lab = labels[y, x]
        for dy, dx in nbrs:
            ny, nx = y + dy, x + dx
            if not (0 <= ny < h and 0 <= nx < w):
                continue
            if not mask8[ny, nx] or labels[ny, nx] or queued[ny, nx]:
                continue
            labels[ny, nx] = lab
            queued[ny, nx] = True
            heapq.heappush(
                heap, (max(elev, float(elevation[ny, nx])), order, ny, nx)
            )
            order += 1
    return labels


def distance_markers(
    binary_mask: np.ndarray,
    marker_frac: float = 0.6,
    smooth_sigma: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(markers, distance): per-component distance peaks.

    For each 8-connected foreground component, markers are the connected
    regions where the (smoothed) distance transform exceeds `marker_frac` of
    that component's maximum — one marker for a round cell, several for a
    merged blob."""
    binary = np.asarray(binary_mask) > 0
    dist = ndi.distance_transform_edt(binary).astype(np.float32)
    if smooth_sigma > 0:
        dist_s = ndi.gaussian_filter(dist, smooth_sigma)
    else:
        dist_s = dist
    comp, n = label_components(binary)
    markers = np.zeros(binary.shape, np.uint16)
    if n == 0:
        return markers, dist
    maxima = ndi.maximum(dist_s, labels=comp, index=np.arange(1, n + 1))
    thresh_map = np.zeros(n + 1, np.float32)
    thresh_map[1:] = np.asarray(maxima) * marker_frac
    seed_region = (dist_s >= thresh_map[comp]) & binary
    markers, _ = ndi.label(seed_region, structure=_STRUCT8)
    return markers.astype(np.uint16), dist


def merge_shallow_ridges(
    labels: np.ndarray, dist: np.ndarray, merge_frac: float = 0.7
) -> np.ndarray:
    """Merge watershed regions separated by a *shallow* ridge.

    For each pair of 4-adjacent regions, the saddle height is the level at
    which the two regions would first connect — the maximum over their
    shared boundary of min(dist on either side); two regions are the same
    cell — and get merged — when ``saddle >= merge_frac * min(peak_i,
    peak_j)``: a genuine cell-cell contact is a thin neck (saddle near 0),
    while a bumpy single cell has a saddle almost as high as its peaks.
    This is a prominence (h-maxima-like) criterion evaluated on the final
    watershed partition, and it directly attacks the NS (split) errors of
    the CTC TRA measure without touching genuine separations."""
    labels = np.asarray(labels)
    if labels.max() < 2:
        return labels
    dist = np.asarray(dist, np.float32)
    n = int(labels.max())
    peaks = ndi.maximum(dist, labels=labels, index=np.arange(1, n + 1))
    peaks = np.concatenate([[0.0], np.asarray(peaks, np.float32)])
    # saddle[i, j] = max dist on the boundary between regions i and j,
    # collected from horizontally/vertically adjacent pixel pairs
    keys, vals = [], []
    for a, b, d_ab in (
        (labels[:, :-1], labels[:, 1:], np.minimum(dist[:, :-1], dist[:, 1:])),
        (labels[:-1, :], labels[1:, :], np.minimum(dist[:-1, :], dist[1:, :])),
    ):
        sel = (a != b) & (a > 0) & (b > 0)
        la, lb, dv = a[sel], b[sel], d_ab[sel]
        lo, hi = np.minimum(la, lb), np.maximum(la, lb)
        keys.append(lo.astype(np.int64) * (n + 1) + hi)
        vals.append(dv)
    key = np.concatenate(keys)
    val = np.concatenate(vals)
    uniq, inv = np.unique(key, return_inverse=True)
    sad = np.zeros(len(uniq), np.float32)
    np.maximum.at(sad, inv, val)
    saddles = dict(zip(uniq.tolist(), sad.tolist()))
    parent = np.arange(n + 1)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for k, saddle in saddles.items():
        i, j = int(k // (n + 1)), int(k % (n + 1))
        if saddle >= merge_frac * min(peaks[i], peaks[j]):
            parent[find(i)] = find(j)
    root = np.array([find(x) for x in range(n + 1)])
    return root[labels]


def get_instance_masks_watershed(
    binary_mask: np.ndarray,
    min_size: int = 15,
    marker_frac: float = 0.6,
    smooth_sigma: float = 2.0,
    merge_saddle_frac: float = 0.0,
    backend: str = "native",
) -> np.ndarray:
    """Drop-in alternative to post.cc.get_instance_masks that splits merged
    cells: distance-peak markers + watershed on -distance, optionally
    followed by shallow-ridge re-merging (merge_saddle_frac > 0, see
    merge_shallow_ridges)."""
    binary = np.asarray(binary_mask) > 0
    markers, dist = distance_markers(binary, marker_frac, smooth_sigma)
    labels = watershed(-dist, markers, binary, backend=backend)
    if merge_saddle_frac > 0:
        labels = merge_shallow_ridges(labels, dist, merge_saddle_frac)
    labels = remove_small(labels.astype(np.int64), min_size)
    return relabel_sequential(labels).astype(np.uint16)


def expand_markers(
    binary_mask: np.ndarray,
    interior: np.ndarray,
    min_size: int = 15,
    backend: str = "native",
) -> np.ndarray:
    """Instances from a 3-class prediction: connected interior regions are
    the markers, expanded over the full foreground by watershed on the
    negated distance transform (see train/steps.three_class_targets)."""
    fg = np.asarray(binary_mask) > 0
    markers, _ = label_components(np.asarray(interior) > 0)
    markers = np.where(fg, markers, 0)
    dist = ndi.distance_transform_edt(fg).astype(np.float32)
    labels = watershed(-dist, markers, fg, backend=backend)
    labels = remove_small(labels.astype(np.int64), min_size)
    return relabel_sequential(labels).astype(np.uint16)
