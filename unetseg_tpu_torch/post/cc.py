"""Connected-component instance extraction (a copy of
unetseg_tpu/post/cc.py).

Behavioral equivalent of the reference's get_instance_masks
(reference: utils/metrics.py:42-72): 8-connectivity labeling of the binary
mask, removal of components smaller than `min_size` *without relabeling*
(surviving labels keep their ids, leaving gaps — skimage remove_small_objects
semantics), output uint16 as CTC requires. Labeling itself is inherently
sequential union-find; it stays on the host (scipy's C implementation) while
everything around it is vectorized. An optional `relabel` compacts ids.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage as ndi

# 8-connectivity structure == skimage connectivity=2 for 2D
_STRUCT8 = np.ones((3, 3), dtype=np.int32)


def label_components(binary_mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connected component labeling, labels 1..n in raster order."""
    labeled, n = ndi.label(np.asarray(binary_mask) > 0, structure=_STRUCT8)
    return labeled, int(n)


def remove_small(labeled: np.ndarray, min_size: int) -> np.ndarray:
    """Zero out components with < min_size pixels; ids are preserved (gaps
    allowed), matching skimage.morphology.remove_small_objects as used by the
    reference (utils/metrics.py:69)."""
    if labeled.max() == 0 or min_size <= 1:
        return labeled
    counts = np.bincount(labeled.ravel())
    kill = counts < min_size
    kill[0] = False
    return np.where(kill[labeled], 0, labeled)


def relabel_sequential(labeled: np.ndarray) -> np.ndarray:
    """Compact label ids to 1..k preserving order of first appearance by id."""
    ids = np.unique(labeled)
    ids = ids[ids != 0]
    lut = np.zeros(int(labeled.max()) + 1, dtype=labeled.dtype)
    lut[ids] = np.arange(1, len(ids) + 1, dtype=labeled.dtype)
    return lut[labeled]


def get_instance_masks(
    binary_mask: np.ndarray,
    min_size: int = 15,
    relabel: bool = False,
) -> np.ndarray:
    """binary (0/1 or 0/255) -> uint16 instance labels
    (reference: utils/metrics.py:42-72; min_size 15 from scripts/predict.py:47)."""
    labeled, _ = label_components(binary_mask)
    labeled = remove_small(labeled, min_size)
    if relabel:
        labeled = relabel_sequential(labeled)
    return labeled.astype(np.uint16)
