"""File IO and the Cell Tracking Challenge naming conventions (a copy of
the parts of unetseg_tpu/data/io.py that preprocessing, training and
prediction use).

Raw frames are `t{NNN}.tif`, silver-truth instance masks
`{seq}_ST/SEG/man_seg{NNN}.tif`, weight maps
`{seq}_ST/WEIGHT_MAPS/weight_map_{NNN}.npy` (reference:
utils/dataset.py:30-56), prediction outputs `{seq}_RES/mask{NNN}.tif`
(0/255 uint8) and `{seq}_RES_INST/m{NNN}.tif` (uint16 instance labels)
(reference: scripts/predict.py:104-112). PIL is imported by the functions
that read or write files, so that the port imports where Pillow is not
installed.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Read TIFF/PNG as numpy, preserving uint16 where present."""
    from PIL import Image

    img = Image.open(path)
    if grayscale and img.mode not in ("I;16", "I", "F"):
        img = img.convert("L")
    return np.array(img)


def write_mask_u8(path: str, mask: np.ndarray) -> None:
    """Binary mask as 0/255 uint8 TIFF/PNG (reference: scripts/predict.py:92,106)."""
    from PIL import Image

    arr = ((np.asarray(mask) > 0) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def write_mask_u16(path: str, mask: np.ndarray) -> None:
    """Instance mask as uint16 TIFF — the CTC-required format
    (reference: scripts/predict.py:98,112)."""
    from PIL import Image

    arr = np.asarray(mask).astype(np.uint16)
    Image.fromarray(arr).save(path)


def frame_number(path: str) -> int:
    """Frame index from CTC file names (t012.tif, mask012.tif, m012.tif,
    man_seg012.tif, man_track012.tif)."""
    m = re.search(r"(\d+)\.(tif|tiff|png)$", os.path.basename(path), re.IGNORECASE)
    if not m:
        raise ValueError(f"no frame number in {path}")
    return int(m.group(1))


def sorted_frames(directory: str, pattern: str) -> List[str]:
    return sorted(glob.glob(os.path.join(directory, pattern)))


@dataclass(frozen=True)
class SequencePaths:
    """Resolved paths for one CTC sequence under a data root
    (reference: utils/dataset.py:30-32, scripts/predict.py:136-141)."""

    data_root: str
    sequence: str

    @property
    def images_dir(self) -> str:
        return os.path.join(self.data_root, self.sequence)

    @property
    def masks_dir(self) -> str:
        return os.path.join(self.data_root, self.sequence + "_ST", "SEG")

    @property
    def weight_maps_dir(self) -> str:
        return os.path.join(self.data_root, self.sequence + "_ST", "WEIGHT_MAPS")

    def image_files(self) -> List[str]:
        return sorted_frames(self.images_dir, "t*.tif")

    def mask_path(self, num: str) -> str:
        return os.path.join(self.masks_dir, f"man_seg{num}.tif")

    def weight_map_path(self, num: str) -> str:
        return os.path.join(self.weight_maps_dir, f"weight_map_{num}.npy")


def prediction_dirs(data_root: str, sequence: str) -> Tuple[str, str]:
    """(binary_masks_dir, instance_masks_dir) mirroring the reference's output
    layout `processed/predictions/DIC-C2DH-HeLa/{seq}_RES{,_INST}`
    (reference: scripts/predict.py:136-141)."""
    base = os.path.join(
        os.path.dirname(os.path.dirname(data_root)),
        "processed", "predictions", os.path.basename(data_root),
    )
    return (
        os.path.join(base, f"{sequence}_RES"),
        os.path.join(base, f"{sequence}_RES_INST"),
    )


def file_number_str(image_path: str) -> str:
    """The zero-padded number string the reference slices out of t{NNN}.tif
    (reference: utils/dataset.py:49 — base_name[1:-4])."""
    return os.path.basename(image_path)[1:-4]


@dataclass(frozen=True)
class Triplet:
    image: str
    mask: str
    weight_map: Optional[str]


def index_sequence(paths: SequencePaths, require_weight_maps: bool = True) -> List[Triplet]:
    """Pair each frame with its mask and weight map, skipping incomplete
    triplets like the reference (utils/dataset.py:46-58)."""
    if not os.path.isdir(paths.images_dir):
        raise FileNotFoundError(f"image directory not found: {paths.images_dir}")
    if not os.path.isdir(paths.masks_dir):
        raise FileNotFoundError(f"mask directory not found: {paths.masks_dir}")
    triplets: List[Triplet] = []
    for img in paths.image_files():
        num = file_number_str(img)
        mask = paths.mask_path(num)
        wmap = paths.weight_map_path(num)
        if not os.path.exists(mask):
            continue
        if require_weight_maps and not os.path.exists(wmap):
            continue
        triplets.append(Triplet(img, mask, wmap if os.path.exists(wmap) else None))
    return triplets
