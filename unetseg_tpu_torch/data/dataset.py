"""In-memory dataset and deterministic batching (a copy of
unetseg_tpu/data/dataset.py).

The whole training set is loaded into dense arrays once; the train loop
puts it on the device and gathers batches by index. The last partial
batch is padded to the static batch size and carries a `valid` mask; the
loss divides by the number of valid pixels, which reproduces the
reference's plain mean over real items. PIL is imported by the function
that reads images, so that the port imports where Pillow is not
installed (datasets built in memory need none).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from unetseg_tpu_torch.core.config import DataConfig
from unetseg_tpu_torch.data.io import SequencePaths, Triplet, index_sequence, read_image


@dataclass(frozen=True)
class Batch:
    """One host-side batch; arrays are padded to the static batch size."""

    images: np.ndarray        # (B, H, W) float32 in [0, 1]
    masks: np.ndarray         # (B, H, W) int32 instance labels (not binarized)
    weight_maps: np.ndarray   # (B, H, W) float32
    valid: np.ndarray         # (B,) bool — False for padding items


def _load_image_01(path: str, image_size: Optional[int]) -> np.ndarray:
    """Grayscale image scaled to [0,1] like torchvision ToTensor on an 'L'
    PIL image (reference: utils/dataset.py:73,96)."""
    from PIL import Image

    img = Image.open(path).convert("L")
    if image_size is not None and img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


@dataclass
class HeLaArrays:
    """All triplets materialised as dense arrays."""

    images: np.ndarray       # (N, H, W) float32 [0,1]
    masks: np.ndarray        # (N, H, W) int32 instance labels
    weight_maps: np.ndarray  # (N, H, W) float32
    files: List[Triplet]

    def __len__(self) -> int:
        return self.images.shape[0]

    @classmethod
    def load(
        cls, cfg: DataConfig, require_weight_maps: bool = True,
        image_size: Optional[int] = None,
    ) -> "HeLaArrays":
        paths = SequencePaths(cfg.data_root, cfg.sequence)
        triplets = index_sequence(paths, require_weight_maps=require_weight_maps)
        if not triplets:
            raise RuntimeError(
                f"no valid image/mask/weight-map triplets under {cfg.data_root} "
                f"sequence {cfg.sequence}; run the preprocess command first"
            )
        imgs, masks, wmaps = [], [], []
        for t in triplets:
            # images stay in [0, 1]; DataConfig.standardize is applied on
            # the device inside the train/eval steps after photometric
            # augmentation (ops/intensity.py) — gamma needs the [0,1] domain
            imgs.append(_load_image_01(t.image, image_size))
            masks.append(read_image(t.mask).astype(np.int32))
            if t.weight_map is not None:
                wmaps.append(np.load(t.weight_map).astype(np.float32))
            else:
                wmaps.append(np.ones_like(imgs[-1], dtype=np.float32))
        return cls(images=np.stack(imgs), masks=np.stack(masks),
                   weight_maps=np.stack(wmaps), files=triplets)

    @classmethod
    def load_many(
        cls, cfg: DataConfig, sequences: Sequence[str], require_weight_maps: bool = True,
        image_size: Optional[int] = None,
    ) -> "HeLaArrays":
        """Concatenate several sequences (the reference's evaluate.py uses a
        ConcatDataset over 01+02, reference: scripts/evaluate.py:54-69)."""
        parts = [cls.load(dataclasses.replace(cfg, sequence=s),
                          require_weight_maps=require_weight_maps, image_size=image_size)
                 for s in sequences]
        return cls(
            images=np.concatenate([p.images for p in parts]),
            masks=np.concatenate([p.masks for p in parts]),
            weight_maps=np.concatenate([p.weight_maps for p in parts]),
            files=[t for p in parts for t in p.files],
        )


def train_val_split(n: int, val_percent: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic permutation split; sizes match the reference's
    random_split (n_val = int(n * val_percent), reference: scripts/train.py:82-84)."""
    n_val = int(n * val_percent)
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_val:], perm[:n_val]


def iter_batches(
    data: HeLaArrays, indices: Sequence[int], batch_size: int, shuffle: bool, seed: int,
) -> Iterator[Batch]:
    """Yield padded fixed-shape batches. `seed` should fold in the epoch so
    shuffling differs per epoch but stays reproducible."""
    idx = np.asarray(indices)
    if shuffle:
        idx = np.random.RandomState(seed).permutation(idx)
    for start in range(0, len(idx), batch_size):
        chunk = idx[start : start + batch_size]
        valid = np.zeros((batch_size,), bool)
        valid[: len(chunk)] = True
        if len(chunk) < batch_size:
            chunk = np.concatenate([chunk, np.full(batch_size - len(chunk), chunk[0])])
        yield Batch(images=data.images[chunk], masks=data.masks[chunk],
                    weight_maps=data.weight_maps[chunk], valid=valid)


def epoch_index_matrix(
    indices: Sequence[int], batch_size: int, shuffle: bool, seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The batch schedule `iter_batches` would yield, as one (S, B) int32
    index matrix and (S, B) valid mask: the per-epoch upload of the
    device-resident feed (train/steps.make_epoch_train_step). The same
    shuffle seed gives the same batches as the host-fed path."""
    idx = np.asarray(indices)
    if shuffle:
        idx = np.random.RandomState(seed).permutation(idx)
    n_steps = num_batches(len(idx), batch_size)
    mat = np.zeros((n_steps, batch_size), np.int32)
    valid = np.zeros((n_steps, batch_size), bool)
    for s in range(n_steps):
        chunk = idx[s * batch_size : (s + 1) * batch_size]
        mat[s, : len(chunk)] = chunk
        mat[s, len(chunk) :] = chunk[0]  # pad like iter_batches
        valid[s, : len(chunk)] = True
    return mat, valid


def num_batches(n_items: int, batch_size: int) -> int:
    return -(-n_items // batch_size)
