"""On-device connected components (8-connectivity) via label propagation
(counterpart of unetseg_tpu/post/cc_device.py).

The host path (post/cc.py, scipy union-find) is the default; this keeps
probabilities -> threshold -> labels on the device. Classic iterative
algorithm: seed every foreground pixel with its own flat index, then
repeatedly take the minimum label over the 3x3 neighbourhood (masked to
foreground) until a fixpoint: O(component diameter) dense min-pools.

The JAX version is an XLA `reduce_window` min inside a `lax.while_loop`
that tests convergence on the device; there is no Pallas kernel, and the
port's form is plain PyTorch on the labels' device:

- the min-pool is the minimum of shifted views with `torch.minimum` over
  int32 labels padded with 2**31 - 1, so labels stay exact (no float
  pooling of negated labels);
- reading a convergence flag is a host sync, so the flag is read once every
  `check_every` iterations. An iteration at the fixpoint is the identity,
  so the extra iterations change no bit, and the blocks never run past
  `max_iters`: the cap stops at the same iteration as JAX's
  `it < max_iters`.

Labels returned are raveled-seed minima (the component's smallest flat
index within its frame + 1); `compact_labels` renumbers them to
scipy.ndimage.label's raster numbering exactly.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from unetseg_tpu_torch.post.cc import relabel_sequential, remove_small

_INF32 = 2**31 - 1
CHECK_EVERY = 32  # iterations between reads of the convergence count


def _min_pool3x3(x: torch.Tensor) -> torch.Tensor:
    """Minimum over each pixel's 3x3 window of (B, H, W) int32, padding
    with _INF32: a row pass then a column pass of three shifted views."""
    p = F.pad(x, (1, 1, 1, 1), value=_INF32)
    h, w = x.shape[-2:]
    rows = torch.minimum(torch.minimum(p[:, :h], p[:, 1 : h + 1]), p[:, 2 : h + 2])
    return torch.minimum(torch.minimum(rows[..., :w], rows[..., 1 : w + 1]), rows[..., 2 : w + 2])


def propagate_labels(
    binary_masks: torch.Tensor, max_iters: int = 4096, check_every: int = CHECK_EVERY
) -> Tuple[torch.Tensor, int]:
    """(B, H, W) masks -> ((B, H, W) int32 labels, iterations).

    `iterations` is the count of JAX's loop on the slowest frame: the
    iterations that changed a label, plus the one that found the fixpoint,
    at most `max_iters`."""
    fg = binary_masks > 0
    b, h, w = fg.shape
    seeds = torch.arange(1, h * w + 1, dtype=torch.int32, device=fg.device).reshape(1, h, w)
    labels = torch.where(fg, seeds, _INF32)
    changed = torch.zeros((), dtype=torch.int64, device=fg.device)
    it = 0
    while it < max_iters:
        block = min(check_every, max_iters - it)
        for _ in range(block):
            nxt = torch.where(fg, torch.minimum(labels, _min_pool3x3(labels)), _INF32)
            changed += torch.any(nxt != labels)
            labels = nxt
        it += block
        if int(changed) < it:  # an iteration of this block was the fixpoint
            break
    iters = min(int(changed) + 1, max_iters)
    return torch.where(fg, labels, 0), iters


def label_components_device(binary_masks: torch.Tensor, max_iters: int = 4096) -> torch.Tensor:
    """(B, H, W) bool/int masks -> (B, H, W) int32 labels on their device
    (0 background; foreground labels are 1 + the component's minimum flat
    index within its frame). JAX's version takes one (H, W) frame and is
    vmapped over a batch; the frames here are independent in the same
    way."""
    return propagate_labels(binary_masks, max_iters)[0]


def get_instance_masks_device(
    binary_mask: np.ndarray,
    min_size: int = 15,
    compact: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Device CC of one (H, W) mask on `device` + host-side
    compaction/small-object removal; matches
    post.cc.get_instance_masks(relabel=compact) output exactly except that
    compact=False here still renumbers to scipy raster ids (with gaps where
    small objects were removed), not raw seed minima."""
    m = torch.from_numpy(np.asarray(binary_mask) > 0).to(device)
    raw = label_components_device(m[None])[0].cpu().numpy()
    return compact_labels(raw, min_size=min_size, relabel=compact)


def compact_labels(
    raw: np.ndarray, min_size: int = 15, relabel: bool = False
) -> np.ndarray:
    """Host post-pass on raw device labels, mirroring post.cc.get_instance_masks
    step for step: renumber seed-minimum labels to scipy's raster-order
    1..n, remove small objects id-preserving (gaps allowed), optionally
    compact. Split out so callers that already hold fetched device labels
    (e.g. predict --device-cc) skip the re-upload."""
    if raw.max() == 0:
        return raw.astype(np.uint16)
    # Raw labels are 1 + the component's minimum flat index; sorted unique
    # ids are therefore exactly scipy.ndimage.label's raster numbering.
    ids, inv = np.unique(raw, return_inverse=True)
    labels = inv.reshape(raw.shape).astype(np.int64)
    if ids[0] != 0:  # no background pixel: shift so components start at 1
        labels = labels + 1
    labels = remove_small(labels, min_size)
    if relabel:
        labels = relabel_sequential(labels)
    return labels.astype(np.uint16)
