"""The elastic resampler: wrapper, plain version and launch counter
(counterpart of unetseg_tpu/ops/pallas/elastic.py:sample_displaced, held
to the f32 gather path of unetseg_tpu/ops/elastic.py:elastic_deform_batch).

A CPU tensor runs the plain PyTorch gather; a CUDA tensor launches
csrc/sample_displaced.cu or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unetseg_tpu_torch.ops.kernels.build import library
from unetseg_tpu_torch.ops.kernels.conv3x3 import _on_cpu, _raise_on, _stream
from unetseg_tpu_torch.ops.kernels.launches import counted


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = torch.remainder(idx, 2 * n)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def sample_displaced_plain(
    images: torch.Tensor, masks: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h, w = images.shape
    y0, x0 = torch.floor(yy), torch.floor(xx)
    ty, tx = yy - y0, xx - x0
    r0 = _reflect(y0.long(), h)
    r1 = _reflect(y0.long() + 1, h)
    c0 = _reflect(x0.long(), w)
    c1 = _reflect(x0.long() + 1, w)
    img = images.float().reshape(b, h * w)
    lab = masks.reshape(b, h * w)

    def at(t, r, c):
        return torch.gather(t, 1, (r * w + c).reshape(b, -1)).reshape(b, h, w)

    out = (
        at(img, r0, c0) * (1 - ty) * (1 - tx)
        + at(img, r0, c1) * (1 - ty) * tx
        + at(img, r1, c0) * ty * (1 - tx)
        + at(img, r1, c1) * ty * tx
    )
    rn = torch.where(torch.round(yy) > y0, r1, r0)  # round half to even
    cn = torch.where(torch.round(xx) > x0, c1, c0)
    return out, at(lab, rn, cn)


@counted
def sample_displaced(
    images: torch.Tensor, masks: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image (B,H,W) f32 sampled bilinearly and int32 label masks (B,H,W)
    sampled nearest at absolute coordinates yy, xx (B,H,W) f32, scipy
    'reflect' outside the frame -> (f32 images, int32 masks)."""
    if _on_cpu(images, masks, yy, xx):
        return sample_displaced_plain(images, masks, yy, xx)
    b, h, w = images.shape
    for name, t, dt in (("images", images, torch.float32), ("masks", masks, torch.int32),
                        ("yy", yy, torch.float32), ("xx", xx, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"sample_displaced: {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != (b, h, w) or not t.is_contiguous():
            raise ValueError(f"sample_displaced: {name} must be a contiguous "
                             f"({b}, {h}, {w}) tensor, got {tuple(t.shape)}")
    img_out = torch.empty_like(images)
    mask_out = torch.empty_like(masks)
    err = library().sample_displaced_f32(
        images.data_ptr(), masks.data_ptr(), yy.data_ptr(), xx.data_ptr(),
        b, h, w, img_out.data_ptr(), mask_out.data_ptr(), _stream(images),
    )
    _raise_on(err, "sample_displaced")
    sample_displaced.launches += 1
    return img_out, mask_out
