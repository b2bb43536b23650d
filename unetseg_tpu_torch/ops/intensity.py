"""Photometric augmentation and standardization (counterpart of
unetseg_tpu/ops/intensity.py).

Each random stage is split into a draw (from a torch.Generator) and an
apply that takes the draws, so a test can hand the JAX package's draws to
the apply functions here. torch and jax.random give different numbers from
the same seed; the distributions are the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _uniform(generator, shape, lo, hi, device):
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


def draw_photometric(
    generator: torch.Generator, batch: int, gamma_log: float, illum: float,
    illum_cells: int = 4, device=None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(log-gamma (B,) ~ U[-gamma_log, gamma_log], coarse illumination grid
    (B, cells, cells) ~ U[-1, 1]); None for a stage whose strength is 0."""
    u = _uniform(generator, (batch,), -gamma_log, gamma_log, device) if gamma_log > 0 else None
    c = (_uniform(generator, (batch, illum_cells, illum_cells), -1.0, 1.0, device)
         if illum > 0 else None)
    return u, c


def photometric_augment_batch(
    images: torch.Tensor, log_gamma: Optional[torch.Tensor],
    coarse: Optional[torch.Tensor], illum: float = 0.0,
) -> torch.Tensor:
    """Per-item gamma img ** exp(log_gamma) on [0, 1]-clipped images, then
    the multiplicative low-frequency field 1 + illum * bilinear(coarse).

    images (B, H, W) f32. The field is the coarse grid resized with
    half-pixel centres and edge clamping (F.interpolate, align_corners
    False), which equals jax.image.resize(..., "bilinear") for upsampling."""
    out = images
    if log_gamma is not None:
        out = out.clamp(0.0, 1.0) ** torch.exp(log_gamma)[:, None, None]
    if coarse is not None:
        h, w = images.shape[1:]
        field = F.interpolate(coarse[:, None], size=(h, w), mode="bilinear",
                              align_corners=False)[:, 0]
        out = out * (1.0 + illum * field)
    return out


def draw_noise(
    generator: torch.Generator, shape, max_std: float, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-item std (B,) ~ U[0, max_std], standard normal noise of `shape`)."""
    sigma = _uniform(generator, (shape[0],), 0.0, max_std, device)
    noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return sigma, noise


def gaussian_noise_batch(
    images: torch.Tensor, sigma: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """images + sigma (per item) * noise."""
    return images + sigma[:, None, None] * noise


def standardize_batch(images: torch.Tensor) -> torch.Tensor:
    """Per-item z-score over (H, W) with the population std, floored at 1e-6."""
    m = images.mean(dim=(1, 2), keepdim=True)
    s = images.std(dim=(1, 2), keepdim=True, correction=0)
    return (images - m) / s.clamp_min(1e-6)
