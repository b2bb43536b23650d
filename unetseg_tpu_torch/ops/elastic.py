"""Elastic deformation (counterpart of unetseg_tpu/ops/elastic.py).

Random uniform fields -> Gaussian blur (mode 'constant') -> x alpha ->
image sampled bilinearly and labels nearest, with scipy's 'reflect'
boundary (reference: utils/augmentations.py:4-39). The blur is two dense
band-matrix products, B_h @ u @ B_w^T, in plain torch as the JAX package
computes it outside any kernel; the sampling is the hand-written kernel of
ops/kernels/elastic.py. The uniform fields are drawn apart from the
deformation (draw_elastic) so tests can hand both packages the same draws.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from unetseg_tpu_torch.ops.kernels.elastic import sample_displaced


def _gaussian_kernel1d_np(sigma: float, truncate: float = 4.0):
    """scipy.ndimage.gaussian_filter1d's order-0 kernel: radius
    int(truncate * sigma + 0.5), normalised to sum 1, f32."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32), radius


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> torch.Tensor:
    return torch.from_numpy(_gaussian_kernel1d_np(sigma, truncate)[0])


@functools.lru_cache(maxsize=16)
def _band_np(size: int, sigma: float, truncate: float) -> np.ndarray:
    k, r = _gaussian_kernel1d_np(sigma, truncate)
    i = np.arange(size)
    d = i[None, :] - i[:, None] + r  # kernel tap of column j for row i
    valid = (d >= 0) & (d < k.shape[0])
    return np.where(valid, k[np.clip(d, 0, k.shape[0] - 1)], np.float32(0.0))


def blur_band_matrix(size: int, sigma: float, truncate: float = 4.0,
                     device=None) -> torch.Tensor:
    """(size, size) f32 band matrix B[i, j] = gauss(j - i): B @ x blurs a
    length-`size` signal with a zero ('constant') boundary."""
    return torch.tensor(_band_np(size, float(sigma), float(truncate)), device=device)


def gaussian_blur_2d(img: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) in f32, zero boundary
    (scipy gaussian_filter(mode='constant')). On a card the f32 products
    run without TF32 unless torch.backends.cuda.matmul.allow_tf32 is set."""
    h, w = img.shape[-2:]
    bh = blur_band_matrix(h, sigma, truncate, img.device)
    bw = blur_band_matrix(w, sigma, truncate, img.device)
    return torch.matmul(torch.matmul(bh, img.float()), bw.t())


def draw_elastic(generator: torch.Generator, batch: int, h: int, w: int,
                 device=None) -> torch.Tensor:
    """(B, 2, H, W) uniforms in [-1, 1): [:, 0] drives dx, [:, 1] dy."""
    u = torch.rand((batch, 2, h, w), generator=generator, device=device,
                   dtype=torch.float32)
    return u * 2.0 - 1.0


def displacement_fields(
    uniforms: torch.Tensor, alpha: float, sigma: float, truncate: float = 4.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy, dx), each gaussian_blur(U[-1, 1]) * alpha, from (..., 2, H, W)
    uniforms (reference: utils/augmentations.py:27-28)."""
    blurred = gaussian_blur_2d(uniforms, sigma, truncate) * alpha
    return blurred[..., 1, :, :], blurred[..., 0, :, :]


def reflect_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """scipy 'reflect' ((d c b a | a b c d | d c b a), period 2n) for
    integer indices of any magnitude."""
    idx = torch.remainder(idx, 2 * n)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def sample_2d(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor, order: int,
              mode: str = "reflect") -> torch.Tensor:
    """map_coordinates of a (H, W) tensor at (yy, xx) with scipy's
    'reflect' boundary, as jax.scipy.ndimage.map_coordinates computes it:
    order 0 takes the nearest pixel (half away from zero) in img's dtype,
    order 1 the bilinear f32 value. Plain PyTorch on any device; the
    train step samples through the sample_displaced kernel instead."""
    if mode != "reflect":
        raise NotImplementedError(f"sample_2d: mode {mode!r}; only 'reflect' is ported")
    h, w = img.shape
    if order == 0:
        near = [(c.sign() * (c.abs() + 0.5).floor()).long() for c in (yy, xx)]
        return img[reflect_index(near[0], h), reflect_index(near[1], w)]
    if order != 1:
        raise NotImplementedError(f"sample_2d: order {order}; orders 0 and 1 are ported")
    img = img.float()
    taps = []
    for c, n in ((yy, h), (xx, w)):
        lo = c.floor()
        up = c - lo
        i = lo.long()
        taps.append(((reflect_index(i, n), 1 - up), (reflect_index(i + 1, n), up)))
    out = None
    for iy, wy in taps[0]:
        for ix, wx in taps[1]:
            term = wy * wx * img[iy, ix]
            out = term if out is None else out + term
    return out


def displacement_pad(alpha: float, sigma: float) -> int:
    """Bound on |displacement| (8 standard deviations of alpha times the
    blurred U[-1, 1] field); coordinates are clamped to it."""
    sd = float(alpha) / (2.0 * float(sigma) * math.sqrt(math.pi))
    return int(math.ceil(min(8.0 * sd, float(alpha)))) + 1


def displaced_coords(
    uniforms: torch.Tensor, alpha: float, sigma: float, truncate: float = 4.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute sampling coordinates (yy, xx), each (B, H, W) f32, of the
    fields from `uniforms` (B, 2, H, W), clamped into the displacement_pad
    halo exactly as unetseg_tpu/ops/elastic.py:207-208 clamps them."""
    h, w = uniforms.shape[-2:]
    d = displacement_pad(alpha, sigma)
    dy, dx = displacement_fields(uniforms, alpha, sigma, truncate)
    rows = torch.arange(h, dtype=torch.float32, device=uniforms.device)
    cols = torch.arange(w, dtype=torch.float32, device=uniforms.device)
    yy = (rows[None, :, None] + dy).clamp(-d, h - 1 + d - 1.001)
    xx = (cols[None, None, :] + dx).clamp(-d, w - 1 + d - 1.001)
    return yy.contiguous(), xx.contiguous()


def elastic_deform_batch(
    images: torch.Tensor, masks: torch.Tensor, uniforms: torch.Tensor,
    alpha: float = 2000.0, sigma: float = 20.0, truncate: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deform (B, H, W) images (bilinear, f32 out) and int32 label masks
    (nearest, exact) with one field per item from `uniforms` (B, 2, H, W)."""
    yy, xx = displaced_coords(uniforms, alpha, sigma, truncate)
    return sample_displaced(images.float().contiguous(), masks.contiguous(), yy, xx)


def elastic_deform(
    image: torch.Tensor, mask: torch.Tensor, uniforms: torch.Tensor,
    alpha: float = 2000.0, sigma: float = 20.0, truncate: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deform one (H, W) image (bilinear, f32 out) and its integer label
    mask (nearest, in the mask's dtype) with one field from `uniforms`
    (2, H, W) (counterpart of unetseg_tpu/ops/elastic.py:elastic_deform,
    which draws the field from a key: [0] drives dx, [1] dy). A batch of
    one through elastic_deform_batch, so a CUDA tensor launches the
    sample_displaced kernel. The JAX single-image path reflects without
    the displacement_pad clamp; the two differ only past 8 standard
    deviations of the displacement."""
    img_d, mask_d = elastic_deform_batch(image[None], mask[None].to(torch.int32),
                                         uniforms[None], alpha, sigma, truncate)
    return img_d[0], mask_d[0].to(mask.dtype)
