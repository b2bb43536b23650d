"""Exact Euclidean distance transforms on the device (counterpart of
unetseg_tpu/ops/edt.py and unetseg_tpu/ops/pallas/minplus.py:edt_sq_pallas).

The exact squared EDT is two (min, +) products:

  phase 1 (columns): G[i, j] = min_k (i - k)^2 + (0 if feat[k, j] else 1e12)
  phase 2 (rows):    D[i, j] = min_k G[i, k] + (j - k)^2

Both run through ops/kernels/minplus.py: on a CUDA tensor the Hopper
kernel, on a CPU tensor its plain version. Features may carry a leading
batch dimension (one plane per instance); the distance matrices are then
shared operands, so each phase is one kernel launch for the whole batch.
Every candidate is one f32 add of integers below 2^24 or of 1e12, and min
is exact, so the result equals the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

from unetseg_tpu_torch.ops.kernels.minplus import BIG, minplus


def _sq_dist(n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (i[:, None] - i[None, :]) ** 2


def edt_sq(features: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance from every pixel to the nearest True
    pixel of `features` (H, W) or (K, H, W), per plane; f32. A plane with
    no feature gets ~1e12."""
    f = features.bool()
    h, w = f.shape[-2:]
    col_cost = torch.where(f, 0.0, BIG)
    g = minplus(_sq_dist(h, f.device), col_cost)
    return torch.clamp_max(minplus(g, _sq_dist(w, f.device)), BIG)


def edt(features: torch.Tensor) -> torch.Tensor:
    """Euclidean distance to the nearest True pixel of `features`."""
    return torch.sqrt(edt_sq(features))


def distance_transform_edt(x: torch.Tensor) -> torch.Tensor:
    """scipy's semantics: the distance from each nonzero pixel of x to the
    nearest zero pixel, 0 at zero pixels. An input with no zero returns
    ~1e6 everywhere (scipy would return hypot of the extent)."""
    return torch.where(x != 0, edt(x == 0), 0.0)
