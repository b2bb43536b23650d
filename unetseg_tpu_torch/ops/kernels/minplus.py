"""The (min, +) matrix product of the exact EDT: wrapper, plain version
and launch counter (counterpart of unetseg_tpu/ops/pallas/minplus.py).

| wrapper  | CUDA source       | TPU kernel it replaces            |
|----------|-------------------|-----------------------------------|
| minplus  | csrc/minplus.cu   | ops/pallas/minplus.py:minplus     |

out = min(1e12, min_k a[..., i, k] + b[..., k, j]) in f32. Either operand
may carry a leading batch dimension; a 2-D operand is shared by every
batch item (batch stride 0 in the kernel). Routing as in
ops/kernels/conv3x3.py: a CPU tensor runs the plain version, a CUDA tensor
the kernel or a raise. Both are exact (one f32 add per candidate, an exact
min), so they agree bit for bit.
"""

from __future__ import annotations

import torch

from unetseg_tpu_torch.ops.kernels.build import library
from unetseg_tpu_torch.ops.kernels.conv3x3 import _on_cpu, _raise_on, _stream
from unetseg_tpu_torch.ops.kernels.launches import counted

BIG = 1e12  # the accumulator's start, as _minplus_kernel's
PLAIN_BLOCK_ELEMS = 2**22  # the plain version's (rows, K, N) broadcast, at most


def _batch_shape(a: torch.Tensor, b: torch.Tensor):
    """(batch or None, M, K, N); raises on shapes that do not multiply."""
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"minplus: operands must be 2-D or 3-D, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"minplus: inner sizes differ: {tuple(a.shape)} x {tuple(b.shape)}")
    batches = {t.shape[0] for t in (a, b) if t.dim() == 3}
    if len(batches) > 1:
        raise ValueError(f"minplus: batch sizes differ: {tuple(a.shape)} x {tuple(b.shape)}")
    return (batches.pop() if batches else None), m, k, n


def minplus_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Blocked over batch items and rows, so the broadcast (rows, K, N)
    stays under PLAIN_BLOCK_ELEMS elements."""
    batch, m, k, n = _batch_shape(a, b)
    a3 = a.float() if a.dim() == 3 else a.float()[None]
    b3 = b.float() if b.dim() == 3 else b.float()[None]
    out = torch.empty((batch or 1, m, n), dtype=torch.float32, device=a.device)
    rows = max(1, PLAIN_BLOCK_ELEMS // max(1, k * n))
    for z in range(batch or 1):
        az, bz = a3[z % a3.shape[0]], b3[z % b3.shape[0]]
        for r in range(0, m, rows):
            cand = az[r : r + rows, :, None] + bz[None]
            out[z, r : r + rows] = torch.clamp_max(cand.amin(1), BIG)
    return out if batch is not None else out[0]


@counted
def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) or (batch, M, K) x (K, N) or (batch, K, N) -> (batch, M, N)
    (or (M, N) when neither operand is batched) under (min, +), f32."""
    if _on_cpu(a, b):
        return minplus_plain(a, b)
    batch, m, k, n = _batch_shape(a, b)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"minplus: {name} must be a contiguous float32 tensor, "
                            f"got {t.dtype}, contiguous={t.is_contiguous()}")
    if k == 0:
        raise ValueError("minplus: inner size 0")
    out = torch.empty((batch or 1, m, n), dtype=torch.float32, device=a.device)
    err = library().minplus_f32(
        a.data_ptr(), m * k if a.dim() == 3 else 0, b.data_ptr(), k * n if b.dim() == 3 else 0,
        out.data_ptr(), batch or 1, m, k, n, _stream(a))
    _raise_on(err, "minplus")
    minplus.launches += 1
    return out if batch is not None else out[0]
