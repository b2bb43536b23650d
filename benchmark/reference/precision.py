"""The control's lower precision: fp8, one step below the bf16 that the
configurations state. Per-tensor scaled float8: a tensor is scaled so its
largest magnitude meets the format's largest value, rounded to the
format, and scaled back. A conv's input and weights take e4m3; in
training their gradients take e5m2 (the usual fp8 training recipe's
formats). Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x.float() * scale).to(dtype).float() / scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_to(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, E5M2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x in e4m3 on the way forward, its gradient in e5m2 on the way back."""
    return _FP8.apply(x)
