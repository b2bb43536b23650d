"""The fused weighted softmax cross-entropy: wrappers, plain versions,
launch counters and the autograd Function (counterpart of
unetseg_tpu/ops/pallas/wce.py).

| wrapper          | CUDA source           | TPU kernel it replaces       |
|------------------|-----------------------|------------------------------|
| weighted_ce_fwd  | csrc/weighted_ce.cu   | ops/pallas/wce.py:_call_fwd  |
| weighted_ce_bwd  | csrc/weighted_ce.cu   | ops/pallas/wce.py:_call_bwd  |

Logits are NHWC (B, H, W, C), f32 or bf16. Targets (int32) and weights
(f32) are (B, Ht, Wt) frames at least as large as the logits, read at
(row_off, col_off): the train step hands them uncropped with the center
crop's offsets. Routing as in ops/kernels/conv3x3.py: a CPU tensor runs
the plain version, a CUDA tensor the kernel or a raise.

The plain version is the JAX step's default loss in PyTorch: a
log-softmax in f32, the target's entry gathered, times w, and for the
backward the autograd of exactly that. The kernel computes the same
function in the same form (with z = logit - the row's max and ls =
log(sum(exp(z))): loss = (ls - z_t) w, d_logit_c = exp(z_c - ls) w g -
[c == t] w g). The TPU kernel's (lse - logit_t) and (e / sum(e) - onehot)
w g are the same numbers up to rounding; for a confident pixel all of
them are small differences, so their low digits follow the rounding, and
one large SGD step carries those into the next step's gradients: the port
follows the default path, which tests/test_torch_port_train_step.py
holds it to. Targets must lie in [0, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unetseg_tpu_torch.ops.kernels.build import library
from unetseg_tpu_torch.ops.kernels.conv3x3 import _on_cpu, _raise_on, _stream
from unetseg_tpu_torch.ops.kernels.launches import counted

def _crop(t: torch.Tensor, h: int, w: int, row_off: int, col_off: int) -> torch.Tensor:
    return t[:, row_off : row_off + h, col_off : col_off + w]


# ------------------------------------------------------------ plain versions
def weighted_ce_fwd_plain(logits, targets, weights, row_off=0, col_off=0):
    h, w = logits.shape[1], logits.shape[2]
    t = _crop(targets, h, w, row_off, col_off).long()
    logz = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logz, -1, t[..., None])[..., 0] * _crop(weights, h, w, row_off,
                                                                  col_off).float()


def weighted_ce_bwd_plain(logits, targets, weights, g, row_off=0, col_off=0):
    with torch.enable_grad():
        lg = logits.detach().requires_grad_(True)
        out = weighted_ce_fwd_plain(lg, targets, weights, row_off, col_off)
        (d,) = torch.autograd.grad(out, lg, g.float())
    return d


# ------------------------------------------------------------------ wrappers
def _check(logits, targets, weights, row_off, col_off, g=None):
    if logits.dim() != 4 or not logits.is_contiguous():
        raise ValueError(f"weighted_ce: logits must be a contiguous (B, H, W, C) tensor, "
                         f"got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weighted_ce: logits must be float32 or bfloat16, got {logits.dtype}")
    b, h, w, c = logits.shape
    if c < 1:
        raise ValueError("weighted_ce: logits have no classes")
    for name, t, dt in (("targets", targets, torch.int32), ("weights", weights, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"weighted_ce: {name} must be {dt}, got {t.dtype}")
        if t.dim() != 3 or t.shape[0] != b or not t.is_contiguous():
            raise ValueError(f"weighted_ce: {name} must be a contiguous ({b}, Ht, Wt) "
                             f"tensor, got {tuple(t.shape)}")
    if targets.shape != weights.shape:
        raise ValueError(f"weighted_ce: targets {tuple(targets.shape)} and weights "
                         f"{tuple(weights.shape)} differ")
    ht, wt = targets.shape[1], targets.shape[2]
    if row_off < 0 or col_off < 0 or row_off + h > ht or col_off + w > wt:
        raise ValueError(f"weighted_ce: crop ({row_off}, {col_off}) + {h}x{w} leaves the "
                         f"{ht}x{wt} target frame")
    if g is not None and (g.dtype != torch.float32 or tuple(g.shape) != (b, h, w)
                          or not g.is_contiguous()):
        raise ValueError(f"weighted_ce: g must be a contiguous float32 ({b}, {h}, {w}) "
                         f"tensor, got {g.dtype} {tuple(g.shape)}")
    return (b, h, w, c, ht, wt, row_off, col_off)


@counted
def weighted_ce_fwd(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                    row_off: int = 0, col_off: int = 0) -> torch.Tensor:
    """Per-pixel w * CE: logits (B,H,W,C), targets int32 and weights f32
    (B,Ht,Wt) read at (row_off, col_off) -> (B,H,W) f32."""
    if _on_cpu(logits, targets, weights):
        return weighted_ce_fwd_plain(logits, targets, weights, row_off, col_off)
    geo = _check(logits, targets, weights, row_off, col_off)
    out = torch.empty(geo[:3], dtype=torch.float32, device=logits.device)
    err = library().weighted_ce_fwd(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16), targets.data_ptr(),
        weights.data_ptr(), *geo, out.data_ptr(), _stream(logits))
    _raise_on(err, "weighted_ce_fwd")
    weighted_ce_fwd.launches += 1
    return out


@counted
def weighted_ce_bwd(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                    g: torch.Tensor, row_off: int = 0, col_off: int = 0) -> torch.Tensor:
    """d(sum g * weighted_ce_fwd)/d logits = (softmax - onehot) * w * g,
    (B,H,W,C) in the logits' dtype; g (B,H,W) f32."""
    if _on_cpu(logits, targets, weights, g):
        return weighted_ce_bwd_plain(logits, targets, weights, g, row_off, col_off)
    geo = _check(logits, targets, weights, row_off, col_off, g)
    d = torch.empty_like(logits)
    err = library().weighted_ce_bwd(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16), targets.data_ptr(),
        weights.data_ptr(), g.data_ptr(), *geo, d.data_ptr(), _stream(logits))
    _raise_on(err, "weighted_ce_bwd")
    weighted_ce_bwd.launches += 1
    return d


class WeightedCE(torch.autograd.Function):
    """Per-pixel weighted CE, differentiable in the logits: forward
    weighted_ce_fwd, backward weighted_ce_bwd (no saved softmax; the
    logits are read again), as wce.py's custom VJP."""

    @staticmethod
    def forward(ctx, logits, targets, weights, row_off, col_off):
        ctx.save_for_backward(logits, targets, weights)
        ctx.offs = (row_off, col_off)
        return weighted_ce_fwd(logits, targets, weights, row_off, col_off)

    @staticmethod
    def backward(ctx, g):
        logits, targets, weights = ctx.saved_tensors
        d = weighted_ce_bwd(logits, targets, weights, g.float().contiguous(), *ctx.offs)
        return d, None, None, None, None
