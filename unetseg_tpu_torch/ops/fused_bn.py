"""Fused BatchNorm+ReLU with a hand-written backward, for the kernel train
forward (counterpart of unetseg_tpu/ops/fused_bn.py:make_bn_relu_nhwc).

The same function as models/unet.masked_batch_norm followed by ReLU, at
the minimum pass count over the activation:

  forward : one masked-reduction pass (s, sq) + one normalise+ReLU pass
  backward: one reduction pass (G1 = sum g'z, G2 = sum g') + one dz pass

with every reduction accumulated in fp32 and the elementwise work in the
activation's dtype. JAX's tie conventions are kept: the ReLU gradient is
0.5 at exactly 0 and so is the gradient of the variance clamp at 0 (the
`jnp.maximum` convention), so the two packages agree on those ties too.
This is plain PyTorch: the JAX version is a custom VJP in XLA, not a
Pallas kernel.

With a process group (`group`, the data axis of a mesh) the moments are
global, as the JAX forward's psum((s, sq, n)) makes them: the forward
sums (s, sq, n) over the ranks before the mean and the variance, so the
unbiasing factor and the new running statistics come from the global n
and agree on every rank; the backward sums the statistics' cotangents
(G1, G2 and those of the running statistics) before dz, the transpose of
that sum. dgamma and dbeta stay this rank's contributions: the step sums
them with every other gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unetseg_tpu_torch.core.distributed import all_reduce_cat


def _tie(x: torch.Tensor) -> torch.Tensor:
    """Gradient factor of max(x, 0): 1 above 0, 0.5 at 0, 0 below (f32)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, 0.0, 0.5)).float()


class BnReluNHWC(torch.autograd.Function):
    """(z (B,H,W,C), gamma, beta, run_mean, run_var, item_mask (B,) bool or
    None, momentum, eps, group or None) -> (y, new_mean, new_var)."""

    @staticmethod
    def forward(ctx, z, gamma, beta, run_mean, run_var, item_mask, momentum, eps, group):
        b, h, w, _ = z.shape
        dims = (0, 1, 2)
        if item_mask is not None:
            wm = item_mask.to(z.dtype)[:, None, None, None]
            s = (z * wm).sum(dims, dtype=torch.float32)
            sq = (z.square() * wm).sum(dims, dtype=torch.float32)
            n = item_mask.float().sum() * (h * w)
        else:
            s = z.sum(dims, dtype=torch.float32)
            sq = z.square().sum(dims, dtype=torch.float32)
            n = torch.tensor(float(b * h * w), device=z.device)
        if group is not None:
            s, sq, n = all_reduce_cat(group, s, sq, n)
        n = n.clamp_min(1.0)
        mean = s / n
        var_raw = sq / n - mean.square()
        var = var_raw.clamp_min(0.0)
        unbias = n / (n - 1.0).clamp_min(1.0)
        new_mean = momentum * run_mean + (1 - momentum) * mean
        new_var = momentum * run_var + (1 - momentum) * var * unbias
        a = gamma * torch.rsqrt(var + eps)
        bb = beta - mean * a
        ac, bc = a.to(z.dtype), bb.to(z.dtype)
        y = torch.addcmul(bc, z, ac).clamp_min_(0)
        ctx.save_for_backward(z, gamma, item_mask, mean, var_raw, var, n, unbias, ac, bc)
        ctx.momentum, ctx.eps, ctx.group = momentum, eps, group
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, gy, ct_mean, ct_var):
        z, gamma, item_mask, mean, var_raw, var, n, unbias, ac, bc = ctx.saved_tensors
        mom = ctx.momentum
        inv = torch.rsqrt(var + ctx.eps)
        a = gamma * inv
        gp = gy * _tie(torch.addcmul(bc, z, ac)).to(gy.dtype)
        dims = (0, 1, 2)
        g1 = (gp * z).sum(dims, dtype=torch.float32)
        g2 = gp.sum(dims, dtype=torch.float32)
        da = g1 - mean * g2
        dgamma, dbeta, d_run = da * inv, g2, (mom * ct_mean, mom * ct_var)
        if ctx.group is not None:  # the statistics' cotangents from every rank
            g1, g2, ct_mean, ct_var = all_reduce_cat(ctx.group, g1, g2, ct_mean, ct_var)
            da = g1 - mean * g2
        dvar = -0.5 * inv.pow(3) * (gamma * da)
        dvar = (dvar + (1 - mom) * unbias * ct_var) * _tie(var_raw)
        dmean = -a * g2 + (1 - mom) * ct_mean - 2.0 * mean * dvar
        ds, dsq = dmean / n, dvar / n
        dt = z.dtype
        stat = torch.addcmul(ds.to(dt), z, (2.0 * dsq).to(dt))
        if item_mask is not None:
            stat = stat * item_mask.to(dt)[:, None, None, None]
        dz = torch.addcmul(stat, gp, a.to(dt))
        return dz, dgamma, dbeta, *d_run, None, None, None, None


def bn_relu_nhwc(
    z: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    run_mean: torch.Tensor, run_var: torch.Tensor, momentum: float, eps: float,
    item_mask: Optional[torch.Tensor] = None, group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm+ReLU of an NHWC tensor -> (y, new running
    mean, new running var); the same values as
    models/unet.masked_batch_norm + ReLU with the fused backward. With a
    process `group` the moments are those of the whole group's batch."""
    return BnReluNHWC.apply(z, gamma, beta, run_mean, run_var, item_mask,
                            momentum, eps, group)
