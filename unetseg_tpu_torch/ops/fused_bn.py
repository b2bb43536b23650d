"""Fused BatchNorm+ReLU with a hand-written backward, for the kernel train
forward (counterpart of unetseg_tpu/ops/fused_bn.py:make_bn_relu_nhwc).

The same function as models/unet.masked_batch_norm followed by ReLU, at
the minimum pass count over the activation:

  forward : one masked-reduction pass (s, sq) + one normalise+ReLU pass
  backward: one reduction pass (G1 = sum g'z, G2 = sum g') + one dz pass

with every reduction accumulated in fp32. JAX's tie conventions are kept:
the ReLU gradient is 0.5 at exactly 0 and so is the gradient of the
variance clamp at 0 (the `jnp.maximum` convention), so the two packages
agree on those ties too. The passes are ops/kernels/bn_relu.py's
`bn_relu_fwd` and `bn_relu_bwd`: on a CUDA tensor the kernels of
csrc/bn_relu.cu (three launches each way, the elementwise work in f32),
on a CPU tensor the plain PyTorch version (the elementwise work in the
activation's dtype). The JAX version is a custom VJP in XLA, not a Pallas
kernel.

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

from unetseg_tpu_torch.ops.kernels.bn_relu import bn_relu_bwd, bn_relu_fwd


class BnReluNHWC(torch.autograd.Function):
    """(z (B,H,W,C), gamma, beta, run_mean, run_var, item_mask (B,) bool or
    None, momentum, eps, group or None) -> (y, new_mean, new_var)."""

    @staticmethod
    def forward(ctx, z, gamma, beta, run_mean, run_var, item_mask, momentum, eps, group):
        y, new_mean, new_var, saved = bn_relu_fwd(z, gamma, beta, run_mean, run_var, item_mask,
                                                  momentum, eps, group)
        # an unused running statistic's cotangent arrives as None, not as
        # zeros built on the device
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(z, gamma, item_mask, saved)
        ctx.momentum, ctx.group = momentum, group
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, gy, ct_mean, ct_var):
        z, gamma, item_mask, saved = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(z)
        dz, dgamma, dbeta, d_mean, d_var = bn_relu_bwd(gy, z, gamma, item_mask, saved, ct_mean,
                                                       ct_var, ctx.momentum, ctx.group)
        return dz, dgamma, dbeta, d_mean, d_var, None, None, None, None


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
