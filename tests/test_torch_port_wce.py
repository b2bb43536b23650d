"""The port's fused weighted cross-entropy against the JAX package on the
CPU: the plain versions (which the kernel wrappers run for CPU tensors)
against the Pallas kernel pair in interpret mode, and the train step's
masked mean loss against both JAX loss paths.

Tolerances: f32 forward and VJP 1e-6 absolute (one log-sum-exp per pixel
of O(1) logits, rounded in two libraries); bf16 logits: the loss 1e-6
(both compute in f32 from the same bf16 values), the bf16 gradient one
bf16 ulp of its entry plus 1e-6 (rounding to bf16 after f32 values that
differ in their last bits can flip the last bf16 bit); the masked mean
loss 1e-5 relative (a sum of 1,152 f32 terms taken in two orders), its
gradient 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.ops.pallas import wce as jax_wce
from unetseg_tpu.train.steps import _masked_mean_loss as jax_masked_mean_loss
from unetseg_tpu_torch.ops.kernels.wce import (
    WeightedCE,
    weighted_ce_bwd,
    weighted_ce_bwd_plain,
    weighted_ce_fwd,
    weighted_ce_fwd_plain,
)
from unetseg_tpu_torch.ops.losses import weighted_ce_pixels, weighted_cross_entropy
from unetseg_tpu_torch.train.steps import _masked_mean_loss


def _data(c, n=3, h=17, w=23, seed=0):
    """N = 3 * 17 * 23 = 1173 pixels: not a multiple of the TPU kernel's
    1024-row block, so its padding is exercised too."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(n, h, w, c).astype(np.float32)
    targets = rs.randint(0, c, (n, h, w)).astype(np.int32)
    weights = (rs.rand(n, h, w) * 0.75 + 0.25).astype(np.float32)
    cot = rs.randn(n, h, w).astype(np.float32)
    return logits, targets, weights, cot


def _jax_vjp(logits, targets, weights, cot):
    out, vjp = jax.vjp(lambda lg: jax_wce.weighted_ce_pixels(lg, jnp.asarray(targets),
                                                             jnp.asarray(weights), True), logits)
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0].astype(jnp.float32))


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_weighted_ce_matches_the_pallas_kernel(c, dtype):
    logits, targets, weights, cot = _data(c, seed=c)
    jl = jnp.asarray(logits).astype(dtype)
    want_out, want_d = _jax_vjp(jl, targets, weights, cot)
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(getattr(torch, dtype))
    t, w, g = (torch.from_numpy(a) for a in (targets, weights, cot))
    out = weighted_ce_fwd_plain(tl, t, w)
    d = weighted_ce_bwd_plain(tl, t, w, g)
    assert out.dtype == torch.float32 and d.dtype == tl.dtype and d.shape == tl.shape
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-6, rtol=0)
    tol = 1e-6 + (2.0**-8 * np.abs(want_d) if dtype == "bfloat16" else 0.0)
    np.testing.assert_array_less(np.abs(d.float().numpy() - want_d), tol + 1e-12)
    # the wrappers take the plain versions on the CPU and launch nothing
    weighted_ce_fwd.launches = weighted_ce_bwd.launches = 0
    assert torch.equal(weighted_ce_fwd(tl, t, w), out)
    assert torch.equal(weighted_ce_bwd(tl, t, w, g), d)
    assert weighted_ce_fwd.launches == weighted_ce_bwd.launches == 0


def test_autograd_function_and_mean():
    logits, targets, weights, cot = _data(2, seed=5)
    lg = torch.from_numpy(logits).requires_grad_(True)
    t, w = torch.from_numpy(targets), torch.from_numpy(weights)
    out = WeightedCE.apply(lg, t, w, 0, 0)
    (d,) = torch.autograd.grad(out, lg, torch.from_numpy(cot))
    want_out, want_d = _jax_vjp(jnp.asarray(logits), targets, weights, cot)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d.numpy(), want_d, atol=1e-6, rtol=0)
    mean = weighted_cross_entropy(torch.from_numpy(logits), t, w)
    want = jax_wce.weighted_cross_entropy_pallas(jnp.asarray(logits), jnp.asarray(targets),
                                                 jnp.asarray(weights), True)
    np.testing.assert_allclose(float(mean), float(want), rtol=1e-6)


def test_reading_at_the_crop_offset_equals_pre_cropped_inputs():
    logits, _, _, cot = _data(2, h=9, w=11, seed=6)
    rs = np.random.RandomState(7)
    t_full = rs.randint(0, 2, (3, 20, 25)).astype(np.int32)
    w_full = rs.rand(3, 20, 25).astype(np.float32)
    r0, c0 = 5, 7
    t_crop = np.ascontiguousarray(t_full[:, r0 : r0 + 9, c0 : c0 + 11])
    w_crop = np.ascontiguousarray(w_full[:, r0 : r0 + 9, c0 : c0 + 11])
    lg, g = torch.from_numpy(logits), torch.from_numpy(cot)
    full = [torch.from_numpy(a) for a in (t_full, w_full)]
    crop = [torch.from_numpy(a) for a in (t_crop, w_crop)]
    assert torch.equal(weighted_ce_fwd_plain(lg, *full, r0, c0), weighted_ce_fwd_plain(lg, *crop))
    assert torch.equal(weighted_ce_bwd_plain(lg, *full, g, r0, c0),
                       weighted_ce_bwd_plain(lg, *crop, g))
    assert torch.equal(weighted_ce_pixels(lg, *full, r0, c0), weighted_ce_pixels(lg, *crop))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_masked_mean_loss_matches_jax(use_pallas, monkeypatch):
    """The train step's loss with weight maps and a padded item: the
    targets and weights are the uncropped (B, 40, 40) frames, the logits
    the (B, 24, 24) output; loss and d_logits against the JAX step's fused
    loss (Pallas, interpret mode) and its default loss."""
    pixels = jax_wce.weighted_ce_pixels
    monkeypatch.setattr(jax_wce, "weighted_ce_pixels", lambda lg, t, w: pixels(lg, t, w, True))
    rs = np.random.RandomState(8)
    logits = (2 * rs.randn(3, 24, 24, 2)).astype(np.float32)
    targets = rs.randint(0, 2, (3, 40, 40)).astype(np.int32)
    weights = (rs.rand(3, 40, 40) * 5 + 1).astype(np.float32)
    valid = np.array([True, True, False])
    jloss, jd = jax.value_and_grad(
        lambda lg: jax_masked_mean_loss(lg, jnp.asarray(targets), jnp.asarray(weights),
                                        jnp.asarray(valid), use_pallas=use_pallas)
    )(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    loss = _masked_mean_loss(lg, *(torch.from_numpy(a) for a in (targets, weights, valid)))
    (d,) = torch.autograd.grad(loss, lg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    assert not d[2].any()  # the padded item gets no gradient
    # unweighted (validation): the per-pixel CE
    unw = _masked_mean_loss(torch.from_numpy(logits), torch.from_numpy(targets), None,
                            torch.from_numpy(valid))
    want = jax_masked_mean_loss(jnp.asarray(logits), jnp.asarray(targets), None,
                                jnp.asarray(valid))
    np.testing.assert_allclose(float(unw), float(want), rtol=1e-5)
