"""The port's train forwards and their autograd Functions against the JAX
package on the CPU, fp32, tiny nets (base_features 4, input 188):

- models/train_forward.train_forward (the kernel train forward; on the CPU
  its Functions run the kernels' plain versions) against
  models/lanes_train.train_forward_lanes(interpret=True): logits, new
  batch statistics and every parameter gradient, with a full and a
  [True, False] item mask, as tests/test_lanes_train.py:33-104 holds the
  lanes forward to UNet.apply;
- the fused BN+ReLU Function against ops/fused_bn.make_bn_relu_nhwc,
  values and gradients, ties at 0 included;
- the train-mode UNet against UNet.apply(train=True, mutable=...).

Variables are seeded numpy arrays in the Flax layout handed to both.
Tolerances follow tests/test_lanes_train.py: logits 2e-4 absolute, stats
1e-4, gradients 3e-4 after scaling by max(1, max |g|); the pre-BN conv
biases, whose true gradient is 0 and whose values on both sides are float
noise, 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models.lanes_train import train_forward_lanes
from unetseg_tpu.models.unet import UNet as JaxUNet
from unetseg_tpu.ops.fused_bn import make_bn_relu_nhwc
from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.models.train_forward import train_forward
from unetseg_tpu_torch.models.unet import UNet, split_state_dict
from unetseg_tpu_torch.ops.fused_bn import bn_relu_nhwc
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax

TINY = dict(base_features=4, compute_dtype="float32")
CFG = ModelConfig(**TINY)
JCFG = JaxModelConfig(**TINY)


@pytest.fixture(scope="module")
def setup():
    v = fast_random_variables(CFG, 5)
    rs = np.random.RandomState(5)
    x = rs.rand(2, 188, 188, 1).astype(np.float32)
    ct = rs.rand(2, 4, 4, 2).astype(np.float32)  # cotangent of the logits
    return v, x, ct


def _leaves(tree, prefix=""):
    out = {}
    for k, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(val)
    return out


def _torch_grads(forward, v, x, ct, mask):
    params, stats = split_state_dict(flax_to_state_dict(v))
    params = {k: p.requires_grad_(True) for k, p in params.items()}
    logits, new_stats = forward(params, stats, torch.from_numpy(x), CFG,
                                None if mask is None else torch.tensor(mask))
    (logits * torch.from_numpy(ct)).sum().backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
    return logits.detach().numpy(), state_dict_to_flax(new_stats), state_dict_to_flax(grads)


def _check_grads(got, want):
    got, want = _leaves(got["params"]), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        # a pre-BN conv bias has true gradient 0: both sides sum cancelling
        # terms over every pixel, and with a masked item the lanes path's
        # noise reaches 2^-11 (measured), so those get a 2e-3 floor
        pre_bn_bias = k.startswith(("enc", "dec")) and k.endswith("bias") and "/conv" in k
        np.testing.assert_allclose(got[k] / scale, w / scale,
                                   atol=2e-3 if pre_bn_bias else 3e-4, err_msg=k)


@pytest.fixture(scope="module")
def lanes_grad(setup):
    """train_forward_lanes' logits, stats and gradients, jitted once for
    both masks (interpret-mode kernels run far faster under jit)."""
    v, x, ct = setup

    def jax_loss(params, mask):
        logits, stats = train_forward_lanes(
            params, v["batch_stats"], jnp.asarray(x), JCFG, item_mask=mask, interpret=True)
        return jnp.sum(logits * ct), (logits, stats)

    return jax.jit(jax.value_and_grad(jax_loss, has_aux=True))


@pytest.mark.parametrize("mask", [[True, True], [True, False]])
def test_train_forward_matches_train_forward_lanes(setup, lanes_grad, mask):
    v, x, ct = setup
    (_, (ref_logits, ref_stats)), ref_grads = lanes_grad(v["params"], jnp.asarray(mask))
    logits, stats, grads = _torch_grads(train_forward, v, x, ct, mask)
    np.testing.assert_allclose(logits, np.asarray(ref_logits), atol=2e-4, rtol=1e-4)
    got_s, want_s = _leaves(stats["batch_stats"]), _leaves(ref_stats)
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-4, rtol=1e-4, err_msg=k)
    _check_grads(grads, ref_grads)
    # the middle's pre-BN conv biases are detached, as lanes_train stops them
    assert not np.any(_leaves(grads["params"])["enc2/conv0/bias"])


@pytest.mark.parametrize("mask", [[True, True], [True, False]])
def test_train_mode_unet_matches_flax_apply(setup, mask):
    """Logits, new stats and (full mask) every gradient. With a masked item
    only logits and stats are held, as tests/test_lanes_train.py holds the
    lanes forward: there UNet.apply's gradients below enc2 differ from
    train_forward_lanes' by up to 0.6% (measured), while this port's plain
    and kernel paths both agree with train_forward_lanes (test above)."""
    v, x, ct = setup
    model = JaxUNet(cfg=JCFG)

    def jax_loss(params):
        logits, mutated = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
            train=True, item_mask=jnp.asarray(mask), mutable=["batch_stats"])
        return jnp.sum(logits * ct), (logits, mutated["batch_stats"])

    (_, (ref_logits, ref_stats)), ref_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(v["params"])
    net = UNet(CFG)
    net.load_state_dict(flax_to_state_dict(v))
    net.train()
    logits, new_stats = net(torch.from_numpy(x), item_mask=torch.tensor(mask))
    (logits * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=2e-4, rtol=1e-4)
    got_s, want_s = _leaves(state_dict_to_flax(new_stats)["batch_stats"]), _leaves(ref_stats)
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-4, rtol=1e-4, err_msg=k)
    if all(mask):
        grads = {k: p.grad for k, p in net.named_parameters()}
        _check_grads(state_dict_to_flax(grads), ref_grads)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_bn_matches_make_bn_relu_nhwc(masked):
    """Values, new running stats and the z / gamma / beta gradients. A few
    z sit exactly where z*a + b == 0 (the ReLU tie, gradient 0.5 in both)."""
    rs = np.random.RandomState(7)
    z = rs.randn(3, 5, 6, 8).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, 8).astype(np.float32)
    beta = np.zeros(8, np.float32)
    z[0, 0, 0] = 0.0
    z[:, :, :, 3] = 2.0 * (z[:, :, :, 3] > 0)  # a two-valued channel
    rm, rv = np.zeros(8, np.float32), np.ones(8, np.float32)
    mask = np.array([True, False, True]) if masked else np.ones(3, bool)
    gy = rs.randn(3, 5, 6, 8).astype(np.float32)
    fn = make_bn_relu_nhwc(0.9, 1e-5, masked=masked)

    def jloss(z, gamma, beta):
        y, nm, nv = fn(z, gamma, beta, rm, rv, jnp.asarray(mask))
        return jnp.sum(y * gy), (y, nm, nv)

    (_, (y, nm, nv)), (dz, dg, db) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(z), jnp.asarray(gamma), jnp.asarray(beta))
    tz, tg, tb = (torch.tensor(a, requires_grad=True) for a in (z, gamma, beta))
    ty, tnm, tnv = bn_relu_nhwc(tz, tg, tb, torch.from_numpy(rm), torch.from_numpy(rv), 0.9, 1e-5,
                                torch.from_numpy(mask) if masked else None)
    (ty * torch.from_numpy(gy)).sum().backward()
    for got, want in ((ty, y), (tnm, nm), (tnv, nv), (tz.grad, dz), (tg.grad, dg), (tb.grad, db)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
