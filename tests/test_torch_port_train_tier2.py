"""The tier-2 train step as a whole against the JAX package on the CPU.

- models/train_forward.train_forward(tier2=True) (enc1 and dec2 through
  Conv3x3DenseTrain / DecConv0DenseTrain, on the CPU their kernels' plain
  versions) against models/lanes_train.train_forward_lanes(tier2=True,
  interpret=True): logits, new batch statistics and every parameter
  gradient, with a full and a [True, False] item mask, base_features 8,
  fp32, input 188, batch 2; enc1's and dec2's conv biases get their
  gradient as in the JAX package, the middle's are stopped.
- train/steps.make_train_step(lanes="on", tier2=True) against tier2=False,
  and train(..., tier2=True) against tier2=False: the same function up to
  summation order; tier2 where the kernel forward is not taken raises.

The variables are tie-free (tests/test_torch_port_train_step.py:
live_variables): with exact ties under a ReLU or a max-pool, XLA and torch
route the gradient to different (equally valid) inputs. At base 8 the
BatchNorm shift that avoids them is +2: measured on these seeded weights,
+0 meets ties at enc0 (6.4e-4 apart), and +1 and +3 each meet a near-tie
under one of the two masks where the JAX paths themselves part by 2e-3 to
4e-3 (train_forward_lanes at tier 1 against tier 2, and against
UNet.apply), while the port's tier 1 and tier 2 agree to 8e-6. At +2 the
port and train_forward_lanes(tier2=True) agree to 5e-5 under both masks,
so the tier-1 forward test's tolerances hold
(tests/test_torch_port_train_forward.py): logits 2e-4 absolute, stats
1e-4, gradients 3e-4 after scaling by max(1, max |g|), the pre-BN conv
biases (true gradient 0, float noise on both sides) 2e-3; the steps' loss
and grad_norm 1e-5 relative. The JAX side is jitted once for both masks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.models.lanes_train import train_forward_lanes
from unetseg_tpu_torch.core.config import Config, DataConfig, ModelConfig, TrainConfig
from unetseg_tpu_torch.data import dataset
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.models.train_forward import supports_tier2, train_forward
from unetseg_tpu_torch.models.unet import split_state_dict
from unetseg_tpu_torch.train.loop import train
from unetseg_tpu_torch.train.state import create_train_state
from unetseg_tpu_torch.train.steps import make_train_step
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax

S = 188
WIDE = dict(base_features=8, compute_dtype="float32")
TINY = dict(base_features=4, compute_dtype="float32")
RECIPE = dict(elastic_alpha=2000.0, elastic_sigma=20.0, standardize=True,
              aug_gamma=0.35, aug_illum=0.15, aug_noise=0.05)


def live_variables(seed, shift, **cfg):
    """Seeded variables whose BatchNorm shifts keep most ReLUs open, so no
    ReLU or max-pool meets an exact tie."""
    v = fast_random_variables(ModelConfig(**cfg), seed)
    for name, block in v["params"].items():
        if name.startswith(("enc", "dec")):
            for i in range(2):
                block[f"bn{i}"]["bias"] += shift
    return v


def _leaves(tree, prefix=""):
    out = {}
    for k, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def setup():
    v = live_variables(6, 2.0, **WIDE)
    rs = np.random.RandomState(6)
    x = rs.rand(2, S, S, 1).astype(np.float32)
    ct = rs.rand(2, 4, 4, 2).astype(np.float32)  # cotangent of the logits
    return v, x, ct


@pytest.fixture(scope="module")
def lanes_grad(setup):
    """train_forward_lanes(tier2=True)'s loss, logits, stats and gradients,
    jitted once for both masks."""
    v, x, ct = setup

    def jax_loss(params, mask):
        logits, stats = train_forward_lanes(
            params, v["batch_stats"], jnp.asarray(x), JaxModelConfig(**WIDE), item_mask=mask,
            interpret=True, tier2=True)
        return jnp.sum(logits * ct), (logits, stats)

    return jax.jit(jax.value_and_grad(jax_loss, has_aux=True))


@pytest.mark.parametrize("mask", [[True, True], [True, False]])
def test_tier2_train_forward_matches_train_forward_lanes(setup, lanes_grad, mask):
    v, x, ct = setup
    (_, (ref_logits, ref_stats)), ref_grads = lanes_grad(v["params"], jnp.asarray(mask))
    params, stats = split_state_dict(flax_to_state_dict(v))
    params = {k: p.requires_grad_(True) for k, p in params.items()}
    logits, new_stats = train_forward(params, stats, torch.from_numpy(x), ModelConfig(**WIDE),
                                      torch.tensor(mask), tier2=True)
    (logits * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=2e-4,
                               rtol=1e-4)
    got_s, want_s = _leaves(state_dict_to_flax(new_stats)["batch_stats"]), _leaves(ref_stats)
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-4, rtol=1e-4, err_msg=k)

    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
    got, want = _leaves(state_dict_to_flax(grads)["params"]), _leaves(ref_grads)
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        pre_bn_bias = k.startswith(("enc", "dec")) and k.endswith("bias") and "/conv" in k
        np.testing.assert_allclose(got[k] / scale, w / scale,
                                   atol=2e-3 if pre_bn_bias else 3e-4, err_msg=k)
    # enc1's and dec2's conv biases get db = sum g, as the JAX dense VJPs
    # return it; the middle's are stopped
    for k in ("enc1/conv0/bias", "enc1/conv1/bias", "dec2/conv0/bias", "dec2/conv1/bias"):
        assert np.any(got[k]) and np.any(want[k]), k
    assert not np.any(got["enc2/conv0/bias"]) and not np.any(want["enc2/conv0/bias"])


def _batch(seed, b=2):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:S, :S]
    masks = np.zeros((b, S, S), np.int32)
    for i in range(b):
        for lab in range(1, 6):
            cy, cx, r = rs.uniform(20, S - 20), rs.uniform(20, S - 20), rs.uniform(12, 30)
            masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = lab
    imgs = (0.3 + 0.4 * (masks > 0) + 0.05 * rs.randn(b, S, S)).astype(np.float32)
    weights = rs.uniform(1.0, 3.0, (b, S, S)).astype(np.float32)
    return imgs, masks, weights


def test_tier2_step_matches_tier1_step():
    """One augmented SGD step with tier 2 and with tier 1: the same loss,
    grad_norm and update (SGD moves a noise gradient by lr x noise)."""
    v = live_variables(4, 3.0, **TINY)
    imgs, masks, weights = (torch.from_numpy(a) for a in _batch(30))
    valid = torch.ones(2, dtype=torch.bool)
    out = {}
    for tier2 in (False, True):
        state = create_train_state(v, ModelConfig(**TINY), TrainConfig(learning_rate=0.05))
        step = make_train_step(lanes="on", tier2=tier2, **RECIPE)
        out[tier2] = step(state, imgs, masks, weights, valid, torch.Generator().manual_seed(1))
    (s2, m2), (s1, m1) = out[True], out[False]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5, err_msg=k)
    for k, p in s1.params.items():
        np.testing.assert_allclose(s2.params[k].numpy(), p.numpy(), atol=2e-5, err_msg=k)


def test_tier2_needs_the_kernel_forward():
    cfg = ModelConfig(**TINY)
    assert supports_tier2(cfg, S, "cpu") and not supports_tier2(cfg, 187, "cpu")
    assert supports_tier2(ModelConfig(), 512, "cuda")
    assert not supports_tier2(dataclasses.replace(ModelConfig(), base_features=32), 512, "cuda")
    with pytest.raises(ValueError, match="lanes='off'"):
        make_train_step(lanes="off", tier2=True)
    # "auto" resolves to off on the CPU: the step raises
    step = make_train_step(lanes="auto", tier2=True, augment=False)
    state = create_train_state(0, cfg, TrainConfig())
    imgs, masks, weights = (torch.from_numpy(a) for a in _batch(31))
    with pytest.raises(ValueError, match="tier2 needs the kernel train forward"):
        step(state, imgs, masks, weights, torch.ones(2, dtype=torch.bool))


def test_train_loop_takes_tier2(tmp_path):
    """train(..., tier2=True) trains through tier 2 as tier 1 trains (the
    same history to 1e-5); with lanes resolving to off it raises."""
    imgs, masks, weights = _batch(32, b=10)
    data = dataset.HeLaArrays(imgs, masks, weights, [])
    cfg = Config(model=ModelConfig(**TINY), data=DataConfig(augment=False), train=TrainConfig(
        batch_size=2, num_epochs=1, learning_rate=1e-3, lanes="on", save_checkpoint=False))
    runs = {t2: train(cfg, data=data, device="cpu", tier2=t2) for t2 in (False, True)}
    assert len(runs[True].history) == 1
    for k in ("train_loss", "val_loss", "val_acc", "val_iou"):
        np.testing.assert_allclose(runs[True].history[0][k], runs[False].history[0][k],
                                   rtol=1e-5, err_msg=k)
    off = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lanes="auto"))
    with pytest.raises(ValueError, match="lanes='off'"):
        train(off, data=data, device="cpu", tier2=True)
