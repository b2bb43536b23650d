"""The port's train step and state against the JAX package on the CPU.

- make_train_step against JAX make_train_step(lanes=False) (whose equality
  with the lanes step tests/test_lanes_train.py pins): params, batch
  stats, loss and grad_norm after 2 SGD steps, augmentation off, and on
  with the recipe's options and the JAX step's own draws handed to the
  port. Tiny net (base 4, input 188, fp32), the same seeded variables.
  SGD is used because its update is linear in the gradient: Adam turns
  the pre-BN conv biases' float-noise gradients (their true gradient is
  0) into lr-sized steps of either sign, differently in each framework,
  so Adam is compared only on given gradients, below.
- The optimizers (SGD momentum, Adam, AdamW with cosine decay) and the EMA
  against optax and the JAX TrainState on the same gradients.
- lanes resolution: "auto" takes the kernel forward only on a CUDA device.

Tolerances: params and batch stats 2e-5 absolute + 1e-5 relative after
the two steps (lr 0.05, f32 grads agreeing to ~1e-5 relative; running
variances reach ~10); loss and grad_norm 1e-5 relative, 5e-5
with augmentation (the augmented images agree to 2e-5, the blur's
band-matrix products summed in another order; 1.4e-5 measured on the
loss); optimizer states 1e-6 relative (the same f32 arithmetic up to
operation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unetseg_tpu.core.config import ModelConfig as JaxModelConfig
from unetseg_tpu.core.config import TrainConfig as JaxTrainConfig
from unetseg_tpu.models.unet import UNet as JaxUNet
from unetseg_tpu.train.state import TrainState as JaxTrainState
from unetseg_tpu.train.state import make_optimizer as jax_make_optimizer
from unetseg_tpu.train.steps import make_train_step as jax_make_train_step
from unetseg_tpu_torch.core.config import ModelConfig, TrainConfig
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.train.state import create_train_state, make_optimizer
from unetseg_tpu_torch.train.steps import AugmentDraws, lanes_active, make_train_step
from unetseg_tpu_torch.utils.flax_bridge import state_dict_to_flax

TINY = dict(base_features=4, compute_dtype="float32")
RECIPE = dict(elastic_alpha=2000.0, elastic_sigma=20.0, standardize=True,
              aug_gamma=0.35, aug_illum=0.15, aug_noise=0.05)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch(seed, b=2, s=188):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:s, :s]
    masks = np.zeros((b, s, s), np.int32)
    for i in range(b):
        for lab in range(1, 6):
            cy, cx, r = rs.uniform(20, s - 20), rs.uniform(20, s - 20), rs.uniform(12, 30)
            masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = lab
    imgs = (0.3 + 0.4 * (masks > 0) + 0.05 * rs.randn(b, s, s)).astype(np.float32)
    weights = rs.uniform(1.0, 3.0, (b, s, s)).astype(np.float32)
    return imgs, masks, weights, np.ones(b, bool)


def jax_draws(key, b, s, opts):
    """The draws the JAX step makes from `key` (steps.py:114-131): elastic
    from the key, photometric from fold_in(key, 1), noise from
    fold_in(key, 2), each split as the JAX functions split them."""
    u = []
    for k in jax.random.split(key, b):
        kx, ky = jax.random.split(k)
        u.append([jax.random.uniform(kx, (s, s), jnp.float32, -1.0, 1.0),
                  jax.random.uniform(ky, (s, s), jnp.float32, -1.0, 1.0)])
    kg, ki = jax.random.split(jax.random.fold_in(key, 1))
    ks, kn = jax.random.split(jax.random.fold_in(key, 2))
    g = opts["aug_gamma"]
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return AugmentDraws(
        elastic=t(np.asarray(u)),
        log_gamma=t(jax.random.uniform(kg, (b, 1, 1), minval=-g, maxval=g)[:, 0, 0]),
        illum=t(jax.random.uniform(ki, (b, 4, 4), minval=-1.0, maxval=1.0)),
        noise_sigma=t(jax.random.uniform(ks, (b, 1, 1), maxval=opts["aug_noise"])[:, 0, 0]),
        noise=t(jax.random.normal(kn, (b, s, s))),
    )


def live_variables(seed):
    """Seeded variables whose BatchNorm shifts (+3) keep nearly every ReLU
    open. With many zeros, a conv over an all-zero window outputs exactly
    its bias, the 2x2 max-pools meet exact ties, and which tied input gets
    the gradient is an arbitrary (valid) choice that XLA and torch make
    differently: the enc0/enc1 gradients then differ by ~1e-3. Without
    dead windows there are no ties, and the two steps agree."""
    v = fast_random_variables(ModelConfig(**TINY), seed)
    for name, block in v["params"].items():
        if name.startswith(("enc", "dec")):
            for i in range(2):
                block[f"bn{i}"]["bias"] += 3.0
    return v


@pytest.mark.parametrize("augment", [False, True])
def test_two_sgd_steps_match_jax(augment):
    v = live_variables(3)
    opts = RECIPE if augment else {}
    t_cfg = TrainConfig(learning_rate=0.05)
    jstate = JaxTrainState.create(
        apply_fn=JaxUNet(cfg=JaxModelConfig(**TINY)).apply, params=v["params"],
        batch_stats=v["batch_stats"], tx=jax_make_optimizer(JaxTrainConfig(learning_rate=0.05)))
    jstep = jax_make_train_step(JaxUNet(cfg=JaxModelConfig(**TINY)), augment=augment,
                                donate=False, lanes=False, assume_valid=True, **opts)
    state = create_train_state(v, ModelConfig(**TINY), t_cfg)
    step = make_train_step(augment=augment, assume_valid=True, **opts)
    for i in range(2):
        imgs, masks, weights, valid = _batch(10 + i)
        key = jax.random.key(20 + i)
        jstate, jm = jstep(jstate, jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(weights),
                           jnp.asarray(valid), key)
        draws = jax_draws(key, 2, 188, opts) if augment else AugmentDraws()
        state, m = step(state, *(torch.from_numpy(a) for a in (imgs, masks, weights, valid)),
                        draws=draws)
        rtol = 5e-5 if augment else 1e-5
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=rtol)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=rtol)
    assert state.step == 2
    got = _leaves(state_dict_to_flax({**state.params, **state.batch_stats}))
    want = _leaves({"params": jstate.params, "batch_stats": jstate.batch_stats})
    assert got.keys() == want.keys()
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=1e-5, err_msg=k)
        moved += not np.array_equal(want[k], _leaves(v)[k])
    assert moved > len(want) // 2  # the steps really moved the state


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(optimizer="sgd", momentum=0.99)),
    ("adam", dict(optimizer="adam", cosine_decay=True, learning_rate=3e-4)),
    ("adamw", dict(optimizer="adamw", cosine_decay=True, weight_decay=0.01)),
])
def test_optimizers_and_ema_match_optax(name, kw):
    """Three updates on the same gradients, with the EMA (decay 0.999,
    debiased) riding along; cosine decay over 2 epochs x 2 steps, so the
    schedule's count runs to its end."""
    rs = np.random.RandomState(1)
    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "b.running_mean": (4,)}
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items() if "running" not in k}
    bs = {"b.running_mean": rs.randn(4).astype(np.float32)}
    cfg_kw = dict(num_epochs=2, ema_decay=0.999, **kw)
    jtx = jax_make_optimizer(JaxTrainConfig(**cfg_kw), steps_per_epoch=2)
    jstate = JaxTrainState.create(
        apply_fn=None, params={k: jnp.asarray(a) for k, a in p0.items()},
        batch_stats={k: jnp.asarray(a) for k, a in bs.items()}, tx=jtx,
        ema_params={k: jnp.asarray(a) for k, a in p0.items()},
        ema_batch_stats={k: jnp.asarray(a) for k, a in bs.items()}, ema_decay=0.999)
    tx = make_optimizer(TrainConfig(**cfg_kw), steps_per_epoch=2)
    state = create_train_state(fast_random_variables(ModelConfig(base_features=4), 0),
                               ModelConfig(base_features=4), TrainConfig(**cfg_kw))
    state = dataclasses.replace(
        state, params={k: torch.from_numpy(a.copy()) for k, a in p0.items()},
        batch_stats={k: torch.from_numpy(a.copy()) for k, a in bs.items()}, tx=tx,
        ema_params={k: torch.from_numpy(a.copy()) for k, a in p0.items()},
        ema_batch_stats={k: torch.from_numpy(a.copy()) for k, a in bs.items()})
    state = dataclasses.replace(state, opt_state=tx.init(state.params))
    for i in range(3):
        g = {k: rs.randn(*a.shape).astype(np.float32) for k, a in p0.items()}
        new_bs = {k: rs.randn(4).astype(np.float32) for k in bs}
        jstate = jstate.apply_gradients(
            grads={k: jnp.asarray(a) for k, a in g.items()},
            batch_stats={k: jnp.asarray(a) for k, a in new_bs.items()})
        state = state.apply_gradients({k: torch.from_numpy(a) for k, a in g.items()},
                                      {k: torch.from_numpy(a) for k, a in new_bs.items()})
        for got, want in ((state.params, jstate.params), (state.ema_params, jstate.ema_params),
                          (state.ema_batch_stats, jstate.ema_batch_stats)):
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{name} step {i} {k}")
    assert state.step == int(jstate.step) == 3
    assert optax is not None


def test_lanes_resolution():
    cfg = ModelConfig()
    assert lanes_active("auto", cfg, 512, "cuda")
    assert not lanes_active("auto", cfg, 512, "cpu")
    assert lanes_active("on", cfg, 512, "cpu")  # the kernels' plain versions
    assert not lanes_active("off", cfg, 512, "cuda")
    assert not lanes_active("auto", dataclasses.replace(cfg, base_features=32), 512, "cuda")
    with pytest.raises(ValueError, match="does not take"):
        lanes_active("on", dataclasses.replace(cfg, compute_dtype="float32"), 512, "cuda")
    with pytest.raises(ValueError, match="does not take"):
        lanes_active("on", cfg, 187, "cpu")  # no valid U-Net geometry
    with pytest.raises(ValueError, match="auto|on|off"):
        lanes_active("maybe", cfg, 512, "cpu")


def test_kernel_forward_step_matches_plain_step():
    """One augmented step through the kernel train forward (lanes "on";
    on the CPU its kernels' plain versions) against the plain step: the
    same loss and the same update, except the middle's pre-BN conv biases,
    whose gradient the kernel forward drops (their true gradient is 0)."""
    v = live_variables(4)
    imgs, masks, weights, valid = (torch.from_numpy(a) for a in _batch(30))
    out = {}
    for lanes in ("on", "off"):
        state = create_train_state(v, ModelConfig(**TINY), TrainConfig(learning_rate=0.05))
        step = make_train_step(lanes=lanes, **RECIPE)
        out[lanes] = step(state, imgs, masks, weights, valid, torch.Generator().manual_seed(1))
    (s_on, m_on), (s_off, m_off) = out["on"], out["off"]
    np.testing.assert_allclose(float(m_on["loss"]), float(m_off["loss"]), rtol=1e-5)
    for k, p in s_off.params.items():
        middle_bias = (k.split(".")[0] not in ("enc0", "dec3") and ".conv" in k
                       and k.endswith("bias"))
        if not middle_bias:
            np.testing.assert_allclose(s_on.params[k].numpy(), p.numpy(), atol=2e-5, err_msg=k)
