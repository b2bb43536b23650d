"""Train state: params, BatchNorm statistics, optimizer state, step count
and the optional EMA shadows (counterpart of unetseg_tpu/train/state.py).

Parameters and statistics are flat dicts of f32 tensors under the
state-dict names of models/unet.UNet. The optimizers are plain functions
of those dicts with optax's arithmetic (optax is the reference; torch.optim
orders some operations differently):

  sgd    trace = g + momentum * trace (no dampening, no Nesterov, as optax
         `trace`); p += -lr * trace
  adam   optax scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, bias correction
         with the post-increment count, applied as a product with its f32
         reciprocal, as `_foreach_div` by a scalar does on the card);
         p += -lr * update
  adamw  adam's update + weight_decay * p, decoupled, then scaled by -lr

The cosine schedule reads the step count before its increment, as optax's
schedule count does. After every step the EMA shadows move by
e += (1 - d) (p - e), d = min(ema_decay, (1 + t) / (10 + t)) with t the
post-increment step (unetseg_tpu/train/state.py:40-58). Updates make new
tensors, as the JAX state is immutable; the step then drops the old ones.

Every scalar of a step (the rate, the bias corrections, the EMA decay) is
computed on the host from the Python step count, so the update never
waits on the device. On the card the parameters, the moments and the
shadows are packed into flat buffers (ops/kernels/update.FlatTensors:
dicts of per-leaf views) and each step is one pass of `fused_update` and
one `fused_ema` per shadow; a state that arrives unpacked (fresh, resumed,
or rebuilt by a caller) is packed at its first step. On the CPU the
update is the plain `_foreach` code of ops/kernels/update.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from unetseg_tpu_torch.core.config import ModelConfig, TrainConfig
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.models.unet import split_state_dict
from unetseg_tpu_torch.ops.kernels.update import (
    UpdateScalars, ema_plain, fused_ema, fused_update, is_packed, pack, update_plain,
)
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict

Tensors = Dict[str, torch.Tensor]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(init_value, decay_steps) with alpha 0."""

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init_value * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

    return schedule


def _f32_pow(base: float, count: int) -> np.float32:
    """base ** count in f32, as optax's bias correction computes it: the
    f32 base raised in f64 and rounded once, on the host."""
    return np.float32(float(np.float32(base)) ** count)


class Gradients(dict):
    """A gradient tree (name -> tensor) that keeps the global norm the
    fused update computed while reading it (train/steps.optax_global_norm
    returns that one), so the norm costs no pass of its own."""

    global_norm: Optional[torch.Tensor] = None


def _flat_route(tree: Tensors) -> bool:
    """The update's route, by the device of the tree's first leaf: packed
    buffers and the fused kernels on the card, the plain leaves elsewhere."""
    return next(iter(tree.values())).device.type == "cuda"


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optax-style gradient transformation over flat tensor dicts."""

    kind: str                       # "sgd" | "adam" | "adamw"
    learning_rate: Union[float, Callable[[int], float]]
    momentum: float = 0.99
    weight_decay: float = 0.0

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @property
    def moments(self) -> Tuple[str, ...]:
        if self.kind == "sgd":
            return ("trace",)
        if self.kind in ("adam", "adamw"):
            return ("mu", "nu")
        raise ValueError(f"unknown optimizer {self.kind!r}")

    def init(self, params: Tensors) -> Dict[str, Any]:
        return {"count": 0, **{m: {k: torch.zeros_like(v) for k, v in params.items()}
                               for m in self.moments}}

    def scalars(self, count: int) -> UpdateScalars:
        """The host scalars of the step after `count` steps."""
        step = -self.lr(count)
        if self.kind == "sgd":
            return UpdateScalars(step, momentum=self.momentum)
        one = np.float32(1.0)
        c1 = one - _f32_pow(ADAM_B1, count + 1)
        c2 = one - _f32_pow(ADAM_B2, count + 1)
        return UpdateScalars(step, b1=ADAM_B1, b2=ADAM_B2, inv_c1=float(one / c1),
                             inv_c2=float(one / c2), eps=ADAM_EPS,
                             weight_decay=self.weight_decay if self.kind == "adamw" else 0.0)

    def apply(self, params: Tensors, grads: Tensors, state: Dict[str, Any]):
        """-> (new params, new optimizer state). On the card, in packed
        buffers through `fused_update`, which also leaves the gradients'
        global norm on `grads` when it is a `Gradients`."""
        count, names = state["count"], self.moments
        h = self.scalars(count)
        if _flat_route(params):
            p = params if is_packed(params) else pack(params)
            ms = [state[m] if is_packed(state[m], p.layout) else pack(state[m], p.layout)
                  for m in names]
            new_p, new_ms, norm = fused_update(self.kind, p, grads, ms, h)
            if isinstance(grads, Gradients):
                grads.global_norm = norm
            return new_p, {"count": count + 1, **dict(zip(names, new_ms))}
        keys = list(params)
        new_p, new_ms = update_plain(self.kind, [params[k] for k in keys],
                                     [grads[k] for k in keys],
                                     [[state[m][k] for k in keys] for m in names], h)
        return dict(zip(keys, new_p)), {"count": count + 1,
                                        **{m: dict(zip(keys, v)) for m, v in zip(names, new_ms)}}


def make_optimizer(cfg: TrainConfig, steps_per_epoch: Optional[int] = None) -> Optimizer:
    """SGD momentum 0.99 by default (the reference's optimizer); adam/adamw
    and cosine decay over num_epochs * steps_per_epoch as in
    unetseg_tpu/train/state.py:61-77."""
    lr: Union[float, Callable[[int], float]] = cfg.learning_rate
    if cfg.cosine_decay and steps_per_epoch:
        lr = cosine_decay_schedule(cfg.learning_rate, cfg.num_epochs * steps_per_epoch)
    if cfg.optimizer == "sgd":
        return Optimizer("sgd", lr, momentum=cfg.momentum)
    if cfg.optimizer == "adam":
        return Optimizer("adam", lr)
    if cfg.optimizer == "adamw":
        return Optimizer("adamw", lr, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _ema(shadow: Tensors, new: Tensors, d: float) -> Tensors:
    """The EMA's one entry on both routes: shadow + (new - shadow)(1 - d)."""
    if _flat_route(shadow):
        return fused_ema(shadow if is_packed(shadow) else pack(shadow), new, 1.0 - d)
    keys = list(shadow)
    return dict(zip(keys, ema_plain([shadow[k] for k in keys], [new[k] for k in keys], 1.0 - d)))


@dataclasses.dataclass
class TrainState:
    params: Tensors
    batch_stats: Tensors
    tx: Optimizer
    opt_state: Dict[str, Any]
    model_cfg: ModelConfig
    step: int = 0
    ema_params: Optional[Tensors] = None
    ema_batch_stats: Optional[Tensors] = None
    ema_decay: float = 0.0

    def apply_gradients(self, grads: Tensors, batch_stats: Tensors) -> "TrainState":
        """One optimizer step, then the EMA update (when EMA is on)."""
        params, opt_state = self.tx.apply(self.params, grads, self.opt_state)
        state = dataclasses.replace(self, params=params, batch_stats=dict(batch_stats),
                                    opt_state=opt_state, step=self.step + 1)
        if self.ema_params is None:
            return state
        t = np.float32(state.step)
        d = float(min(np.float32(self.ema_decay), (1.0 + t) / (10.0 + t)))
        return dataclasses.replace(
            state, ema_params=_ema(self.ema_params, params, d),
            ema_batch_stats=_ema(self.ema_batch_stats, state.batch_stats, d),
        )


def create_train_state(
    rng: Union[int, torch.Generator, Mapping[str, Any]],
    model_cfg: Optional[ModelConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    input_size: int = 512,
    steps_per_epoch: Optional[int] = None,
    device=None,
) -> TrainState:
    """The counterpart of unetseg_tpu/train/state.py:create_train_state.

    `rng` is either the variables in the Flax layout ({'params',
    'batch_stats'}, e.g. from the JAX package through utils/flax_bridge or
    from models/fast_init) or a seed (an int, or a torch.Generator whose
    initial seed is used) for models/fast_init.fast_random_variables.
    `input_size` is accepted for the JAX signature; the weights do not
    depend on it. Tensors go to `device` in f32."""
    m_cfg = model_cfg or ModelConfig()
    t_cfg = train_cfg or TrainConfig()
    if isinstance(rng, Mapping):
        variables = rng
    else:
        seed = rng.initial_seed() if isinstance(rng, torch.Generator) else int(rng)
        variables = fast_random_variables(m_cfg, seed % 2**32)
    sd = {k: v.to(device) for k, v in flax_to_state_dict(variables).items()}
    params, stats = split_state_dict(sd)
    tx = make_optimizer(t_cfg, steps_per_epoch)
    ema = float(t_cfg.ema_decay or 0.0)
    clone = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return TrainState(
        params=params, batch_stats=stats, tx=tx, opt_state=tx.init(params),
        model_cfg=m_cfg, step=0,
        ema_params=clone(params) if ema > 0 else None,
        ema_batch_stats=clone(stats) if ema > 0 else None,
        ema_decay=ema,
    )
