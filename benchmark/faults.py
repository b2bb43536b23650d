"""Faults planted under the timed path, and the control, for the tests and
for the readings that set the limits (calibrate.py): each makes a cell's
run produce what a broken program would, so its check must read
`correct` false. The benchmark's own runs plant none of them.

  unchanged   a train step returns its state unchanged
  half        half of the batch left out: a train step on the first half
              of its items (the mean taken over them); a masks call on the
              first half of its frames, whose masks stand in for the rest
  altered     a masks call's answer altered where it is produced: a 32 x 32
              block of the first frame's mask flipped
  ema         the EMA's decay held at the recipe's ema_decay, without the
              warm-up min(decay, (1 + t) / (10 + t))
  horizon     the cosine schedule over twice the recipe's steps
  control     the plain reference in fp8 (reference/precision.py) put in
              the program's place
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np

from reference.precision import fp8

SERVE = ("half", "altered", "control")
TRAIN = ("unchanged", "half", "ema", "horizon", "control")


@contextlib.contextmanager
def planted(kind: str, fault: str) -> Iterator[None]:
    """Plant `fault` in the program for the cells built inside the block
    (the control is set on a built cell by `control`; no fault plants
    nothing)."""
    if fault in ("", "control"):
        yield
        return
    if kind == "serve_tiles":
        from unetseg_tpu_torch.infer.engine import Predictor

        orig = Predictor.masks_tiled

        def masks_tiled(self, images, *a, **k):
            if fault == "half":
                n = images.shape[0]
                out = orig(self, np.ascontiguousarray(images[: n // 2]), *a, **k)
                return np.concatenate([out, out])[:n]
            out = orig(self, images, *a, **k).copy()
            out[0, :32, :32] ^= 1
            return out

        Predictor.masks_tiled = masks_tiled
        try:
            yield
        finally:
            Predictor.masks_tiled = orig
        return
    import unetseg_tpu_torch.train.state as state_mod
    import unetseg_tpu_torch.train.steps as steps

    if fault in ("ema", "horizon"):
        cls, name = ((state_mod.TrainState, "apply_gradients") if fault == "ema"
                     else (state_mod, "cosine_decay_schedule"))
        orig = getattr(cls, name)
        if fault == "ema":
            def wrong(self, grads, batch_stats):
                ema = state_mod._ema
                state_mod._ema = lambda shadow, new, d: ema(shadow, new, self.ema_decay)
                try:
                    return orig(self, grads, batch_stats)
                finally:
                    state_mod._ema = ema
        else:
            def wrong(init_value, decay_steps):
                return orig(init_value, 2 * decay_steps)
        setattr(cls, name, wrong)
        try:
            yield
        finally:
            setattr(cls, name, orig)
        return
    make = steps.make_train_step

    def make_faulty(*a, **k):
        step = make(*a, **k)

        def faulty(state, images, masks, weights, valid, generator=None, *, draws=None):
            if fault == "unchanged":
                return state, step(state, images, masks, weights, valid, generator,
                                   draws=draws)[1]
            h = images.shape[0] // 2
            return step(state, images[:h], masks[:h], weights[:h], valid[:h], generator,
                        draws=None if draws is None else draws.rows(slice(0, h)))

        return faulty

    steps.make_train_step = make_faulty
    try:
        yield
    finally:
        steps.make_train_step = make


def control(cell) -> None:
    """Put the fp8 reference in the program's place on a built cell: its
    masks calls, or its train readout."""
    if hasattr(cell, "serve"):
        cell.predictor = None
        cell.serve = lambda frames: cell.reference(frames, quant=fp8)[0]
    else:
        cell.got = cell.reference_readout(quant=fp8)
