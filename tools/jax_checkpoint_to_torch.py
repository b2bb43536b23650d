#!/usr/bin/env python3
"""Convert the JAX package's Orbax checkpoints into the PyTorch port's
light checkpoint stream.

    python tools/jax_checkpoint_to_torch.py --checkpoint-dir JAX_DIR \
        --output-dir PORT_DIR [--epoch N] [--config configs/best_recipe.json]

Every epoch of the JAX light best-k stream (or the one `--epoch` names) is
restored with unetseg_tpu/train/checkpoint.restore_params_for_inference,
raw weights and, where the checkpoint carries it, the EMA shadow. Each is
mapped into the port's layout by unetseg_tpu_torch/utils/flax_bridge.py
and written by the port's own checkpoint writer, as its training loop
writes it: `<epoch>.pt` (bf16 params, f32 BatchNorm statistics, the EMA
shadow under "ema") and `<epoch>.json` with the epoch's val_loss and the
JAX checkpoint's stored config. `Predictor.from_checkpoint(PORT_DIR,
ema=...)` and `Predictor.from_checkpoints([...], ema=...)` of the port then
read it unchanged, the best epoch chosen by the same val_loss.

The script imports jax, flax and orbax, so it runs where the JAX package
is installed; the port itself never reads Orbax. The model's shape comes
from `--config`, else from the config the checkpoint stores, else the
default ModelConfig.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

from unetseg_tpu.core.config import Config as JaxConfig  # noqa: E402
from unetseg_tpu.core.config import ModelConfig as JaxModelConfig  # noqa: E402
from unetseg_tpu.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from unetseg_tpu.models.unet import UNet, init_unet  # noqa: E402
from unetseg_tpu.train import checkpoint as jax_ckpt  # noqa: E402
from unetseg_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from unetseg_tpu.train.state import make_optimizer  # noqa: E402
from unetseg_tpu_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from unetseg_tpu_torch.models.unet import split_state_dict  # noqa: E402
from unetseg_tpu_torch.train.checkpoint import Checkpointer, device_light_payload  # noqa: E402
from unetseg_tpu_torch.train.state import create_train_state  # noqa: E402
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict  # noqa: E402


def light_epochs(directory: str) -> Dict[int, float]:
    """{epoch: val_loss} of the JAX light stream's checkpoints."""
    mgr = ocp.CheckpointManager(os.path.abspath(directory))
    try:
        out = {}
        for step in mgr.all_steps():
            restored = mgr.restore(step, args=ocp.args.Composite(metrics=ocp.args.JsonRestore()))
            out[int(step)] = float(restored["metrics"]["val_loss"])
        return out
    finally:
        mgr.close()


def model_config(directory: str, config: Optional[str]) -> dict:
    """The ModelConfig fields of --config, else of the checkpoint's stored
    config, else the defaults."""
    if config:
        return dataclasses.asdict(JaxConfig.from_json_file(config).model)
    saved = jax_ckpt.read_checkpoint_config(directory).get("model", {})
    known = {f.name for f in dataclasses.fields(JaxModelConfig)}
    return dataclasses.asdict(JaxModelConfig(**{k: v for k, v in saved.items() if k in known}))


def restore_template(model_cfg: JaxModelConfig) -> JaxTrainState:
    """A train state of the U-Net's structure for restore_params_for_inference:
    zeros of its variables' shapes, traced by jax.eval_shape (initialising
    the net compiles its forward, which took most of a minute on a CPU)."""
    model = UNet(cfg=model_cfg)
    shapes = jax.eval_shape(lambda: init_unet(model, jax.random.key(0), input_size=188))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return JaxTrainState.create(apply_fn=model.apply, params=zeros["params"],
                                batch_stats=zeros["batch_stats"],
                                tx=make_optimizer(JaxTrainConfig()))


def convert(directory: str, output_dir: str, epoch: Optional[int] = None,
            config: Optional[str] = None) -> Dict[int, bool]:
    """Write the port's light stream for the JAX checkpoints under
    `directory`; returns {epoch: whether it carried an EMA shadow}."""
    epochs = light_epochs(directory)
    if epoch is not None:
        if epoch not in epochs:
            raise FileNotFoundError(f"no light checkpoint for epoch {epoch} under {directory}")
        epochs = {epoch: epochs[epoch]}
    if not epochs:
        raise FileNotFoundError(f"no light checkpoints under {directory}")
    fields = model_config(directory, config)
    template = restore_template(JaxModelConfig(**fields))
    writer = Checkpointer(output_dir, keep=len(epochs))
    done = {}
    for e, val_loss in sorted(epochs.items()):
        raw = jax_ckpt.restore_params_for_inference(directory, template, epoch=e)
        try:
            ema = jax_ckpt.restore_params_for_inference(directory, template, epoch=e, ema=True)
        except FileNotFoundError:
            ema = None
        state = create_train_state({"params": raw[0], "batch_stats": raw[1]},
                                   ModelConfig(**fields),
                                   TrainConfig(ema_decay=0.5 if ema else 0.0), device="cpu")
        if ema is not None:
            params, stats = split_state_dict(
                flax_to_state_dict({"params": ema[0], "batch_stats": ema[1]}))
            state = dataclasses.replace(state, ema_params=params, ema_batch_stats=stats)
        extra = jax_ckpt.read_checkpoint_config(directory, e)
        writer.save_light_payload(device_light_payload(state), e, val_loss,
                                  extra={"config": extra} if extra else None)
        done[e] = ema is not None
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint-dir", required=True, help="the JAX checkpoint directory")
    p.add_argument("--output-dir", required=True, help="the port's checkpoint directory")
    p.add_argument("--epoch", type=int, default=None, help="one epoch (default: every one)")
    p.add_argument("--config", default=None, help="JSON config for the model's shape")
    args = p.parse_args(argv)
    done = convert(args.checkpoint_dir, args.output_dir, args.epoch, args.config)
    for e, has_ema in done.items():
        print(f"epoch {e}: {os.path.join(args.output_dir, f'{e}.pt')}"
              f"{' with the EMA shadow' if has_ema else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
