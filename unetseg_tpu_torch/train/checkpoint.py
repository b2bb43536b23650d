"""Checkpoints in two streams written with torch.save (counterpart of
unetseg_tpu/train/checkpoint.py, which writes the same streams with Orbax;
the port does not read Orbax checkpoints).

- light best-k (the checkpoint directory root, `<epoch>.pt`): bf16
  params, f32 BatchNorm statistics, and the EMA shadows under "ema" when
  the state has them: everything inference needs. Keeps the k lowest
  val_loss.
- full latest (`<dir>/full/<epoch>.pt`): f32 params, statistics,
  optimizer state, step and EMA, so that training resumes exactly. Keeps
  the latest only.

Each `<epoch>.pt` has a `<epoch>.json` beside it ({"epoch", "val_loss",
"extra"}), written after the tensors: a checkpoint is complete when its
JSON exists. Saves write at once, on the caller's thread: a background
writer gained nothing for the host-bound loop, whose steps need the GIL
that serialisation holds. Tensors are keyed by the state-dict names of
models/unet.UNet; restore_params_for_inference returns the Flax-layout
tree that infer/engine.Predictor takes; restore_light the light stream's
TrainState-keyed params (f32) and statistics, read_checkpoint_config the
Config dict the loop saves beside each epoch.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from unetseg_tpu_torch.core.distributed import is_primary
from unetseg_tpu_torch.train.state import TrainState
from unetseg_tpu_torch.utils.flax_bridge import state_dict_to_flax

FULL_SUBDIR = "full"
Tensors = Dict[str, torch.Tensor]


def _copy(tree: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """Fresh copies of every tensor of a nested dict (floats cast to
    `dtype` when given); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _copy(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        if dtype is not None and tree.is_floating_point():
            return tree.to(dtype, copy=True)
        return tree.clone()
    return tree


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _ema_payload(state: TrainState, dtype: Optional[torch.dtype] = None) -> Optional[dict]:
    if state.ema_params is None:
        return None
    return {"params": _copy(state.ema_params, dtype), "batch_stats": _copy(state.ema_batch_stats)}


def device_light_payload(state: TrainState) -> Dict[str, Any]:
    """The light payload as device copies: bf16 params, f32 statistics and
    the EMA shadows (bf16 params) under "ema"."""
    out = {"params": _copy(state.params, torch.bfloat16),
           "batch_stats": _copy(state.batch_stats)}
    ema = _ema_payload(state, torch.bfloat16)
    if ema is not None:
        out["ema"] = ema
    return out


def light_payload(state: TrainState) -> Dict[str, Any]:
    """device_light_payload copied to the host: a payload that no later
    step can change, for save_light_payload."""
    return _to_host(device_light_payload(state))


def device_full_payload(state: TrainState) -> Dict[str, Any]:
    out = {"params": _copy(state.params), "batch_stats": _copy(state.batch_stats),
           "opt_state": _copy(state.opt_state), "step": int(state.step)}
    ema = _ema_payload(state)
    if ema is not None:
        out["ema"] = ema
    return out


def _write(directory: str, payload: Dict[str, Any], epoch: int, val_loss: float,
           extra: Optional[Dict[str, Any]]) -> None:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{epoch}.pt")
    torch.save(_to_host(payload), path + ".tmp")
    os.replace(path + ".tmp", path)
    meta = {"epoch": int(epoch), "val_loss": float(val_loss), "extra": extra or {}}
    with open(os.path.join(directory, f"{epoch}.json.tmp"), "w") as f:
        json.dump(meta, f)
    os.replace(os.path.join(directory, f"{epoch}.json.tmp"),
               os.path.join(directory, f"{epoch}.json"))


def _entries(directory: str) -> Dict[int, float]:
    """{epoch: val_loss} of the complete checkpoints in one stream."""
    out = {}
    for p in glob.glob(os.path.join(directory, "*.json")):
        with open(p) as f:
            meta = json.load(f)
        out[int(meta["epoch"])] = float(meta["val_loss"])
    return out


def _remove(directory: str, epoch: int) -> None:
    for suffix in (".json", ".pt"):  # the JSON first: no half checkpoint is listed
        p = os.path.join(directory, f"{epoch}{suffix}")
        if os.path.exists(p):
            os.remove(p)


class Checkpointer:
    """Two-stream checkpoint writer; every save is written before it
    returns. Under several processes only rank 0 writes (the others hold
    the same replicated state) and the saves of the rest do nothing."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.active = is_primary()

    def save_light_payload(self, payload: Dict[str, Any], epoch: int, val_loss: float,
                           extra: Optional[Dict[str, Any]] = None) -> None:
        """Save a device_light_payload taken earlier (the loop holds the
        best state's payload until the save cooldown allows a write), then
        keep the k lowest val_loss (the earlier epoch wins a tie)."""
        if not self.active:
            return
        _write(self.directory, payload, epoch, val_loss, extra)
        ranked = sorted(_entries(self.directory).items(), key=lambda e: (e[1], e[0]))
        for e, _ in ranked[self.keep:]:
            _remove(self.directory, e)

    def save_full(self, state: TrainState, epoch: int, val_loss: float,
                  extra: Optional[Dict[str, Any]] = None) -> None:
        """Full train-state save (latest only): the resume artifact."""
        if not self.active:
            return
        full = os.path.join(self.directory, FULL_SUBDIR)
        _write(full, device_full_payload(state), epoch, val_loss, extra)
        for e in _entries(full):
            if e != epoch:
                _remove(full, e)

    def close(self) -> None:
        """Nothing is pending; kept for the JAX Checkpointer's interface."""


def save_checkpoint(directory: str, state: TrainState, epoch: int, val_loss: float,
                    keep: int = 3, extra: Optional[Dict[str, Any]] = None) -> None:
    """One save of both streams (tests and scripts)."""
    ck = Checkpointer(directory, keep)
    ck.save_light_payload(device_light_payload(state), epoch, val_loss, extra)
    ck.save_full(state, epoch, val_loss, extra)
    ck.close()


def latest_epoch(directory: str) -> Optional[int]:
    """The latest resumable epoch (the full stream), or None."""
    eps = _entries(os.path.join(directory, FULL_SUBDIR))
    return max(eps) if eps else None


def best_epoch(directory: str) -> Optional[int]:
    """The light stream's epoch with the lowest val_loss, or None."""
    eps = _entries(directory)
    return min(eps, key=lambda e: (eps[e], e)) if eps else None


def light_latest_epoch(directory: str) -> Optional[int]:
    """The light stream's latest epoch, or None."""
    return max(_entries(directory), default=None)


def _light_epoch(directory: str, epoch: Optional[int]) -> int:
    """`epoch`, else the light stream's latest; raises when there is none."""
    epoch = light_latest_epoch(directory) if epoch is None else epoch
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return epoch


def _load(directory: str, epoch: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    path = os.path.join(directory, f"{epoch}.pt")
    if not os.path.exists(os.path.join(directory, f"{epoch}.json")):
        raise FileNotFoundError(f"no checkpoint for epoch {epoch} under {directory}")
    with open(os.path.join(directory, f"{epoch}.json")) as f:
        meta = json.load(f)
    return torch.load(path, map_location="cpu", weights_only=True), meta


def _to(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def restore_checkpoint(
    directory: str, state: TrainState, epoch: Optional[int] = None
) -> Tuple[TrainState, int, Dict[str, Any]]:
    """Restore the full train state into `state` (the resume path) from
    `<dir>/full`, on the device of state's params. Returns (state,
    epoch_restored, extra). A state with EMA restored from a checkpoint
    without it restarts the shadows at the restored weights."""
    full = os.path.join(directory, FULL_SUBDIR)
    e = epoch if epoch is not None else latest_epoch(directory)
    if e is None:
        raise FileNotFoundError(f"no full checkpoints under {full}")
    payload, meta = _load(full, e)
    dev = next(iter(state.params.values())).device
    p = _to(payload, dev)
    state = dataclasses.replace(state, params=p["params"], batch_stats=p["batch_stats"],
                                opt_state=p["opt_state"], step=int(p["step"]))
    if state.ema_params is not None:
        ema = p.get("ema") or {"params": _copy(p["params"]), "batch_stats": _copy(p["batch_stats"])}
        state = dataclasses.replace(state, ema_params=ema["params"],
                                    ema_batch_stats=ema["batch_stats"])
    return state, int(e), meta["extra"]


def restore_light(
    directory: str, params_template: Optional[Tensors] = None,
    batch_stats_template: Optional[Tensors] = None, epoch: Optional[int] = None,
    ema: bool = False,
) -> Tuple[Tensors, Tensors, Dict[str, Any]]:
    """(params in f32, batch_stats, extra) of the light stream's given or
    latest epoch, keyed as TrainState keys them; `ema` takes the EMA
    shadows, and a checkpoint without them raises. Given templates, the
    saved keys must be theirs and the tensors go to their device; else
    they stay on the CPU."""
    epoch = _light_epoch(directory, epoch)
    payload, meta = _load(directory, epoch)
    if ema:
        if "ema" not in payload:
            raise FileNotFoundError(
                f"checkpoint {directory} (epoch {epoch}) has no EMA shadow: was it trained "
                f"with TrainConfig.ema_decay > 0?")
        payload = payload["ema"]
    out = []
    for name, template in (("params", params_template), ("batch_stats", batch_stats_template)):
        tree = payload[name]
        if template is not None:
            if set(tree) != set(template):
                raise KeyError(f"checkpoint {directory} (epoch {epoch}): {name} keys "
                               f"{sorted(set(tree) ^ set(template))} differ from the template's")
            tree = _to(tree, next(iter(template.values())).device)
        out.append(tree)
    return {k: v.float() for k, v in out[0].items()}, out[1], meta["extra"]


def read_checkpoint_config(directory: str, epoch: Optional[int] = None) -> Dict[str, Any]:
    """The Config dict saved beside the light stream's given or latest
    epoch ({} if none was)."""
    epoch = _light_epoch(directory, epoch)
    with open(os.path.join(directory, f"{epoch}.json")) as f:
        return json.load(f)["extra"].get("config", {})


def restore_params_for_inference(
    directory: str, epoch: Optional[int] = None, prefer_best: bool = True, ema: bool = False,
) -> Dict[str, Any]:
    """The {'params', 'batch_stats'} tree (f32 numpy, Flax layout) that
    infer/engine.Predictor takes, from the best (default) or given epoch of
    the light stream, else from the full stream at that epoch. `ema` takes
    the EMA shadows; a checkpoint without them raises."""
    if epoch is None:
        epoch = best_epoch(directory) if prefer_best else max(_entries(directory), default=None)
    full = os.path.join(directory, FULL_SUBDIR)
    if epoch is None:
        epoch = latest_epoch(directory)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    where = directory if os.path.exists(os.path.join(directory, f"{epoch}.json")) else full
    payload, _ = _load(where, epoch)
    if ema:
        if "ema" not in payload:
            raise FileNotFoundError(
                f"checkpoint {where} (epoch {epoch}) has no EMA shadow: was it trained "
                f"with TrainConfig.ema_decay > 0?")
        payload = payload["ema"]
    params = {k: v.float() for k, v in payload["params"].items()}
    return state_dict_to_flax({**params, **payload["batch_stats"]})
