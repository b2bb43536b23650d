"""Import reference PyTorch checkpoints (counterpart of
unetseg_tpu/utils/torch_import.py).

Users of the reference train with scripts/train.py and hold `.pth` state
dicts keyed by its module names (reference: models/unet_model.py —
`inc.double_conv.{0,1,3,4}`, `down{k}.maxpool_conv.1.double_conv.*`,
`up{k}.up.*` (ConvTranspose2d), `up{k}.conv.double_conv.*`,
`outc.conv.*`). This converts such a checkpoint into the Flax-layout
numpy tree that infer/engine.Predictor takes (see utils/flax_bridge.py),
so existing models migrate without retraining.

Layout rules, as in the JAX package:
  Conv2d   (O,I,kH,kW) -> HWIO transpose(2,3,1,0)
  ConvT2d  (I,O,kH,kW) -> (kH,kW,I,O) with the kernel spatially flipped
  BatchNorm weight/bias -> scale/bias; running_mean/var -> batch_stats

`to_reference_state_dict` is the inverse, so that a reference checkpoint
can be synthesised from any variables (the repo ships no `.pth`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_DOUBLE_CONV = ((0, 1), (3, 4))  # reference DoubleConv: conv, bn, relu, conv, bn, relu


def _conv(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    w = np.asarray(sd[f"{prefix}.weight"], dtype=np.float32)
    b = np.asarray(sd[f"{prefix}.bias"], dtype=np.float32)
    return {"kernel": w.transpose(2, 3, 1, 0), "bias": b}


def _tconv(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    w = np.asarray(sd[f"{prefix}.weight"], dtype=np.float32)  # (I,O,kH,kW)
    b = np.asarray(sd[f"{prefix}.bias"], dtype=np.float32)
    w = w.transpose(2, 3, 0, 1)[::-1, ::-1].copy()
    return {"kernel": w, "bias": b}


def _bn(sd: Mapping[str, Any], prefix: str):
    params = {
        "scale": np.asarray(sd[f"{prefix}.weight"], dtype=np.float32),
        "bias": np.asarray(sd[f"{prefix}.bias"], dtype=np.float32),
    }
    stats = {
        "mean": np.asarray(sd[f"{prefix}.running_mean"], dtype=np.float32),
        "var": np.asarray(sd[f"{prefix}.running_var"], dtype=np.float32),
    }
    return params, stats


def _double_conv(sd: Mapping[str, Any], prefix: str):
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i, (ci, bi) in enumerate(_DOUBLE_CONV):
        params[f"conv{i}"] = _conv(sd, f"{prefix}.{ci}")
        p, s = _bn(sd, f"{prefix}.{bi}")
        params[f"bn{i}"] = p
        stats[f"bn{i}"] = s
    return params, stats


def _block_prefixes(levels: int):
    """(Flax block name, reference DoubleConv prefix) of every block."""
    yield "enc0", "inc.double_conv"
    for k in range(1, levels):
        yield f"enc{k}", f"down{k}.maxpool_conv.1.double_conv"
    for k in range(1, levels):
        yield f"dec{k - 1}", f"up{k}.conv.double_conv"


def from_reference_state_dict(state_dict: Mapping[str, Any], levels: int = 5) -> Dict[str, Any]:
    """Reference state dict -> {'params': ..., 'batch_stats': ...} of f32
    numpy arrays in the Flax layout."""
    sd = {
        k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
        for k, v in state_dict.items()
    }
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for block, prefix in _block_prefixes(levels):
        params[block], stats[block] = _double_conv(sd, prefix)
    for k in range(1, levels):
        params[f"up{k - 1}_tconv"] = _tconv(sd, f"up{k}.up")
    params["outc"] = _conv(sd, "outc.conv")
    return {"params": params, "batch_stats": stats}


def to_reference_state_dict(
    variables: Mapping[str, Any], levels: int = 5
) -> Dict[str, torch.Tensor]:
    """Flax-layout variables -> a reference-layout state dict of f32
    tensors (the inverse of from_reference_state_dict, bit for bit)."""
    p, st = variables["params"], variables["batch_stats"]
    f32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    sd: Dict[str, torch.Tensor] = {}
    for block, prefix in _block_prefixes(levels):
        for i, (ci, bi) in enumerate(_DOUBLE_CONV):
            conv, bn, stats = p[block][f"conv{i}"], p[block][f"bn{i}"], st[block][f"bn{i}"]
            sd[f"{prefix}.{ci}.weight"] = f32(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
            sd[f"{prefix}.{ci}.bias"] = f32(conv["bias"])
            sd[f"{prefix}.{bi}.weight"] = f32(bn["scale"])
            sd[f"{prefix}.{bi}.bias"] = f32(bn["bias"])
            sd[f"{prefix}.{bi}.running_mean"] = f32(stats["mean"])
            sd[f"{prefix}.{bi}.running_var"] = f32(stats["var"])
    for k in range(1, levels):
        t = p[f"up{k - 1}_tconv"]
        sd[f"up{k}.up.weight"] = f32(np.asarray(t["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
        sd[f"up{k}.up.bias"] = f32(t["bias"])
    sd["outc.conv.weight"] = f32(np.asarray(p["outc"]["kernel"]).transpose(3, 2, 0, 1))
    sd["outc.conv.bias"] = f32(p["outc"]["bias"])
    return sd


def load_reference_checkpoint(path: str, levels: int = 5) -> Dict[str, Any]:
    """Load a reference .pth (torch.save(model.state_dict())) and convert."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_reference_state_dict(sd, levels=levels)
