"""Convert between the JAX package's variable tree and the port's state.

The JAX package holds a U-Net as `{"params": ..., "batch_stats": ...}`
nested by module name (enc0/conv0/kernel, enc0/bn0/scale, ...). The port's
`models.unet.UNet` uses the same module names, so a flat state-dict key is
the Flax path joined with dots. Layout rules, as in
unetseg_tpu/utils/torch_import.py:
  Conv           HWIO (kH,kW,I,O)            <-> OIHW (O,I,kH,kW)
  ConvTranspose  (kH,kW,I,O) spatially flipped <-> (I,O,kH,kW)
  BatchNorm      scale/bias <-> weight/bias; mean/var <-> running_mean/var

Flax's ConvTranspose applies its kernel flipped
(out[2r+dy, 2j+dx] += W[1-dy, 1-dx] x[r, j]); torch's does not, so the
flip happens here and every torch-side consumer uses torch's convention.
All conversions are transposes and flips only, so a round trip is
bit-exact.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _conv_to_torch(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)


def _conv_to_flax(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)


def _tconv_to_torch(k: np.ndarray) -> np.ndarray:
    return k[::-1, ::-1].transpose(2, 3, 0, 1)


def _tconv_to_flax(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 0, 1)[::-1, ::-1]


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} tree of arrays -> flat f32 torch state dict."""
    sd: Dict[str, np.ndarray] = {}
    for block, tree in variables["params"].items():
        if block.endswith("_tconv"):
            sd[f"{block}.weight"] = _tconv_to_torch(np.asarray(tree["kernel"]))
            sd[f"{block}.bias"] = np.asarray(tree["bias"])
        elif block == "outc":
            sd["outc.weight"] = _conv_to_torch(np.asarray(tree["kernel"]))
            sd["outc.bias"] = np.asarray(tree["bias"])
        else:  # enc{k} / dec{k}: conv0, bn0, conv1, bn1
            for name, leaf in tree.items():
                if name.startswith("conv"):
                    sd[f"{block}.{name}.weight"] = _conv_to_torch(np.asarray(leaf["kernel"]))
                    sd[f"{block}.{name}.bias"] = np.asarray(leaf["bias"])
                else:
                    for k, v in leaf.items():
                        sd[f"{block}.{name}.{_BN_PARAMS[k]}"] = np.asarray(v)
    for block, tree in variables.get("batch_stats", {}).items():
        for name, leaf in tree.items():
            for k, v in leaf.items():
                sd[f"{block}.{name}.{_BN_STATS[k]}"] = np.asarray(v)
    # np.array copies: jax hands out read-only buffers, which torch must not alias
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of flax_to_state_dict: numpy {'params', 'batch_stats'} tree."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in sd.items():
        v = t.detach().cpu().numpy()
        parts = key.split(".")
        block, leaf = parts[0], parts[-1]
        if len(parts) == 2:  # up{i}_tconv.* or outc.*
            if leaf == "weight":
                conv = _tconv_to_flax if block.endswith("_tconv") else _conv_to_flax
                params.setdefault(block, {})["kernel"] = np.ascontiguousarray(conv(v))
            else:
                params.setdefault(block, {})["bias"] = v
            continue
        name = parts[1]
        if name.startswith("conv"):
            if leaf == "weight":
                v = np.ascontiguousarray(_conv_to_flax(v))
            params.setdefault(block, {}).setdefault(name, {})[
                "kernel" if leaf == "weight" else "bias"
            ] = v
        elif leaf in ("running_mean", "running_var"):
            stats.setdefault(block, {}).setdefault(name, {})[leaf[len("running_"):]] = v
        else:
            params.setdefault(block, {}).setdefault(name, {})[
                "scale" if leaf == "weight" else "bias"
            ] = v
    return {"params": params, "batch_stats": stats}
