"""Seeded random variables in the Flax tree layout
(counterpart of unetseg_tpu/models/fast_init.py).

The JAX version draws with jax.random; this one draws with a numpy
RandomState so the same arrays can feed both packages (convert with
utils/flax_bridge.py). Leaves are filled by role: conv kernels ~ N(0, std)
with He fan-out scaling, std = sqrt(2 / (kH*kW*O)), as the training init
has it; biases 0; BatchNorm parameters and running statistics drawn
around the identity (scale, var in [0.5, 1.5]; bias, mean in [-0.2, 0.2])
so that folding is exercised. The JAX version's flat N(0, 0.05) grows the
activations about 10x per layer at 1024 channels, which overflows a
full-width forward; He scaling keeps it finite.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from unetseg_tpu_torch.core.config import ModelConfig


def fast_random_variables(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    rs = np.random.RandomState(seed)
    feats = [cfg.base_features * 2**i for i in range(cfg.levels)]

    def kernel(shape):  # HWIO
        std = np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        return (rs.standard_normal(shape) * std).astype(np.float32)

    def zeros(n):
        return np.zeros((n,), np.float32)

    def block(cin, f):
        p, s = {}, {}
        for i, ci in enumerate((cin, f)):
            p[f"conv{i}"] = {"kernel": kernel((3, 3, ci, f)), "bias": zeros(f)}
            p[f"bn{i}"] = {
                "scale": rs.uniform(0.5, 1.5, f).astype(np.float32),
                "bias": rs.uniform(-0.2, 0.2, f).astype(np.float32),
            }
            s[f"bn{i}"] = {
                "mean": rs.uniform(-0.2, 0.2, f).astype(np.float32),
                "var": rs.uniform(0.5, 1.5, f).astype(np.float32),
            }
        return p, s

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    cin = cfg.in_channels
    for lvl, f in enumerate(feats):
        params[f"enc{lvl}"], stats[f"enc{lvl}"] = block(cin, f)
        cin = f
    for i, skip_f in enumerate(reversed(feats[:-1])):
        in_f = feats[-1 - i]
        up_f = in_f if cfg.bilinear else in_f // 2
        if not cfg.bilinear:
            params[f"up{i}_tconv"] = {
                "kernel": kernel((2, 2, in_f, up_f)), "bias": zeros(up_f)
            }
        params[f"dec{i}"], stats[f"dec{i}"] = block(skip_f + up_f, skip_f)
    params["outc"] = {
        "kernel": kernel((1, 1, feats[0], cfg.num_classes)),
        "bias": zeros(cfg.num_classes),
    }
    return {"params": params, "batch_stats": stats}
