"""A toy architecture module, for the room test (test_ubench_room.py): a
net that is no U-Net of either package, brought to the benchmark as new
files alone. Two levels of valid 3x3 convs with BatchNorm + ReLU
(blocks `a0`, `a1`), a 2x2 max-pool between them, a parameter-free
nearest 2x upsampling of `a1`'s output concatenated after the
centre-cropped skip, one block `b0`, and a 1x1 head `logits`. It exports
the seven functions of README.md's "Adding a configuration" and nothing
else the harness reads.

The program's names for its leaves (ref_key) follow the PyTorch
convention: `a0.conv0.weight`, `a0.bn0.running_mean`, `logits.bias`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flops import BF16, F32, PEAK_BF16, PEAK_F32, conv_ops, layer, shapes
from reference.common import centre_crop, flat

EPS, MOMENTUM = 1e-5, 0.9
BLOCKS = ("a0", "a1", "b0")


def widths(model):
    f = model["base_features"]
    return dict(zip(BLOCKS, ((model["in_channels"], f), (f, 2 * f), (3 * f, f))))


def leaf_shapes(model: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], str]]:
    out = []
    for name, (cin, f) in widths(model).items():
        for i, ci in enumerate((cin, f)):
            out += [(f"params/{name}/conv{i}/kernel", (3, 3, ci, f), "kernel"),
                    (f"params/{name}/conv{i}/bias", (f,), "zeros"),
                    (f"params/{name}/bn{i}/scale", (f,), "scale"),
                    (f"params/{name}/bn{i}/bias", (f,), "shift"),
                    (f"batch_stats/{name}/bn{i}/mean", (f,), "shift"),
                    (f"batch_stats/{name}/bn{i}/var", (f,), "scale")]
    f, nc = model["base_features"], model["num_classes"]
    return out + [("params/logits/kernel", (1, 1, f, nc), "kernel"),
                  ("params/logits/bias", (nc,), "zeros")]


def to_tensors(variables: Mapping[str, Any], device):
    params = {k: torch.tensor(np.ascontiguousarray(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v),
                              device=device) for k, v in flat(variables["params"]).items()}
    stats = {k: torch.tensor(v, device=device) for k, v in flat(variables["batch_stats"]).items()}
    return params, stats


def ref_key(key: str) -> str:
    block, *rest = key.split(".")
    if block == "logits":
        return f"logits/{'kernel' if rest[0] == 'weight' else 'bias'}"
    sub, leaf = rest
    leaf = {"weight": "kernel" if sub.startswith("conv") else "scale",
            "running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    return f"{block}/{sub}/{leaf}"


def forward(params, stats, x, model, train=False, quant=None):
    q = quant or (lambda t: t)
    new_stats = {}

    def block(name, h):
        for i in range(2):
            h = F.conv2d(q(h), q(params[f"{name}/conv{i}/kernel"]), params[f"{name}/conv{i}/bias"])
            st = f"{name}/bn{i}/"
            if train:
                n = h.shape[0] * h.shape[2] * h.shape[3]
                mean, var = h.mean(dim=(0, 2, 3)), h.var(dim=(0, 2, 3), unbiased=False)
                new_stats[st + "mean"] = (MOMENTUM * stats[st + "mean"]
                                          + (1 - MOMENTUM) * mean.detach())
                new_stats[st + "var"] = (MOMENTUM * stats[st + "var"]
                                         + (1 - MOMENTUM) * var.detach() * n / (n - 1))
            else:
                mean, var = stats[st + "mean"], stats[st + "var"]
                new_stats[st + "mean"], new_stats[st + "var"] = mean, var
            h = (h - mean[None, :, None, None]) * torch.rsqrt(var + EPS)[None, :, None, None]
            h = F.relu(h * params[st + "scale"][None, :, None, None]
                       + params[st + "bias"][None, :, None, None])
        return h

    skip = block("a0", x)
    deep = F.interpolate(block("a1", F.max_pool2d(skip, 2)), scale_factor=2, mode="nearest")
    h = block("b0", torch.cat([centre_crop(skip, deep.shape[-1]), deep], dim=1))
    return F.conv2d(q(h), q(params["logits/kernel"]), params["logits/bias"]), new_stats


def plant_intensity_path(variables, gain=20.0, level=0.475, head_scale=0.05):
    """Channel 0 of every block carries the input intensity; the head
    thresholds it at `level` (the U-Net module's planted path, on this net)."""
    p, st = variables["params"], variables["batch_stats"]
    for name in BLOCKS:
        for i in (0, 1):
            k = p[name][f"conv{i}"]["kernel"]
            k[..., 0] = 0.0
            k[1, 1, 0, 0] = 1.0
            p[name][f"conv{i}"]["bias"][0] = 0.0
            p[name][f"bn{i}"]["scale"][0], p[name][f"bn{i}"]["bias"][0] = 1.0, 0.0
            st[name][f"bn{i}"]["mean"][0], st[name][f"bn{i}"]["var"][0] = 0.0, 1.0
    p["logits"]["kernel"] *= head_scale
    p["logits"]["kernel"][0, 0, 0] = (-gain / 2, gain / 2)
    p["logits"]["bias"][:] = (gain * level / 2, -gain * level / 2)
    return variables


def forward_layers(model: Dict[str, Any], b: int, size: int):
    sh = shapes(size, 2)
    w = widths(model)
    out = []

    def conv(name, hi, ci, co, act_in=BF16, dgrad=True):
        ho = hi - 2
        out.append(layer(name, conv_ops(b, ho, ho, ci, co), b * hi * hi * ci * act_in,
                         b * ho * ho * co * BF16, PEAK_BF16, w_bytes=9 * ci * co * BF16 + co * F32,
                         conv=True, bn_relu=True, dgrad=dgrad))

    (h0, _), (h1, _) = sh["enc"]
    (hd, _), = sh["dec"]
    f, nc = model["base_features"], model["num_classes"]
    conv("a0.conv0", h0, w["a0"][0], f, act_in=F32, dgrad=False)
    conv("a0.conv1", h0 - 2, f, f)
    out.append(layer("pool", 3 * b * h1 * h1 * f, 0, b * h1 * h1 * f * BF16, PEAK_F32,
                     grad_in_bytes=4 * b * h1 * h1 * f * BF16))
    conv("a1.conv0", h1, f, 2 * f)
    conv("a1.conv1", h1 - 2, 2 * f, 2 * f)
    out.append(layer("upsample", b * hd * hd * 2 * f, 0, b * hd * hd * 2 * f * BF16, PEAK_F32,
                     grad_in_bytes=b * hd * hd * 2 * f * BF16 / 4))
    conv("b0.conv0", hd, 3 * f, f)
    conv("b0.conv1", hd - 2, f, f)
    o = sh["out"]
    out.append(layer("head", conv_ops(b, o, o, f, nc, taps=1), 0, b * o * o * nc * F32, PEAK_BF16,
                     w_bytes=f * nc * BF16 + nc * F32, conv=True, dgrad=True))
    return out


def watched(model: Dict[str, Any]) -> Dict[str, List[str]]:
    return {"logits_grad1_err": ["logits/kernel"],
            "b0_grad1_err": ["b0/conv0/kernel", "b0/conv1/kernel"]}
