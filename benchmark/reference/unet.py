"""Architecture module `unet`: the U-Net of Ronneberger et al.
(arXiv:1505.04597, Fig. 1, with BatchNorm after each conv): valid 3x3
convs, 2x2 max-pool, 2x2 stride-2 up-convs, the skip centre-cropped and
concatenated first, a 1x1 head. A configuration without an `architecture`
key runs this one.

Everything in the benchmark that depends on the net's layer graph lives
here (README.md, "Adding a configuration"): the variables' leaves, their
layout for the reference, the program's names for them, the plain
forward, the planted intensity path, the logical layers that flops.py
counts, and the leaves the train check watches. The forward is plain
PyTorch in float32 on NCHW tensors, from the Flax-layout numpy variables
the benchmark makes. Imports nothing of the program.

Layouts of the variables (the Flax convention the program reads):
conv kernels (kH, kW, I, O); an up-conv's kernel (2, 2, I, O) is applied
spatially flipped, out[2r + dy, 2c + dx] += k[1 - dy, 1 - dx] . x[r, c];
BatchNorm scale, bias, running mean and var; running statistics move as
new = 0.9 old + 0.1 batch, the variance unbiased by n / (n - 1).

`quant`, when given, is applied to every conv's input and weights: the
control's lower precision (reference/precision.py).

Frozen copies (adapted, and never to be edited to follow the originals):
  leaf_shapes            unetseg_tpu_torch/models/fast_init.py:24, the
                         same leaves and scales
  plant_intensity_path   chip_smoke.py:1146, unchanged
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flops import BF16, F32, PEAK_BF16, PEAK_F32, Layer, conv_ops, layer, shapes
from reference.common import Tensors, centre_crop, flat

MOMENTUM, EPS = 0.9, 1e-5


def features(model: Dict[str, Any]) -> List[int]:
    return [model["base_features"] * 2**i for i in range(model["levels"])]


def leaf_shapes(model: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], str]]:
    """[(path, shape, role)] of the U-Net's variables in the Flax layout;
    role is kernel, zeros, scale (U[0.5, 1.5)) or shift (U[-0.2, 0.2))."""
    feats = features(model)
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def block(name, cin, f):
        for i, ci in enumerate((cin, f)):
            out.append((f"params/{name}/conv{i}/kernel", (3, 3, ci, f), "kernel"))
            out.append((f"params/{name}/conv{i}/bias", (f,), "zeros"))
            out.append((f"params/{name}/bn{i}/scale", (f,), "scale"))
            out.append((f"params/{name}/bn{i}/bias", (f,), "shift"))
            out.append((f"batch_stats/{name}/bn{i}/mean", (f,), "shift"))
            out.append((f"batch_stats/{name}/bn{i}/var", (f,), "scale"))

    cin = model["in_channels"]
    for lvl, f in enumerate(feats):
        block(f"enc{lvl}", cin, f)
        cin = f
    for i, skip_f in enumerate(reversed(feats[:-1])):
        in_f = feats[-1 - i]
        out.append((f"params/up{i}_tconv/kernel", (2, 2, in_f, in_f // 2), "kernel"))
        out.append((f"params/up{i}_tconv/bias", (in_f // 2,), "zeros"))
        block(f"dec{i}", skip_f + in_f // 2, skip_f)
    out.append(("params/outc/kernel", (1, 1, feats[0], model["num_classes"]), "kernel"))
    out.append(("params/outc/bias", (model["num_classes"],), "zeros"))
    return out


def to_tensors(variables: Mapping[str, Any], device) -> Tuple[Tensors, Tensors]:
    """Flax-layout numpy variables -> (params, stats): flat f32 tensors keyed
    'enc0/conv0/kernel' etc., conv kernels as OIHW and up-conv kernels as
    torch's (I, O, kH, kW) of the flipped kernel."""
    params: Tensors = {}
    for k, v in flat(variables["params"]).items():
        if k.endswith("kernel") and "_tconv" in k:
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)
        elif k.endswith("kernel"):
            v = v.transpose(3, 2, 0, 1)
        params[k] = torch.tensor(np.ascontiguousarray(v), dtype=torch.float32, device=device)
    stats = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in flat(variables["batch_stats"]).items()}
    return params, stats


def ref_key(key: str) -> str:
    """The program's state-dict name -> the reference's Flax path."""
    block, *rest = key.split(".")
    if block.endswith("_tconv") or block == "outc":
        return f"{block}/{'kernel' if rest[0] == 'weight' else 'bias'}"
    sub, leaf = rest
    leaf = {"weight": "kernel" if sub.startswith("conv") else "scale",
            "running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    return f"{block}/{sub}/{leaf}"


def forward(
    params: Tensors, stats: Tensors, x: torch.Tensor, model: Dict[str, Any],
    train: bool = False, quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tensors]:
    """x (N, 1, H, W) f32 -> (logits (N, C, h, w) f32, new running stats).
    Eval mode normalises with the running statistics and returns them
    unchanged; train mode uses the batch's and returns the moved ones."""
    q = quant or (lambda t: t)
    new_stats: Tensors = {}

    def conv(h, w, b):
        return F.conv2d(q(h), q(w), b)

    def block(name, h):
        for i in range(2):
            p = f"{name}/conv{i}/"
            h = conv(h, params[p + "kernel"], params[p + "bias"])
            bn, st = f"{name}/bn{i}/", f"{name}/bn{i}/"
            mean_r, var_r = stats[st + "mean"], stats[st + "var"]
            if train:
                n = h.shape[0] * h.shape[2] * h.shape[3]
                mean = h.mean(dim=(0, 2, 3))
                var = h.var(dim=(0, 2, 3), unbiased=False)
                new_stats[st + "mean"] = MOMENTUM * mean_r + (1 - MOMENTUM) * mean.detach()
                new_stats[st + "var"] = (MOMENTUM * var_r
                                         + (1 - MOMENTUM) * var.detach() * n / (n - 1))
            else:
                mean, var = mean_r, var_r
                new_stats[st + "mean"], new_stats[st + "var"] = mean_r, var_r
            h = (h - mean[None, :, None, None]) * torch.rsqrt(var + EPS)[None, :, None, None]
            h = F.relu(h * params[bn + "scale"][None, :, None, None]
                       + params[bn + "bias"][None, :, None, None])
        return h

    skips = []
    for lvl in range(model["levels"]):
        if lvl > 0:
            x = F.max_pool2d(x, 2)
        x = block(f"enc{lvl}", x)
        skips.append(x)
    x = skips[-1]
    for i, skip in enumerate(reversed(skips[:-1])):
        t = f"up{i}_tconv/"
        x = F.conv_transpose2d(q(x), q(params[t + "kernel"]), params[t + "bias"], stride=2)
        x = block(f"dec{i}", torch.cat([centre_crop(skip, x.shape[-1]), x], dim=1))
    logits = conv(x, params["outc/kernel"], params["outc/bias"])
    return logits, new_stats


def plant_intensity_path(variables, gain=20.0, level=0.475, head_scale=0.05):
    """A seeded stand-in for a trained model. Channel 0 of every encoder
    and decoder block carries the input intensity unchanged (a centre tap
    of 1 from input channel 0, BatchNorm the identity on it), and the head
    thresholds it at `level` (margin gain * (I - level)) beside the random
    head weights scaled by `head_scale`. Every other weight stays random
    at full width. A purely random net puts its masks at 1-3% or 90+%
    foreground with a dense band of logits at the threshold, where bf16
    rounding alone flips 0.1-0.25% of the pixels in either bf16 path;
    this net's masks follow the cells with a margin, as a trained model's
    do, so the pixel-agreement bar tests the kernels and not the band."""
    p, st = variables["params"], variables["batch_stats"]
    for name, block in p.items():
        if not name.startswith(("enc", "dec")):
            continue
        for i in (0, 1):
            k = block[f"conv{i}"]["kernel"]  # (3, 3, CI, CO)
            k[..., 0] = 0.0
            k[1, 1, 0, 0] = 1.0
            block[f"conv{i}"]["bias"][0] = 0.0
            block[f"bn{i}"]["scale"][0], block[f"bn{i}"]["bias"][0] = 1.0, 0.0
            st[name][f"bn{i}"]["mean"][0], st[name][f"bn{i}"]["var"][0] = 0.0, 1.0
    ko = p["outc"]["kernel"]  # (1, 1, 64, 2)
    ko *= head_scale
    ko[0, 0, 0] = (-gain / 2, gain / 2)
    p["outc"]["bias"][:] = (gain * level / 2, -gain * level / 2)
    return variables


def forward_layers(model: Dict[str, Any], b: int, size: int) -> List[Layer]:
    """The logical layers of one forward of `b` tiles of `size`^2 (flops.py):
    3x3 conv + bias + ReLU, each followed in training by BatchNorm + ReLU
    and with its input gradient computed, the stem's excepted (the input
    needs none); 2x2 max-pool, whose backward writes 4x its output; 2x2
    up-conv and 1x1 head, with input gradients and no BatchNorm."""
    sh = shapes(size, model["levels"])
    feats = features(model)
    nc = model["num_classes"]
    out: List[Layer] = []

    def conv(name, hi, ci, co, act_in=BF16, dgrad=True):
        ho = hi - 2
        out.append(layer(name, conv_ops(b, ho, ho, ci, co), b * hi * hi * ci * act_in,
                         b * ho * ho * co * BF16, PEAK_BF16,
                         w_bytes=9 * ci * co * BF16 + co * F32, conv=True, bn_relu=True,
                         dgrad=dgrad))

    cin = model["in_channels"]
    prev = size
    for lvl, ((hi, _), f) in enumerate(zip(sh["enc"], feats)):
        if lvl > 0:
            out.append(layer(f"pool{lvl}", 3 * b * hi * hi * cin, 0, b * hi * hi * cin * BF16,
                             PEAK_F32, grad_in_bytes=4 * b * hi * hi * cin * BF16))
        conv(f"enc{lvl}.conv0", hi, cin, f, act_in=F32 if lvl == 0 else BF16, dgrad=lvl > 0)
        conv(f"enc{lvl}.conv1", hi - 2, f, f)
        cin, prev = f, hi - 4
    h = prev
    for i, (hi, _) in enumerate(sh["dec"]):
        ci, co = feats[-1 - i], feats[-1 - i] // 2
        out.append(layer(f"up{i}", conv_ops(b, hi, hi, ci, co, taps=1), b * h * h * ci * BF16,
                         b * hi * hi * co * BF16, PEAK_BF16,
                         w_bytes=4 * ci * co * BF16 + co * F32, conv=True, dgrad=True))
        skip = feats[-2 - i]
        conv(f"dec{i}.conv0", hi, skip + co, skip)
        conv(f"dec{i}.conv1", hi - 2, skip, skip)
        h = hi - 4
    o = sh["out"]
    out.append(layer("head", conv_ops(b, o, o, feats[0], nc, taps=1), 0, b * o * o * nc * F32,
                     PEAK_BF16, w_bytes=feats[0] * nc * BF16 + nc * F32, conv=True, dgrad=True))
    return out


def watched(model: Dict[str, Any]) -> Dict[str, List[str]]:
    """{reading: leaf paths} of the train check's first-gradient errors,
    each the worst of its leaves: the head's kernel, whose gradient reads
    the whole forward and the loss and no BatchNorm backward; the
    decoder's last level, whose first gradients pass the input- and
    weight-gradient kernels and one BatchNorm backward: its two 3x3 convs
    and its up-conv (dec3_grad1_err and up3_grad1_err for 5 levels)."""
    i = model["levels"] - 2
    return {"head_grad1_err": ["outc/kernel"],
            f"dec{i}_grad1_err": [f"dec{i}/conv0/kernel", f"dec{i}/conv1/kernel"],
            f"up{i}_grad1_err": [f"up{i}_tconv/kernel"]}
