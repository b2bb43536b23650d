"""The plain reference of the U-Net (Ronneberger et al., arXiv:1505.04597,
Fig. 1, with BatchNorm after each conv): valid 3x3 convs, 2x2 max-pool,
2x2 stride-2 up-convs, the skip centre-cropped and concatenated first,
a 1x1 head. Plain PyTorch in float32 on NCHW tensors, from the Flax-layout
numpy variables the benchmark makes. Imports nothing of the program.

Layouts of the variables (the Flax convention the program reads):
conv kernels (kH, kW, I, O); an up-conv's kernel (2, 2, I, O) is applied
spatially flipped, out[2r + dy, 2c + dx] += k[1 - dy, 1 - dx] . x[r, c];
BatchNorm scale, bias, running mean and var; running statistics move as
new = 0.9 old + 0.1 batch, the variance unbiased by n / (n - 1).

`quant`, when given, is applied to every conv's input and weights: the
control's lower precision (reference/precision.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]
MOMENTUM, EPS = 0.9, 1e-5


def exact_f32() -> None:
    """Float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tensors(variables: Mapping[str, Any], device) -> Tuple[Tensors, Tensors]:
    """Flax-layout numpy variables -> (params, stats): flat f32 tensors keyed
    'enc0/conv0/kernel' etc., conv kernels as OIHW and up-conv kernels as
    torch's (I, O, kH, kW) of the flipped kernel."""
    params: Tensors = {}
    stats: Tensors = {}

    def walk(tree, prefix, out):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/", out)
            else:
                out[f"{prefix}{k}"] = np.asarray(v, np.float32)

    flat_p: Dict[str, np.ndarray] = {}
    flat_s: Dict[str, np.ndarray] = {}
    walk(variables["params"], "", flat_p)
    walk(variables["batch_stats"], "", flat_s)
    for k, v in flat_p.items():
        if k.endswith("kernel") and "_tconv" in k:
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)
        elif k.endswith("kernel"):
            v = v.transpose(3, 2, 0, 1)
        params[k] = torch.tensor(np.ascontiguousarray(v), dtype=torch.float32, device=device)
    for k, v in flat_s.items():
        stats[k] = torch.tensor(v, dtype=torch.float32, device=device)
    return params, stats


def centre_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    top = (x.shape[-2] - size) // 2
    left = (x.shape[-1] - size) // 2
    return x[..., top:top + size, left:left + size]


def forward(
    params: Tensors, stats: Tensors, x: torch.Tensor, levels: int, train: bool = False,
    quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
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
    for lvl in range(levels):
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
