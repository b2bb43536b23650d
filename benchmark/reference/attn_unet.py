"""Architecture module `attn_unet`: the Attention U-Net of Oktay et al.,
"Attention U-Net: Learning Where to Look for the Pancreas", MIDL 2018
(arXiv:1804.03999, Eq. 1-2, Fig. 2), in 2-D on the valid-conv U-Net of
reference/unet.py (its trunk, widths and BatchNorm unchanged).

Before decoder step i (i = 0 .. levels - 2) the skip is centre-cropped to
the up-conv's output, x (N, F, 2h, 2w), and scaled pixel by pixel by a gate
computed from x and g (N, 2F, h, w), the up-conv's input:

    q     = psi . ReLU(Wx * x + Wg * g + bg) + bpsi   Wx a 2x2 stride-2 conv
                                                      F -> F/2 without bias,
                                                      Wg and psi 1x1 convs
    alpha = upsample2x(sigmoid(q))                    bilinear, align_corners
                                                      False
    x_hat = alpha * x                                 concatenated first, as
                                                      the skip was

Departures from the paper (the configuration's `assumed`): 2-D, so its
trilinear resampling is bilinear; F_int = F / 2 on all four skips, where
the paper gives no F_int and the authors' released U-Nets (as recalled:
inter_size = in_size, the finest skip ungated) differ; Wx a 2x2 stride-2
conv as the released code's sub_sample_factor 2, where the text says 1x1
convs on the input downsampled to g's grid; no BatchNorm in the gate (Eq.
1), and neither the code's output 1x1 conv with its BatchNorm nor deep
supervision; the trunk keeps unet-r15-c2's widths and BatchNorm.

The seven functions of README.md's "Adding a configuration"; the trunk's
leaves, layout, names and planted path are reference/unet.py's, to which
the gates add `gate{i}/wx/kernel` (2, 2, F, F/2), `gate{i}/wg/kernel` (1,
1, 2F, F/2), `gate{i}/wg/bias` (F/2,), `gate{i}/psi/kernel` (1, 1, F/2, 1)
and `gate{i}/psi/bias` (1,) after the trunk's leaves, so a seed draws the
trunk of unet-r15-c2. Plain PyTorch in float32 on NCHW tensors; `quant`
takes every conv's input and weights, the gates' three included. Imports
nothing of the program.

`gate_layers(model, b, size)` and `gate_bound_s` count the gates' own
layers (the gate GEMM and the apply), for the cell's `roofline.gate`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from flops import BF16, F32, PEAK_BF16, PEAK_F32, Layer, conv_ops, layer, shapes
from reference import unet as U
from reference.common import Tensors, centre_crop

MOMENTUM, EPS = U.MOMENTUM, U.EPS
to_tensors = U.to_tensors  # gate kernels are plain convs: (kH, kW, I, O) -> OIHW

# The planted gates (plant_intensity_path): intermediate channel 0 of gate
# i reads t0 = (1 - G_SHARE) x the mean of x's 2x2 patch (x's planted
# channel 0, the intensity) + G_SHARE x g's channel 0 (the intensity times
# the gate above's alpha, which decoder step i - 1 carries; gate 0's g is
# the bottom's intensity); psi weighs it by INTENSITY_GAIN, its bias putting
# q at CELL_Q where t0 is CELL_T[i], the median of t0 over the cells' pixels
# at the cell's tiles (700^2; max-pooling raises a coarser level's
# intensity, so each gate has its own); psi's other weights keep PSI_SCALE /
# sqrt(F/2) of their seeded draw, so the rest of q follows the random
# features of x and g.
INTENSITY_GAIN, CELL_Q, PSI_SCALE, G_SHARE = 20.0, 1.8, 0.1, 0.3
CELL_T = (0.8139, 0.7347, 0.7178, 0.6821)


def gated_levels(model: Dict[str, Any]) -> List[Tuple[int, int]]:
    """[(decoder step i, skip channels F)] of the gates, in decoder order."""
    return list(enumerate(reversed(U.features(model)[:-1])))


def leaf_shapes(model: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], str]]:
    """reference/unet.py's leaves, then each gate's (Flax layout)."""
    out = U.leaf_shapes(model)
    for i, f in gated_levels(model):
        n = f // 2
        out += [(f"params/gate{i}/wx/kernel", (2, 2, f, n), "kernel"),
                (f"params/gate{i}/wg/kernel", (1, 1, 2 * f, n), "kernel"),
                (f"params/gate{i}/wg/bias", (n,), "zeros"),
                (f"params/gate{i}/psi/kernel", (1, 1, n, 1), "kernel"),
                (f"params/gate{i}/psi/bias", (1,), "zeros")]
    return out


def ref_key(key: str) -> str:
    """The program's state-dict name (`gate0.wx.weight`, ...) -> the
    reference's path."""
    block, *rest = key.split(".")
    if block.startswith("gate"):
        sub, leaf = rest
        return f"{block}/{sub}/{'kernel' if leaf == 'weight' else 'bias'}"
    return U.ref_key(key)


def gate(params: Tensors, i: int, x: torch.Tensor, g: torch.Tensor,
         q: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """alpha (N, 1, h, w) of gate i at g's grid, before the upsampling."""
    p = f"gate{i}/"
    t = (F.conv2d(q(x), q(params[p + "wx/kernel"]), stride=2)
         + F.conv2d(q(g), q(params[p + "wg/kernel"]), params[p + "wg/bias"]))
    return torch.sigmoid(F.conv2d(q(F.relu(t)), q(params[p + "psi/kernel"]), params[p + "psi/bias"]))


def forward(
    params: Tensors, stats: Tensors, x: torch.Tensor, model: Dict[str, Any],
    train: bool = False, quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    alphas: Optional[List[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tensors]:
    """x (N, 1, H, W) f32 -> (logits (N, C, h, w) f32, new running stats),
    as reference/unet.py's forward with the gated skips; `alphas`, when
    given, receives each gate's alpha (N, 1, h, w) before the upsampling."""
    q = quant or (lambda t: t)
    new_stats: Tensors = {}

    def conv(h, w, b):
        return F.conv2d(q(h), q(w), b)

    def block(name, h):
        for i in range(2):
            p = f"{name}/conv{i}/"
            h = conv(h, params[p + "kernel"], params[p + "bias"])
            st = f"{name}/bn{i}/"
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
            h = F.relu(h * params[st + "scale"][None, :, None, None]
                       + params[st + "bias"][None, :, None, None])
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
        g = x
        x = F.conv_transpose2d(q(x), q(params[t + "kernel"]), params[t + "bias"], stride=2)
        crop = centre_crop(skip, x.shape[-1])
        a = gate(params, i, crop, g, q)
        if alphas is not None:
            alphas.append(a.detach())
        x_hat = F.interpolate(a, scale_factor=2, mode="bilinear", align_corners=False) * crop
        x = block(f"dec{i}", torch.cat([x_hat, x], dim=1))
    logits = conv(x, params["outc/kernel"], params["outc/bias"])
    return logits, new_stats


def plant_intensity_path(variables, gain=20.0, level=0.475, head_scale=0.05):
    """reference/unet.py's planted intensity path (channel 0 of every block
    carries the input intensity I; the head thresholds it at `level`),
    which here runs through every gated skip, so the head thresholds
    alpha3 x I of the last gate. Each gate's intermediate channel 0 reads
    the 2x2 patch's mean intensity and, at G_SHARE, g's channel 0: alpha of
    the gate above times I, so each gate's alpha reaches every gate below
    it and the head. alpha is near 0 on the background (0.25) and spreads
    over the cells by the frame's noise, by the cells' edges, by the gate
    above and by the random rest of q (psi's other weights at PSI_SCALE /
    sqrt(F/2) of their draw): at the cell's tiles the median over a cell's
    pixels is 0.70-0.94 at each gate and a tenth to a half of them lie
    under level / I (~0.68). The masks follow the cells, less the pixels
    whose last gate closes; a gate at any level held at 1, resampled
    nearest, fed another crop or summing part of its K moves pixels
    through the gates below to the head, so the check sees it. A gate
    saturated at 0 or 1 would make the check blind to it (PERF.md gives
    alpha's spread and each level's faults' readings)."""
    U.plant_intensity_path(variables, gain=gain, level=level, head_scale=head_scale)
    for name, g in variables["params"].items():
        if not name.startswith("gate"):
            continue
        wx, wg, psi = g["wx"]["kernel"], g["wg"]["kernel"], g["psi"]["kernel"]
        n = psi.shape[2]
        wx[..., 0] = 0.0
        wx[:, :, 0, 0] = 0.25 * (1.0 - G_SHARE)  # theta_0: the patch's mean of x's channel 0
        wg[..., 0] = 0.0
        wg[0, 0, 0, 0] = G_SHARE  # phi_0: g's channel 0
        g["wg"]["bias"][0] = 0.0
        psi *= PSI_SCALE / n**0.5
        psi[0, 0, 0, 0] = INTENSITY_GAIN
        g["psi"]["bias"][:] = CELL_Q - INTENSITY_GAIN * CELL_T[int(name[4:])]
    return variables


def gate_layers(model: Dict[str, Any], b: int, size: int) -> Dict[int, List[Layer]]:
    """{decoder step i: [gate{i}, gate{i}.apply]} of one forward of `b`
    tiles of `size`^2: the gate's GEMM (Wx over the crop's 2x2 patches, Wg
    over g, psi over the F/2 outputs; reads the crop and g once, writes
    alpha in f32; with its input gradient in training), and the apply
    (upsampling alpha and scaling the crop: reads the crop and alpha,
    writes x_hat; its backward writes the crop's and alpha's gradients)."""
    sh = shapes(size, model["levels"])
    out: Dict[int, List[Layer]] = {}
    for (i, f), (hi, _) in zip(gated_levels(model), sh["dec"]):
        h, n = hi // 2, f // 2
        crop, gb, ab = b * hi * hi * f * BF16, b * h * h * 2 * f * BF16, b * h * h * F32
        ops = (conv_ops(b, h, h, f, n, taps=4) + conv_ops(b, h, h, 2 * f, n, taps=1)
               + conv_ops(b, h, h, n, 1, taps=1))
        out[i] = [
            layer(f"gate{i}", ops, crop + gb, ab, PEAK_BF16,
                  w_bytes=6 * f * n * BF16 + (2 * n + 1) * F32, conv=True, dgrad=True),
            layer(f"gate{i}.apply", b * hi * hi * (f + 7), crop + ab, crop, PEAK_F32,
                  grad_in_bytes=crop + ab),
        ]
    return out


def gate_bound_s(model: Dict[str, Any], b: int, size: int) -> float:
    """The least time of the gates' layers of one forward (gate_layers)."""
    return sum(x["bound_s"] for v in gate_layers(model, b, size).values() for x in v)


def forward_layers(model: Dict[str, Any], b: int, size: int) -> List[Layer]:
    """reference/unet.py's layers with each gate's two (gate_layers) before
    its decoder entry."""
    gates = gate_layers(model, b, size)
    out: List[Layer] = []
    for x in U.forward_layers(model, b, size):
        if x["name"].endswith(".conv0") and x["name"].startswith("dec"):
            out += gates[int(x["name"][3:x["name"].index(".")])]
        out.append(x)
    return out


def watched(model: Dict[str, Any]) -> Dict[str, List[str]]:
    """reference/unet.py's readings, and the last gate's three kernels."""
    i = model["levels"] - 2
    return dict(U.watched(model),
                **{f"gate{i}_grad1_err": [f"gate{i}/wx/kernel", f"gate{i}/wg/kernel",
                                          f"gate{i}/psi/kernel"]})
