"""The yardstick's arithmetic: operations and bytes of a net's logical
layers from their shapes, the published peaks of one NVIDIA H100, and
the roofline bound of a call or a step.

Counted by logical layer, never by kernel name, so a count reads the same
work whatever implements it. A layer's bound is max(ops / peak, bytes /
HBM bandwidth), with each input read once and each output written once.
Convolutions (and in training their input and weight gradients) count at
the bf16 tensor-core peak; elementwise layers at the f32 peak. A
convolution's bias and ReLU are part of its layer. Layers that only move
what a neighbour counts (a skip's crop and concat, which the next conv
reads as its input; a flip, which is indexing) count no bytes of their
own, and an elementwise layer whose input is the previous layer's output
counts its output only.

The net's own layers come from its architecture module
(reference/<architecture>.py: forward_layers, leaf_shapes), which every
function here that needs them takes as `arch`; this module imports none.
`shapes` and `tile_grid` are the valid-conv geometry every such net keeps.

Frozen copies: conv_ops and bound_s from chip_smoke.py:654 (conv_ops) and
chip_smoke.py:675 (add_bound), the peaks from chip_smoke.py:393.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor cores, f32 outside the
# tensor cores, HBM3 bandwidth; stated at the card's full power limit of
# 700 W (a run reports its card's limit as device.power_limit_w)
PEAK_BF16, PEAK_F32, HBM_BPS = 989e12, 67e12, 3.35e12
BF16, F32 = 2, 4

Layer = Dict[str, Any]


def conv_ops(b, ho, wo, ci, co, taps=9):
    """Multiply-adds x 2 of a convolution with (b, ho, wo, co) outputs."""
    return 2 * b * ho * wo * ci * co * taps


def bound_s(ops: float, peak: float, n_bytes: float) -> float:
    """The least time of one layer: max(operations / peak, bytes / HBM)."""
    return max(ops / peak, n_bytes / HBM_BPS)


def layer(name: str, ops: float, in_bytes: float, out_bytes: float, peak: float,
          w_bytes: float = 0.0, conv: bool = False, bn_relu: bool = False,
          dgrad: bool = False, grad_in_bytes: float = 0.0) -> Layer:
    """One logical layer: activations read (`in_bytes`), weights read
    (`w_bytes`), output written (`out_bytes`). What a train step adds to it
    (train_step): a convolution's output passes BatchNorm + ReLU where
    `bn_relu`, and its input gradient is computed where `dgrad`; any other
    layer's backward reads its output's gradient and writes
    `grad_in_bytes`, its input's."""
    n_bytes = in_bytes + w_bytes + out_bytes
    return {"name": name, "ops": float(ops), "in_bytes": float(in_bytes),
            "w_bytes": float(w_bytes), "out_bytes": float(out_bytes), "bytes": float(n_bytes),
            "peak": peak, "conv": conv, "bn_relu": bn_relu, "dgrad": dgrad,
            "grad_in_bytes": float(grad_in_bytes), "bound_s": bound_s(ops, peak, n_bytes)}


def scaled(x: Layer, k: float) -> Layer:
    """A layer run k times over (the weights are read each time)."""
    return dict(x, **{key: x[key] * k for key in ("ops", "in_bytes", "w_bytes", "out_bytes",
                                                  "bytes", "grad_in_bytes", "bound_s")})


def shapes(size: int, levels: int) -> Dict[str, Any]:
    """The spatial size at every stage of the valid-conv U-Net: each block's
    (input, output) and the net's output (the paper's 572 -> 388). Odd
    sizes pool by floor."""
    enc, s = [], size
    for lvl in range(levels):
        if lvl > 0:
            s //= 2
        enc.append((s, s - 4))
        s -= 4
        if s < 1:
            raise ValueError(f"input {size}: encoder level {lvl} collapses")
    dec = []
    for _, skip_out in reversed(enc[:-1]):
        s *= 2
        if skip_out < s:
            raise ValueError(f"input {size}: skip {skip_out} under the up-conv's {s}")
        dec.append((s, s - 4))
        s -= 4
        if s < 1:
            raise ValueError(f"input {size}: decoder collapses")
    return {"enc": enc, "dec": dec, "out": s}


def model_flops(layers: List[Layer]) -> float:
    """2 x multiply-adds of every convolution (and, in a train step, of
    their gradients)."""
    return sum(x["ops"] for x in layers if x["conv"])


def total_bound_s(layers: List[Layer]) -> float:
    return sum(x["bound_s"] for x in layers)


def tile_grid(h: int, tile_in: int, levels: int) -> Dict[str, int]:
    """Overlap-tile geometry of an h x h frame: outputs tile the frame at the
    tile's output size; the input is mirror-padded by half the margin."""
    t_out = shapes(tile_in, levels)["out"]
    n = math.ceil(h / t_out)
    return {"tile_out": t_out, "per_side": n, "tiles": n * n}


def serve_call(arch, model: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    """One masks call: frames x tiles in forward chunks of tile_batch, for
    each member and each TTA flip, each forward ending in the class
    probabilities (softmax and the threshold), with the tile extraction,
    stitching, merges and the uint8 masks. -> {"layers", "model_flops",
    "bound_s", "forwards"} for the whole call."""
    f, h, t_in, tb = (traffic[k] for k in ("frames", "size", "tile_input", "tile_batch"))
    grid = tile_grid(h, t_in, model["levels"])
    flips = {"none": 1, "flips": 4, "flips8": 8}[traffic["tta"]]
    members = traffic["members"]
    chunks = math.ceil(f * grid["tiles"] / tb)
    forwards = members * flips * chunks
    o, n_pad, nc = grid["tile_out"], chunks * tb, model["num_classes"]
    forward = arch.forward_layers(model, tb, t_in) + [
        layer("softmax_threshold", 5 * tb * o * o * nc, 0, tb * o * o * F32, PEAK_F32)]
    layers = [scaled(x, forwards) for x in forward] + [
        layer("tiles", 4 * flips * n_pad * t_in * t_in, f * h * h * F32,
              flips * n_pad * t_in * t_in * F32, PEAK_F32),
        layer("stitch_flip", flips * f * h * h, 0, flips * f * h * h * F32, PEAK_F32),
        layer("masks", 2 * flips * f * h * h, 0, f * h * h, PEAK_F32),
    ]
    if members > 1:
        layers.append(layer("ensemble_vote", 2 * members * flips * n_pad * o * o, 0,
                            flips * n_pad * o * o * F32, PEAK_F32))
    return {"layers": layers, "model_flops": model_flops(layers),
            "bound_s": total_bound_s(layers), "forwards": forwards}


def param_count(arch, model: Dict[str, Any]) -> Dict[str, int]:
    """{"params": parameters, "stats": BatchNorm running statistics} of the
    net's variables (arch.leaf_shapes)."""
    n = {"params": 0, "batch_stats": 0}
    for path, shape, _ in arch.leaf_shapes(model):
        n[path.split("/")[0]] += math.prod(shape)
    return {"params": n["params"], "stats": n["batch_stats"]}


def train_step(arch, model: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    """One augmented train step on a batch of `batch` frames of `size`^2:
    the augmentation, the net's forward layers (each convolution's output
    through BatchNorm + ReLU where the layer says so), the loss, the
    backward (weight gradients of every convolution, input gradients where
    the layer says so; BatchNorm + ReLU backward; the other layers'
    backward), and the Adam + EMA update. -> {"layers", "model_flops",
    "bound_s"}."""
    b, s = traffic["batch"], traffic["size"]
    layers: List[Layer] = []
    for x in arch.forward_layers(model, b, s):
        name = x["name"]
        layers.append(dict(x, name=name + ".fwd"))
        act = x["out_bytes"]
        if x["conv"]:
            if x["bn_relu"]:
                layers.append(layer(name + ".bn_relu", 4 * act / BF16, act, act, PEAK_F32))
                layers.append(layer(name + ".bn_relu.bwd", 8 * act / BF16, 2 * act, act,
                                    PEAK_F32))
            if x["dgrad"]:  # read g and w, write dx
                layers.append(layer(name + ".dgrad", x["ops"], act, x["in_bytes"], PEAK_BF16,
                                    w_bytes=x["w_bytes"], conv=True))
            # wgrad: read x and g, write dw (f32)
            layers.append(layer(name + ".wgrad", x["ops"], x["in_bytes"] + act,
                                2 * x["w_bytes"], PEAK_BF16, conv=True))
        else:  # read the output's gradient, write the input's
            layers.append(layer(name + ".bwd", x["ops"], act, x["grad_in_bytes"], PEAK_F32))
    o = shapes(s, model["levels"])["out"]
    nc = model["num_classes"]
    layers.append(layer("loss", 20 * b * o * o * nc, b * o * o * (nc * F32 + 4 + F32),
                        b * o * o * nc * F32, PEAK_F32))
    n = param_count(arch, model)
    layers.append(layer("adam_ema", 20 * n["params"] + 4 * n["stats"],
                        5 * F32 * n["params"] + 2 * F32 * n["stats"],
                        4 * F32 * n["params"] + F32 * n["stats"], PEAK_F32))
    # elastic fields blurred by a Gaussian of 2 round(4 sigma) + 1 taps along
    # each axis, sampled, photometric, standardised, noised; targets
    taps = 2 * int(4.0 * traffic["elastic_sigma"] + 0.5) + 1
    layers.append(layer("augment", 2 * b * 2 * 2 * taps * s * s + 30 * b * s * s,
                        b * s * s * (F32 + 4 + F32 + 2 * F32 + F32), b * s * s * (F32 + 4 + F32),
                        PEAK_F32))
    return {"layers": layers, "model_flops": model_flops(layers),
            "bound_s": total_bound_s(layers)}

