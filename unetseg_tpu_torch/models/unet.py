"""Valid-convolution U-Net (counterpart of unetseg_tpu/models/unet.py).

Same topology and parameter tree as the Flax `UNet`: per level a
`DoubleConv` of two (valid 3x3 conv -> BatchNorm -> ReLU), 2x2 max-pool
between encoder levels, a k=2 s=2 transposed conv (or bilinear
align-corners upsampling) up path, the skip center-cropped with
`center_crop_bounds` and concatenated skip-first, and a 1x1 head with f32
logits. Module names follow the Flax names (`enc0.conv0`, `enc0.bn0`,
`up0_tconv`, `outc`) so utils/flax_bridge.py maps one tree onto the other
by name.

With `ModelConfig.skip_gates` (the port's own: the JAX package has no
gates) it is the Attention U-Net of Oktay et al. (arXiv:1804.03999, Eq.
1-2, in 2-D): before decoder step i the cropped skip x (B, F, 2h, 2w) is
scaled pixel by pixel by alpha, computed by `gate{i}` (AttentionGate) from
x and the up-conv's input g (B, 2F, h, w); `attention_gate` is the
arithmetic every path shares.

In eval mode BatchNorm normalises with its running statistics. In train
mode `UNet.forward` returns `(logits, new_batch_stats)`, the counterpart
of `UNet.apply(train=True, mutable=["batch_stats"])`: `unet_train_forward`
over a flat parameter dict, with the masked train-mode BatchNorm
(`masked_batch_norm`). It is the plain train path; models/train_forward.py
is the kernel one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.core.distributed import all_reduce_sum_autograd
from unetseg_tpu_torch.models.shapes import center_crop_bounds

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last storage when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def center_crop_nhwc(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Center-crop an NHWC tensor to (th, tw) with the reference's bounds
    (start = max(0, (s - t) // 2))."""
    h0, h1 = center_crop_bounds(x.shape[1], th)
    w0, w1 = center_crop_bounds(x.shape[2], tw)
    return x[:, h0:h1, w0:w1, :]


def upsample_bilinear_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling of an NHWC tensor, align_corners=True."""
    y = F.interpolate(
        to_nchw(x), scale_factor=2, mode="bilinear", align_corners=True
    )
    return to_nhwc(y)


def masked_batch_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    running_mean: torch.Tensor, running_var: torch.Tensor,
    momentum: float, eps: float, item_mask: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode MaskedBatchNorm (unetseg_tpu/models/unet.py:82-153) on an
    NCHW tensor -> (y, new running mean, new running var).

    One-pass fp32 statistics E[x^2] - E[x]^2 over (N, H, W), var clamped at
    0; with a per-item mask the sums are weighted and n = sum(mask)*H*W,
    clamped to >= 1. Running stats follow flax's momentum (0.9 keeps 90%)
    with torch's unbiased n/(n-1) variance. The normalisation is one
    per-channel multiply-add in x's dtype. With a process `group` the sums
    (s, sq, n) are summed over its ranks by an all-reduce that autograd
    differentiates (its backward sums the cotangents), so the moments are
    the whole group's batch's."""
    dims = (0, 2, 3)
    hw = x.shape[2] * x.shape[3]
    if item_mask is None:
        n = torch.tensor(float(x.shape[0] * hw), device=x.device)
        s = x.sum(dims, dtype=torch.float32)
        sq = x.square().sum(dims, dtype=torch.float32)
    else:
        wm = item_mask.to(x.dtype)[:, None, None, None]
        n = item_mask.float().sum() * hw
        s = (x * wm).sum(dims, dtype=torch.float32)
        sq = (x.square() * wm).sum(dims, dtype=torch.float32)
    if group is not None:
        c = s.shape[0]
        s, sq, n = all_reduce_sum_autograd(torch.cat([s, sq, n[None]]), group).split([c, c, 1])
        n = n[0]
    n = n.clamp_min(1.0)
    mean = s / n
    mean_sq = sq / n
    var = (mean_sq - mean.square()).clamp_min(0.0)
    unbias = n / (n - 1.0).clamp_min(1.0)
    new_mean = momentum * running_mean + (1 - momentum) * mean
    new_var = momentum * running_var + (1 - momentum) * var * unbias
    a = weight * torch.rsqrt(var + eps)
    b = bias - mean * a
    y = x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]
    return y, new_mean, new_var


class BatchNorm(nn.Module):
    """BatchNorm over channels (NCHW).

    Eval mode matches MaskedBatchNorm(use_running_average=True): fp32
    statistics folded into one per-channel multiply-add, applied in the
    input dtype. Train mode normalises with the batch statistics
    (masked_batch_norm); the updated running statistics are returned by
    the U-Net's train forward, not written into the buffers."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x NCHW
        if self.training:
            return masked_batch_norm(x, self.weight, self.bias, self.running_mean,
                                     self.running_var, 0.9, self.eps)[0]
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * a
        return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


class DoubleConv(nn.Module):
    """(valid 3x3 conv -> BN -> ReLU) x2."""

    def __init__(self, cin: int, features: int, eps: float):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, features, 3)
        self.bn0 = BatchNorm(features, eps)
        self.conv1 = nn.Conv2d(features, features, 3)
        self.bn1 = BatchNorm(features, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x NCHW
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            x = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))
            x = F.relu(bn(x))
        return x


class AttentionGate(nn.Module):
    """The gate of one skip, F skip channels, F_int = F / 2 (the default of
    the authors' gate block): wx a 2x2 stride-2 conv F -> F/2 without bias, wg a
    1x1 conv 2F -> F/2, psi a 1x1 conv F/2 -> 1. No BatchNorm."""

    def __init__(self, f: int):
        super().__init__()
        self.wx = nn.Conv2d(f, f // 2, 2, stride=2, bias=False)
        self.wg = nn.Conv2d(2 * f, f // 2, 1)
        self.psi = nn.Conv2d(f // 2, 1, 1)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:  # NCHW
        return attention_gate(x, g, self.wx.weight, self.wg.weight, self.wg.bias,
                              self.psi.weight, self.psi.bias)


def gate_alpha(
    x: torch.Tensor, g: torch.Tensor, wx: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor,
    psi: torch.Tensor, bpsi: torch.Tensor,
) -> torch.Tensor:
    """alpha (B, 1, h, w) f32 of Eq. 1 at g's grid: sigmoid(psi . ReLU(wx *
    x + wg * g + bg) + bpsi), x (B, F, 2h, 2w) and g (B, 2F, h, w) NCHW.
    The products take x, g, wx and wg in x's dtype and sum in f32, as the
    gate kernel does (ops/kernels/attn_gate.py)."""
    dt = x.dtype
    t = F.conv2d(x.float(), wx.to(dt).float(), stride=2)
    t = t + F.conv2d(g.to(dt).float(), wg.to(dt).float(), bg.float())
    return torch.sigmoid(F.conv2d(F.relu(t), psi.float(), bpsi.float()))


def upsample_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """alpha (B, 1, h, w) -> (B, 1, 2h, 2w), bilinear, align_corners=False."""
    return F.interpolate(alpha, scale_factor=2, mode="bilinear", align_corners=False)


def attention_gate(
    x: torch.Tensor, g: torch.Tensor, wx: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor,
    psi: torch.Tensor, bpsi: torch.Tensor,
) -> torch.Tensor:
    """x_hat = upsample2x(alpha) * x in x's dtype (Eq. 2), NCHW."""
    alpha = upsample_alpha(gate_alpha(x, g, wx, wg, bg, psi, bpsi))
    return (alpha * x.float()).to(x.dtype)


class UNet(nn.Module):
    """Input NHWC (N, H, W, in_channels); output f32 logits
    (N, H', W', num_classes) with H' = H - margin(H). Built in eval mode;
    after .train(), forward returns (logits, new_batch_stats)."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        add_blocks(self, lambda cin, f: DoubleConv(cin, f, cfg.bn_epsilon))
        self.eval()

    def forward(self, x: torch.Tensor, item_mask: Optional[torch.Tensor] = None):
        if self.training:
            return unet_train_forward(
                dict(self.named_parameters()), dict(self.named_buffers()), x,
                self.cfg, item_mask,
            )
        x = trunk(self, to_nchw(x.to(compute_dtype(self.cfg))))
        logits = F.conv2d(x.float(), self.outc.weight, self.outc.bias)
        return to_nhwc(logits)


def create_unet(cfg: Optional[ModelConfig] = None) -> UNet:
    return UNet(cfg or ModelConfig())


def param_count(variables: Union[nn.Module, Mapping[str, Any]]) -> int:
    """Number of parameters of a module (its nn.Parameters; BatchNorm's
    running statistics are buffers) or of a {'params', ...} tree of arrays
    in the Flax layout, as unetseg_tpu/models/unet.py:param_count counts."""
    if isinstance(variables, nn.Module):
        return sum(p.numel() for p in variables.parameters())

    def leaves(tree) -> int:
        if isinstance(tree, Mapping):
            return sum(leaves(v) for v in tree.values())
        return int(np.size(tree))

    return leaves(variables["params"])


def add_blocks(net: nn.Module, make_block: Callable[[int, int], nn.Module]) -> None:
    """Give `net` (with a ModelConfig `net.cfg`) the U-Net's modules under
    the Flax names: enc{k} and dec{i} from make_block(in_channels,
    features), up{i}_tconv, gate{i} where cfg.skip_gates, outc."""
    cfg = net.cfg
    feats = [cfg.base_features * 2**i for i in range(cfg.levels)]
    cin = cfg.in_channels
    for lvl, f in enumerate(feats):
        net.add_module(f"enc{lvl}", make_block(cin, f))
        cin = f
    for i, skip_f in enumerate(reversed(feats[:-1])):
        in_f = feats[-1 - i]
        up_f = in_f if cfg.bilinear else in_f // 2
        if not cfg.bilinear:
            net.add_module(f"up{i}_tconv", nn.ConvTranspose2d(in_f, up_f, 2, stride=2))
        if cfg.skip_gates:
            net.add_module(f"gate{i}", AttentionGate(skip_f))
        net.add_module(f"dec{i}", make_block(skip_f + up_f, skip_f))
    net.outc = nn.Conv2d(feats[0], cfg.num_classes, 1)


def trunk(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Encoder and decoder of a U-Net module with blocks enc{k}, up{i}_tconv
    and dec{i} (UNet or infer.folding.FoldedUNet): NCHW input in the compute
    dtype -> the last decoder block's NCHW output, before the head."""
    dtype = x.dtype

    def tconv(i, h):
        t = getattr(net, f"up{i}_tconv")
        return F.conv_transpose2d(h, t.weight.to(dtype), t.bias.to(dtype), stride=2)

    return trunk_with(net.cfg, x, lambda name, h: getattr(net, name)(h), tconv,
                      lambda i, skip, g: getattr(net, f"gate{i}")(skip, g))


def trunk_with(
    cfg: ModelConfig, x: torch.Tensor,
    block: Callable[[str, torch.Tensor], torch.Tensor],
    tconv: Callable[[int, torch.Tensor], torch.Tensor],
    gate: Optional[Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """The U-Net's encoder and decoder around `block(name, x)` (the
    DoubleConv named enc{k} or dec{i}), `tconv(i, x)` (up{i}_tconv) and,
    where cfg.skip_gates, `gate(i, skip, g)` (gate{i}: the cropped skip
    scaled by its gate, from g, the up-conv's input), all NCHW."""
    skips = []
    for lvl in range(cfg.levels):
        if lvl > 0:
            x = F.max_pool2d(x, 2)  # floors odd sizes
        x = block(f"enc{lvl}", x)
        skips.append(x)

    x = skips[-1]
    for i, skip in enumerate(reversed(skips[:-1])):
        g = x
        if cfg.bilinear:
            x = to_nchw(upsample_bilinear_align_corners(to_nhwc(x)))
        else:
            x = tconv(i, x)
        skip_c = to_nchw(center_crop_nhwc(to_nhwc(skip), x.shape[2], x.shape[3]))
        if cfg.skip_gates:
            skip_c = gate(i, skip_c, g)
        # skip first, as the reference concatenates
        x = torch.cat([skip_c, x.to(skip.dtype)], dim=1)
        x = block(f"dec{i}", x)
    return x


def gate_from(params: Mapping[str, torch.Tensor], i: int, x: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """attention_gate of gate{i} from a flat parameter dict (state-dict
    names), NCHW."""
    p = f"gate{i}"
    return attention_gate(x, g, params[f"{p}.wx.weight"], params[f"{p}.wg.weight"],
                          params[f"{p}.wg.bias"], params[f"{p}.psi.weight"],
                          params[f"{p}.psi.bias"])


def split_state_dict(sd: Mapping[str, torch.Tensor]):
    """Flat state dict -> (params, batch_stats): the running statistics go
    to batch_stats, everything else is a parameter."""
    params, stats = {}, {}
    for k, v in sd.items():
        (stats if k.endswith(("running_mean", "running_var")) else params)[k] = v
    return params, stats


def unet_train_forward(
    params: Mapping[str, torch.Tensor], batch_stats: Mapping[str, torch.Tensor],
    x: torch.Tensor, cfg: ModelConfig, item_mask: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain train-mode forward, UNet.apply(train=True, item_mask=...,
    mutable=["batch_stats"]): x (N, H, W, 1) -> (f32 NHWC logits, new
    batch stats). `params` and `batch_stats` use the state-dict names
    (`enc0.conv0.weight`, `enc0.bn0.running_mean`, ...); the new stats are
    detached. With a process `group` BatchNorm takes the group's global
    moments (the data-parallel step)."""
    dtype = compute_dtype(cfg)
    new_stats: Dict[str, torch.Tensor] = {}

    def block(name: str, h: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            c, bn = f"{name}.conv{i}", f"{name}.bn{i}"
            h = F.conv2d(h, params[f"{c}.weight"].to(dtype), params[f"{c}.bias"].to(dtype))
            h, nm, nv = masked_batch_norm(
                h, params[f"{bn}.weight"], params[f"{bn}.bias"],
                batch_stats[f"{bn}.running_mean"], batch_stats[f"{bn}.running_var"],
                cfg.bn_momentum, cfg.bn_epsilon, item_mask, group,
            )
            new_stats[f"{bn}.running_mean"] = nm.detach()
            new_stats[f"{bn}.running_var"] = nv.detach()
            h = F.relu(h).to(dtype)
        return h

    h = trunk_with(cfg, to_nchw(x.to(dtype)), block,
                   lambda i, h: F.conv_transpose2d(
                       h, params[f"up{i}_tconv.weight"].to(dtype),
                       params[f"up{i}_tconv.bias"].to(dtype), stride=2),
                   lambda i, skip, g: gate_from(params, i, skip, g))
    logits = F.conv2d(h.float(), params["outc.weight"], params["outc.bias"])
    return to_nhwc(logits), new_stats
