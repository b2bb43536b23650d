"""Inputs the benchmark makes from a seed and hands to both the program
and the plain reference: cell frames, instance labels, weight maps,
augmentation draws and the net's variables, whose leaves the
configuration's architecture module lists (reference/<architecture>.py,
leaf_shapes). Imports nothing of the program.

Frozen copies (adapted, and never to be edited to follow the originals):
  cell_frames            chip_smoke.py:1119 (cell_frames), moved from a
                         numpy RandomState on the host to a torch.Generator
                         on the frames' device, all frames at once
  variables              unetseg_tpu_torch/models/fast_init.py:24, the same
                         scales drawn on the device in two calls
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (weights, frames, draws...) of a run."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def cell_frames(g: torch.Generator, n: int, size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frames (n, size, size) f32 in [0, 1], labels (n, size, size) int32):
    15-30 bright elliptic cells (0.70) on a dark background (0.25), plus
    Gaussian noise of std 0.05; cell k is label k + 1, and a later cell
    overwrites an earlier one where they overlap."""
    counts = torch.randint(15, 31, (n,), generator=g, device=device)
    cy, cx = (torch.rand((2, n, 30), generator=g, device=device) * size).unbind(0)
    ry, rx = (torch.rand((2, n, 30), generator=g, device=device) * 30 + 15).unbind(0)
    th = torch.rand((n, 30), generator=g, device=device) * math.pi
    noise = torch.randn((n, size, size), generator=g, device=device)
    yy = torch.arange(size, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(size, device=device, dtype=torch.float32)[None, None, :]
    lab = torch.zeros((n, size, size), dtype=torch.int32, device=device)
    for k in range(30):
        dy, dx = yy - cy[:, k, None, None], xx - cx[:, k, None, None]
        c, s = torch.cos(th[:, k, None, None]), torch.sin(th[:, k, None, None])
        u = (dy * c + dx * s) / ry[:, k, None, None]
        v = (dx * c - dy * s) / rx[:, k, None, None]
        inside = (u * u + v * v < 1) & (k < counts)[:, None, None]
        lab = torch.where(inside, torch.full_like(lab, k + 1), lab)
    frames = (0.25 + 0.45 * (lab > 0).float() + 0.05 * noise).clamp(0.0, 1.0)
    return frames, lab


def weight_maps(labels: torch.Tensor, w0: float = 10.0, sigma: float = 5.0) -> torch.Tensor:
    """Weight maps wc + w0 * border term, on the labels' device: wc balances
    the two classes by their frequency in each frame; the border term is a
    Gaussian blur (sigma) of the pixels whose 3x3 window holds another
    label, scaled to peak at 1 (a cheap stand-in for the paper's
    exp(-(d1 + d2)^2 / 2 sigma^2), with the same range)."""
    fg = (labels > 0).float()
    frac = fg.mean(dim=(1, 2), keepdim=True).clamp(1e-3, 1 - 1e-3)
    wc = torch.where(fg > 0, 0.5 / frac, 0.5 / (1 - frac))
    lab = labels.float()[:, None]
    mx = F.max_pool2d(lab, 3, stride=1, padding=1)
    mn = -F.max_pool2d(-lab, 3, stride=1, padding=1)
    edge = (mx != mn).float()
    r = int(3 * sigma)
    x = torch.arange(-r, r + 1, device=labels.device, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    blur = F.conv2d(edge, k.view(1, 1, 1, -1), padding=(0, r))
    blur = F.conv2d(blur, k.view(1, 1, -1, 1), padding=(r, 0))[:, 0]
    blur = blur / blur.amax(dim=(1, 2), keepdim=True).clamp_min(1e-6)
    return (wc + w0 * blur).contiguous()


def augment_draws(g: torch.Generator, steps: int, batch: int, size: int, aug: Dict[str, float],
                  device) -> List[Dict[str, torch.Tensor]]:
    """The random numbers of `steps` augmented steps, one dict per step:
    elastic (B, 2, H, W) U[-1, 1) (fields behind dx, dy), log_gamma (B,)
    U[-gamma, gamma), illum (B, 4, 4) U[-1, 1), noise_sigma (B,) U[0,
    noise), noise (B, H, W) N(0, 1)."""
    out = []
    for _ in range(steps):
        out.append({
            "elastic": torch.rand((batch, 2, size, size), generator=g, device=device) * 2 - 1,
            "log_gamma": (torch.rand((batch,), generator=g, device=device) * 2 - 1)
            * aug["aug_gamma"],
            "illum": torch.rand((batch, 4, 4), generator=g, device=device) * 2 - 1,
            "noise_sigma": torch.rand((batch,), generator=g, device=device) * aug["aug_noise"],
            "noise": torch.randn((batch, size, size), generator=g, device=device),
        })
    return out


def variables(arch, model: Dict[str, Any], seed: int, device,
              tag: str = "variables") -> Dict[str, Any]:
    """Seeded variables {'params', 'batch_stats'} of the net
    `arch.leaf_shapes(model)` lists, as numpy f32 arrays in the Flax layout
    (HWIO kernels), in its order: kernels N(0, 2 / (kH kW O)) (He
    fan-out), conv biases 0, BatchNorm scale and running var U[0.5, 1.5),
    BatchNorm bias and running mean U[-0.2, 0.2). Drawn on `device` in one
    normal and one uniform call from the stream `tag` of `seed`, then
    copied to the host once."""
    leaves = arch.leaf_shapes(model)
    g = generator(seed, tag, device)
    sizes = [math.prod(s) for _, s, _ in leaves]
    n_kernel = sum(n for n, (_, _, r) in zip(sizes, leaves) if r == "kernel")
    n_uniform = sum(n for n, (_, _, r) in zip(sizes, leaves) if r in ("scale", "shift"))
    normal = torch.randn(n_kernel, generator=g, device=device).cpu().numpy()
    uniform = torch.rand(n_uniform, generator=g, device=device).cpu().numpy()
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    i_n = i_u = 0
    for (path, shape, role), n in zip(leaves, sizes):
        if role == "kernel":
            std = math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
            leaf = normal[i_n:i_n + n].reshape(shape) * np.float32(std)
            i_n += n
        elif role == "zeros":
            leaf = np.zeros(shape, np.float32)
        else:
            u = uniform[i_u:i_u + n].reshape(shape)
            i_u += n
            leaf = u + np.float32(0.5) if role == "scale" else u * np.float32(0.4) - np.float32(0.2)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(leaf, dtype=np.float32)
    return tree
