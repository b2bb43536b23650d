"""The plain reference of the best recipe's train step, followed for the
first steps of a run from the same variables, batches and augmentation
draws as the program. Plain PyTorch in float32; imports nothing of the
program.

One step:
  elastic: each uniform field (B, 2, H, W) blurred by a Gaussian (sigma,
    truncated at 4 sigma, zero outside the frame) and scaled by alpha;
    field 0 displaces x, field 1 y; the sampling coordinates are clamped to
    [-d, n - 2.001 + d], d = ceil(min(8 alpha / (2 sigma sqrt(pi)), alpha))
    + 1; the image is sampled bilinearly and the labels at the nearest
    pixel (halves away from zero), both mirrored at the frame ("reflect":
    d c b a | a b c d | d c b a); the weight maps are not deformed
  photometric: clip to [0, 1], power exp(log_gamma), times 1 + illum x the
    4 x 4 grid resized bilinearly (half-pixel centres, edges clamped)
  standardize: per-item z-score, population std floored at 1e-6
  noise: + noise_sigma x noise
  targets: foreground (labels > 0), or three classes (0 background, 1 a
    foreground pixel whose (2 halo + 1)^2 window, clipped at the frame,
    holds only its label, 2 the other foreground) with the weights times
    border_boost on class 2
  loss: the mean over the batch's pixels of weight x softmax cross-entropy,
    targets and weights centre-cropped to the logits
  backward; Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected with the
    step's count) at the cosine-decayed rate lr 0.5 (1 + cos(pi c / T)),
    c the count before the step, T = epochs x steps an epoch; then the
    EMA: e += (1 - d)(p - e), d = min(decay, (1 + t) / (10 + t)), t the
    count after the step, for the parameters and the running statistics.

The net's forward is the configuration's architecture module's (`arch`,
reference/<architecture>.py), in train mode.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

from reference.common import Tensors, centre_crop

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def gaussian_1d(sigma: float, device) -> torch.Tensor:
    r = int(4.0 * sigma + 0.5)
    x = torch.arange(-r, r + 1, dtype=torch.float64, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).float()


def blur(u: torch.Tensor, sigma: float) -> torch.Tensor:
    """(N, H, W) -> Gaussian blur with zeros outside."""
    k = gaussian_1d(sigma, u.device)
    r = (k.numel() - 1) // 2
    x = F.conv2d(u[:, None], k.view(1, 1, 1, -1), padding=(0, r))
    return F.conv2d(x, k.view(1, 1, -1, 1), padding=(r, 0))[:, 0]


def reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    i = torch.remainder(i, 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def elastic(images, labels, uniforms, alpha, sigma):
    b, _, h, w = uniforms.shape
    field = blur(uniforms.reshape(b * 2, h, w), sigma).reshape(b, 2, h, w) * alpha
    dx, dy = field[:, 0], field[:, 1]
    sd = alpha / (2.0 * sigma * math.sqrt(math.pi))
    d = int(math.ceil(min(8.0 * sd, alpha))) + 1
    rows = torch.arange(h, dtype=torch.float32, device=images.device)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=images.device)[None, None, :]
    yy = (rows + dy).clamp(-d, h - 1 + d - 1.001)
    xx = (cols + dx).clamp(-d, w - 1 + d - 1.001)
    bi = torch.arange(b, device=images.device)[:, None, None]
    y0, x0 = yy.floor(), xx.floor()
    fy, fx = yy - y0, xx - x0
    y0, x0 = y0.long(), x0.long()
    out = 0
    for oy, wy in ((0, 1 - fy), (1, fy)):
        for ox, wx in ((0, 1 - fx), (1, fx)):
            out = out + wy * wx * images[bi, reflect(y0 + oy, h), reflect(x0 + ox, w)]
    ny = (yy.sign() * (yy.abs() + 0.5).floor()).long()
    nx = (xx.sign() * (xx.abs() + 0.5).floor()).long()
    return out, labels[bi, reflect(ny, h), reflect(nx, w)]


def augment(images, labels, weights, draws: Mapping[str, torch.Tensor], aug: Mapping[str, Any],
            three_class: bool, halo: int, border_boost: float):
    x, lab = elastic(images, labels, draws["elastic"], aug["elastic_alpha"], aug["elastic_sigma"])
    x = x.clamp(0.0, 1.0) ** torch.exp(draws["log_gamma"])[:, None, None]
    field = F.interpolate(draws["illum"][:, None], size=x.shape[1:], mode="bilinear",
                          align_corners=False)[:, 0]
    x = x * (1.0 + aug["aug_illum"] * field)
    if aug["standardize"]:
        mu = x.mean(dim=(1, 2), keepdim=True)
        sd = x.std(dim=(1, 2), keepdim=True, correction=0).clamp_min(1e-6)
        x = (x - mu) / sd
    x = x + draws["noise_sigma"][:, None, None] * draws["noise"]
    fg = lab > 0
    if three_class:
        k = 2 * halo + 1
        m = lab.double()[:, None]
        same = (F.max_pool2d(m, k, 1, halo) == -F.max_pool2d(-m, k, 1, halo))[:, 0]
        targets = torch.where(fg & same, 1, torch.where(fg, 2, 0))
        weights = torch.where(targets == 2, weights * border_boost, weights)
    else:
        targets = fg.long()
    return x, targets, weights


def loss_of(params, stats, x, targets, weights, arch, model, quant=None):
    logits, new_stats = arch.forward(params, stats, x[:, None], model, train=True, quant=quant)
    o = logits.shape[-1]
    t, w = centre_crop(targets, o), centre_crop(weights, o)
    ce = F.cross_entropy(logits, t.long(), reduction="none")
    return (ce * w).mean(), new_stats


class Trainer:
    """The reference's training state and step: parameters (requiring
    gradients), running statistics, Adam's moments, the step count and
    the EMA shadows."""

    def __init__(self, params: Tensors, stats: Tensors, recipe: Mapping[str, Any],
                 steps_per_epoch: int, count: int = 0, quant: Optional[Callable] = None):
        self.params = {k: v.clone() for k, v in params.items()}
        self.stats = {k: v.clone() for k, v in stats.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.ema = {k: v.clone() for k, v in params.items()}
        self.ema_stats = {k: v.clone() for k, v in stats.items()}
        self.count = count
        self.recipe = recipe
        self.decay_steps = recipe["num_epochs"] * steps_per_epoch
        self.quant = quant

    def lr(self) -> float:
        c = min(self.count, self.decay_steps)
        return self.recipe["learning_rate"] * 0.5 * (1 + math.cos(math.pi * c / self.decay_steps))

    def step(self, images, labels, weights, draws, arch, model: Mapping[str, Any],
             three_class: bool, halo: int, border_boost: float) -> Dict[str, Any]:
        """One step; returns {"loss", "grads"}."""
        x, t, w = augment(images, labels, weights, draws, self.recipe, three_class, halo,
                          border_boost)
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        with torch.enable_grad():
            loss, new_stats = loss_of(params, self.stats, x, t, w, arch, model, self.quant)
            keys = list(params)
            grads = dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])))
        lr, n = self.lr(), self.count + 1
        c1, c2 = 1 - B1 ** n, 1 - B2 ** n
        for k in keys:
            g = grads[k]
            self.mu[k] = B1 * self.mu[k] + (1 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + ADAM_EPS)
            self.params[k] = self.params[k] - lr * upd
        self.stats = new_stats
        self.count = n
        d = min(self.recipe["ema_decay"], (1.0 + n) / (10.0 + n))
        self.ema = {k: e + (1 - d) * (self.params[k] - e) for k, e in self.ema.items()}
        self.ema_stats = {k: e + (1 - d) * (self.stats[k] - e) for k, e in self.ema_stats.items()}
        return {"loss": float(loss.detach()), "grads": {k: g.detach() for k, g in grads.items()}}


def follow(params: Tensors, stats: Tensors, batches: List[tuple], draws: List[Mapping],
           recipe: Mapping[str, Any], steps_per_epoch: int, count: int, arch,
           model: Mapping[str, Any], three_class: bool, halo: int, border_boost: float,
           quant: Optional[Callable] = None) -> Dict[str, Any]:
    """Run the reference over `batches` [(images, labels, weights)] with
    their draws, from step `count` of the schedule with fresh moments and
    shadows. -> {"losses", "grads1" (the first step's gradients),
    "trainer" (the state after the last step)}."""
    tr = Trainer(params, stats, recipe, steps_per_epoch, count, quant)
    losses, grads1 = [], None
    for (images, labels, weights), dr in zip(batches, draws):
        out = tr.step(images, labels, weights, dr, arch, model, three_class, halo, border_boost)
        losses.append(out["loss"])
        grads1 = out["grads"] if grads1 is None else grads1
    return {"losses": losses, "grads1": grads1, "trainer": tr}
