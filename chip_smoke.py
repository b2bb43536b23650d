#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (unetseg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with the card and the CUDA
toolkit: `python3 chip_smoke.py`. The phases run in order, each prints
its own line, and any failure raises (non-zero exit):

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build the eight kernels from unetseg_tpu_torch/csrc (one nvcc per
   source, in parallel) and print ptxas's register and spill lines;
3. serving-kernel parity at the serving path's full-width shapes (700^2
   tiles, base 64, batch 16): kernel on bf16 inputs against its plain
   version in fp32 (TF32 off) on the same values, plus both times;
4. serving path: Predictor.masks_tiled on 16 seeded synthetic 512^2 cell
   frames at full width, with seeded He-scaled weights, random BatchNorm
   statistics and a planted intensity path (see plant_intensity_path);
   checks the uint8 masks, that its four kernels launched, finite logits,
   and >= 0.999 pixel agreement with the plain forward on the card, and
   times it with CUDA events;
5. train-kernel parity at the train step's full-width shapes (batch 4,
   512^2 input): dgrad, wgrad, the decoder-entry wgrad, the elastic
   sampler, and the forward kernels with relu=False, same bound;
6. train path: make_train_step with the best recipe's options (Adam 3e-4,
   cosine, EMA 0.999, standardize, elastic 2000/20, gamma / illumination /
   noise) on 4 seeded synthetic 512^2 frames with instance labels and
   reference weight maps, full width; checks that every kernel but the
   head launched, finite loss and grad_norm, moved params and EMA; holds
   one step's gradients through the kernels against the plain path in
   fp32 beside the plain path in bf16; times kernel and plain bf16 steps
   the same number of times, alternating which goes first, and prints a
   torch.profiler table (top 10 operations) of three kernel-path steps.

The last two lines are the kernels' JSON record and {"ok": true,
"device": {...}}; the line before them is nvidia-smi's name and power
limit.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from unetseg_tpu_torch.core.config import InferConfig, ModelConfig, TrainConfig
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.infer.folding import FoldedUNet
from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels
from unetseg_tpu_torch.infer.tiling import (
    extract_tiles,
    make_tiled_mask_batch_fn,
    min_tile_input,
    mirror_pad,
    plan_tiles,
)
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.models.shapes import unet_shapes
from unetseg_tpu_torch.models.train_forward import train_forward
from unetseg_tpu_torch.models.unet import to_nchw, to_nhwc, unet_train_forward
from unetseg_tpu_torch.ops.elastic import displaced_coords, draw_elastic
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT
from unetseg_tpu_torch.ops.kernels import elastic as KE
from unetseg_tpu_torch.ops.kernels.build import build, nvcc_path
from unetseg_tpu_torch.ops.losses import binary_probs_from_logits
from unetseg_tpu_torch.train.state import create_train_state
from unetseg_tpu_torch.train.steps import (
    draw_augment,
    loss_and_grads,
    make_augmenter,
    make_train_step,
)

FRAMES, SIZE = 16, 512
BATCH = 16  # tiles per forward chunk: one 700^2 tile per 512^2 frame
SEED = 0
# Tolerance of a kernel against its fp32 plain version: |k - ref| <=
# ATOL_REL * std(ref) + RTOL * |ref| (+ head slack). The kernels round their
# output to bf16 (relative error <= 2^-9 ~ 2e-3) and sum in another order in
# f32. The head kernel also rounds its 64-channel activation to bf16 before
# the f32 head product, as the bf16 network stores it; the fp32 plain
# version does not, so its logits may differ by up to 2^-9 * sum_c |a_c k_c|
# per pixel: the head's bound adds twice that (HEAD_SLACK * sum |a||k|).
# On an H100 the worst err/bound was 0.34 without the head, and 1.01 for the
# head before the slack term.
RTOL, ATOL_REL = 1e-2, 1e-2
HEAD_SLACK = 2.0**-8
AGREEMENT_BAR = 0.999  # BASELINE.md's bf16 pixel-agreement bar

SOURCES = {
    "conv3x3_bias_relu": ("unetseg_tpu_torch/csrc/conv3x3_bias_relu.cu",
                          "unetseg_tpu/ops/pallas/conv3x3.py:377"),
    "tconv2x2_bias": ("unetseg_tpu_torch/csrc/tconv2x2_bias.cu",
                      "unetseg_tpu/ops/pallas/conv3x3.py:783"),
    "dec_conv0": ("unetseg_tpu_torch/csrc/dec_conv0.cu",
                  "unetseg_tpu/ops/pallas/conv3x3.py:893"),
    "conv3x3_head": ("unetseg_tpu_torch/csrc/conv3x3_head.cu",
                     "unetseg_tpu/ops/pallas/conv3x3.py:540"),
    "conv3x3_dgrad": ("unetseg_tpu_torch/csrc/conv3x3_dgrad.cu",
                      "unetseg_tpu/ops/pallas/conv3x3_train.py:74"),
    "conv3x3_wgrad": ("unetseg_tpu_torch/csrc/conv3x3_wgrad.cu",
                      "unetseg_tpu/ops/pallas/conv3x3_train.py:197"),
    "conv3x3_dec0_wgrad": ("unetseg_tpu_torch/csrc/conv3x3_wgrad.cu",
                           "unetseg_tpu/ops/pallas/conv3x3_train.py:616"),
    "sample_displaced": ("unetseg_tpu_torch/csrc/sample_displaced.cu",
                         "unetseg_tpu/ops/pallas/elastic.py:103"),
}
SERVING = ("conv3x3_bias_relu", "tconv2x2_bias", "dec_conv0", "conv3x3_head")
TRAINING = ("conv3x3_bias_relu", "tconv2x2_bias", "dec_conv0", "conv3x3_dgrad",
            "conv3x3_wgrad", "conv3x3_dec0_wgrad", "sample_displaced")

# The train step: batch 4 at 512^2 (TrainConfig.batch_size,
# DataConfig.image_size) with configs/best_recipe.json's options.
TRAIN_BATCH, TRAIN_SIZE, TRAIN_MODEL = 4, 512, ModelConfig()
DEVICE = "cuda"
RECIPE = dict(augment=True, elastic_alpha=2000.0, elastic_sigma=20.0, standardize=True,
              aug_gamma=0.35, aug_illum=0.15, aug_noise=0.05)
RECIPE_TRAIN = TrainConfig(optimizer="adam", learning_rate=3e-4, cosine_decay=True,
                           num_epochs=80, ema_decay=0.999)
STEPS_PER_EPOCH = 38  # 152 training frames / batch 4
SAMPLER_ATOL = 1e-5
# kernel path's gradient error against the fp32 plain path, per tensor:
# at most max(GRAD_FACTOR x the plain bf16 path's error, GRAD_FLOOR)
GRAD_FACTOR, GRAD_FLOOR, LOSS_RTOL = 2.0, 1e-2, 1e-2
TIMING_ROUNDS = 4  # timed runs of each train path, alternating which goes first


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, with CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, ref, slack=0.0):
    """Max abs error of a kernel output against its fp32 reference; raises
    when any element is outside the tolerance (plus `slack`)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bound = ATOL_REL * ref.std() + RTOL * ref.abs() + slack
    worst = (err / bound).max().item()
    max_err = err.max().item()
    finite = bool(torch.isfinite(got).all())
    print(f"parity {name}: shape {tuple(got.shape)} max_abs_err {max_err:.3e} "
          f"ref_std {ref.std().item():.3e} worst err/bound {worst:.3f}", flush=True)
    if not finite or worst > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(finite={finite}, worst err/bound {worst:.3f})")
    return max_err


def he(g, *shape, fan_out):
    """He-scaled f32 weights holding bf16 values, so the kernel (which reads
    weights in bf16) and the fp32 plain version see the same numbers."""
    w = torch.randn(*shape, generator=g, device="cuda") * (2.0 / fan_out) ** 0.5
    return w.to(torch.bfloat16).float()


def head_slack(x, w, b, k_head, b_head):
    """HEAD_SLACK * sum_c |a_c| |k_c| per pixel, a = the fp32 activation."""
    a = K.conv3x3_bias_relu_plain(x, w, b)
    return HEAD_SLACK * to_nhwc(F.conv2d(to_nchw(a).abs(), k_head.abs()))


@torch.inference_mode()
def kernel_parity(sh, c=64):
    """Each kernel at the main path's shapes against its plain version."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda").to(bf)

    s = sh.input_size
    e0, up_w = sh.encoder[0], sh.crops[-1]
    off = (e0 - up_w) // 2
    cases = {
        "stem": ("conv3x3_bias_relu", K.conv3x3_bias_relu, K.conv3x3_bias_relu_plain,
                 (rand(BATCH, s, s, 1), he(g, c, 1, 3, 3, fan_out=9 * c),
                  0.1 * torch.randn(c, generator=g, device="cuda")), {}),
        "enc0_conv1_pool": ("conv3x3_bias_relu", K.conv3x3_bias_relu,
                            K.conv3x3_bias_relu_plain,
                            (rand(BATCH, s - 2, s - 2, c), he(g, c, c, 3, 3, fan_out=9 * c),
                             0.1 * torch.randn(c, generator=g, device="cuda")),
                            {"fuse_pool": True}),
        "up3": ("tconv2x2_bias", K.tconv2x2_bias, K.tconv2x2_bias_plain,
                (rand(BATCH, up_w // 2, up_w // 2, 2 * c), he(g, 2 * c, c, 2, 2, fan_out=4 * c),
                 0.1 * torch.randn(c, generator=g, device="cuda")), {}),
        "dec3_conv0": ("dec_conv0", K.dec_conv0, K.dec_conv0_plain,
                       (rand(BATCH, e0, e0, c), rand(BATCH, up_w, up_w, c),
                        he(g, c, 2 * c, 3, 3, fan_out=9 * c),
                        0.1 * torch.randn(c, generator=g, device="cuda"), off, off), {}),
        "dec3_conv1_head": ("conv3x3_head", K.conv3x3_head, K.conv3x3_head_plain,
                            (rand(BATCH, up_w - 2, up_w - 2, c), he(g, c, c, 3, 3, fan_out=9 * c),
                             0.1 * torch.randn(c, generator=g, device="cuda"),
                             he(g, 2, c, 1, 1, fan_out=2),
                             0.1 * torch.randn(2, generator=g, device="cuda")), {}),
    }
    stats = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in SOURCES}
    run_cases(cases, stats, BATCH)
    return stats


def f32(*ts):
    """bf16 activations -> f32; weights, biases, offsets as they are."""
    return [t.float() if isinstance(t, torch.Tensor) else t for t in ts]


def run_cases(cases, stats, batch):
    """Each case's kernel against its plain version in fp32 on the same
    values (compare's bound), then both timed on the bf16 tensors; the
    errors and times accumulate per kernel into `stats`."""
    for case, (kname, kernel, plain, args, kw) in cases.items():
        got = kernel(*args, **kw)
        ref = plain(*f32(*args), **kw)
        torch.cuda.synchronize()
        slack = head_slack(*f32(*args)) if kname == "conv3x3_head" else 0.0
        pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
        err = max(compare(f"{case}[{i}]", a, b, slack) for i, (a, b) in enumerate(pairs))
        del got, ref, pairs, slack
        ms = cuda_ms(lambda: kernel(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw))  # same bf16 tensors (cuDNN)
        print(f"time {case}: kernel {ms:.3f} ms, plain bf16 {plain_ms:.3f} ms "
              f"(batch {batch})", flush=True)
        st = stats[kname]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["ms"] += ms
        st["plain_ms"] += plain_ms


def cell_frames(rs, n, size, labels=False):
    """Synthetic frames: 15-30 bright elliptic cells (0.70) on a dark
    background (0.25), plus Gaussian noise of std 0.05. With labels, also
    the int32 instance labels (cell k is k + 1; a later cell overwrites an
    earlier one where they overlap)."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    frames, labs = [], []
    for _ in range(n):
        cells = np.zeros((size, size), bool)
        lab = np.zeros((size, size), np.int32)
        for k in range(rs.randint(15, 31)):
            cy, cx = rs.uniform(0, size, 2)
            ry, rx = rs.uniform(15, 45, 2)
            th = rs.uniform(0, np.pi)
            dy, dx = yy - cy, xx - cx
            u = (dy * np.cos(th) + dx * np.sin(th)) / ry
            v = (dx * np.cos(th) - dy * np.sin(th)) / rx
            inside = u * u + v * v < 1
            cells |= inside
            lab[inside] = k + 1
        img = 0.25 + 0.45 * cells + 0.05 * rs.standard_normal((size, size))
        frames.append(np.clip(img, 0.0, 1.0))
        labs.append(lab)
    frames = np.stack(frames).astype(np.float32)
    return (frames, np.stack(labs)) if labels else frames


def weight_map(labels, w0=10.0, sigma=5.0):
    """The reference's pixel weight map (scripts/preprocess_data.py:17-77,
    w0 10, sigma 5): class-balance weights plus w0 exp(-(d1 + d2)^2 /
    (2 sigma^2)), d1 and d2 the two smallest per-cell distances, each
    min(EDT(cell), EDT(not cell)) as the reference computes it."""
    from scipy.ndimage import distance_transform_edt as edt

    fg = labels > 0
    n_fg, total = int(fg.sum()), fg.size
    wc = np.where(fg, total / max(n_fg, 1), total / max(total - n_fg, 1))
    dists = [np.minimum(edt(labels == k), edt(labels != k))
             for k in np.unique(labels[fg])]
    if len(dists) >= 2:
        d1, d2 = np.partition(np.stack(dists, -1), 1, axis=-1)[..., :2].transpose(2, 0, 1)
    else:
        d1 = dists[0] if dists else np.zeros(labels.shape)
        d2 = np.zeros(labels.shape)
    sep = w0 * np.exp(-((d1 + d2) ** 2) / (2 * (sigma**2 + 1e-8)))
    return (wc + sep).astype(np.float32)


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


@torch.inference_mode()
def main_path(gpu):
    """Predictor.masks_tiled at full width through the kernels."""
    cfg = ModelConfig()
    variables = plant_intensity_path(fast_random_variables(cfg, SEED))
    frames = cell_frames(np.random.RandomState(SEED), FRAMES, SIZE)
    tile = min_tile_input(SIZE)
    pred = Predictor(cfg, variables, InferConfig(tile_input=tile, tile_batch=BATCH), "cuda")
    if not pred.uses_kernels:
        raise AssertionError("Predictor did not select the kernel forward")

    pred.masks_tiled(frames)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    K.reset_launch_counts()
    masks = pred.masks_tiled(frames)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"main path: masks {masks.shape} {masks.dtype}, launches {launches}", flush=True)
    if masks.shape != (FRAMES, SIZE, SIZE) or masks.dtype != np.uint8:
        raise AssertionError(f"masks {masks.shape} {masks.dtype}")
    if set(np.unique(masks)) - {0, 1}:
        raise AssertionError("masks are not binary")
    missing = [k for k in SERVING if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")

    grid = plan_tiles(SIZE, SIZE, tile)
    x = torch.from_numpy(frames).cuda()
    tiles = extract_tiles(mirror_pad(x, grid), grid).reshape(-1, tile, tile)
    logits = folded_forward_kernels(pred.folded, tiles[..., None])
    o = unet_shapes(tile).output_size
    if logits.shape != (FRAMES, o, o, 2) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or misshapen")
    # the plain forward in fp32 (TF32 off) is the reference the masks are
    # held to; the plain bf16 forward is reported beside it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref32 = FoldedUNet(dataclasses.replace(cfg, compute_dtype="float32")).cuda()
    ref32.load_state_dict(pred.folded.state_dict())
    fns = {
        name: make_tiled_mask_batch_fn(
            lambda c, net=net: binary_probs_from_logits(net(c[..., None])), grid,
            n_frames=FRAMES, threshold=pred.cfg.threshold, tile_batch=BATCH,
        )
        for name, net in (("fp32", ref32), ("bf16", pred.folded))
    }
    plain = {name: fn(x).cpu().numpy() for name, fn in fns.items()}
    l32 = ref32(tiles[..., None])
    l16 = pred.folded(tiles[..., None])
    margin32 = (l32[..., 1] - l32[..., 0]).abs()

    def rel(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.std()).item()

    print(f"main path: logits rms difference / std: kernel vs fp32 {rel(logits, l32):.3e}, "
          f"plain bf16 vs fp32 {rel(l16, l32):.3e}; fp32 |logit margin| < 1e-2 at "
          f"{float((margin32 < 1e-2).float().mean()):.5f} of pixels", flush=True)
    agreement = float((plain["fp32"] == masks).mean())
    agree16 = float((plain["bf16"] == masks).mean())
    agree16_32 = float((plain["bf16"] == plain["fp32"]).mean())
    print(f"main path: foreground fraction {float(masks.mean()):.4f} "
          f"(plain fp32 {float(plain['fp32'].mean()):.4f}); pixel agreement with the plain "
          f"fp32 forward {agreement:.6f}, with the plain bf16 forward {agree16:.6f} "
          f"(plain bf16 vs fp32 {agree16_32:.6f})", flush=True)
    if agreement < AGREEMENT_BAR:
        raise AssertionError(f"agreement {agreement:.6f} < {AGREEMENT_BAR}")
    plain_fn = fns["bf16"]

    ms = cuda_ms(lambda: pred.masks_tiled(frames), iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: plain_fn(x), iters=5, warmup=1)
    mpix = FRAMES * SIZE * SIZE / 1e6 / (ms / 1e3)
    print(f"main path: {ms:.2f} ms per {FRAMES} frames = {mpix:.2f} MPix/s "
          f"(plain bf16 forward: {plain_ms:.2f} ms = "
          f"{FRAMES * SIZE * SIZE / 1e6 / (plain_ms / 1e3):.2f} MPix/s) on {gpu}", flush=True)
    return launches


@torch.inference_mode()
def train_kernel_parity(stats, c=64):
    """The train step's kernels at its full-width shapes (batch 4, 512^2
    input) against their plain versions, plus the forward kernels with
    relu=False."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sh = unet_shapes(TRAIN_SIZE)
    b, s = TRAIN_BATCH, TRAIN_SIZE
    e0, up_w = sh.encoder[0], sh.crops[-1]
    off = (e0 - up_w) // 2

    def act(*shape):
        return torch.rand(*shape, generator=g, device="cuda").to(torch.bfloat16)

    def grad(*shape):  # output gradients have both signs
        return (torch.rand(*shape, generator=g, device="cuda") - 0.5).to(torch.bfloat16)

    def bias(n):
        return 0.1 * torch.randn(n, generator=g, device="cuda")

    w64, w128 = he(g, c, c, 3, 3, fan_out=9 * c), he(g, c, 2 * c, 3, 3, fan_out=9 * c)
    dg, wg = ("conv3x3_dgrad", KT.conv3x3_dgrad, KT.conv3x3_dgrad_plain), \
        ("conv3x3_wgrad", KT.conv3x3_wgrad, KT.conv3x3_wgrad_plain)
    fw = ("conv3x3_bias_relu", K.conv3x3_bias_relu, K.conv3x3_bias_relu_plain)
    nr = {"relu": False}
    cases = {
        "dgrad_enc0_conv1": (*dg, (grad(b, s - 4, s - 4, c), w64), {}),
        "dgrad_dec3_conv1": (*dg, (grad(b, up_w - 4, up_w - 4, c), w64), {}),
        "dgrad_dec3_conv0": (*dg, (grad(b, up_w - 2, up_w - 2, c), w128), {}),
        "wgrad_stem": (*wg, (act(b, s, s, 1), grad(b, s - 2, s - 2, c)), {}),
        "wgrad_enc0_conv1": (*wg, (act(b, s - 2, s - 2, c), grad(b, s - 4, s - 4, c)), {}),
        "wgrad_dec3_conv1": (*wg, (act(b, up_w - 2, up_w - 2, c),
                                   grad(b, up_w - 4, up_w - 4, c)), {}),
        "dec0_wgrad_dec3_conv0": ("conv3x3_dec0_wgrad", KT.conv3x3_dec0_wgrad,
                                  KT.conv3x3_dec0_wgrad_plain,
                                  (act(b, e0, e0, c), act(b, up_w, up_w, c),
                                   grad(b, up_w - 2, up_w - 2, c), off, off), {}),
        "stem_relu_false": (*fw, (act(b, s, s, 1), he(g, c, 1, 3, 3, fan_out=9 * c), bias(c)), nr),
        "enc0_conv1_relu_false": (*fw, (act(b, s - 2, s - 2, c), w64, bias(c)), nr),
        "dec3_conv0_relu_false": ("dec_conv0", K.dec_conv0, K.dec_conv0_plain,
                                  (act(b, e0, e0, c), act(b, up_w, up_w, c), w128, bias(c),
                                   off, off), nr),
        "dec3_conv1_relu_false": (*fw, (act(b, up_w - 2, up_w - 2, c), w64, bias(c)), nr),
    }
    run_cases(cases, stats, b)

    # the elastic sampler: real recipe fields on synthetic cell frames
    frames, labels = cell_frames(np.random.RandomState(SEED + 2), b, s, labels=True)
    images, masks = torch.from_numpy(frames).cuda(), torch.from_numpy(labels).cuda()
    yy, xx = displaced_coords(draw_elastic(g, b, s, s, "cuda"), RECIPE["elastic_alpha"],
                              RECIPE["elastic_sigma"])
    img, mask = KE.sample_displaced(images, masks, yy, xx)
    ref_img, ref_mask = KE.sample_displaced_plain(images, masks, yy, xx)
    torch.cuda.synchronize()
    err = (img - ref_img).abs().max().item()
    exact = bool(torch.equal(mask, ref_mask))
    print(f"parity sample_displaced: shape {tuple(img.shape)} image max_abs_err {err:.3e} "
          f"(bound {SAMPLER_ATOL:g}), masks exact: {exact}; max |displacement| "
          f"{(yy - torch.arange(s, device='cuda')[None, :, None]).abs().max().item():.1f} px",
          flush=True)
    if not (err <= SAMPLER_ATOL and exact and bool(torch.isfinite(img).all())):
        raise AssertionError("sample_displaced disagrees with its plain version")
    ms = cuda_ms(lambda: KE.sample_displaced(images, masks, yy, xx))
    plain_ms = cuda_ms(lambda: KE.sample_displaced_plain(images, masks, yy, xx))
    print(f"time sample_displaced: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(batch {b})", flush=True)
    stats["sample_displaced"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def zero_grad_params(name):
    """Parameters whose true gradient is exactly 0: every conv bias that
    feeds a BatchNorm, directly (enc*/dec* conv biases) or through the
    next conv (up*_tconv biases: a per-channel shift of the conv's input
    is a per-channel shift of its output, which BN's mean removes). Their
    gradients are float noise on every path, so they are left out of the
    relative-error comparison (tests/test_lanes_train.py:98-100)."""
    return name.endswith(".bias") and (".conv" in name or "_tconv" in name)


def train_path(gpu):
    """make_train_step at full width through the kernel train forward."""
    cfg = TRAIN_MODEL
    dev = torch.device(DEVICE)
    frames, labels = cell_frames(np.random.RandomState(SEED + 3), TRAIN_BATCH, TRAIN_SIZE,
                                 labels=True)
    weights = np.stack([weight_map(lab) for lab in labels])
    images, masks, wts = (torch.from_numpy(a).to(dev) for a in (frames, labels, weights))
    valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
    state = create_train_state(fast_random_variables(cfg, SEED), cfg, RECIPE_TRAIN,
                               steps_per_epoch=STEPS_PER_EPOCH, device=dev)
    step = make_train_step(cfg, lanes="auto", assume_valid=True, **RECIPE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    step(state, images, masks, wts, valid, gen)  # warm-up: cuDNN choice, allocator
    torch.cuda.synchronize()
    K.reset_launch_counts()
    new, metrics = step(state, images, masks, wts, valid, gen)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    print(f"train path: loss {loss:.6f}, grad_norm {gnorm:.6f}, step {new.step}, "
          f"launches {launches}", flush=True)
    missing = [k for k in TRAINING if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: {missing}")
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError("loss or grad_norm not finite")
    # Adam moves every parameter with a nonzero gradient; the middle's
    # pre-BN conv biases are detached on the kernel path and stay put
    detached = [k for k in state.params if zero_grad_params(k) and ".conv" in k
                and k.split(".")[0] not in ("enc0", "dec3")]
    for name, old, cur in (("params", state.params, new.params),
                           ("EMA params", state.ema_params, new.ema_params),
                           ("EMA batch stats", state.ema_batch_stats, new.ema_batch_stats)):
        still = [k for k in old if k not in detached and torch.equal(old[k], cur[k])]
        if still or not all(torch.isfinite(t).all() for t in cur.values()):
            raise AssertionError(f"{name} did not all move or are not finite: {still[:5]}")
    print(f"train path: every parameter and EMA shadow moved except the "
          f"{len(detached)} detached middle biases", flush=True)

    # ---- one step's gradients: kernel path vs plain fp32 and plain bf16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    draws = draw_augment(gen, images, True, RECIPE["aug_gamma"], RECIPE["aug_illum"],
                         RECIPE["aug_noise"])
    augment = make_augmenter(RECIPE["augment"], RECIPE["elastic_alpha"], RECIPE["elastic_sigma"],
                             False, 1.0, RECIPE["standardize"], RECIPE["aug_gamma"],
                             RECIPE["aug_illum"], RECIPE["aug_noise"])
    x, targets, w = augment(images, masks, wts, draws)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    res = {}
    for name, fwd, c in (("kernel", train_forward, cfg), ("plain_fp32", unet_train_forward, cfg32),
                         ("plain_bf16", unet_train_forward, cfg)):
        res[name] = loss_and_grads(fwd, state, x, targets, w, valid, None, c)
        torch.cuda.synchronize()
    l32 = float(res["plain_fp32"][0])
    worst, worst_ratio = {}, 0.0
    lines = []
    for k, g32 in res["plain_fp32"][2].items():
        if zero_grad_params(k):
            continue
        n32 = g32.norm().item()
        ek = (res["kernel"][2][k] - g32).norm().item() / n32
        eb = (res["plain_bf16"][2][k] - g32).norm().item() / n32
        lines.append(f"  {k}: kernel {ek:.3e}, plain bf16 {eb:.3e}")
        worst[k] = (ek, eb)
        worst_ratio = max(worst_ratio, ek / max(GRAD_FACTOR * eb, GRAD_FLOOR))
    print(f"train grads: loss kernel {float(res['kernel'][0]):.6f}, plain fp32 {l32:.6f}, "
          f"plain bf16 {float(res['plain_bf16'][0]):.6f}; relative L2 gradient error "
          f"against plain fp32 per tensor ({len(lines)} tensors, the zero-gradient "
          f"conv biases left out):", flush=True)
    print("\n".join(lines), flush=True)
    print(f"train grads: worst kernel err / max({GRAD_FACTOR} x plain bf16 err, "
          f"{GRAD_FLOOR}) = {worst_ratio:.3f}; median kernel err "
          f"{np.median([e[0] for e in worst.values()]):.3e}, median plain bf16 err "
          f"{np.median([e[1] for e in worst.values()]):.3e}", flush=True)
    loss_rel = abs(float(res["kernel"][0]) - l32) / abs(l32)
    if worst_ratio > 1.0 or loss_rel > LOSS_RTOL:
        raise AssertionError(f"kernel path gradients or loss off the fp32 plain path "
                             f"(worst ratio {worst_ratio:.3f}, loss rel {loss_rel:.3e})")
    del res

    # ---- time per step: kernel path vs plain bf16 path, same state and
    # data, each timed TIMING_ROUNDS times with the first of each pair
    # alternating (kernel first, then plain first, ...)
    paths = {"kernel": step,
             "plain_bf16": make_train_step(cfg, lanes="off", assume_valid=True, **RECIPE)}
    times = {name: [] for name in paths}
    for r in range(TIMING_ROUNDS):
        for name in (("kernel", "plain_bf16") if r % 2 == 0 else ("plain_bf16", "kernel")):
            holder = [state]

            def one(fn=paths[name], holder=holder):
                holder[0] = fn(holder[0], images, masks, wts, valid, gen)[0]

            times[name].append(cuda_ms(one, iters=5, warmup=2))
    med = {name: float(np.median(t)) for name, t in times.items()}
    runs = "; ".join(f"{name} " + ", ".join(f"{t:.2f}" for t in ts) for name, ts in times.items())
    print(f"train path: median ms per step {med['kernel']:.2f} through the kernels, "
          f"{med['plain_bf16']:.2f} plain bf16 (runs of 5 steps, in ms: {runs}); "
          f"batch {TRAIN_BATCH} at {TRAIN_SIZE}^2, best recipe, on {gpu}", flush=True)
    profile_step(step, state, images, masks, wts, valid, gen, med["kernel"])
    return launches


def profile_step(step, state, images, masks, wts, valid, gen, step_ms, steps=3):
    """torch.profiler over `steps` kernel-path train steps: device time by
    operation, and the device's idle share of the step time measured
    without the profiler (`step_ms`), which slows the host down."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    holder = [state]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            holder[0] = step(holder[0], images, masks, wts, valid, gen)[0]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    print(f"profile: {wall:.2f} ms wall per step with the profiler on, {step_ms:.2f} ms "
          f"without; summed device kernel time {dev_total:.2f} ms per step, idle share "
          f"{1 - dev_total / step_ms:.3f} of the unprofiled step", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=10), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    gpu = gpu.splitlines()[0]
    nvcc = run([nvcc_path(), "--version"]).splitlines()[-1]
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc}, "
          f"device {torch.cuda.get_device_name(0)} ({gpu})", flush=True)

    t0 = time.perf_counter()
    info = build()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"build: {info['seconds']:.1f} s nvcc ({time.perf_counter() - t0:.1f} s total), "
          f"{info['path']}", flush=True)
    for ln in regs:
        print(f"build: ptxas {ln}", flush=True)

    sh = unet_shapes(min_tile_input(SIZE))
    stats = kernel_parity(sh)
    serving = main_path(gpu)
    train_kernel_parity(stats)
    training = train_path(gpu)

    # launches: the serving path's run plus the train path's run
    record = [
        {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
         "launches": serving[k] + training[k], **stats[k]}
        for k in SOURCES
    ]
    print(json.dumps({"kernels": record}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
