#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (unetseg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with the card and the CUDA
toolkit: `python3 chip_smoke.py`. The phases run in order, each prints
its own line, and any failure raises (non-zero exit):

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build the four serving-path kernels from unetseg_tpu_torch/csrc;
3. per-kernel parity at the main path's full-width shapes (700^2 tiles,
   base 64, batch 16): kernel on bf16 inputs against its plain version in
   fp32 (TF32 off) on the same values, plus both times;
4. main path: Predictor.masks_tiled on 16 seeded synthetic 512^2 cell
   frames at full width, with seeded He-scaled weights, random BatchNorm
   statistics and a planted intensity path (see plant_intensity_path);
   checks the uint8 masks, that all four kernels launched, finite logits,
   and >= 0.999 pixel agreement with the plain forward on the card, and
   times it with CUDA events.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}; the line before them is nvidia-smi's
name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
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
from unetseg_tpu_torch.models.unet import to_nchw, to_nhwc
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.ops.kernels.build import build, nvcc_path
from unetseg_tpu_torch.ops.losses import binary_probs_from_logits

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
}


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

    def f32(*ts):  # bf16 activations -> f32; weights, biases, offsets as they are
        return [t.float() if isinstance(t, torch.Tensor) else t for t in ts]

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
              f"(batch {BATCH})", flush=True)
        st = stats[kname]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["ms"] += ms
        st["plain_ms"] += plain_ms
    return stats


def cell_frames(rs, n, size):
    """Synthetic frames: 15-30 bright elliptic cells (0.70) on a dark
    background (0.25), plus Gaussian noise of std 0.05."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    frames = []
    for _ in range(n):
        cells = np.zeros((size, size), bool)
        for _ in range(rs.randint(15, 31)):
            cy, cx = rs.uniform(0, size, 2)
            ry, rx = rs.uniform(15, 45, 2)
            th = rs.uniform(0, np.pi)
            dy, dx = yy - cy, xx - cx
            u = (dy * np.cos(th) + dx * np.sin(th)) / ry
            v = (dx * np.cos(th) - dy * np.sin(th)) / rx
            cells |= u * u + v * v < 1
        img = 0.25 + 0.45 * cells + 0.05 * rs.standard_normal((size, size))
        frames.append(np.clip(img, 0.0, 1.0))
    return np.stack(frames).astype(np.float32)


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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

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
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    print(f"build: {info['seconds']:.1f} s nvcc ({time.perf_counter() - t0:.1f} s total), "
          f"{info['path']}", flush=True)
    for ln in regs:
        print(f"build: ptxas {ln}", flush=True)

    sh = unet_shapes(min_tile_input(SIZE))
    stats = kernel_parity(sh)
    launches = main_path(gpu)

    record = [
        {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
         "launches": launches[k], **stats[k]}
        for k in SOURCES
    ]
    print(json.dumps({"kernels": record}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
