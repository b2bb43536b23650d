#!/usr/bin/env python3
"""A/B of the PyTorch port's default serving path between checkouts, on
one NVIDIA GPU.

    python3 tools/torch_serving_ab.py ROOT [ROOT ...]

runs the roots in order and then in reverse (A B B A for two), each in a
fresh process that imports that checkout's unetseg_tpu_torch (building its
kernels) and its chip_smoke.py's frames and planted net. Per run it prints
one JSON line: Predictor.masks_tiled ms per call as chip_smoke.py's
serving phase times it (16 synthetic 512^2 frames, 700^2 tiles, tile_batch
16, CUDA events, median of 5 runs of 5 calls), the kernel forward's ms per
16-tile chunk (CUDA events, 10 calls), and the forward's device kernels
(launches and ms per call, torch.profiler over 3 calls). Then the card's
name and power limit. Give roots as paths to checkouts, for example
`git archive`s unpacked into an ignored directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def one(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
    from unetseg_tpu_torch.infer.engine import Predictor
    from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels
    from unetseg_tpu_torch.infer.tiling import min_tile_input
    from unetseg_tpu_torch.models.fast_init import fast_random_variables

    if not torch.cuda.is_available():
        raise SystemExit("torch_serving_ab: no CUDA device")
    cfg = ModelConfig()
    variables = cs.plant_intensity_path(fast_random_variables(cfg, cs.SEED))
    frames = cs.cell_frames(np.random.RandomState(cs.SEED), cs.FRAMES, cs.SIZE)
    tile = min_tile_input(cs.SIZE)
    pred = Predictor(cfg, variables, InferConfig(tile_input=tile, tile_batch=cs.BATCH), "cuda")
    runs = [cs.cuda_ms(lambda: pred.masks_tiled(frames), iters=5, warmup=2 if r == 0 else 0)
            for r in range(5)]
    x = torch.rand(cs.BATCH, tile, tile, 1, device="cuda")
    with torch.inference_mode():
        fwd_ms = cs.cuda_ms(lambda: folded_forward_kernels(pred.folded, x), iters=10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                folded_forward_kernels(pred.folded, x)
            torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            k = kernels.setdefault(e.name[:80], [0, 0.0])
            k[0] += 1
            k[1] += e.device_time_total / 1e3
    ms = float(np.median(runs))
    print(json.dumps({"root": root, "ms": ms, "runs_ms": runs,
                      "mpix_s": cs.FRAMES * cs.SIZE * cs.SIZE / 1e6 / (ms / 1e3),
                      "forward_ms": fwd_ms,
                      "forward_kernels": {k: [n / 3, t / 3] for k, (n, t) in kernels.items()}}),
          flush=True)


def main() -> None:
    if sys.argv[1] == "--one":
        return one(sys.argv[2])
    roots = sys.argv[1:]
    for root in roots + roots[::-1]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
