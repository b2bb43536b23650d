"""Benchmark of the port on the card: sustained 512x512 overlap-tile
segmentation throughput (MPix/s) and the best-recipe train step
(counterpart of the repository root's bench.py, definition by definition).

    python -m unetseg_tpu_torch bench
    python -m unetseg_tpu_torch.bench [--tier2] [--fused-enc0]
        [--dec-fuse head|tail] [--cblock NAME [NAME ...]]

Serving measures the whole production pipeline on the card: mirror-pad ->
overlapping tile extraction -> the full-width bf16 folded U-Net through
the kernel forward (infer/kernel_net.py) -> softmax -> threshold ->
stitch to full-resolution uint8 masks, all frames of a call batched into
forward chunks. The net is ModelConfig() with models/fast_init's seed-0
variables, folded; the frames are RandomState(0).rand on the card.

Timing is bench.py's L-iteration slope, (time(L_hi) - time(L_lo)) /
(L_hi - L_lo), each time the best of 3 on the host clock around a call
that ends by fetching one scalar: steady-state throughput without the
host transfers. Each iteration feeds a function of the previous masks
back into the frames, so iterations are sequential and none can be
skipped. The train step is timed the same way over runs of L steps from
one initial state, so its number is wall time per step with the host's
dispatch included, as the JAX number includes its own.

The flags choose the kernel forward's serving variants, the keyword
arguments of infer/engine.Predictor that take the place of the JAX
package's UNETSEG_LANES_TIER2 / UNETSEG_FUSED_ENC0 / UNETSEG_DEC_FUSE
switches; without flags the default forward runs. Every measured path
is checked by its launch counters: one segment call must launch exactly
its forward's kernels per chunk, and one train step the nine train
kernels. A wrong count, or a failed train timing, raises.

Prints ONE JSON line on stdout with bench.py's keys and `device` (the
card's name and power limit from nvidia-smi); everything else goes to
stderr. SEG and its provenance come from the port's recorded evaluation,
docs/results_torch_latest.json (tools/reproduce_flagship_torch.sh writes
it), as bench.py takes the JAX package's from docs/results_latest.json;
without that file SEG is null with SEG_SOURCE. Without a CUDA device it
prints one line on stderr and exits 1; there is no CPU fallback.

Environment, as bench.py reads it: BENCH_IMAGE_SIZE (512), BENCH_FRAMES
(16), BENCH_TILE_CHUNK (16), BENCH_TILE_IN ("auto": the smallest tile
whose output covers the frame, infer/tiling.min_tile_input), BENCH_L_LO
(4), BENCH_L_HI (24), BENCH_TRAIN ("1"; "0" skips the train step).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from unetseg_tpu_torch.core.config import DataConfig, ModelConfig, TrainConfig
from unetseg_tpu_torch.infer.folding import fold_batchnorm
from unetseg_tpu_torch.infer.kernel_net import DEC_FUSE, check_options, supports
from unetseg_tpu_torch.infer.serving import member_probs
from unetseg_tpu_torch.infer.tiling import make_tiled_mask_batch_fn, min_tile_input, plan_tiles
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.ops.kernels.conv3x3 import CBLOCK_CO
from unetseg_tpu_torch.ops.kernels.launches import launch_counts, reset_launch_counts
from unetseg_tpu_torch.train.loop import epoch_generator
from unetseg_tpu_torch.train.state import create_train_state
from unetseg_tpu_torch.train.steps import lanes_active, make_train_step
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict
from unetseg_tpu_torch.utils.provenance import recipe_hash

REPO = Path(__file__).resolve().parents[1]
RECIPE_PATH = REPO / "configs" / "best_recipe.json"
BASELINE_PATH = REPO / "baselines" / "torch_cpu.json"
RESULTS_PATH = REPO / "docs" / "results_torch_latest.json"
DEFAULT_OPTIONS = dict(tier2=False, fused_enc0=False, dec_fuse="head", cblock=())
# launches of one augmented train step through the kernel train forward at
# tier 1 (the stem's input gradient is skipped: the input needs none), with
# the 18 BatchNorms' fused forward and backward, and the recipe's update:
# Adam in one pass, the EMA of the parameters and of the statistics in one
# each
TRAIN_LAUNCHES = {"conv3x3_bias_relu": 3, "tconv2x2_bias": 1, "dec_conv0": 1, "conv3x3_dgrad": 3,
                  "conv3x3_wgrad": 3, "conv3x3_dec0_wgrad": 1, "sample_displaced": 1,
                  "weighted_ce_fwd": 1, "weighted_ce_bwd": 1, "bn_relu_fwd": 18,
                  "bn_relu_bwd": 18, "fused_update": 1, "fused_ema": 2}
STEPS_PER_EPOCH = 38  # the recipe's 152 training frames / batch 4
SEG_SOURCE = ("not measured: no docs/results_torch_latest.json (written by "
              "tools/reproduce_flagship_torch.sh); docs/results_latest.json holds the JAX "
              "package's")


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def serving_launches(cfg: ModelConfig, tier2: bool = False, fused_enc0: bool = False,
                     dec_fuse: str = "head", cblock: Sequence[str] = ()) -> Dict[str, int]:
    """Kernel launches of one forward chunk of infer/kernel_net's forward
    with these options (its stages, counted): every middle conv that
    cblock does not route runs conv3x3_bias_relu, every up-conv
    tconv2x2_bias, every decoder entry outside the tail and tier 2's
    dec2 dec_conv0."""
    names = check_options(cfg, dec_fuse, cblock)
    start, last = (2 if tier2 else 1), cfg.levels - 2
    middle = [(f"enc{lvl}c{i}", cfg.base_features * 2**lvl)
              for lvl in range(start, cfg.levels) for i in (0, 1)]
    middle += [(f"dec{i}c1", cfg.base_features * 2**(last - i))
               for i in range(last - 1 if tier2 else last)]
    routed = sum(1 for name, co in middle
                 if ("all" in names or name in names) and co % CBLOCK_CO == 0)
    tail = dec_fuse == "tail"
    n = {"enc0_fused": int(fused_enc0),
         "conv3x3_bias_relu": (0 if fused_enc0 else 2) + len(middle) - routed,
         "conv3x3_dense": 3 * tier2, "dec_conv0_dense": int(tier2),
         "conv3x3_cblock": routed, "tconv2x2_bias": cfg.levels - 1,
         "dec_conv0": (last - 1 if tier2 else last) + (not tail),
         "dec_tail": int(tail), "conv3x3_head": int(not tail)}
    return {k: v for k, v in n.items() if v}


def forward_chunks(size: int, frames: int, tile_in: int, tile_chunk: int) -> int:
    """Forward chunks of one segment call."""
    return -(-frames * plan_tiles(size, size, tile_in).num_tiles // tile_chunk)


def make_segment(cfg: ModelConfig, variables: Mapping[str, Any], size: int, frames: int,
                 tile_in: int, tile_chunk: int, device, **options) -> Callable:
    """bench.py's `segment`: (frames, size, size) f32 in [0, 1] on `device`
    -> (frames, size, size) uint8 masks: mirror-pad, tiles, x = (t - 0.5) /
    0.5, chunks of `tile_chunk` tiles through the kernel forward with the
    serving variant `options` (DEFAULT_OPTIONS' keys), softmax > 0.5,
    stitch. `variables` is a Flax-layout tree, folded here. On a CPU
    device the kernels' plain versions run."""
    device = torch.device(device)
    opts = {**DEFAULT_OPTIONS, **options}
    opts["cblock"] = check_options(cfg, opts["dec_fuse"], opts["cblock"])
    if not supports(cfg, device):
        raise ValueError(f"the kernel forward does not run this net on {device}")
    net = fold_batchnorm(cfg, flax_to_state_dict(variables)).to(device)
    fn = make_tiled_mask_batch_fn(
        lambda t: member_probs(net, (t - 0.5) / 0.5, True, opts),
        plan_tiles(size, size, tile_in), n_frames=frames, threshold=0.5, tile_batch=tile_chunk,
    )

    @torch.inference_mode()
    def segment(x: torch.Tensor) -> torch.Tensor:
        return fn(x)

    return segment


def check_launches(name: str, want: Mapping[str, int]) -> Dict[str, int]:
    """The launches since the last reset must be exactly `want`."""
    ran = {k: v for k, v in launch_counts().items() if v}
    log(f"launches {name} {json.dumps(ran)}")
    if ran != dict(want):
        raise RuntimeError(f"{name}: launches {ran}, expected {dict(want)}")
    return ran


def slope_seconds(run: Callable[[int], float], lo: int, hi: int) -> float:
    """bench.py's serving slope: warm up both lengths, then the best of 3
    timed runs of each; seconds per iteration."""
    run(lo)
    run(hi)

    def best(length: int, reps: int = 3) -> float:
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(length)
            ts.append(time.perf_counter() - t0)
        log(f"L={length}: {', '.join(f'{t * 1e3:.2f}' for t in ts)} ms")
        return min(ts)

    return (best(hi) - best(lo)) / (hi - lo)


def load_recipe(path=RECIPE_PATH) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def resolve_recipe(recipe: Mapping[str, Any]) -> Tuple[TrainConfig, DataConfig]:
    """bench.py's `section`: the recipe's train and data sections over the
    shipped recipe's values, keys the dataclass lacks ignored."""

    def section(tp, name, **fallback):
        known = {f.name for f in dataclasses.fields(tp)}
        kw = dict(fallback)
        kw.update({k: v for k, v in (recipe.get(name) or {}).items() if k in known})
        return tp(**kw)

    return (
        section(TrainConfig, "train", optimizer="adam", learning_rate=3e-4, cosine_decay=True,
                num_epochs=40),
        section(DataConfig, "data", augment=True, standardize=True, aug_gamma=0.35,
                aug_illum=0.15, aug_noise=0.05),
    )


def measure_train_step(lo: int, hi: int, device="cuda", model_cfg: Optional[ModelConfig] = None,
                       size: int = 512, recipe_path=RECIPE_PATH) -> Dict[str, Any]:
    """bench.py's _measure_train_step: the best recipe's augmented step
    (train/steps.make_train_step, lanes "auto") on a batch of
    TrainConfig.batch_size seeded frames, timed by the slope over runs of
    lo and hi steps from one initial state (lo, hi, lo, hi, lo, hi after a
    warm-up; the minimum of each). The state is never written in place
    (train/state.py makes new tensors), so every run starts from the same
    state. Step i draws from a generator seeded from (7, i)."""
    device = torch.device(device)
    cfg = model_cfg or ModelConfig()
    train_cfg, data_cfg = resolve_recipe(load_recipe(recipe_path))
    state0 = create_train_state(0, cfg, train_cfg, input_size=size,
                                steps_per_epoch=STEPS_PER_EPOCH, device=device)
    b = train_cfg.batch_size
    imgs = torch.from_numpy(np.random.RandomState(0).rand(b, size, size).astype(np.float32))
    masks = torch.from_numpy(np.random.RandomState(1).randint(0, 5, (b, size, size))
                             .astype(np.int32))
    imgs, masks = imgs.to(device), masks.to(device)
    wmaps = torch.ones((b, size, size), device=device)
    valid = torch.ones((b,), dtype=torch.bool, device=device)
    kernels = lanes_active("auto", cfg, size, device)
    step = make_train_step(
        cfg, augment=data_cfg.augment, standardize=data_cfg.standardize,
        aug_gamma=data_cfg.aug_gamma, aug_illum=data_cfg.aug_illum, aug_noise=data_cfg.aug_noise,
        lanes="auto", assume_valid=True,  # the recipe feed divides evenly (152 / 4)
    )

    def run(length: int) -> float:
        st, loss = state0, None
        for i in range(length):
            st, metrics = step(st, imgs, masks, wmaps, valid, epoch_generator(7, i, device))
            loss = metrics["loss"]
        return float(loss)

    for n in (lo, hi):
        run(n)
    reset_launch_counts()
    run(1)
    check_launches("train step", TRAIN_LAUNCHES if device.type == "cuda" else {})
    ts: Dict[int, list] = {}
    for n in (lo, hi, lo, hi, lo, hi):
        t0 = time.perf_counter()
        run(n)
        ts.setdefault(n, []).append(time.perf_counter() - t0)
    for n, t in ts.items():
        log(f"train L={n}: {', '.join(f'{s * 1e3:.2f}' for s in t)} ms")
    per = (min(ts[hi]) - min(ts[lo])) / (hi - lo)
    log("train_step_ms is wall time per step, the host's dispatch included "
        "(the step is host-bound on the card)")
    return {
        "train_steps_per_sec": round(1.0 / per, 2),
        "train_step_ms": round(per * 1e3, 2),
        "train_step_config": (f"augmented best-recipe step, batch {b}, {size}^2, "
                              f"{'kernel' if kernels else 'plain'} path"),
    }


def seg_record(path=RESULTS_PATH, recipe_path=RECIPE_PATH) -> Dict[str, Any]:
    """bench.py's SEG keys from a results record written by
    tools/collect_results_torch.py: the shipped row's SEG, its source and
    eval date, whether its recipe hash is still that of `recipe_path` and
    whether its checkpoint directories still exist (None where the record
    does not say). Without the file, SEG null and SEG_SOURCE."""
    if not os.path.exists(path):
        return {"seg_seq01": None, "seg_seq02": None, "seg_source": SEG_SOURCE,
                "seg_eval_date": None, "seg_recipe_current": None,
                "seg_checkpoints_present": None}
    with open(path) as f:
        seg = json.load(f)
    stored = seg.get("recipe_hash")
    dirs = seg.get("checkpoint_dirs") or []
    return {
        "seg_seq01": seg.get("seg_seq01"),
        "seg_seq02": seg.get("seg_seq02"),
        "seg_source": seg.get("source"),
        "seg_eval_date": seg.get("eval_date"),
        "seg_recipe_current": stored == recipe_hash(str(recipe_path)) if stored else None,
        "seg_checkpoints_present": all(os.path.isdir(d) for d in dirs) if dirs else None,
    }


def metric_text(size: int, frames: int, options: Mapping[str, Any]) -> str:
    text = (f"sustained overlap-tile segmentation, {size}x{size} frames, "
            f"full-width bf16 folded U-Net, batch {frames}")
    opts = {**DEFAULT_OPTIONS, **options}
    extra = [k for k in ("tier2", "fused_enc0") if opts[k]]
    if opts["dec_fuse"] != DEFAULT_OPTIONS["dec_fuse"]:
        extra.append(f"dec_fuse={opts['dec_fuse']}")
    if opts["cblock"]:
        extra.append(f"cblock={','.join(sorted(opts['cblock']))}")
    return text + "".join(f", {e}" for e in extra)


def build_record(mpix: float, size: int, frames: int, options: Mapping[str, Any],
                 train: Mapping[str, Any], device: Optional[str],
                 baseline_path=BASELINE_PATH, results_path=RESULTS_PATH) -> Dict[str, Any]:
    """The JSON line: bench.py's keys (value rounded to 2, vs_baseline to
    1 against the CPU baseline's MPix/s, 1.0 without the file), the train
    step's keys when measured, SEG from seg_record(results_path), and
    `device`."""
    vs = None
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            vs = mpix / json.load(f)["mpix_per_sec"]
    record = {
        "metric": metric_text(size, frames, options),
        "value": round(mpix, 2),
        "unit": "MPix/s/chip",
        "vs_baseline": round(vs, 1) if vs is not None else 1.0,
        **train,
        **seg_record(results_path),
        "device": device,
    }
    return record


def card_name_and_limit() -> Optional[str]:
    """nvidia-smi's "name, power.limit" of the first card, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m unetseg_tpu_torch.bench",
                                description="serving MPix/s and train step ms on the card")
    p.add_argument("--tier2", action="store_true", help="enc1 and dec2 through the kernels")
    p.add_argument("--fused-enc0", action="store_true",
                   help="stem + enc0 conv1 + pool in one kernel")
    p.add_argument("--dec-fuse", choices=list(DEC_FUSE), default="head")
    p.add_argument("--cblock", nargs="+", default=[], metavar="NAME",
                   help='"all" or middle convs such as enc2c1')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device (torch.cuda.is_available() is False): the benchmark measures the "
            "card and has no CPU fallback; no result")
        return 1
    options = dict(tier2=args.tier2, fused_enc0=args.fused_enc0, dec_fuse=args.dec_fuse,
                   cblock=tuple(args.cblock))
    size = int(os.environ.get("BENCH_IMAGE_SIZE", "512"))
    frames = int(os.environ.get("BENCH_FRAMES", "16"))
    tile_chunk = int(os.environ.get("BENCH_TILE_CHUNK", "16"))
    lo = int(os.environ.get("BENCH_L_LO", "4"))
    hi = int(os.environ.get("BENCH_L_HI", "24"))
    tile_env = os.environ.get("BENCH_TILE_IN", "auto")
    tile_in = min_tile_input(size) if tile_env == "auto" else int(tile_env)
    device = torch.device("cuda")
    gpu = card_name_and_limit()
    log(f"{torch.cuda.get_device_name(0)} ({gpu}); {frames} frames of {size}^2, tiles "
        f"{tile_in}^2, chunks of {tile_chunk}, L {lo} -> {hi}, options {options}")

    cfg = ModelConfig()  # full width, bf16
    segment = make_segment(cfg, fast_random_variables(cfg, seed=0), size, frames, tile_in,
                           tile_chunk, device, **options)
    x = torch.from_numpy(np.random.RandomState(0).rand(frames, size, size)
                         .astype(np.float32)).to(device)

    @torch.inference_mode()
    def repeated(length: int) -> float:
        c = x
        for _ in range(length):
            c = c * 0.999 + segment(c).float() * 1e-6
        return segment(c).float().sum().item()  # one scalar fetched: the sync

    per_iter = slope_seconds(repeated, lo, hi)
    reset_launch_counts()
    segment(x)
    torch.cuda.synchronize()
    n = forward_chunks(size, frames, tile_in, tile_chunk)
    check_launches("serving", {k: v * n for k, v in serving_launches(cfg, **options).items()})
    mpix = frames * size * size / 1e6 / per_iter
    log(f"serving: {per_iter * 1e3:.3f} ms per call of {frames} frames = {mpix:.2f} MPix/s")

    train = {}
    if os.environ.get("BENCH_TRAIN", "1") == "1":
        train = measure_train_step(lo, hi, device)
    print(json.dumps(build_record(mpix, size, frames, options, train, gpu)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
