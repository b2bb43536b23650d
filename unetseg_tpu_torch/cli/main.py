"""Command-line interface of the port (counterpart of every subcommand
of unetseg_tpu/cli/main.py):

    python -m unetseg_tpu_torch preprocess --data-root ... --sequence 01 [--mode paper]
    python -m unetseg_tpu_torch train --data-root ... [--config configs/best_recipe.json]
    python -m unetseg_tpu_torch infer --checkpoint-dir ... --input t000.tif
    python -m unetseg_tpu_torch predict --checkpoint-dir ... --data-root ... [--tiled]
    python -m unetseg_tpu_torch refine --masks-dir ... --instance-dir ... --output-dir ...
    python -m unetseg_tpu_torch track --instance-dir ... [--ctc-dir ...] [--output res_track.txt]
    python -m unetseg_tpu_torch evaluate --checkpoint-dir ... --data-root ...
    python -m unetseg_tpu_torch evaluate-divisions --gt-dir 01_GT/TRA --res-dir 01_CTC
    python -m unetseg_tpu_torch evaluate-ctc seg|tra|det --gt-dir ... --res-dir ...
    python -m unetseg_tpu_torch rescue-labels --data-root ... --output-root ... \
        --rescue-sequences 01
    python -m unetseg_tpu_torch visualize --instance-dir ... --images-dir ... --output-dir ...
    python -m unetseg_tpu_torch visualize-prediction --input ... --prediction ... --output ...
    python -m unetseg_tpu_torch visualize-augmentation --input ... --mask ... --output ...
    python -m unetseg_tpu_torch export --checkpoint-dir ... [--batch N] [--output a.pt2]
    python -m unetseg_tpu_torch bench
    python -m unetseg_tpu_torch pipeline --config ... --data-root ... --output-dir ...

Flags and defaults are the JAX command's. The commands run on the card;
`--cpu` runs them on the CPU instead, and `pipeline` hands it to its
preprocess, train and predict stages. `train` is data-parallel over a
mesh of ranks (`--mesh auto|on|off`) when several processes join through
`--coordinator`, `--num-processes` and `--process-id` (one per card, or
gloo processes on the CPU with `--cpu`); on a host with several cards and
no coordinator it starts one worker per visible card on localhost
(launch_local), as the JAX command uses every local chip. The preprocess command's
reference mode and the refine, track, evaluate-divisions, evaluate-ctc,
rescue-labels, visualize and visualize-prediction commands are host
computations (scipy, the native watershed and CTC measures, matplotlib)
with no device version, so they run on the host either way and take
`--cpu` as a no-op. `export` traces on the card unless `--cpu`, and
refuses an ensemble. `bench` runs the benchmark (unetseg_tpu_torch/bench.py)
in a subprocess, on the card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from unetseg_tpu_torch.core.config import Config, InferConfig, ModelConfig, TrackConfig


def _load_config(args) -> Config:
    return Config.from_json_file(args.config) if args.config else Config()


def _device(args) -> str:
    return "cpu" if args.cpu else "cuda"


def _model_cfg(cfg: Config, args) -> ModelConfig:
    kw = {}
    if getattr(args, "three_class", False):
        kw["num_classes"] = 3
    elif args.classes is not None:
        kw["num_classes"] = args.classes
    if args.dtype:
        kw["compute_dtype"] = args.dtype
    if args.bilinear:
        kw["bilinear"] = True
    return dataclasses.replace(cfg.model, **kw)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config",
                   help="JSON config file (Config.to_dict layout, e.g. configs/best_recipe.json)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                   help="compute dtype (default bfloat16)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions) instead of the card")


def _make_predictor(args, cfg: Config, icfg: InferConfig):
    from unetseg_tpu_torch.infer.engine import Predictor

    kw = dict(model_cfg=_model_cfg(cfg, args), infer_cfg=icfg, device=_device(args))
    if args.torch_checkpoint:
        return Predictor.from_torch_checkpoint(args.torch_checkpoint, **kw)
    if not args.checkpoint_dir:
        raise SystemExit("error: --checkpoint-dir or --torch-checkpoint required")
    # comma-separated dirs = deep ensemble (member probabilities merged on the card)
    dirs = [d for d in args.checkpoint_dir.split(",") if d]
    # tri-state: --ema forces on, --no-ema forces off, absent defers to config
    use_ema = icfg.use_ema if args.ema is None else args.ema
    if getattr(args, "ema_both", False) or use_ema == "both":
        use_ema = "both"
    if len(dirs) > 1 or use_ema == "both":
        # "both" with one dir is still an ensemble (raw + EMA members)
        if args.epoch is not None:
            raise SystemExit("error: --epoch is per-checkpoint; ensemble "
                             "dirs always load each member's best")
        return Predictor.from_checkpoints(dirs, ema=use_ema, **kw)
    return Predictor.from_checkpoint(args.checkpoint_dir, epoch=args.epoch, ema=use_ema, **kw)


def _seq_infer_cfg(cfg: Config, args, sequence: str) -> InferConfig:
    """InferConfig for one sequence: config < Config.infer_per_sequence
    (the shipped recipe's sequence-tuned settings, e.g. seq-02
    boundary_grow 1.5) < explicit CLI flags."""
    per_seq = cfg.infer_per_sequence.get(sequence, {})
    return dataclasses.replace(cfg.infer, **{**per_seq, **_infer_overrides(args)})


def _infer_overrides(args) -> dict:
    """InferConfig overrides from explicit CLI flags only. Flag defaults
    must never override a --config file's values (a default
    min_cell_size=15 once overrode a recipe's 1000 and standardize=true);
    numeric flags default to None and boolean flags use store_const(True),
    so absent flags stay absent."""
    out = {}
    for name in ("threshold", "min_cell_size", "normalize", "standardize",
                 "tta", "tta_merge", "ensemble_merge", "boundary_grow"):
        v = getattr(args, name, None)
        if v is not None:
            out[name] = v
    return out


# ---------------------------------------------------------------- preprocess
def cmd_preprocess(args) -> int:
    from unetseg_tpu_torch.data.io import SequencePaths, file_number_str, read_image
    from unetseg_tpu_torch.ops.weight_maps import weight_map

    cfg = _load_config(args)
    paths = SequencePaths(args.data_root or cfg.data.data_root,
                          args.sequence or cfg.data.sequence)
    os.makedirs(paths.weight_maps_dir, exist_ok=True)
    images = paths.image_files()
    if not images:
        print(f"error: no t*.tif frames under {paths.images_dir}", file=sys.stderr)
        return 1
    done = skipped = 0
    for img in images:
        num = file_number_str(img)
        mask_path = paths.mask_path(num)
        out_path = paths.weight_map_path(num)
        if not os.path.exists(mask_path):
            print(f"warning: no mask for frame {num}, skipping")
            continue
        if os.path.exists(out_path) and not args.force:
            skipped += 1
            continue
        wm = weight_map(read_image(mask_path), w0=args.w0, sigma=args.sigma, mode=args.mode,
                        device=_device(args))
        np.save(out_path, wm)
        done += 1
        print(f"weight_map_{num}.npy written")
    print(f"preprocess finished: {done} written, {skipped} already existed")
    return 0


# --------------------------------------------------------------------- train
def _worker(index: int, argv: List[str], coordinator: str, n: int) -> None:
    """One worker of launch_local: the command with its rank's flags."""
    rc = main([*argv, "--coordinator", coordinator, "--num-processes", str(n),
               "--process-id", str(index)])
    if rc:
        raise SystemExit(rc)


def launch_local(argv: List[str], n_workers: int, timeout_s: Optional[float] = None) -> int:
    """Run `main(argv)` in `n_workers` processes joined on localhost (each
    given --coordinator, --num-processes and --process-id); 0 when every
    worker ends with 0. A worker's failure, or the timeout, stops the
    others and raises."""
    import torch.multiprocessing as mp

    from unetseg_tpu_torch.core.distributed import free_port

    ctx = mp.start_processes(_worker, args=(list(argv), f"localhost:{free_port()}", n_workers),
                             nprocs=n_workers, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n_workers} workers still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return 0


def _use_mesh(mode: str, batch_size: int, n: int) -> bool:
    """Whether `train` builds a mesh over n ranks: --mesh on, or auto with
    several ranks and a batch that divides (auto with one that does not
    trains without, with the JAX command's note); on with such a batch
    exits with the JAX command's message."""
    divisible = batch_size % n == 0
    if mode == "on" and not divisible:
        raise SystemExit(
            f"error: --mesh on with batch_size {batch_size} not divisible by the {n} "
            f"visible devices; pick a divisible --batch-size")
    if mode == "auto" and n > 1 and not divisible:
        print(f"note: {n} devices visible but batch_size {batch_size} is not divisible; "
              f"training single-device (--mesh on + a divisible --batch-size to parallelize)")
    return mode == "on" or (mode == "auto" and n > 1 and divisible)


def cmd_train(args) -> int:
    import torch

    from unetseg_tpu_torch.core import distributed
    from unetseg_tpu_torch.core.mesh import make_mesh
    from unetseg_tpu_torch.data.dataset import HeLaArrays
    from unetseg_tpu_torch.train.loop import train

    cfg = _load_config(args)
    data_kw = {}
    if args.data_root:
        data_kw["data_root"] = args.data_root
    if args.sequence:
        data_kw["sequence"] = args.sequence
    if args.no_augment:
        data_kw["augment"] = False
    if args.standardize:
        data_kw["standardize"] = True
    for aug in ("aug_gamma", "aug_illum", "aug_noise"):
        if getattr(args, aug) is not None:
            data_kw[aug] = getattr(args, aug)
    train_kw = {}
    for flag, name in [
        ("epochs", "num_epochs"), ("batch_size", "batch_size"), ("lr", "learning_rate"),
        ("seed", "seed"), ("checkpoint_dir", "checkpoint_dir"),
        ("metrics_jsonl", "metrics_jsonl"), ("optimizer", "optimizer"),
        ("ema_decay", "ema_decay"),
    ]:
        if getattr(args, flag) is not None:
            train_kw[name] = getattr(args, flag)
    if args.resume:
        train_kw["resume"] = True
    if args.cosine:
        train_kw["cosine_decay"] = True
    cfg = dataclasses.replace(
        cfg, model=_model_cfg(cfg, args), data=dataclasses.replace(cfg.data, **data_kw),
        train=dataclasses.replace(cfg.train, **train_kw))
    mode = args.mesh or "auto"
    coordinator = args.coordinator or os.environ.get("UNETSEG_COORDINATOR")
    cards = 0 if args.cpu else torch.cuda.device_count()
    if coordinator is None and cards > 1 and mode != "off":
        # every card of this host, one worker each, as the JAX command
        # takes every local chip
        if _use_mesh(mode, cfg.train.batch_size, cards):
            return launch_local(args.argv, cards)
    was_up = torch.distributed.is_initialized()
    joined_here = distributed.maybe_initialize(
        args.coordinator, args.num_processes, args.process_id, cpu=args.cpu) and not was_up
    try:
        n = distributed.process_count()
        device = _device(args) if n == 1 else distributed.device_of_rank()
        mesh = make_mesh(cfg.mesh, device=device) if _use_mesh(
            mode, cfg.train.batch_size, n) else None
        data = HeLaArrays.load_many(cfg.data, args.sequences) if args.sequences else None
        result = train(cfg, data=data, max_steps=args.max_steps, device=device, mesh=mesh)
        if n > 1:
            # the replicas must agree: their digests are printed side by side.
            # One write of the whole line: the workers of launch_local share
            # the launcher's stdout, and an unbuffered print writes the text
            # and the newline apart, so two ranks' lines could interleave
            sys.stdout.write(f"rank {distributed.process_index()} of {n}: parameters sha256 "
                             f"{distributed.tensor_digest(result.state.params)}\n")
            sys.stdout.flush()
    finally:
        if joined_here:
            distributed.shutdown()
    print(f"training finished: best val loss {result.best_val_loss:.4f} "
          f"at epoch {result.best_epoch}")
    return 0


# --------------------------------------------------------------------- infer
def cmd_infer(args) -> int:
    from PIL import Image

    from unetseg_tpu_torch.infer.engine import load_image_01

    cfg = _load_config(args)
    icfg = dataclasses.replace(cfg.infer, **_infer_overrides(args))
    pred = _make_predictor(args, cfg, icfg)
    if args.tiled:
        mask = pred.predict_image_tiled(load_image_01(args.input, None))
    else:
        mask = pred.predict_image(load_image_01(args.input, icfg.image_size))
    out = args.output or "predicted_mask.png"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    Image.fromarray((mask * 255).astype(np.uint8)).save(out)
    print(f"wrote {out} ({mask.shape[0]}x{mask.shape[1]})")
    return 0


# ------------------------------------------------------------------- predict
def cmd_predict(args) -> int:
    from unetseg_tpu_torch.data.io import prediction_dirs

    cfg = _load_config(args)
    data_root = args.data_root or cfg.data.data_root
    sequence = args.sequence or cfg.data.sequence
    icfg = _seq_infer_cfg(cfg, args, sequence)
    pred = _make_predictor(args, cfg, icfg)
    masks_dir, inst_dir = prediction_dirs(data_root, sequence)
    if args.output_dir:
        masks_dir = os.path.join(args.output_dir, f"{sequence}_RES")
        inst_dir = os.path.join(args.output_dir, f"{sequence}_RES_INST")
    written = pred.predict_sequence(
        os.path.join(data_root, sequence), masks_dir, inst_dir,
        batch_size=args.batch_size,
        tiled=args.tiled,
        resize_output_to=args.resize_output,
        progress=lambda i, n: print(f"  {i}/{n} frames", end="\r", flush=True),
        watershed=args.watershed,
        marker_frac=args.marker_frac,
        device_cc=args.device_cc,
        temporal_markers=args.temporal_markers or icfg.temporal_markers,
        # an explicit flag (True or False) beats the config; absent -> config
        temporal_bidi=icfg.temporal_bidi if args.temporal_bidi is None else args.temporal_bidi,
    )
    print(f"\nwrote {len(written)} files -> {masks_dir} , {inst_dir}")
    return 0


# -------------------------------------------------------------------- refine
def cmd_refine(args) -> int:
    """Post-hoc backward temporal refinement of existing predictions: reads
    the binary and instance masks a predict run wrote, runs
    post/temporal.refine_backward over the first --max-frames frames and
    writes refined instance masks (predict --temporal-bidi applies the same
    sweep inline)."""
    from unetseg_tpu_torch.data.io import frame_number, read_image, sorted_frames, write_mask_u16
    from unetseg_tpu_torch.post.boundary import grow_instances
    from unetseg_tpu_torch.post.temporal import refine_backward

    cfg = _load_config(args)
    masks = sorted_frames(args.masks_dir, "mask*.tif")
    if not masks:
        print(f"error: no mask*.tif in {args.masks_dir}", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    grow = args.boundary_grow if args.boundary_grow is not None else cfg.infer.boundary_grow
    bins, insts, nums = [], [], []
    for f in masks:
        n = frame_number(f)
        inst_path = os.path.join(args.instance_dir, f"m{n:03d}.tif")
        if not os.path.exists(inst_path):
            print(f"error: missing {inst_path}", file=sys.stderr)
            return 1
        b = read_image(f) > 0
        inst = read_image(inst_path)
        if grow > 0:
            # instance masks written with boundary_grow extend past the
            # binary foreground; the sweep's regions come from the binary,
            # so the grown ring is trimmed first and the result re-grown
            inst = np.where(b, inst, 0).astype(inst.dtype)
        bins.append(b)
        insts.append(inst)
        nums.append(n)
    refined = refine_backward(
        bins, insts, min_size=cfg.infer.min_cell_size, marker_frac=args.marker_frac,
        area_guard=cfg.infer.temporal_area_guard, max_frames=args.max_frames,
    )
    changed = sum(int(np.any(np.asarray(a) != np.asarray(b))) for a, b in zip(insts, refined))
    if grow > 0:
        refined = [grow_instances(r, grow) for r in refined]
    for n, r in zip(nums, refined):
        write_mask_u16(os.path.join(args.output_dir, f"m{n:03d}.tif"), r)
    print(f"refined {len(refined)} frames ({changed} changed) -> {args.output_dir}")
    return 0


# --------------------------------------------------------------------- track
def cmd_track(args) -> int:
    from unetseg_tpu_torch.data.io import frame_number, read_image, sorted_frames
    from unetseg_tpu_torch.track.ctc_io import write_res_track
    from unetseg_tpu_torch.track.tracker import Tracker

    files = sorted_frames(args.instance_dir, "m*.tif")
    files = [f for f in files if not os.path.basename(f).startswith("mask")]
    if not files:
        print(f"error: no m*.tif instance masks in {args.instance_dir}", file=sys.stderr)
        return 1
    prune_k = 0 if args.faithful else args.prune_divisions
    tcfg = TrackConfig(
        iou_threshold_track=args.iou_track,
        iou_threshold_division=args.iou_division,
        max_children=args.max_children,
        division_from_matched=not args.no_division_from_matched,
        division_min_child_frac=args.min_child_frac,
    )
    tracker = Tracker(tcfg, faithful_active_map=args.faithful)
    masks = []
    keep_masks = bool(args.ctc_dir) or args.close_gaps > 0 or prune_k > 0
    for f in files:
        m = read_image(f)
        tracker.update(m, frame_number(f))
        if keep_masks:
            masks.append(m)
    tracks = tracker.tracks()
    assignments = tracker.assignments()
    frame_nums = [frame_number(f) for f in files]
    if args.close_gaps > 0:
        from unetseg_tpu_torch.track.postprocess import close_gaps

        n_before = len(tracks)
        tracks, assignments = close_gaps(
            masks, frame_nums, tracks, assignments,
            max_gap=args.close_gaps, iou_threshold=args.gap_iou,
        )
        print(f"gap closing: {n_before} -> {len(tracks)} tracks")
    if prune_k > 0:
        from unetseg_tpu_torch.track.postprocess import prune_short_divisions

        n_div_before = sum(1 for t in tracks if t.parent_label > 0) // 2
        tracks, assignments = prune_short_divisions(
            masks, frame_nums, tracks, assignments, min_child_frames=prune_k,
        )
        n_div_after = sum(1 for t in tracks if t.parent_label > 0) // 2
        if n_div_after != n_div_before:
            print(f"division pruning: {n_div_before} -> {n_div_after} divisions")
    out = args.output or os.path.join(
        os.path.dirname(args.instance_dir.rstrip("/")), "res_track.txt"
    )
    parent_none = -1 if args.reference_parent else 0
    write_res_track(out, tracks, parent_none=parent_none)
    if args.ctc_dir:
        # CTC-conformant result dir: mask{NNN}.tif relabeled by TRACK id +
        # res_track.txt (the labeling the official measures require)
        from unetseg_tpu_torch.data.io import write_mask_u16
        from unetseg_tpu_torch.track.ctc_io import relabel_by_track

        os.makedirs(args.ctc_dir, exist_ok=True)
        for f, m, assignment in zip(files, masks, assignments):
            write_mask_u16(os.path.join(args.ctc_dir, f"mask{frame_number(f):03d}.tif"),
                           relabel_by_track(m, assignment))
        write_res_track(os.path.join(args.ctc_dir, "res_track.txt"), tracks,
                        parent_none=parent_none)
        print(f"CTC-format results -> {args.ctc_dir}")
    print(f"tracked {len(files)} frames -> {len(tracks)} tracks -> {out}")
    return 0


# ------------------------------------------------------------------ evaluate
def cmd_evaluate(args) -> int:
    from unetseg_tpu_torch.data.dataset import HeLaArrays, train_val_split
    from unetseg_tpu_torch.metrics.binary import dice as dice_fn
    from unetseg_tpu_torch.metrics.binary import iou as iou_fn
    from unetseg_tpu_torch.metrics.rand import rand_index_and_error
    from unetseg_tpu_torch.models.shapes import center_crop_bounds
    from unetseg_tpu_torch.post.cc import get_instance_masks

    cfg = _load_config(args)
    data_root = args.data_root or cfg.data.data_root
    sequences = args.sequences or [cfg.data.sequence]
    # images are loaded raw [0,1]; if training standardized (on the device,
    # see ops/intensity.standardize_batch) the predictor must match
    icfg = dataclasses.replace(
        cfg.infer, standardize=cfg.infer.standardize or cfg.data.standardize
    )
    pred = _make_predictor(args, cfg, icfg)
    ious: List[float] = []
    dices: List[float] = []
    rands: List[float] = []
    loaded = [
        HeLaArrays.load(
            dataclasses.replace(cfg.data, data_root=data_root, sequence=seq),
            require_weight_maps=False,
            image_size=cfg.infer.image_size,
        )
        for seq in sequences
    ]
    if args.pooled and len(loaded) > 1:
        # the reference's protocol: every sequence pooled into one dataset
        # and one random split of the pool scored (reference:
        # scripts/evaluate.py:54-82 ConcatDataset + random_split); the
        # default scores each sequence on its own
        pooled = HeLaArrays(
            images=np.concatenate([d.images for d in loaded]),
            masks=np.concatenate([d.masks for d in loaded]),
            weight_maps=None,
            files=[t for d in loaded for t in d.files],
        )
        loaded = [pooled]
    for data in loaded:
        idx = np.arange(len(data))
        if args.val_only:
            vp = args.val_percent if args.val_percent is not None else cfg.data.val_percent
            _, idx = train_val_split(len(data), vp, args.seed)
        bs = args.batch_size or cfg.train.batch_size
        for s in range(0, len(idx), bs):
            chunk = idx[s : s + bs]
            # thresholded on the device; one copy to the host per batch
            binary = (pred.probs(data.images[chunk]) > cfg.infer.threshold).cpu().numpy()
            th = binary.shape[1]
            h = data.masks.shape[1]
            a0, a1 = center_crop_bounds(h, th)
            gt = data.masks[chunk][:, a0:a1, a0:a1] > 0
            for k in range(len(chunk)):
                ious.append(iou_fn(binary[k], gt[k]))
                dices.append(dice_fn(binary[k], gt[k]))
                if args.rand:
                    gt_inst = data.masks[chunk][k][a0:a1, a0:a1]
                    pred_inst = get_instance_masks(binary[k], min_size=cfg.infer.min_cell_size)
                    rands.append(rand_index_and_error(gt_inst, pred_inst)[0])
    out = {
        "n_samples": len(ious),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "mean_dice": float(np.mean(dices)) if dices else 0.0,
    }
    if args.rand:
        out["mean_rand_index"] = float(np.mean(rands)) if rands else 0.0
    print(json.dumps(out))
    return 0


# ------------------------------------------------------- evaluate-divisions
def cmd_evaluate_divisions(args) -> int:
    from unetseg_tpu_torch.metrics.divisions import division_report

    r = division_report(
        args.gt_dir, args.res_dir, res_track_path=args.res_track,
        frame_tolerance=args.frame_tolerance,
    )
    out = {
        "gt_divisions": r.n_gt, "res_divisions": r.n_res,
        "matched": r.matched, "recall": round(r.recall, 4),
        "precision": round(r.precision, 4),
    }
    if args.details:
        out["details"] = r.details
    print(json.dumps(out))
    return 0


# -------------------------------------------------------------- evaluate-ctc
def cmd_evaluate_ctc(args) -> int:
    from unetseg_tpu_torch.metrics import ctc

    if args.measure == "seg":
        r = ctc.seg_measure(args.gt_dir, args.res_dir, backend=args.backend)
        print(json.dumps({"SEG": r.value, "n_objects": r.n_objects}))
    else:
        r = ctc.tra_measure(args.gt_dir, args.res_dir, res_track_path=args.res_track,
                            backend=args.backend)
        print(json.dumps({
            "TRA": r.tra,
            "DET": r.det,
            "DET_no_fp_penalty": r.det_without_fp_penalty,
            "AOGM": r.aogm,
            "AOGM_0": r.aogm0,
            **{k: float(v) for k, v in r.counts.items()},
        }))
    return 0


# ----------------------------------------------------------------- visualize
def cmd_visualize(args) -> int:
    from unetseg_tpu_torch.data.io import frame_number, read_image, sorted_frames
    from unetseg_tpu_torch.infer.engine import load_image_01
    from unetseg_tpu_torch.track.tracker import Tracker
    from unetseg_tpu_torch.viz.overlays import save_frame_overlay

    inst_files = sorted_frames(args.instance_dir, "m*.tif")
    inst_files = [f for f in inst_files if not os.path.basename(f).startswith("mask")]
    if not inst_files:
        print("error: no instance masks found", file=sys.stderr)
        return 1
    img_files = {frame_number(f): f for f in sorted_frames(args.images_dir, "t*.tif")}
    tracker = Tracker() if args.tracks else None
    os.makedirs(args.output_dir, exist_ok=True)
    count = 0
    for f in inst_files[: args.max_frames]:
        num = frame_number(f)
        inst = read_image(f)
        assignment = tracker.update(inst, num) if tracker else None
        img_path = img_files.get(num)
        if img_path is None:
            continue
        img = load_image_01(img_path, inst.shape[0] if args.resize_image else None)
        if img.shape != inst.shape:
            from PIL import Image

            img = np.asarray(
                Image.fromarray((img * 255).astype(np.uint8)).resize(
                    (inst.shape[1], inst.shape[0]), Image.BILINEAR),
                np.float32,
            ) / 255.0
        out = os.path.join(args.output_dir, f"vis_frame_{num:03d}.png")
        save_frame_overlay(out, img, inst, assignment, title=f"frame {num}")
        count += 1
    print(f"wrote {count} overlays -> {args.output_dir}")
    return 0


def cmd_visualize_prediction(args) -> int:
    from unetseg_tpu_torch.data.io import read_image
    from unetseg_tpu_torch.infer.engine import load_image_01
    from unetseg_tpu_torch.viz.overlays import save_prediction_panel

    image = load_image_01(args.input, None)
    gt = read_image(args.gt) if args.gt else None
    pred = read_image(args.prediction)
    save_prediction_panel(args.output, image, gt, pred)
    print(f"wrote {args.output}")
    return 0


def augmentation_arrays(image: np.ndarray, mask: np.ndarray, alpha: float, sigma: float,
                        seed: int, device: str):
    """visualize-augmentation's deformation: one (H, W) frame in [0, 1] and
    its integer labels, deformed with one field on `device` (the
    sample_displaced kernel on the card) -> (f32 image, int32 labels) as
    numpy. The field's uniforms are drawn on the host from a torch
    generator seeded by `seed`, so one seed gives one field on either
    device (not the JAX command's field for that seed: its draws come from
    jax.random.key(seed))."""
    import torch

    from unetseg_tpu_torch.ops.elastic import draw_elastic, elastic_deform

    uniforms = draw_elastic(torch.Generator().manual_seed(seed), 1, *image.shape)[0]
    di, dm = elastic_deform(torch.from_numpy(np.asarray(image, np.float32)).to(device),
                            torch.from_numpy(np.asarray(mask, np.int32)).to(device),
                            uniforms.to(device), alpha=alpha, sigma=sigma)
    return di.cpu().numpy(), dm.cpu().numpy()


def cmd_visualize_augmentation(args) -> int:
    from unetseg_tpu_torch.data.io import read_image
    from unetseg_tpu_torch.infer.engine import load_image_01
    from unetseg_tpu_torch.viz.overlays import save_augmentation_panel

    image = load_image_01(args.input, None)
    mask = read_image(args.mask).astype(np.int32)
    di, dm = augmentation_arrays(image, mask, args.alpha, args.sigma, args.seed, _device(args))
    save_augmentation_panel(args.output, image, mask, di, dm)
    print(f"wrote {args.output}")
    return 0


# ------------------------------------------------------------- rescue-labels
def cmd_rescue_labels(args) -> int:
    """Faint-cell label rescue (data/rescue.py): build a parallel data root
    whose silver labels are augmented with gold-TRA-marker-seeded cores +
    ignore annuli for the cells the silver truth misses. Train against the
    overlay root; evaluate the OTHER sequence (leak-free)."""
    from unetseg_tpu_torch.data.rescue import build_overlay_root

    stats = build_overlay_root(
        args.data_root,
        args.output_root,
        rescue_sequences=args.rescue_sequences,
        passthrough_sequences=args.passthrough_sequences or [],
        cover_thresh=args.cover_thresh,
        core_radius=args.core_radius,
        ignore_radius=args.ignore_radius,
        core_weight=args.core_weight,
        w0=args.w0,
        sigma=args.sigma,
        weight_map_mode=args.mode,
    )
    for seq, st in stats.items():
        print(f"seq {seq}: {st.markers_missing} missing markers rescued in "
              f"{st.frames_rescued}/{st.frames_seen} frames "
              f"({st.core_px} core px, {st.ignore_px} ignore px)")
    print(f"overlay root ready: {args.output_root}")
    return 0


# -------------------------------------------------------------------- export
def _serving_variables(args, cfg: Config, icfg: InferConfig):
    """The one member's variables the export command serves: a reference
    .pth, or one checkpoint directory's raw or EMA weights. An ensemble
    (several directories, or raw and EMA together) is refused: the
    artifact is one member's forward."""
    if args.torch_checkpoint:
        from unetseg_tpu_torch.utils.torch_import import load_reference_checkpoint

        return load_reference_checkpoint(args.torch_checkpoint,
                                         levels=_model_cfg(cfg, args).levels)
    if not args.checkpoint_dir:
        raise SystemExit("error: --checkpoint-dir or --torch-checkpoint required")
    dirs = [d for d in args.checkpoint_dir.split(",") if d]
    use_ema = icfg.use_ema
    if len(dirs) > 1 or use_ema == "both":
        raise SystemExit("error: export serves one member; an ensemble (several "
                         "--checkpoint-dir, or use_ema \"both\") cannot be exported: "
                         "export each member on its own")
    from unetseg_tpu_torch.train.checkpoint import restore_params_for_inference

    return restore_params_for_inference(dirs[0], epoch=args.epoch, ema=bool(use_ema))


def cmd_export(args) -> int:
    from unetseg_tpu_torch.infer.export import export_inference, save_exported

    cfg = _load_config(args)
    icfg = dataclasses.replace(cfg.infer, **_infer_overrides(args))
    if args.image_size is not None:
        icfg = dataclasses.replace(icfg, image_size=args.image_size)
    platforms = tuple(s.strip() for s in args.platforms.split(",") if s.strip())
    data = export_inference(
        _model_cfg(cfg, args), _serving_variables(args, cfg, icfg), infer_cfg=icfg,
        batch=args.batch, platforms=platforms, device=_device(args),
    )
    out = args.output or "unetseg_serving.pt2"
    save_exported(out, data)
    batch = "symbolic" if args.batch is None else str(args.batch)
    print(f"wrote {out} ({len(data) / 1e6:.1f} MB, platforms={','.join(platforms)}, "
          f"batch={batch}, input {icfg.image_size}x{icfg.image_size})")
    return 0


# --------------------------------------------------------------------- bench
def cmd_bench(args) -> int:
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return subprocess.call([sys.executable, "-m", "unetseg_tpu_torch.bench"], cwd=root)


# ------------------------------------------------------------------ pipeline
def cmd_pipeline(args) -> int:
    """The reference README's whole workflow as one command: preprocess ->
    train -> predict -> track -> evaluate-ctc per sequence (reference:
    README.md:183-290 documents the steps as separate manual scripts). All
    knobs come from --config; `--cpu` reaches the three device stages. The
    per-sequence CTC scores print as one summary JSON at the end and land
    in <output-dir>/summary.json."""
    from unetseg_tpu_torch.metrics import ctc

    seqs = args.sequences or ["01"]
    data_root = args.data_root
    out_dir = args.output_dir
    ckpt_dir = args.checkpoint_dir or os.path.join(out_dir, "checkpoints")
    os.makedirs(out_dir, exist_ok=True)
    cfg_flags = ["--config", args.config] if args.config else []
    cpu_flag = ["--cpu"] if args.cpu else []

    if not args.skip_preprocess:
        for seq in seqs:
            rc = main(["preprocess", *cfg_flags, *cpu_flag, "--data-root", data_root,
                       "--sequence", seq])
            if rc:
                return rc
    if not args.skip_train:
        rc = main(["train", *cfg_flags, *cpu_flag, "--data-root", data_root,
                   "--sequences", *seqs, "--checkpoint-dir", ckpt_dir,
                   "--metrics-jsonl", os.path.join(out_dir, "metrics.jsonl")])
        if rc:
            return rc

    pred_flags = ["--tiled"] if args.tiled else []
    if args.resize_output:
        pred_flags += ["--resize-output", str(args.resize_output)]
    for flag, value in (("--tta", args.tta), ("--tta-merge", args.tta_merge),
                        ("--ensemble-merge", args.ensemble_merge)):
        if value:
            pred_flags += [flag, value]
    if args.temporal_bidi is not None:
        pred_flags += ["--temporal-bidi" if args.temporal_bidi else "--no-temporal-bidi"]
    if args.boundary_grow is not None:
        pred_flags += ["--boundary-grow", str(args.boundary_grow)]
    if args.ema is not None:
        pred_flags += ["--ema" if args.ema else "--no-ema"]
    if args.ema_both:
        pred_flags += ["--ema-both"]
    summary = {}
    for seq in seqs:
        rc = main(["predict", *cfg_flags, *cpu_flag, "--data-root", data_root,
                   "--sequence", seq, "--checkpoint-dir", ckpt_dir, "--output-dir", out_dir,
                   *pred_flags])
        if rc:
            return rc
        ctc_dir = os.path.join(out_dir, f"{seq}_CTC")
        rc = main(["track", "--instance-dir", os.path.join(out_dir, f"{seq}_RES_INST"),
                   "--ctc-dir", ctc_dir,
                   "--output", os.path.join(out_dir, f"{seq}_res_track.txt")])
        if rc:
            return rc
        row = {}
        seg_gt = os.path.join(data_root, f"{seq}_GT", "SEG")
        tra_gt = os.path.join(data_root, f"{seq}_GT", "TRA")
        if os.path.isdir(seg_gt):
            row["SEG"] = ctc.seg_measure(seg_gt, ctc_dir).value
        if os.path.isdir(tra_gt):
            r = ctc.tra_measure(tra_gt, ctc_dir)
            row["TRA"], row["DET"] = r.tra, r.det
        if not row:
            row["note"] = f"no {seq}_GT dirs under {data_root}; skipped scoring"
        summary[seq] = row
    print(json.dumps({"pipeline": summary}))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


# -------------------------------------------------------------------- parser
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="unetseg_tpu_torch",
        description="U-Net cell segmentation, PyTorch + CUDA port: weight maps, training, "
                    "prediction, tracking and CTC scoring",
    )
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("preprocess", help="generate EDT weight maps")
    _add_common(sp)
    sp.add_argument("--data-root", default=None)
    sp.add_argument("--sequence", default=None)
    sp.add_argument("--w0", type=float, default=10.0)
    sp.add_argument("--sigma", type=float, default=5.0)
    sp.add_argument("--mode", choices=["reference", "paper"], default="reference",
                    help="paper: the U-Net paper's separation term, on the card (min-plus "
                         "EDT kernel) unless --cpu; reference: the reference generator's "
                         "formula, a host-only scipy computation with no device version")
    sp.add_argument("--device", action="store_true",
                    help="accepted so that the JAX command's lines parse; paper mode "
                         "always runs on the device the command runs on")
    sp.add_argument("--force", action="store_true", help="overwrite existing maps")
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("train", help="train the U-Net")
    _add_common(sp)
    sp.add_argument("--data-root", default=None)
    sp.add_argument("--sequence", default=None)
    sp.add_argument("--sequences", nargs="*", default=None,
                    help="train on several sequences concatenated (e.g. 01 02)")
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    sp.add_argument("--lr", type=float, default=None)
    sp.add_argument("--seed", type=int, default=None)
    sp.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None)
    sp.add_argument("--metrics-jsonl", dest="metrics_jsonl", default=None)
    sp.add_argument("--no-augment", action="store_true")
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--optimizer", choices=["sgd", "adam", "adamw"], default=None)
    sp.add_argument("--ema-decay", dest="ema_decay", type=float, default=None,
                    help="parameter EMA decay (0 disables; the shadow is saved beside "
                         "the raw weights)")
    sp.add_argument("--cosine", action="store_true", help="cosine lr decay")
    sp.add_argument("--standardize", action="store_true",
                    help="per-frame z-score input standardization")
    sp.add_argument("--aug-gamma", dest="aug_gamma", type=float, default=None,
                    help="log-range of per-item random gamma (0 disables)")
    sp.add_argument("--aug-illum", dest="aug_illum", type=float, default=None,
                    help="strength of the low-frequency multiplicative illumination "
                         "augmentation (0 disables)")
    sp.add_argument("--aug-noise", dest="aug_noise", type=float, default=None,
                    help="max additive Gaussian noise std (0 disables)")
    sp.add_argument("--three-class", dest="three_class", action="store_true",
                    help="train background/interior/border")
    sp.add_argument("--max-steps", type=int, default=None)
    sp.add_argument("--classes", type=int, default=None)
    sp.add_argument("--bilinear", action="store_true")
    sp.add_argument("--mesh", choices=["auto", "on", "off"], default=None,
                    help="device-mesh DP train: auto (mesh when >1 device), "
                    "on, or off (default auto)")
    sp.add_argument("--coordinator", default=None,
                    help="torch.distributed coordinator address host:port "
                    "(multi-process; or env UNETSEG_COORDINATOR)")
    sp.add_argument("--num-processes", dest="num_processes", type=int,
                    default=None, help="total processes (multi-process)")
    sp.add_argument("--process-id", dest="process_id", type=int, default=None,
                    help="this process's id (multi-process)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("infer", help="segment one image")
    _add_common(sp)
    _add_checkpoint_flags(sp)
    sp.add_argument("--input", required=True)
    sp.add_argument("--output", default=None)
    sp.add_argument("--threshold", type=float, default=None)
    sp.add_argument("--tiled", action="store_true", help="overlap-tile full resolution")
    sp.add_argument("--normalize", action="store_const", const=True, default=None,
                    help="apply Normalize(0.5,0.5) like the reference's predict.py "
                         "(its training does not normalize - documented skew)")
    sp.add_argument("--classes", type=int, default=None)
    sp.add_argument("--bilinear", action="store_true")
    sp.set_defaults(fn=cmd_infer)

    sp = sub.add_parser("predict", help="segment a sequence into masks + instances")
    _add_common(sp)
    _add_checkpoint_flags(sp, ensemble=True)
    sp.add_argument("--data-root", default=None)
    sp.add_argument("--sequence", default=None)
    sp.add_argument("--output-dir", default=None)
    sp.add_argument("--threshold", type=float, default=None)
    sp.add_argument("--min-cell-size", dest="min_cell_size", type=int, default=None)
    sp.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    sp.add_argument("--tiled", action="store_true")
    sp.add_argument("--normalize", action="store_const", const=True, default=None,
                    help="apply Normalize(0.5,0.5) like the reference's predict.py")
    sp.add_argument("--standardize", action="store_const", const=True, default=None,
                    help="per-frame z-score (must match training)")
    sp.add_argument("--three-class", dest="three_class", action="store_true",
                    help="model was trained with --three-class")
    sp.add_argument("--watershed", action="store_true",
                    help="split touching cells via distance-transform watershed")
    sp.add_argument("--temporal-markers", dest="temporal_markers", action="store_true",
                    help="watershed re-seeded from the previous frame's instance cores where "
                         "the distance transform under-segments (implies --watershed)")
    sp.add_argument("--marker-frac", dest="marker_frac", type=float, default=0.5,
                    help="watershed marker threshold as a fraction of each component's "
                         "distance maximum")
    sp.add_argument("--temporal-bidi", dest="temporal_bidi", action="store_const", const=True,
                    default=None,
                    help="backward temporal sweep: propagate later frames' instance "
                         "boundaries back so early frames split too (needs "
                         "--temporal-markers)")
    sp.add_argument("--no-temporal-bidi", dest="temporal_bidi", action="store_const",
                    const=False,
                    help="explicitly disable the backward sweep (overrides a --config that "
                         "enables it)")
    sp.add_argument("--ensemble-merge", dest="ensemble_merge", choices=["mean", "gmean", "vote"],
                    default=None,
                    help="deep-ensemble member merge (binary head): mean, geometric mean, or "
                         "per-member-threshold majority vote")
    sp.add_argument("--boundary-grow", dest="boundary_grow", type=float, default=None,
                    help="grow instances up to this many px into background at write time "
                         "(post/boundary.py)")
    sp.add_argument("--tta", choices=["none", "flips", "flips8"], default=None,
                    help="test-time augmentation for tiled binary prediction: combine "
                         "probabilities over flips (4x device compute)")
    sp.add_argument("--tta-merge", dest="tta_merge", choices=["mean", "gmean", "vote", "max"],
                    default=None,
                    help="how TTA probabilities merge: mean, gmean (geometric), vote "
                         "(per-flip threshold + strict pixel majority), max (union)")
    sp.add_argument("--resize-output", dest="resize_output", type=int, default=None,
                    help="nearest-resize outputs (e.g. 512 to match GT size)")
    sp.add_argument("--device-cc", dest="device_cc", action="store_true",
                    help="connected components on the card (probs -> threshold -> CC "
                         "without a mask round trip)")
    sp.add_argument("--classes", type=int, default=None)
    sp.add_argument("--bilinear", action="store_true")
    sp.set_defaults(fn=cmd_predict)

    sp = sub.add_parser("refine", help="backward temporal refinement of existing instance "
                                       "masks (no re-prediction; see predict --temporal-bidi)")
    sp.add_argument("--config")
    sp.add_argument("--masks-dir", required=True,
                    help="binary mask*.tif directory from a predict run")
    sp.add_argument("--instance-dir", required=True,
                    help="m*.tif instance masks from the same run")
    sp.add_argument("--output-dir", required=True, help="where refined m*.tif land")
    sp.add_argument("--marker-frac", dest="marker_frac", type=float, default=0.5)
    sp.add_argument("--boundary-grow", dest="boundary_grow", type=float, default=None,
                    help="grow radius the input instance masks were written with (default: "
                         "the --config value); trimmed before the sweep and re-applied after")
    sp.add_argument("--max-frames", dest="max_frames", type=int, default=8,
                    help="sweep depth from the sequence start (whole-sequence sweeps "
                         "pre-split dividing parents, a measured negative)")
    _add_host_cpu(sp)
    sp.set_defaults(fn=cmd_refine)

    sp = sub.add_parser("track", help="track instance masks into res_track.txt")
    sp.add_argument("--instance-dir", required=True)
    sp.add_argument("--output", default=None)
    sp.add_argument("--iou-track", type=float, default=0.3)
    sp.add_argument("--iou-division", type=float, default=0.1)
    sp.add_argument("--max-children", type=int, default=2)
    sp.add_argument("--faithful", action="store_true",
                    help="replicate the reference's stale active-label map")
    sp.add_argument("--reference-parent", action="store_true",
                    help="write parent -1 like the reference instead of CTC's 0")
    sp.add_argument("--ctc-dir", default=None,
                    help="also write a CTC-conformant result dir: maskNNN.tif relabeled by "
                         "track id + res_track.txt")
    sp.add_argument("--close-gaps", type=int, default=0, metavar="N",
                    help="link tracks across gaps of up to N frames (tracklet stitching)")
    sp.add_argument("--gap-iou", type=float, default=0.2)
    sp.add_argument("--no-division-from-matched", action="store_true",
                    help="reference division semantics only (unmatched-parent rule)")
    sp.add_argument("--min-child-frac", type=float, default=0.25,
                    help="area gate: every daughter >= this fraction of the parent area "
                         "(0 disables)")
    sp.add_argument("--prune-divisions", type=int, default=3, metavar="K",
                    help="revoke divisions whose childless daughter lives < K frames "
                         "(0 disables; forced off with --faithful)")
    _add_host_cpu(sp)
    sp.set_defaults(fn=cmd_track)

    sp = sub.add_parser("evaluate", help="IoU/Dice against silver truth")
    _add_common(sp)
    _add_checkpoint_flags(sp)
    sp.add_argument("--data-root", default=None)
    sp.add_argument("--sequences", nargs="*", default=None)
    sp.add_argument("--val-only", action="store_true")
    sp.add_argument("--val-percent", type=float, default=None,
                    help="validation fraction for --val-only (default: config)")
    sp.add_argument("--pooled", action="store_true",
                    help="pool all sequences into one dataset and split once (the "
                         "reference's ConcatDataset+random_split protocol)")
    sp.add_argument("--rand", action="store_true",
                    help="also report the Rand index of CC instances vs GT instances")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    sp.add_argument("--classes", type=int, default=None)
    sp.add_argument("--bilinear", action="store_true")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("evaluate-divisions",
                        help="division recall/precision vs GT lineage (man_track.txt)")
    sp.add_argument("--gt-dir", required=True, help="{seq}_GT/TRA directory")
    sp.add_argument("--res-dir", required=True,
                    help="CTC result dir (mask{NNN}.tif by track id)")
    sp.add_argument("--res-track", default=None)
    sp.add_argument("--frame-tolerance", type=int, default=2)
    sp.add_argument("--details", action="store_true")
    _add_host_cpu(sp)
    sp.set_defaults(fn=cmd_evaluate_divisions)

    sp = sub.add_parser("evaluate-ctc", help="official CTC SEG/TRA/DET measures")
    sp.add_argument("measure", choices=["seg", "tra", "det"])
    sp.add_argument("--gt-dir", required=True,
                    help="GT dir ({seq}_GT/SEG for seg, {seq}_GT/TRA for tra/det)")
    sp.add_argument("--res-dir", required=True)
    sp.add_argument("--res-track", default=None)
    sp.add_argument("--backend", choices=["native", "python"], default="native")
    _add_host_cpu(sp)
    sp.set_defaults(fn=cmd_evaluate_ctc)

    sp = sub.add_parser("visualize", help="overlay instances / track ids on frames")
    sp.add_argument("--instance-dir", required=True)
    sp.add_argument("--images-dir", required=True)
    sp.add_argument("--output-dir", required=True)
    sp.add_argument("--tracks", action="store_true", help="show stable track ids")
    sp.add_argument("--max-frames", type=int, default=10**9)
    sp.add_argument("--resize-image", action="store_true")
    _add_host_cpu(sp)
    sp.set_defaults(fn=cmd_visualize)

    sp = sub.add_parser("visualize-prediction", help="original / GT / prediction panel figure")
    sp.add_argument("--input", required=True)
    sp.add_argument("--gt", default=None)
    sp.add_argument("--prediction", required=True)
    sp.add_argument("--output", required=True)
    _add_host_cpu(sp)
    sp.set_defaults(fn=cmd_visualize_prediction)

    sp = sub.add_parser("visualize-augmentation", help="original vs elastically deformed panel")
    sp.add_argument("--input", required=True)
    sp.add_argument("--mask", required=True)
    sp.add_argument("--output", required=True)
    sp.add_argument("--alpha", type=float, default=2000.0)
    sp.add_argument("--sigma", type=float, default=20.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--cpu", action="store_true",
                    help="deform on the CPU (the sampler's plain version) instead of the card")
    sp.set_defaults(fn=cmd_visualize_augmentation)

    sp = sub.add_parser("rescue-labels",
                        help="gold-marker-seeded faint-cell label rescue into an overlay data "
                             "root (train against it; evaluate the OTHER sequence)")
    sp.add_argument("--data-root", required=True)
    sp.add_argument("--output-root", required=True)
    sp.add_argument("--rescue-sequences", nargs="+", required=True,
                    help="sequences whose labels get rescued from their gold TRA markers "
                         "(leaks into THEIR eval)")
    sp.add_argument("--passthrough-sequences", nargs="*", default=None,
                    help="sequences symlinked verbatim (silver labels)")
    sp.add_argument("--cover-thresh", type=float, default=0.5)
    sp.add_argument("--core-radius", type=float, default=30.0)
    sp.add_argument("--ignore-radius", type=float, default=70.0)
    sp.add_argument("--core-weight", type=float, default=3.0)
    # regenerated weight maps must match the dataset's preprocess settings
    # or rescued vs passthrough frames mix two weight-map formulas
    sp.add_argument("--w0", type=float, default=10.0)
    sp.add_argument("--sigma", type=float, default=5.0)
    sp.add_argument("--mode", choices=["reference", "paper"], default="reference")
    _add_host_cpu(sp)
    sp.set_defaults(fn=cmd_rescue_labels)

    sp = sub.add_parser("export", help="export the folded inference forward as a portable "
                                       "serving artifact (torch.export; weights baked in)")
    _add_common(sp)
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--torch-checkpoint", default=None)
    sp.add_argument("--epoch", type=int, default=None)
    sp.add_argument("--output", default=None)
    sp.add_argument("--batch", type=int, default=None,
                    help="pin the batch dimension (default: symbolic)")
    sp.add_argument("--platforms", default="cuda,cpu",
                    help="comma-separated devices the artifact is for")
    sp.add_argument("--image-size", type=int, default=None)
    sp.add_argument("--normalize", action="store_const", const=True, default=None)
    sp.add_argument("--standardize", action="store_const", const=True, default=None)
    sp.add_argument("--classes", type=int, default=None)
    sp.add_argument("--bilinear", action="store_true")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("bench", help="run the performance benchmark")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("pipeline",
                        help="preprocess -> train -> predict -> track -> evaluate-ctc in one "
                             "command")
    sp.add_argument("--config")
    sp.add_argument("--data-root", required=True)
    sp.add_argument("--sequences", nargs="+", default=["01"])
    sp.add_argument("--output-dir", required=True)
    sp.add_argument("--checkpoint-dir", help="default <output-dir>/checkpoints")
    sp.add_argument("--tiled", action="store_true", default=True)
    sp.add_argument("--no-tiled", dest="tiled", action="store_false")
    sp.add_argument("--resize-output", dest="resize_output", type=int, default=None,
                    help="nearest-resize predictions (non-tiled path) so CTC scoring sees GT "
                         "resolution")
    sp.add_argument("--skip-preprocess", action="store_true")
    sp.add_argument("--skip-train", action="store_true",
                    help="reuse an existing --checkpoint-dir")
    sp.add_argument("--tta", choices=["none", "flips", "flips8"], default=None,
                    help="forwarded to predict")
    sp.add_argument("--tta-merge", dest="tta_merge", choices=["mean", "gmean", "vote", "max"],
                    default=None, help="forwarded to predict")
    sp.add_argument("--temporal-bidi", dest="temporal_bidi", action="store_const", const=True,
                    default=None, help="forwarded to predict")
    sp.add_argument("--no-temporal-bidi", dest="temporal_bidi", action="store_const",
                    const=False, help="forwarded to predict")
    sp.add_argument("--ensemble-merge", dest="ensemble_merge", choices=["mean", "gmean", "vote"],
                    default=None, help="forwarded to predict")
    sp.add_argument("--boundary-grow", dest="boundary_grow", type=float, default=None,
                    help="forwarded to predict")
    sp.add_argument("--ema", action="store_true", default=None,
                    help="forwarded to predict: evaluate the EMA weight shadow")
    sp.add_argument("--no-ema", dest="ema", action="store_false",
                    help="force raw weights even if the config sets use_ema")
    sp.add_argument("--ema-both", dest="ema_both", action="store_true",
                    help="ensemble: two members per checkpoint dir (raw + EMA shadow)")
    sp.add_argument("--cpu", action="store_true",
                    help="run preprocess, train and predict on the CPU (the kernels' plain "
                         "versions) instead of the card")
    sp.set_defaults(fn=cmd_pipeline)
    return p


def _add_host_cpu(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cpu", action="store_true",
                   help="accepted for the other commands' lines: this command is a host "
                        "computation either way")


def _add_checkpoint_flags(p: argparse.ArgumentParser, ensemble: bool = False) -> None:
    p.add_argument("--checkpoint-dir", default=None,
                   help="one dir, or comma-separated dirs for a deep ensemble (member "
                        "probabilities merged on the card)")
    p.add_argument("--ema", action="store_true", default=None,
                   help="load the EMA weight shadow instead of the raw weights (requires "
                        "TrainConfig.ema_decay > 0 at training time)")
    p.add_argument("--no-ema", dest="ema", action="store_false",
                   help="force raw weights even if the config sets use_ema")
    if ensemble:
        p.add_argument("--ema-both", dest="ema_both", action="store_true",
                       help="ensemble: two members per checkpoint dir (raw + EMA shadow)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference-format .pth state dict (migration path)")
    p.add_argument("--epoch", type=int, default=None)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    args.argv = argv
    return args.fn(args)
