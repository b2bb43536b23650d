"""Command-line interface of the port (counterpart of the `preprocess`,
`train`, `infer`, `predict` and `refine` subcommands of
unetseg_tpu/cli/main.py):

    python -m unetseg_tpu_torch preprocess --data-root ... --sequence 01 [--mode paper]
    python -m unetseg_tpu_torch train --data-root ... [--config configs/best_recipe.json]
    python -m unetseg_tpu_torch infer --checkpoint-dir ... --input t000.tif
    python -m unetseg_tpu_torch predict --checkpoint-dir ... --data-root ... [--tiled]
    python -m unetseg_tpu_torch refine --masks-dir ... --instance-dir ... --output-dir ...

Flags and defaults are the JAX command's, apart from its mesh and
multi-process flags (data parallelism is not ported). The commands run
on the card; `--cpu` runs them on the CPU instead. The preprocess
command's reference mode and the refine command are host computations
(scipy, the native watershed) with no device version, so they run on the
host either way.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np

from unetseg_tpu_torch.core.config import Config, InferConfig, ModelConfig


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
def cmd_train(args) -> int:
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
    data = HeLaArrays.load_many(cfg.data, args.sequences) if args.sequences else None
    result = train(cfg, data=data, max_steps=args.max_steps, device=_device(args))
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


# -------------------------------------------------------------------- parser
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="unetseg_tpu_torch",
        description="U-Net cell segmentation, PyTorch + CUDA port: weight maps, training "
                    "and prediction",
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
    sp.add_argument("--cpu", action="store_true",
                    help="accepted for the other commands' lines: refine is a host "
                         "computation (scipy and the native watershed) either way")
    sp.set_defaults(fn=cmd_refine)
    return p


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
    args = build_parser().parse_args(argv)
    return args.fn(args)
