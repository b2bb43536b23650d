"""Command-line interface of the port (counterpart of the `preprocess` and
`train` subcommands of unetseg_tpu/cli/main.py):

    python -m unetseg_tpu_torch preprocess --data-root ... --sequence 01 [--mode paper]
    python -m unetseg_tpu_torch train --data-root ... [--config configs/best_recipe.json]

Flags and defaults are the JAX command's, apart from its mesh and
multi-process flags (data parallelism is not ported). Both commands run
on the card; `--cpu` runs them on the CPU instead. The preprocess
command's reference mode is a host formula (scipy) with no device
version, so it runs on the host either way.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np

from unetseg_tpu_torch.core.config import Config, ModelConfig


def _load_config(args) -> Config:
    return Config.from_json_file(args.config) if args.config else Config()


def _device(args) -> str:
    return "cpu" if args.cpu else "cuda"


def _model_cfg(cfg: Config, args) -> ModelConfig:
    kw = {}
    if args.three_class:
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


# -------------------------------------------------------------------- parser
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="unetseg_tpu_torch",
        description="U-Net cell segmentation, PyTorch + CUDA port: weight maps and training",
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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
