"""Inference engine: single image, overlap-tile, device connected
components and sequence prediction (counterpart of
unetseg_tpu/infer/engine.py:Predictor).

The Predictor folds BatchNorm into the convolutions once per member,
keeps the folded nets on an explicit device, and runs every forward under
`torch.inference_mode()`. For the 5-level transposed-conv U-Net it runs
the kernel forward (infer/kernel_net.py), as the JAX Predictor runs its
Pallas forward on a TPU; other nets run FoldedUNet's plain forward. It
never moves work to another device by itself.

Ensembles: `variables` may be a list of variable trees (one per trained
seed, or raw and EMA weights of each). Member probabilities merge per
forward chunk, before the TTA merge and the stitch, by
`InferConfig.ensemble_merge` ("mean", "gmean" or "vote"; a 3-class head
always takes the mean). One member's activations are held at a time:
each member's probabilities are added into one accumulator.

The kernel forward's serving variants are keyword arguments of the
Predictor, with the JAX Predictor's defaults; they take the place of its
environment switches (unetseg_tpu/infer/engine.py:149-171) and apply to
every member:

    tier2=False       UNETSEG_LANES_TIER2=1   enc1 and dec2 through the kernels
    fused_enc0=False  UNETSEG_FUSED_ENC0=1    stem + enc0 conv1 + pool in one kernel
    dec_fuse="head"   UNETSEG_DEC_FUSE        "head" or "tail"
    cblock=()         UNETSEG_CBLOCK          "all" or names such as "enc2c1"

An unknown dec_fuse or cblock name raises (the JAX "none", which runs the
head outside the kernels, among them), and so does any variant the
kernel forward cannot run for this net on this device: a request never
silently becomes another forward.

Tile-sharded serving: with `mesh` (core/mesh.MeshSpec) the tiled paths
(`masks_tiled`, `probs_tiled` and the sequence core's tiled chunks) shard
each forward chunk's tiles over the mesh's ranks and gather the shares
(infer/tiling.py), as the JAX Predictor's mesh does. Unlike the JAX
Predictor, which leaves its kernel path under a mesh because GSPMD cannot
partition a pallas_call, every rank here runs whole kernels on its own
card, so the kernel forward stays on. Its kernels sum each output in
one fixed order whatever the chunk's batch, so the masks are the
single-rank masks bit for bit. The other paths run whole on every rank.

Sequences: `predict_frames` is the in-memory core (frames and their
numbers in; frame number, binary mask and instances out, one frame at a
time) and `predict_sequence` the file layer around it (t*.tif in,
mask{NNN}.tif and m{NNN}.tif out). PIL is imported only by the functions
that read, resize or write images.
"""

from __future__ import annotations

import os
from itertools import islice
from typing import (
    Any, Callable, Collection, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch

from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
from unetseg_tpu_torch.core.mesh import MeshSpec
from unetseg_tpu_torch.data.io import frame_number, sorted_frames, write_mask_u16, write_mask_u8
from unetseg_tpu_torch.infer.folding import fold_batchnorm
from unetseg_tpu_torch.infer.kernel_net import check_options, supports, supports_tier2
from unetseg_tpu_torch.infer.serving import member_probs, normalize_input
from unetseg_tpu_torch.infer.tiling import (
    TTA_TRANSFORMS,
    make_tiled_fn,
    make_tiled_mask_batch_fn,
    plan_tiles,
)
from unetseg_tpu_torch.post.boundary import grow_instances
from unetseg_tpu_torch.post.cc import get_instance_masks
from unetseg_tpu_torch.post.cc_device import compact_labels, label_components_device
from unetseg_tpu_torch.post.temporal import refine_backward, temporal_instance_masks
from unetseg_tpu_torch.post.watershed import expand_markers, get_instance_masks_watershed
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict
from unetseg_tpu_torch.utils.profiling import annotate

MERGES = ("gmean", "max", "mean", "vote")
ENSEMBLE_MERGES = ("gmean", "mean", "vote")


def _resize_nearest_binary(mask: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor resize of a {0,1} uint8 mask to (size, size)."""
    from PIL import Image

    return np.asarray(
        Image.fromarray(mask * 255).resize((size, size), Image.NEAREST)
    ) // 255


def _resize_nearest_labels(raw: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor resize of int32 labels on the binary masks' grid."""
    from PIL import Image

    return np.asarray(
        Image.fromarray(raw.astype(np.int32), mode="I").resize((size, size), Image.NEAREST)
    )


def load_image_01(path: str, image_size: Optional[int] = None) -> np.ndarray:
    """Grayscale [0,1], optional bilinear resize — torchvision ToTensor +
    Resize semantics (reference: scripts/predict.py:76-77)."""
    from PIL import Image

    img = Image.open(path).convert("L")
    if image_size is not None and img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


class Predictor:
    """Folded U-Net members on `device` with single-image, tiled,
    device-CC and sequence prediction.

    `variables` is the JAX package's {'params', 'batch_stats'} tree of
    arrays (see utils/flax_bridge.py), or a list of them for an ensemble.
    `mesh` shards the tiled paths' tiles over its ranks; `device` is then
    this rank's device."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        variables: Union[Mapping[str, Any], Sequence[Mapping[str, Any]]],
        cfg: InferConfig,
        device: Union[str, torch.device],
        *,
        tier2: bool = False,
        fused_enc0: bool = False,
        dec_fuse: str = "head",
        cblock: Collection[str] = (),
        mesh: Optional[MeshSpec] = None,
    ):
        if cfg.tta not in TTA_TRANSFORMS:
            raise ValueError(
                f"InferConfig.tta={cfg.tta!r}; expected one of {sorted(TTA_TRANSFORMS)}"
            )
        for name, allowed in (("tta_merge", MERGES), ("ensemble_merge", ENSEMBLE_MERGES)):
            if getattr(cfg, name) not in allowed:
                raise ValueError(
                    f"InferConfig.{name}={getattr(cfg, name)!r}; expected one of {list(allowed)}"
                )
        members = list(variables) if isinstance(variables, (list, tuple)) else [variables]
        if not members:
            raise ValueError("an ensemble needs at least one member")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.options = dict(tier2=tier2, fused_enc0=fused_enc0, dec_fuse=dec_fuse,
                            cblock=check_options(model_cfg, dec_fuse, cblock))
        self.uses_kernels = supports(model_cfg, self.device)
        if tier2 and not supports_tier2(model_cfg, self.device):
            raise ValueError(f"tier2: the kernel forward does not run this net on {self.device}")
        if (fused_enc0 or dec_fuse != "head" or self.options["cblock"]) and not self.uses_kernels:
            raise ValueError(f"fused_enc0, dec_fuse and cblock choose kernels of the kernel "
                             f"forward, which does not run this net on {self.device}")
        self.members = [fold_batchnorm(model_cfg, flax_to_state_dict(v)).to(self.device)
                        for v in members]
        self.folded = self.members[0]

    # ------------------------------------------------------------- forward
    def _probs(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W) on the device -> (B, h', w') foreground probability, or
        (B, h', w', 3) class probabilities for a 3-class head; an
        ensemble's members merged by cfg.ensemble_merge."""
        x = normalize_input(images, self.cfg)
        if len(self.members) == 1:
            return member_probs(self.folded, x, self.uses_kernels, self.options)
        # Member PROBABILITIES (post-softmax/sigmoid) combine: "mean" is the
        # standard deep-ensemble merge but smooths the thin membranes
        # between touching cells where members disagree; "gmean" keeps a
        # near-zero member authoritative; "vote" thresholds each member and
        # returns the strict majority as {0, 1} probabilities.
        merge, m = self.cfg.ensemble_merge, len(self.members)
        acc = None
        for net in self.members:
            p = member_probs(net, x, self.uses_kernels, self.options)
            binary = p.dim() == 3
            if binary and merge == "gmean":
                p = torch.log(p + 1e-7)
            elif binary and merge == "vote":
                p = (p > self.cfg.threshold).to(torch.int32)
            acc = p if acc is None else acc + p
        if binary and merge == "gmean":
            return torch.exp(acc / m)
        if binary and merge == "vote":
            return (acc * 2 > m).to(torch.float32)
        return acc / m

    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(images, np.float32)).to(self.device)

    @torch.inference_mode()
    def probs(self, images: np.ndarray) -> torch.Tensor:
        """(B, H, W) in [0,1] -> (B, h', w') foreground probability on the device."""
        return self._probs(self._to_device(images))

    @torch.inference_mode()
    def labels_device(self, images: np.ndarray) -> np.ndarray:
        """(B, H, W) images -> raw connected-component labels (B, h', w')
        int32: probabilities, threshold and labels on the device (see
        post/cc_device.py); pair with post.cc_device.compact_labels. A
        3-class head's foreground is p1 + p2 > threshold."""
        p = self._probs(self._to_device(images))
        thr = self.cfg.threshold
        fg = (p[..., 1] + p[..., 2] > thr) if p.dim() == 4 else (p > thr)
        return label_components_device(fg).cpu().numpy()

    @torch.inference_mode()
    def predict_image(self, image: np.ndarray) -> np.ndarray:
        """Single (H, W) image -> binary uint8 mask at the net's output size."""
        p = self._probs(self._to_device(image[None]))[0]
        return (p > self.cfg.threshold).to(torch.uint8).cpu().numpy()

    # --------------------------------------------------------- overlap-tile
    @torch.inference_mode()
    def probs_tiled(
        self,
        image: np.ndarray,
        tile_input: Optional[int] = None,
        tile_batch: Optional[int] = None,
    ) -> np.ndarray:
        """Full-resolution seamless probabilities (h, w), or (h, w, 3) for a
        3-class head, of an arbitrary-size (h, w) image via the overlap-tile
        strategy."""
        h, w = image.shape
        grid = plan_tiles(h, w, tile_input or self.cfg.tile_input)
        fn = make_tiled_fn(self._probs, grid, tile_batch=tile_batch or self.cfg.tile_batch,
                           mesh=self.mesh)
        return fn(self._to_device(image)).cpu().numpy()

    def predict_image_tiled(self, image: np.ndarray) -> np.ndarray:
        return (self.probs_tiled(image) > self.cfg.threshold).astype(np.uint8)

    @torch.inference_mode()
    def masks_tiled(
        self,
        images: np.ndarray,
        tile_input: Optional[int] = None,
        tile_batch: Optional[int] = None,
    ) -> np.ndarray:
        """Binary uint8 masks (F, H, W) for a batch of (F, H, W) frames:
        pad -> tile -> forward -> stitch -> threshold on the device, all
        frames' tiles pooled into shared forward chunks of `tile_batch`.
        Spans (utils/profiling): serve.call over serve.copy_in, the copy
        to the device; serve.dispatch, planning and enqueueing the work;
        serve.copy_out, the wait for the device and the copy back."""
        with annotate("serve.call"):
            with annotate("serve.copy_in"):
                x = self._to_device(images)
            with annotate("serve.dispatch"):
                f, h, w = images.shape
                fn = make_tiled_mask_batch_fn(
                    self._probs, plan_tiles(h, w, tile_input or self.cfg.tile_input),
                    n_frames=f, threshold=self.cfg.threshold,
                    tile_batch=tile_batch or self.cfg.tile_batch,
                    tta=self.cfg.tta, tta_merge=self.cfg.tta_merge, mesh=self.mesh,
                )
                masks = fn(x)
            with annotate("serve.copy_out"):
                return masks.cpu().numpy()

    # ------------------------------------------------------------ sequence
    def _chunk_masks(self, images: np.ndarray, tiled: bool, device_cc: bool):
        """(binary, interior or None, raw device labels or None) of a chunk."""
        if tiled and self.model_cfg.num_classes != 3:
            return self.masks_tiled(images), None, None
        if tiled:
            probs = np.stack([self.probs_tiled(img) for img in images])
        elif device_cc:
            # probs -> threshold -> CC stays on the device; only the int32
            # label maps come back (binary = labels > 0)
            raw = self.labels_device(images)
            return (raw > 0).astype(np.uint8), None, raw
        else:
            probs = self.probs(images).cpu().numpy()
        if probs.ndim == 4:  # three-class head
            fg_prob = probs[..., 1] + probs[..., 2]
            return ((fg_prob > self.cfg.threshold).astype(np.uint8),
                    (np.argmax(probs, -1) == 1).astype(np.uint8), None)
        return (probs > self.cfg.threshold).astype(np.uint8), None, None

    def predict_frames(
        self,
        frames: Iterable[np.ndarray],
        numbers: Sequence[int],
        batch_size: Optional[int] = None,
        tiled: bool = False,
        resize_output_to: Optional[int] = None,
        progress: Optional[Callable[[int, int], None]] = None,
        watershed: bool = False,
        marker_frac: float = 0.5,
        device_cc: bool = False,
        temporal_markers: bool = False,
        temporal_bidi: bool = False,
    ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """The in-memory sequence core: (H, W) frames in [0, 1] (already at
        cfg.image_size unless `tiled`), in time order, with their frame
        numbers -> an iterator of (number, uint8 {0,1} mask, uint16
        instances before the boundary grow), one per frame, in the order
        their instances are final: with `temporal_bidi` the first
        cfg.temporal_bidi_frames + 1 frames come last, after the backward
        sweep. Frames are read `batch_size` (default cfg.tile_batch) at a
        time. The options are predict_sequence's; an invalid combination
        raises here, before any frame is read."""
        if device_cc and (tiled or self.model_cfg.num_classes == 3):
            raise ValueError(
                "device_cc applies to the batched binary path only "
                "(tiled and 3-class predictions post-process on host)"
            )
        if temporal_markers and device_cc:
            raise ValueError(
                "temporal_markers re-seeds the host watershed from the "
                "previous frame and is incompatible with device_cc"
            )
        if temporal_bidi and not temporal_markers:
            raise ValueError("temporal_bidi refines the temporal_markers "
                             "pass; enable both")
        bs = batch_size or self.cfg.tile_batch
        frames, numbers = iter(frames), list(numbers)

        def run() -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
            cfg = self.cfg
            prev_inst: Optional[np.ndarray] = None  # temporal-marker state
            window: List[tuple] = []  # backward-sweep frames: (number, binary, instances)
            for start in range(0, len(numbers), bs):
                nums = numbers[start : start + bs]
                images = np.stack(list(islice(frames, len(nums))))
                binary, interior, raw_labels = self._chunk_masks(images, tiled, device_cc)
                for k, num in enumerate(nums):
                    b = binary[k]
                    inter = interior[k] if interior is not None else None
                    raw = raw_labels[k] if raw_labels is not None else None
                    if resize_output_to is not None and b.shape[0] != resize_output_to:
                        b = _resize_nearest_binary(b, resize_output_to)
                        if inter is not None:
                            # the marker map must track the mask's geometry
                            inter = _resize_nearest_binary(inter, resize_output_to)
                        if raw is not None:
                            # same NEAREST grid as the mask, so labels > 0 == b and
                            # min_size is measured at the saved resolution
                            raw = _resize_nearest_labels(raw, resize_output_to)
                    if inter is not None:
                        inst = expand_markers(b, inter, min_size=cfg.min_cell_size)
                    elif temporal_markers:
                        # split under-segmented components with the previous
                        # frame's instance cores (post/temporal.py)
                        inst = temporal_instance_masks(
                            b, prev_inst, min_size=cfg.min_cell_size, marker_frac=marker_frac,
                            area_guard=cfg.temporal_area_guard,
                        )
                        prev_inst = inst
                    elif watershed:
                        inst = get_instance_masks_watershed(
                            b, min_size=cfg.min_cell_size, marker_frac=marker_frac)
                    elif raw is not None:
                        inst = compact_labels(raw, min_size=cfg.min_cell_size, relabel=False)
                    else:
                        inst = get_instance_masks(b, min_size=cfg.min_cell_size)
                    if temporal_bidi and len(window) <= cfg.temporal_bidi_frames:
                        # held for the sweep window only: frames past
                        # temporal_bidi_frames are untouched by the depth-bounded
                        # backward sweep, so they are final now
                        window.append((num, b, inst))
                    else:
                        yield num, b, inst
                if progress:
                    progress(min(start + bs, len(numbers)), len(numbers))
            if temporal_bidi:
                refined = refine_backward(
                    [b for _, b, _ in window], [i for _, _, i in window],
                    min_size=cfg.min_cell_size, marker_frac=marker_frac,
                    area_guard=cfg.temporal_area_guard, max_frames=cfg.temporal_bidi_frames,
                )
                for (num, b, _), inst in zip(window, refined):
                    yield num, b, inst

        return run()

    def predict_sequence(
        self,
        input_dir: str,
        output_masks_dir: str,
        output_instance_dir: str,
        batch_size: Optional[int] = None,
        tiled: bool = False,
        resize_output_to: Optional[int] = None,
        progress: Optional[Callable[[int, int], None]] = None,
        watershed: bool = False,
        marker_frac: float = 0.5,
        device_cc: bool = False,
        temporal_markers: bool = False,
        temporal_bidi: bool = False,
    ) -> List[str]:
        """Predict every t*.tif frame -> mask{NNN}.tif (0/255) +
        m{NNN}.tif (uint16 instances, grown by cfg.boundary_grow)
        (reference: scripts/predict.py:57-116); returns the written paths
        in write order. With `tiled=True` frames keep their native
        resolution (no resize, no valid-conv shrink). `resize_output_to`
        nearest-resizes the saved masks (the reference's 324x324 outputs
        score SEG=0.0 against 512x512 GT; pass 512 to fix, None to
        reproduce faithfully)."""
        os.makedirs(output_masks_dir, exist_ok=True)
        os.makedirs(output_instance_dir, exist_ok=True)
        paths = sorted_frames(input_dir, "t*.tif")
        if not paths:
            raise FileNotFoundError(f"no t*.tif frames in {input_dir}")
        size = None if tiled else self.cfg.image_size
        results = self.predict_frames(
            (load_image_01(p, size) for p in paths), [frame_number(p) for p in paths],
            batch_size=batch_size, tiled=tiled, resize_output_to=resize_output_to,
            progress=progress, watershed=watershed, marker_frac=marker_frac,
            device_cc=device_cc, temporal_markers=temporal_markers, temporal_bidi=temporal_bidi,
        )
        written: List[str] = []
        for num, b, inst in results:
            mask_path = os.path.join(output_masks_dir, f"mask{num:03d}.tif")
            inst_path = os.path.join(output_instance_dir, f"m{num:03d}.tif")
            write_mask_u8(mask_path, b)
            write_mask_u16(inst_path, self._grown(inst))
            written += [mask_path, inst_path]
        return written

    def _grown(self, inst: np.ndarray) -> np.ndarray:
        """Instance-write epilogue: the configured boundary grow
        (post/boundary.py). Applied only at write time so the temporal /
        bidi state machines always see ungrown instances."""
        if self.cfg.boundary_grow > 0:
            return grow_instances(inst, self.cfg.boundary_grow)
        return inst

    # ------------------------------------------------------- construction
    @classmethod
    def from_torch_checkpoint(
        cls,
        path: str,
        model_cfg: Optional[ModelConfig] = None,
        infer_cfg: Optional[InferConfig] = None,
        device: Union[str, torch.device] = "cuda",
        **options: Any,
    ) -> "Predictor":
        """Load a reference-format .pth state dict (see utils/torch_import),
        so reference users run their trained models here. `options` are the
        serving variants and the mesh of __init__."""
        from unetseg_tpu_torch.utils.torch_import import load_reference_checkpoint

        model_cfg = model_cfg or ModelConfig()
        variables = load_reference_checkpoint(path, levels=model_cfg.levels)
        return cls(model_cfg, variables, infer_cfg or InferConfig(), device, **options)

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_dir: str,
        model_cfg: Optional[ModelConfig] = None,
        infer_cfg: Optional[InferConfig] = None,
        epoch: Optional[int] = None,
        ema: bool = False,
        device: Union[str, torch.device] = "cuda",
        **options: Any,
    ) -> "Predictor":
        """From the port's light checkpoint stream (train/checkpoint.py): the
        best epoch, or `epoch`; `ema` takes the EMA shadow. `options` are
        the serving variants and the mesh of __init__."""
        from unetseg_tpu_torch.train.checkpoint import restore_params_for_inference

        variables = restore_params_for_inference(checkpoint_dir, epoch=epoch, ema=ema)
        return cls(model_cfg or ModelConfig(), variables, infer_cfg or InferConfig(), device,
                   **options)

    @classmethod
    def from_checkpoints(
        cls,
        checkpoint_dirs: List[str],
        model_cfg: Optional[ModelConfig] = None,
        infer_cfg: Optional[InferConfig] = None,
        ema: Any = False,
        device: Union[str, torch.device] = "cuda",
        **options: Any,
    ) -> "Predictor":
        """Deep-ensemble Predictor over several trained checkpoints (e.g.
        the per-seed best checkpoints of a multi-seed recipe run).

        ema: False = raw weights, True = each member's EMA shadow,
        "both" = two members per checkpoint (raw + EMA), a 2k-member
        ensemble from a k-seed training run. One directory without "both"
        is from_checkpoint. `options` are the serving variants and the
        mesh of __init__."""
        both = ema == "both"
        if len(checkpoint_dirs) == 1 and not both:
            return cls.from_checkpoint(
                checkpoint_dirs[0], model_cfg=model_cfg, infer_cfg=infer_cfg,
                ema=bool(ema), device=device, **options,
            )
        from unetseg_tpu_torch.train.checkpoint import restore_params_for_inference

        members = [restore_params_for_inference(d, ema=use)
                   for d in checkpoint_dirs for use in ((False, True) if both else (bool(ema),))]
        return cls(model_cfg or ModelConfig(), members, infer_cfg or InferConfig(), device,
                   **options)
