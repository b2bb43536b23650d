"""Inference engine: single-image and overlap-tile paths (counterpart of
unetseg_tpu/infer/engine.py:Predictor; ensembles, device connected
components and sequence prediction are not ported yet).

The Predictor folds BatchNorm into the convolutions once, keeps the
folded net on an explicit device, and runs every forward under
`torch.inference_mode()`. For the 5-level transposed-conv U-Net it runs
the kernel forward (infer/kernel_net.py), as the JAX Predictor runs its
Pallas forward on a TPU; other nets run FoldedUNet's plain forward. It
never moves work to another device by itself.

The kernel forward's serving variants are keyword arguments of the
Predictor, with the JAX Predictor's defaults; they take the place of its
environment switches (unetseg_tpu/infer/engine.py:149-171):

    tier2=False       UNETSEG_LANES_TIER2=1   enc1 and dec2 through the kernels
    fused_enc0=False  UNETSEG_FUSED_ENC0=1    stem + enc0 conv1 + pool in one kernel
    dec_fuse="head"   UNETSEG_DEC_FUSE        "head" or "tail"
    cblock=()         UNETSEG_CBLOCK          "all" or names such as "enc2c1"

An unknown dec_fuse or cblock name raises (the JAX "none", which runs the
head outside the kernels, among them), and so does any variant the
kernel forward cannot run for this net on this device: a request never
silently becomes another forward.
"""

from __future__ import annotations

from typing import Any, Collection, Mapping, Optional, Union

import numpy as np
import torch

from unetseg_tpu_torch.core.config import InferConfig, ModelConfig
from unetseg_tpu_torch.infer.folding import fold_batchnorm
from unetseg_tpu_torch.infer.kernel_net import (
    check_options,
    folded_forward_kernels,
    supports,
    supports_tier2,
)
from unetseg_tpu_torch.infer.tiling import (
    TTA_TRANSFORMS,
    make_tiled_mask_batch_fn,
    plan_tiles,
)
from unetseg_tpu_torch.ops.losses import binary_probs_from_logits
from unetseg_tpu_torch.utils.flax_bridge import flax_to_state_dict

MERGES = ("gmean", "max", "mean", "vote")


class Predictor:
    """Folded U-Net on `device` with single-image and tiled prediction.

    `variables` is the JAX package's {'params', 'batch_stats'} tree of
    arrays (see utils/flax_bridge.py)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        variables: Mapping[str, Any],
        cfg: InferConfig,
        device: Union[str, torch.device],
        *,
        tier2: bool = False,
        fused_enc0: bool = False,
        dec_fuse: str = "head",
        cblock: Collection[str] = (),
    ):
        if cfg.tta not in TTA_TRANSFORMS:
            raise ValueError(
                f"InferConfig.tta={cfg.tta!r}; expected one of {sorted(TTA_TRANSFORMS)}"
            )
        if cfg.tta_merge not in MERGES:
            raise ValueError(
                f"InferConfig.tta_merge={cfg.tta_merge!r}; expected one of {list(MERGES)}"
            )
        if isinstance(variables, (list, tuple)):
            raise TypeError("ensembles are not ported yet: pass one variable tree")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = torch.device(device)
        self.options = dict(tier2=tier2, fused_enc0=fused_enc0, dec_fuse=dec_fuse,
                            cblock=check_options(model_cfg, dec_fuse, cblock))
        self.uses_kernels = supports(model_cfg, self.device)
        if tier2 and not supports_tier2(model_cfg, self.device):
            raise ValueError(f"tier2: the kernel forward does not run this net on {self.device}")
        if (fused_enc0 or dec_fuse != "head" or self.options["cblock"]) and not self.uses_kernels:
            raise ValueError(f"fused_enc0, dec_fuse and cblock choose kernels of the kernel "
                             f"forward, which does not run this net on {self.device}")
        self.folded = fold_batchnorm(model_cfg, flax_to_state_dict(variables)).to(self.device)

    # ------------------------------------------------------------- forward
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.uses_kernels:
            return folded_forward_kernels(self.folded, x, **self.options)
        return self.folded(x)

    def _probs(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W) on the device -> (B, h', w') foreground probability, or
        (B, h', w', 3) class probabilities for a 3-class head."""
        x = images
        if self.cfg.standardize:
            mu = x.mean(dim=(-2, -1), keepdim=True)
            sd = x.std(dim=(-2, -1), keepdim=True, correction=0).clamp_min(1e-6)
            x = (x - mu) / sd
        elif self.cfg.normalize:
            x = (x - self.cfg.normalize_mean) / self.cfg.normalize_std
        logits = self._logits(x[..., None])
        if logits.shape[-1] == 3:
            return torch.softmax(logits.float(), dim=-1)
        return binary_probs_from_logits(logits)

    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(images, np.float32)).to(self.device)

    @torch.inference_mode()
    def probs(self, images: np.ndarray) -> torch.Tensor:
        """(B, H, W) in [0,1] -> (B, h', w') foreground probability on the device."""
        return self._probs(self._to_device(images))

    @torch.inference_mode()
    def predict_image(self, image: np.ndarray) -> np.ndarray:
        """Single (H, W) image -> binary uint8 mask at the net's output size."""
        p = self._probs(self._to_device(image[None]))[0]
        return (p > self.cfg.threshold).to(torch.uint8).cpu().numpy()

    # --------------------------------------------------------- overlap-tile
    @torch.inference_mode()
    def masks_tiled(
        self,
        images: np.ndarray,
        tile_input: Optional[int] = None,
        tile_batch: Optional[int] = None,
    ) -> np.ndarray:
        """Binary uint8 masks (F, H, W) for a batch of (F, H, W) frames:
        pad -> tile -> forward -> stitch -> threshold on the device, all
        frames' tiles pooled into shared forward chunks of `tile_batch`."""
        f, h, w = images.shape
        t_in = tile_input or self.cfg.tile_input
        t_batch = tile_batch or self.cfg.tile_batch
        fn = make_tiled_mask_batch_fn(
            self._probs, plan_tiles(h, w, t_in), n_frames=f,
            threshold=self.cfg.threshold, tile_batch=t_batch,
            tta=self.cfg.tta, tta_merge=self.cfg.tta_merge,
        )
        return fn(self._to_device(images)).cpu().numpy()
