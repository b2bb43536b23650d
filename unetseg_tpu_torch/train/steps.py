"""The augmented train step, the eval step and their whole-epoch forms
(counterpart of unetseg_tpu/train/steps.py).

One step: elastic augmentation -> photometric (gamma / illumination) ->
per-item standardization -> additive noise -> targets -> U-Net forward ->
center-cropped weighted softmax CE in fp32, averaged over the valid items'
pixels -> backward -> optimizer update (+ EMA). Spans (utils/profiling):
train.step over train.augment, train.forward (with the loss),
train.backward (with the all-reduce) and train.update.

Randomness comes from a torch.Generator, drawn per stage in that order
(AugmentDraws), where the JAX step folds distinct constants into one key;
a step can also be handed the draws, which is how the tests feed both
packages the same numbers.

The forward is the kernel train forward (models/train_forward.py) when
`lanes` resolves to on, else the plain train-mode UNet
(models/unet.unet_train_forward): "auto" takes the kernels on a CUDA
device at a geometry they take, "on" requires them (it raises where they
do not fit, and on the CPU runs the kernels' plain versions), "off"
never takes them. `tier2` runs the kernel train forward's tier 2 (enc1 and
dec2 through the kernels too; the JAX package's UNETSEG_LANES_TIER2_TRAIN)
and raises where the kernel forward is not taken. The weighted loss is
the fused weighted CE (ops/kernels/wce.py) on every path.

The epoch steps take the dataset resident on the device and an (S, B)
index matrix per epoch; a Python loop over its rows, gathering each
batch with index_select, takes the place of the JAX package's lax.scan.

Data parallelism (`mesh`, core/mesh.MeshSpec; parallel/sharding.py builds
these steps under the JAX package's names). Each rank is fed its B / D
items of a global batch of B (D = mesh.num_data) and computes what the
single-process step computes on the whole batch: the draws are made for
the global batch and sliced (each item's elastic field, photometric draw
and noise are the single-process step's), BatchNorm takes the global
moments, the loss is normalised by the global valid-pixel count, and the
gradients are summed over the data axis in one flat all-reduce before
grad_norm, the optimizer and the EMA, which then run identically on every
rank; the reported loss is the sum of the ranks' losses. A mesh of one
data rank runs the single-process step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.core.distributed import all_reduce_sum, all_reduce_tree
from unetseg_tpu_torch.core.mesh import MeshSpec
from unetseg_tpu_torch.models.shapes import center_crop_bounds
from unetseg_tpu_torch.models.train_forward import supports, supports_tier2, train_forward
from unetseg_tpu_torch.models.unet import UNet, unet_train_forward
from unetseg_tpu_torch.ops.elastic import draw_elastic, elastic_deform_batch
from unetseg_tpu_torch.ops.intensity import (
    draw_noise,
    draw_photometric,
    gaussian_noise_batch,
    photometric_augment_batch,
    standardize_batch,
)
from unetseg_tpu_torch.ops.kernels.update import global_norm_plain
from unetseg_tpu_torch.ops.losses import center_crop_nhw, per_pixel_ce, weighted_ce_pixels
from unetseg_tpu_torch.train.state import Gradients, TrainState
from unetseg_tpu_torch.utils.profiling import annotate

Forward = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class AugmentDraws:
    """The random numbers of one augmented step; None where a stage is off.

    elastic      (B, 2, H, W) U[-1, 1): the fields behind dx ([:, 0]), dy
    log_gamma    (B,) U[-aug_gamma, aug_gamma]
    illum        (B, 4, 4) U[-1, 1], the coarse illumination grid
    noise_sigma  (B,) U[0, aug_noise]
    noise        (B, H, W) standard normal
    """

    elastic: Optional[torch.Tensor] = None
    log_gamma: Optional[torch.Tensor] = None
    illum: Optional[torch.Tensor] = None
    noise_sigma: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None

    def rows(self, sl: slice) -> "AugmentDraws":
        """The draws of items `sl` (a rank's share of a global batch's)."""
        return AugmentDraws(**{f.name: None if getattr(self, f.name) is None
                               else getattr(self, f.name)[sl]
                               for f in dataclasses.fields(self)})


def data_group(mesh: Optional[MeshSpec]):
    """The process group a step sums over: the mesh's data axis, or None
    (no collective) without a mesh or with one data rank."""
    return None if mesh is None else mesh.data_group


def _masked_mean_loss(
    logits: torch.Tensor, full_targets: torch.Tensor,
    full_weights: Optional[torch.Tensor], valid: torch.Tensor,
    n_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean over the valid items' pixels of w * CE, targets and weights
    center-cropped to the logits (reference: scripts/train.py:118-128).
    The weighted case is the fused weighted CE (the JAX step's
    use_pallas_loss), which reads the uncropped targets and weights at the
    crop's offsets; the unweighted case (validation) is per_pixel_ce.
    `n_valid` is the normaliser's item count (the global count under data
    parallelism, JAX's n_pix); by default this batch's valid items."""
    th, tw = logits.shape[1], logits.shape[2]
    if full_weights is not None:
        row_off = center_crop_bounds(full_targets.shape[1], th)[0]
        col_off = center_crop_bounds(full_targets.shape[2], tw)[0]
        ce = weighted_ce_pixels(logits, full_targets, full_weights, row_off, col_off)
    else:
        ce = per_pixel_ce(logits, center_crop_nhw(full_targets, th, tw))
    item = valid.float()
    n_pix = (item.sum() if n_valid is None else n_valid).clamp_min(1.0) * (th * tw)
    return (ce * item[:, None, None]).sum() / n_pix


def three_class_targets(masks: torch.Tensor, halo: int = 2) -> torch.Tensor:
    """Instance labels -> {0 background, 1 interior, 2 border}: a foreground
    pixel is interior iff its (2*halo+1)^2 window holds only its own label
    (window min == max, the window clipped at the frame)."""
    k = 2 * halo + 1
    m = masks.double()[:, None]  # labels are exact in f64
    mx = F.max_pool2d(m, k, stride=1, padding=halo)
    mn = -F.max_pool2d(-m, k, stride=1, padding=halo)
    fg = masks > 0
    interior = fg & (mn == mx)[:, 0]
    return torch.where(interior, 1, torch.where(fg, 2, 0)).to(torch.int32)


def draw_augment(
    generator: torch.Generator, images: torch.Tensor, augment: bool,
    aug_gamma: float, aug_illum: float, aug_noise: float, batch: Optional[int] = None,
) -> AugmentDraws:
    """Draw every random number one step needs, stage by stage, for
    `batch` items (default: images' batch; a data-parallel step draws for
    the global batch)."""
    if not augment:
        return AugmentDraws()
    b, h, w = images.shape
    b = batch or b
    dev = images.device
    draws = AugmentDraws(elastic=draw_elastic(generator, b, h, w, dev))
    if aug_gamma > 0 or aug_illum > 0:
        draws.log_gamma, draws.illum = draw_photometric(
            generator, b, aug_gamma, aug_illum, device=dev)
    if aug_noise > 0:
        draws.noise_sigma, draws.noise = draw_noise(generator, (b, h, w), aug_noise, dev)
    return draws


def make_augmenter(
    augment: bool, elastic_alpha: float, elastic_sigma: float, three_class: bool,
    border_boost: float, standardize: bool, aug_gamma: float, aug_illum: float,
    aug_noise: float,
) -> Callable:
    """(images, masks, weights, draws) -> (images, targets, weights), the
    stage order of unetseg_tpu/train/steps.py:make_augmenter: elastic ->
    photometric ([0, 1] domain) -> standardize -> noise."""

    def apply(images, masks, weights, draws: AugmentDraws):
        if augment:
            # fresh field per item; image bilinear, labels nearest; the
            # weight maps are not deformed (reference: utils/dataset.py:83-93)
            images, masks = elastic_deform_batch(
                images, masks, draws.elastic, alpha=elastic_alpha, sigma=elastic_sigma)
            if aug_gamma > 0 or aug_illum > 0:
                images = photometric_augment_batch(
                    images, draws.log_gamma, draws.illum, illum=aug_illum)
        if standardize:
            images = standardize_batch(images)
        if augment and aug_noise > 0:
            images = gaussian_noise_batch(images, draws.noise_sigma, draws.noise)
        if three_class:
            targets = three_class_targets(masks)
            if border_boost != 1.0:
                weights = torch.where(targets == 2, weights * border_boost, weights)
        else:
            targets = (masks > 0).to(torch.int32)
        return images, targets, weights

    return apply


def lanes_active(mode: str, model_cfg: ModelConfig, input_size: int, device) -> bool:
    """Resolve TrainConfig.lanes ("auto" | "on" | "off") for a step on
    `device` at `input_size`, as unetseg_tpu/train/loop.lanes_active does
    for the TPU: "auto" takes the kernel train forward on a CUDA device at
    a geometry its kernels take; "on" raises where they do not."""
    if mode == "off":
        return False
    ok = supports(model_cfg, input_size, device)
    if mode == "on":
        if not ok:
            raise ValueError(
                f"lanes='on' but the kernel train forward does not take this "
                f"geometry on {device} (input_size={input_size}, levels="
                f"{model_cfg.levels}, base_features={model_cfg.base_features}, "
                f"compute_dtype={model_cfg.compute_dtype})")
        return True
    if mode != "auto":
        raise ValueError(f"lanes must be auto|on|off, got {mode!r}")
    return ok and torch.device(device).type == "cuda"


def loss_and_grads(
    forward: Forward, state: TrainState, images: torch.Tensor, targets: torch.Tensor,
    weights: Optional[torch.Tensor], valid: torch.Tensor, bn_mask: Optional[torch.Tensor],
    model_cfg: Optional[ModelConfig] = None, group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(loss, new batch stats, grads) of one forward/backward; a parameter
    the loss does not reach gets a zero gradient (as jax.grad gives).
    With a process `group` (the forward already bound to it) the loss is
    normalised by the group's valid-pixel count, and the loss and the
    gradients come back summed over the group: the whole batch's."""
    cfg = model_cfg or state.model_cfg
    with annotate("train.forward"), torch.enable_grad():
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        n_valid = None if group is None else all_reduce_sum(valid.float().sum(), group)
        logits, new_bs = forward(params, state.batch_stats, images[..., None], cfg, bn_mask)
        loss = _masked_mean_loss(logits, targets, weights, valid, n_valid)
    with annotate("train.backward"):
        keys = list(params)
        with torch.enable_grad():
            gs = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(keys, gs)}
        # one SUM all-reduce of every gradient: the loss is globally normalised,
        # so the sum is the whole batch's gradient (an average would divide it)
        return (all_reduce_sum(loss.detach(), group), new_bs,
                Gradients(all_reduce_tree(grads, group)))


def optax_global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32: the norm that the
    fused update already computed where it read `tree` (a Gradients)."""
    norm = getattr(tree, "global_norm", None)
    return global_norm_plain(tree.values()) if norm is None else norm


def make_train_step(
    model_cfg: Optional[ModelConfig] = None,
    augment: bool = True,
    elastic_alpha: float = 2000.0,
    elastic_sigma: float = 20.0,
    three_class: bool = False,
    border_boost: float = 1.0,
    standardize: bool = False,
    aug_gamma: float = 0.0,
    aug_illum: float = 0.0,
    aug_noise: float = 0.0,
    lanes: str = "auto",
    assume_valid: bool = False,
    tier2: bool = False,
    mesh: Optional[MeshSpec] = None,
) -> Callable:
    """Build the train step (unetseg_tpu/train/steps.py:151, without the
    JAX-only donate / jit / remat / Pallas-loss switches).

    step(state, images (B,H,W) f32 [0,1], masks (B,H,W) int32 instance
         labels, weights (B,H,W) f32, valid (B,) bool, generator, *,
         draws=None) -> (state, {"loss", "grad_norm"})

    `draws` (AugmentDraws) replaces the generator's draws. With
    `assume_valid` every item is promised real: BatchNorm gets no item
    mask, while `valid` still weights the loss. `model_cfg` defaults to
    the state's. `tier2` needs the kernel train forward: it raises
    ValueError here for lanes="off", and in the step where "auto" resolves
    to off or supports_tier2 fails. Under a `mesh` the arrays are this
    rank's share of the global batch, and `draws` are the global batch's
    (the step takes its rows)."""
    if tier2 and lanes == "off":
        raise ValueError("tier2 runs in the kernel train forward, which lanes='off' never takes")
    augmenter = make_augmenter(augment, elastic_alpha, elastic_sigma, three_class,
                               border_boost, standardize, aug_gamma, aug_illum, aug_noise)

    group = data_group(mesh)

    def step(state: TrainState, images, masks, weights, valid, generator=None, *, draws=None):
        with annotate("train.step"):
            cfg = model_cfg or state.model_cfg
            with annotate("train.augment"):
                n = images.shape[0] * (1 if mesh is None else mesh.num_data)
                if draws is None:
                    draws = draw_augment(generator, images, augment, aug_gamma, aug_illum,
                                         aug_noise, batch=n)
                if mesh is not None:
                    draws = draws.rows(mesh.batch_rows(n))
                images, targets, weights = augmenter(images, masks, weights, draws)
            use_kernels = lanes_active(lanes, cfg, images.shape[1], images.device)
            if tier2 and not (use_kernels and supports_tier2(cfg, images.shape[1],
                                                             images.device)):
                raise ValueError(
                    f"tier2 needs the kernel train forward, which lanes={lanes!r} does not "
                    f"take on {images.device} at input_size={images.shape[1]}")
            forward = (functools.partial(train_forward, tier2=tier2, group=group)
                       if use_kernels else functools.partial(unet_train_forward, group=group))
            bn_mask = None if assume_valid else valid
            loss, new_bs, grads = loss_and_grads(
                forward, state, images, targets, weights, valid, bn_mask, cfg, group)
            with annotate("train.update"):
                state = state.apply_gradients(grads, new_bs)
                return state, {"loss": loss, "grad_norm": optax_global_norm(grads)}

    return step


def make_epoch_train_step(
    model_cfg: Optional[ModelConfig] = None, inner_step: Optional[Callable] = None,
    mesh: Optional[MeshSpec] = None, **step_kw
) -> Callable:
    """Whole-epoch train step over a device-resident dataset
    (unetseg_tpu/train/steps.py:247).

    epoch_step(state, images_all (N,H,W) f32, masks_all (N,H,W) int32,
               wmaps_all (N,H,W) f32, idx (S,B) int, valid (S,B) bool,
               generator) -> (state, {"loss": (S,), "grad_norm": (S,)})

    The steps draw their augmentation from `generator` in order; the loop
    seeds it from (seed, epoch) alone, so a run resumed at an epoch
    boundary draws what an uninterrupted run draws. `inner_step` overrides
    make_train_step(model_cfg, mesh=mesh, **step_kw). The metrics stay on
    the device. Under a `mesh` the matrices are the global schedule and
    each rank gathers its columns of every row."""
    inner = inner_step or make_train_step(model_cfg, mesh=mesh, **step_kw)

    def epoch_step(state, images_all, masks_all, wmaps_all, idx, valid, generator=None):
        if mesh is not None:
            cols = mesh.batch_rows(idx.shape[1])
            idx, valid = idx[:, cols], valid[:, cols]
        metrics = []
        for ib, vb in zip(idx, valid):
            state, m = inner(state, images_all.index_select(0, ib), masks_all.index_select(0, ib),
                             wmaps_all.index_select(0, ib), vb, generator)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics]) for k in ("loss", "grad_norm")}

    return epoch_step


def make_epoch_eval_step(
    model_cfg: Optional[ModelConfig] = None, mesh: Optional[MeshSpec] = None, **eval_kw
) -> Callable:
    """Whole-validation eval over the device-resident dataset (the
    companion of make_epoch_train_step, unetseg_tpu/train/steps.py:308).

    epoch_eval(state, images_all, masks_all, idx (S,B), valid (S,B))
        -> {"val_loss": (S,), "val_acc": (S,), "val_iou": (S,)}
    Under a `mesh` each rank takes its columns, as the epoch train step."""
    inner = make_eval_step(model_cfg, mesh=mesh, **eval_kw)

    def epoch_eval(state, images_all, masks_all, idx, valid):
        if mesh is not None:
            cols = mesh.batch_rows(idx.shape[1])
            idx, valid = idx[:, cols], valid[:, cols]
        ms = [inner(state, images_all.index_select(0, ib), masks_all.index_select(0, ib), vb)
              for ib, vb in zip(idx, valid)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return epoch_eval


def make_eval_step(
    model_cfg: Optional[ModelConfig] = None, three_class: bool = False,
    standardize: bool = False,
    mesh: Optional[MeshSpec] = None,
) -> Callable:
    """Validation step (unetseg_tpu/train/steps.py:336): unweighted CE on
    the cropped targets over the valid items, pixel accuracy and the binary
    foreground IoU (classes {1, 2} count as foreground with three classes),
    through the eval-mode UNet (BatchNorm on its running statistics).

    step(state, images (B,H,W), masks (B,H,W) int32, valid (B,) bool)
        -> {"val_loss", "val_acc", "val_iou"} as device scalars
    Under a `mesh` the arrays are this rank's share and the metrics the
    global batch's: the summed per-rank losses over the global normaliser,
    and accuracy and IoU from the summed counts."""
    nets: Dict[ModelConfig, UNet] = {}
    group = data_group(mesh)

    @torch.no_grad()
    def step(state: TrainState, images, masks, valid):
        cfg = model_cfg or state.model_cfg
        if cfg not in nets:  # the state's tensors stand in for the module's
            with torch.device("meta"):
                nets[cfg] = UNet(cfg)
        net = nets[cfg]
        if standardize:
            images = standardize_batch(images)
        targets = three_class_targets(masks) if three_class else (masks > 0).to(torch.int32)
        logits = torch.func.functional_call(
            net, {**state.params, **state.batch_stats}, (images[..., None],))
        n_valid = None if group is None else all_reduce_sum(valid.float().sum(), group)
        loss = all_reduce_sum(_masked_mean_loss(logits, targets, None, valid, n_valid), group)
        th, tw = logits.shape[1], logits.shape[2]
        t = center_crop_nhw(targets, th, tw)
        pred = logits.argmax(-1)
        item = valid[:, None, None]
        right, n_items = (all_reduce_sum(c, group) for c in (((pred == t) & item).sum(),
                                                            valid.sum()))
        acc = right / (n_items * th * tw).clamp_min(1)
        pred_fg, t_fg = pred >= 1, t >= 1
        inter, union = (all_reduce_sum(c, group) for c in ((pred_fg & t_fg & item).sum(),
                                                           ((pred_fg | t_fg) & item).sum()))
        iou = torch.where(union > 0, inter / union.clamp_min(1), 1.0)
        return {"val_loss": loss, "val_acc": acc, "val_iou": iou}

    return step
