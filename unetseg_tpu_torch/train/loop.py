"""The training loop: epochs, validation, best checkpoints, resume
(counterpart of unetseg_tpu/train/loop.py:train, single device).

A 90/10 split, weighted-CE train epochs, unweighted-CE validation, a light
checkpoint on each new best validation loss (held back by the
`checkpoint_min_interval` cooldown, never dropped), a full resumable
checkpoint every `full_save_interval` epochs and at the end, resume from
the latest full checkpoint, and JSONL metrics.

Feeds. With `device_data` (and no `max_steps`) the dataset is put on the
device once and each epoch runs train/steps.make_epoch_train_step over that
epoch's (S, B) index matrix; otherwise batches are fed from the host one
step at a time. Both feeds take the same batches and draw the same random
numbers: each epoch's torch.Generator on the device is seeded from (seed,
epoch) alone, so a run resumed at an epoch boundary continues exactly as an
uninterrupted run. Losses stay on the device until one fetch per epoch.

Profiling. `profile_dir` writes a chrome trace through
utils/profiling.trace, with the steps' train.* spans as regions: of the
train part of the run's second epoch (its only one in a one-epoch run) on
the epoch feed, of `profile_steps` steps from the second on the host feed.

Data parallelism (`mesh`, core/mesh.MeshSpec): every rank runs this loop
on its own device with the same seed, so state, schedule and draws are
the same everywhere; each step takes the rank's B / D columns of the
global schedule (parallel/sharding.py), and only rank 0 writes the
metrics JSONL and the checkpoints, with a barrier after each save so that
no rank reads a checkpoint before it exists.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from unetseg_tpu_torch.core.config import Config
from unetseg_tpu_torch.core.distributed import barrier, host_put, is_primary
from unetseg_tpu_torch.core.mesh import MeshSpec
from unetseg_tpu_torch.data.dataset import (
    HeLaArrays,
    epoch_index_matrix,
    iter_batches,
    num_batches,
    train_val_split,
)
from unetseg_tpu_torch.models.shapes import output_size
from unetseg_tpu_torch.train import checkpoint as ckpt
from unetseg_tpu_torch.train.metrics_log import MetricsLogger, StepTimer
from unetseg_tpu_torch.train.state import TrainState, create_train_state
from unetseg_tpu_torch.train.steps import (
    lanes_active,
    make_epoch_eval_step,
    make_epoch_train_step,
    make_eval_step,
    make_train_step,
)
from unetseg_tpu_torch.utils import profiling


@dataclass
class TrainResult:
    state: TrainState
    best_val_loss: float
    best_epoch: int
    history: List[Dict[str, float]]


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The augmentation generator of one epoch, seeded from (seed, epoch)."""
    s = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def train(
    cfg: Config, data: Optional[HeLaArrays] = None, max_steps: Optional[int] = None,
    device: Union[str, torch.device] = "cuda", init: Optional[Mapping[str, Any]] = None,
    tier2: bool = False, mesh: Optional[MeshSpec] = None,
) -> TrainResult:
    """Train on `device` (the card unless the caller asks otherwise), or
    data-parallel over `mesh` on the mesh's device for this rank; the
    batch size must divide by the mesh's data-parallel degree.
    `init` is a Flax-layout {'params', 'batch_stats'} tree to start from
    (e.g. the JAX package's initial variables through the same layout);
    without it the weights come from models/fast_init with the config's
    seed. `data` defaults to HeLaArrays.load(cfg.data). `tier2` trains
    through the kernel train forward's tier 2 (the JAX loop's
    UNETSEG_LANES_TIER2_TRAIN); it raises ValueError where `lanes`
    resolves to off."""
    t_cfg, d_cfg, m_cfg = cfg.train, cfg.data, cfg.model
    dev = mesh.device if mesh is not None else torch.device(device)
    if mesh is not None and t_cfg.batch_size % mesh.num_data:
        raise ValueError(
            f"batch_size ({t_cfg.batch_size}) must divide by the data-parallel degree "
            f"({mesh.num_data}): each rank takes an equal share of every batch")
    logger = MetricsLogger(t_cfg.metrics_jsonl if is_primary() else None)
    data = data or HeLaArrays.load(d_cfg)
    train_idx, val_idx = train_val_split(len(data), d_cfg.val_percent, t_cfg.seed)
    logger.log({"event": "start", "n_train": len(train_idx), "n_val": len(val_idx)})

    input_size = data.images.shape[1]
    state = create_train_state(
        init if init is not None else t_cfg.seed, m_cfg, t_cfg, input_size=input_size,
        steps_per_epoch=num_batches(len(train_idx), t_cfg.batch_size), device=dev)
    start_epoch = 0
    if t_cfg.resume and ckpt.latest_epoch(t_cfg.checkpoint_dir) is not None:
        state, start_epoch, _ = ckpt.restore_checkpoint(t_cfg.checkpoint_dir, state)
        start_epoch += 1
        logger.log({"event": "resume", "epoch": start_epoch})

    three_class = m_cfg.num_classes == 3
    lanes = "on" if lanes_active(t_cfg.lanes, m_cfg, input_size, dev) else "off"
    if lanes == "on":
        logger.log({"event": "lanes_train", "input_size": input_size, "tier2": tier2})
    # every item is real when the split divides evenly: BatchNorm then
    # needs no item mask
    assume_valid = len(train_idx) % t_cfg.batch_size == 0
    step_kw = dict(
        assume_valid=assume_valid, augment=d_cfg.augment, elastic_alpha=d_cfg.elastic_alpha,
        elastic_sigma=d_cfg.elastic_sigma, three_class=three_class,
        border_boost=t_cfg.border_boost, standardize=d_cfg.standardize,
        aug_gamma=d_cfg.aug_gamma, aug_illum=d_cfg.aug_illum, aug_noise=d_cfg.aug_noise,
        lanes=lanes, tier2=tier2,
    )
    eval_kw = dict(three_class=three_class, standardize=d_cfg.standardize, mesh=mesh)
    train_step = make_train_step(m_cfg, mesh=mesh, **step_kw)
    eval_step = make_eval_step(m_cfg, **eval_kw)
    use_epoch_feed = t_cfg.device_data and max_steps is None
    if use_epoch_feed:
        epoch_step = make_epoch_train_step(m_cfg, inner_step=train_step, mesh=mesh)
        epoch_eval = make_epoch_eval_step(m_cfg, **eval_kw)
        on_dev = [torch.from_numpy(a).to(dev) for a in (data.images, data.masks, data.weight_maps)]
        logger.log({"event": "device_data", "bytes": int(
            data.images.nbytes + data.masks.nbytes + data.weight_maps.nbytes)})
        val_mat, val_valid = (torch.from_numpy(a).to(dev) for a in epoch_index_matrix(
            val_idx, t_cfg.batch_size, shuffle=False, seed=0))

    shard = (0, 1) if mesh is None else (mesh.data_index, mesh.num_data)

    def to_dev(batch):  # this rank's rows of the global batch
        return [host_put(a, dev, *shard) for a in
                (batch.images, batch.masks, batch.weight_maps, batch.valid)]

    out = output_size(input_size, m_cfg.levels)
    timer = StepTimer(pixels_per_step=t_cfg.batch_size * out * out)
    best_val, best_epoch = float("inf"), -1
    history: List[Dict[str, float]] = []
    global_step = 0  # steps of this run, as the JAX loop counts them
    done = False
    checkpointer = (ckpt.Checkpointer(t_cfg.checkpoint_dir, keep=t_cfg.keep_best_k)
                    if t_cfg.save_checkpoint else None)
    last_saved_epoch = last_full_epoch = -(10**9)
    pending_best = None  # (payload, epoch, val_loss) awaiting the cooldown
    profiled_epoch = min(start_epoch + 1, t_cfg.num_epochs - 1) if t_cfg.profile_dir else None
    prof: Optional[contextlib.ExitStack] = None  # the host feed's open trace

    for epoch in range(start_epoch, t_cfg.num_epochs):
        # ---------------------------------------------------------- train
        gen = epoch_generator(t_cfg.seed, epoch, dev)
        timer.reset()
        if use_epoch_feed:
            mat, vmat = (torch.from_numpy(a).to(dev) for a in epoch_index_matrix(
                train_idx, t_cfg.batch_size, shuffle=True, seed=t_cfg.seed * 100003 + epoch))
            with profiling.trace(t_cfg.profile_dir if epoch == profiled_epoch else None):
                state, ms = epoch_step(state, *on_dev, mat, vmat, gen)
                losses = ms["loss"].cpu().numpy()  # the epoch's one sync point
            if epoch == profiled_epoch:
                logger.log({"event": "profile_written", "dir": t_cfg.profile_dir})
            n_steps = len(losses)
            global_step += n_steps
            timer.tick(n_steps)
            logger.log({"event": "train_step", "epoch": epoch, "step": global_step,
                        "loss": float(losses[-1]), **timer.rates()})
        else:
            pending, n_steps = [], 0
            for batch in iter_batches(data, train_idx, t_cfg.batch_size, shuffle=True,
                                      seed=t_cfg.seed * 100003 + epoch):
                if t_cfg.profile_dir and global_step == 1 and prof is None:
                    prof = contextlib.ExitStack()
                    prof.enter_context(profiling.trace(t_cfg.profile_dir))
                state, metrics = train_step(state, *to_dev(batch), gen)
                pending.append(metrics["loss"])
                n_steps += 1
                global_step += 1
                timer.tick()
                if prof is not None and global_step == 1 + t_cfg.profile_steps:
                    prof.close()
                    logger.log({"event": "profile_written", "dir": t_cfg.profile_dir})
                if global_step % t_cfg.log_every == 0:
                    logger.log({"event": "train_step", "epoch": epoch, "step": global_step,
                                "loss": float(pending[-1]), **timer.rates()},
                               echo=global_step % (t_cfg.log_every * 10) == 0)
                if max_steps is not None and global_step >= max_steps:
                    done = True
                    break
            losses = torch.stack(pending).cpu().numpy() if pending else np.zeros(0)
        avg_train = float(losses.sum()) / max(n_steps, 1)

        # ------------------------------------------------------------ val
        val_metrics: Dict[str, float] = {}
        if len(val_idx) > 0:
            if use_epoch_feed:
                ms = epoch_eval(state, on_dev[0], on_dev[1], val_mat, val_valid)
                val_metrics = {k: float(v.cpu().numpy().mean()) for k, v in ms.items()}
            else:
                per_batch = []
                for b in iter_batches(data, val_idx, t_cfg.batch_size, shuffle=False, seed=0):
                    images, masks, _, valid = to_dev(b)
                    per_batch.append(eval_step(state, images, masks, valid))
                val_metrics = {k: float(np.mean([float(d[k]) for d in per_batch]))
                               for k in per_batch[0]}

        record = {"event": "epoch", "epoch": epoch, "train_loss": avg_train, **val_metrics,
                  **timer.rates()}
        logger.log(record)
        history.append({k: v for k, v in record.items() if isinstance(v, float)})

        # ----------------------------------------------------- checkpoint
        val_loss = val_metrics.get("val_loss", avg_train)
        if val_loss < best_val:
            best_val, best_epoch = val_loss, epoch
            # the payload is copied now: later steps make new state tensors
            pending_best = (ckpt.device_light_payload(state) if t_cfg.save_checkpoint
                            else None, epoch, val_loss)
        last = epoch == t_cfg.num_epochs - 1 or done
        if pending_best is not None and checkpointer is not None and (
                epoch - last_saved_epoch >= t_cfg.checkpoint_min_interval or last):
            payload, b_epoch, b_loss = pending_best
            checkpointer.save_light_payload(payload, b_epoch, b_loss,
                                            extra={"config": cfg.to_dict()})
            barrier()
            last_saved_epoch, pending_best = epoch, None
            logger.log({"event": "checkpoint", "epoch": b_epoch, "val_loss": b_loss})
        # the full (resumable) save: the CURRENT state, on its own cadence
        if checkpointer is not None and (
                epoch - last_full_epoch >= t_cfg.full_save_interval or last):
            checkpointer.save_full(state, epoch, val_loss, extra={"config": cfg.to_dict()})
            barrier()
            last_full_epoch = epoch
            logger.log({"event": "checkpoint_full", "epoch": epoch})
        if done:
            break

    if prof is not None:
        prof.close()  # a run that ended before profile_steps: a no-op after the close above
    if checkpointer is not None:
        checkpointer.close()
    return TrainResult(state=state, best_val_loss=best_val, best_epoch=best_epoch,
                       history=history)
