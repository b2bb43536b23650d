"""The data-parallel train and eval steps under the JAX package's names
(counterpart of unetseg_tpu/parallel/sharding.py).

One process per card; parameters, statistics and optimizer state are
replicated (built from the same seed on every rank, as the JAX loop
builds them), and each rank's batch is its B / D items of the global
batch (D = mesh.num_data). The steps are train/steps.make_train_step and
make_eval_step with a mesh: see train/steps.py for what makes one rank's
step equal the single-process step on the whole batch (global draws,
global BatchNorm moments, the global loss normaliser, one SUM all-reduce
of the gradients). The JAX package needs two forms, GSPMD for the plain
forward and shard_map for its Pallas kernels; here every rank runs whole
kernels on its own card, so both are one step:

    make_sharded_train_step   the plain forward (models/unet.unet_train_forward)
    make_lanes_dp_train_step  the kernel train forward (models/train_forward.py;
                              on the CPU its kernels' plain versions)
    make_lanes_dp_epoch_step  the device-resident epoch feed of the latter
    make_sharded_eval_step    the eval step
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from unetseg_tpu_torch.core.config import ModelConfig
from unetseg_tpu_torch.core.distributed import host_put
from unetseg_tpu_torch.core.mesh import MeshSpec
from unetseg_tpu_torch.train.steps import (
    make_epoch_train_step,
    make_eval_step,
    make_train_step,
)


def make_sharded_train_step(
    mesh: MeshSpec, model_cfg: Optional[ModelConfig] = None, **step_kw
) -> Callable:
    """The data-parallel step through the plain train forward
    (make_train_step's keywords, lanes off)."""
    return make_train_step(model_cfg, lanes="off", mesh=mesh, **step_kw)


def make_lanes_dp_train_step(
    mesh: MeshSpec, model_cfg: Optional[ModelConfig] = None, lanes: str = "on", **step_kw
) -> Callable:
    """The data-parallel step through the kernel train forward, tier 1 or
    (tier2=True) tier 2: each rank runs the kernels on its share."""
    return make_train_step(model_cfg, lanes=lanes, mesh=mesh, **step_kw)


def make_lanes_dp_epoch_step(
    mesh: MeshSpec, model_cfg: Optional[ModelConfig] = None, **step_kw
) -> Callable:
    """The device-resident epoch feed of make_lanes_dp_train_step: the
    global (S, B) schedule in, each rank's columns gathered per row."""
    inner = make_lanes_dp_train_step(mesh, model_cfg, **step_kw)
    return make_epoch_train_step(model_cfg, inner_step=inner, mesh=mesh)


def make_sharded_eval_step(
    mesh: MeshSpec, model_cfg: Optional[ModelConfig] = None, **eval_kw
) -> Callable:
    """The eval step over the mesh: summed per-rank losses over the global
    normaliser, accuracy and IoU from the summed counts."""
    return make_eval_step(model_cfg, mesh=mesh, **eval_kw)


def shard_batch(mesh: MeshSpec, *arrays: np.ndarray) -> tuple:
    """This rank's rows of each global host array, on its device (the
    per-process feed)."""
    return tuple(host_put(np.asarray(a), mesh.device, mesh.data_index, mesh.num_data)
                 for a in arrays)

