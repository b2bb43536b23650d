"""The mesh of ranks with named axes (counterpart of
unetseg_tpu/core/mesh.py).

The JAX package lays its devices out as a (data, tile, model) array; here
the ranks of the process group take that layout, rank = (d * tile + t) *
model + m, one card each:

- ``data``  - the train and eval steps split their batch over it and sum
  their BatchNorm moments, loss normaliser and gradients across it
  (`data_group`);
- ``tile``  - overlap-tile serving splits each forward chunk's tiles over
  the data and tile axes jointly (`tile_group`), as the JAX tile sharding
  does;
- ``model`` - kept at 1 by default and carried through, as in the JAX
  package: ranks that differ only in it compute the same thing.

A group is None where its axis holds one rank, so a 1x1x1 mesh runs the
single-process code with no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from unetseg_tpu_torch.core.config import MeshConfig
from unetseg_tpu_torch.core.distributed import device_of_rank, process_count, process_index


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """This rank's place in the mesh and the process groups of its axes."""

    num_data: int = 1
    num_tile: int = 1
    num_model: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    data_group: Any = None   # the ranks that split a batch with this one
    tile_group: Any = None   # the ranks that split a chunk of tiles with this one
    data_axis: str = "data"
    tile_axis: str = "tile"
    model_axis: str = "model"

    @property
    def data_index(self) -> int:
        return self.rank // (self.num_tile * self.num_model)

    @property
    def num_tile_shards(self) -> int:
        """Ranks a chunk of tiles is split over (data x tile)."""
        return self.num_data * self.num_tile

    @property
    def tile_shard_index(self) -> int:
        return self.rank // self.num_model

    def batch_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of n items; n must divide by
        the data-parallel degree."""
        if n % self.num_data:
            raise ValueError(f"batch of {n} does not divide by the data-parallel degree "
                             f"({self.num_data})")
        k = n // self.num_data
        return slice(self.data_index * k, (self.data_index + 1) * k)


def _groups(dp: int, tp: int, mp: int, rank: int):
    """(data group, tile group) of `rank`: every rank creates every group,
    in one order, as new_group requires, each set of ranks once; the
    whole world is the default group and an axis of one rank has none."""
    world = dp * tp * mp
    groups = {}

    def group_of(members_of):
        sets = sorted({members_of(r) for r in range(world)})
        if len(sets[0]) == 1:
            return None
        if len(sets[0]) == world:
            return dist.group.WORLD
        for m in sets:
            if m not in groups:
                groups[m] = dist.new_group(list(m))
        return groups[members_of(rank)]

    def data_members(r):
        t, m = (r // mp) % tp, r % mp
        return tuple((d * tp + t) * mp + m for d in range(dp))

    def tile_members(r):
        m = r % mp
        return tuple((d * tp + t) * mp + m for d in range(dp) for t in range(tp))

    return group_of(data_members), group_of(tile_members)


def make_mesh(
    cfg: Optional[MeshConfig] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> MeshSpec:
    """The (data, tile, model) mesh over the process group's ranks.

    ``data_parallel == -1`` takes every rank not used by the other axes;
    the axis sizes must multiply to the rank count (the JAX package's
    errors, with ranks for devices). `world_size` and `rank` default to
    the process group's; `device` to this rank's (device_of_rank)."""
    cfg = cfg or MeshConfig()
    n = process_count() if world_size is None else world_size
    tp = max(1, cfg.tile_parallel)
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel
    if dp == -1:
        if n % (tp * mp) != 0:
            raise ValueError(f"{n} devices not divisible by tile*model = {tp * mp}")
        dp = n // (tp * mp)
    if dp * tp * mp != n:
        raise ValueError(f"mesh {dp}x{tp}x{mp} != {n} devices")
    r = process_index() if rank is None else rank
    if n > 1 and not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs the process group "
                           f"(core/distributed.maybe_initialize)")
    data_group, tile_group = _groups(dp, tp, mp, r) if n > 1 else (None, None)
    return MeshSpec(
        num_data=dp, num_tile=tp, num_model=mp, rank=r,
        device=torch.device(device) if device is not None else device_of_rank(),
        data_group=data_group, tile_group=tile_group,
        data_axis=cfg.data_axis, tile_axis=cfg.tile_axis, model_axis=cfg.model_axis,
    )


def single_device_mesh(device=None) -> MeshSpec:
    """A 1x1x1 mesh on one device: every path takes a mesh without
    special-casing one card, and runs no collective."""
    return make_mesh(MeshConfig(data_parallel=1), world_size=1, rank=0, device=device)
