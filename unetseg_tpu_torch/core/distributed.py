"""Multi-process bootstrap, this rank's device and the collectives of the
data-parallel path (counterpart of unetseg_tpu/core/distributed.py).

The PyTorch idiom is one process per card joined by a
`torch.distributed` process group, where the JAX package runs one
process per host over a device mesh. This module supplies:

- :func:`maybe_initialize` - `init_process_group` behind CLI flags or
  environment variables, a no-op (False) for a single process and
  idempotent. The backend is nccl when each rank has a card of its own,
  and gloo on the CPU or where ranks were pinned to cards by hand
  (`local_device_ids`), since nccl refuses two ranks on one card;
- :func:`device_of_rank` - the card (or the CPU) this rank computes on;
- :func:`is_primary` - the rank-0 gate of filesystem writes (checkpoints,
  metrics JSONL), :func:`process_shard_indices` and :func:`barrier`;
- :func:`host_put` - this rank's slice of a global host batch, placed on
  its device (the counterpart of `host_put` on a batch sharding);
- the sums the data-parallel step and tile-sharded serving need, each a
  SUM all-reduce, which both backends take on CUDA and CPU tensors (gloo
  all-reduces CUDA tensors but does not all-gather them, so a gather is
  an all-reduce into a zeroed buffer, which is exact).

A collective with `group=None` is no collective: every caller passes
None on one rank, which keeps the single-process path as it was.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import socket
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_cpu = False
_local_device_ids: Optional[List[int]] = None


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    cpu: bool = False,
) -> bool:
    """Join the process group if several processes are configured.

    Arguments fall back to ``UNETSEG_COORDINATOR``, ``UNETSEG_NUM_PROCESSES``
    and ``UNETSEG_PROCESS_ID``. The coordinator is ``host:port`` (read as
    ``tcp://host:port``) or a URL such as ``file:///path``. Returns True
    when the process group is up; False, doing nothing, when no coordinator
    is configured or there is one process; True at once on a later call.
    `cpu` puts this rank on the CPU (gloo); `local_device_ids` pins it to
    its first entry's card (gloo: other ranks may hold the same card)."""
    global _cpu, _local_device_ids
    coordinator_address = coordinator_address or os.environ.get("UNETSEG_COORDINATOR")
    if num_processes is None and os.environ.get("UNETSEG_NUM_PROCESSES"):
        num_processes = int(os.environ["UNETSEG_NUM_PROCESSES"])
    if process_id is None and os.environ.get("UNETSEG_PROCESS_ID"):
        process_id = int(os.environ["UNETSEG_PROCESS_ID"])
    if dist.is_initialized():
        return True
    if coordinator_address is None or (num_processes or 1) <= 1:
        return False
    if process_id is None:
        raise ValueError("a multi-process run needs this process's id "
                         "(--process-id or UNETSEG_PROCESS_ID)")
    _cpu = cpu or not torch.cuda.is_available()
    _local_device_ids = list(local_device_ids) if local_device_ids is not None else None
    own_card = (not _cpu and _local_device_ids is None
                and ("LOCAL_RANK" in os.environ or torch.cuda.device_count() >= num_processes))
    backend = "nccl" if own_card else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if backend == "nccl":
        torch.cuda.set_device(_rank_device(process_id))
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(minutes=10))
    return True


def shutdown() -> None:
    """Leave the process group (no-op when none is up)."""
    global _cpu, _local_device_ids
    if dist.is_initialized():
        dist.destroy_process_group()
    _cpu, _local_device_ids = False, None


def _rank_device(rank: int) -> torch.device:
    if _local_device_ids:
        return torch.device("cuda", _local_device_ids[0])
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def device_of_rank() -> torch.device:
    """This rank's device: the CPU where the process group was joined on
    it, else the card of `local_device_ids[0]`, of ``LOCAL_RANK``, or of
    the rank modulo the visible cards."""
    if _cpu:
        return torch.device("cpu")
    return _rank_device(process_index())


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that owns filesystem writes (checkpoints, metrics).
    Every rank holds the same replicated state, so rank 0 writing alone
    loses nothing."""
    return process_index() == 0


def process_shard_indices(n_items: int) -> np.ndarray:
    """Contiguous split of range(n_items) across processes: the global
    items this process loads when processes feed disjoint shards."""
    return np.array_split(np.arange(n_items), process_count())[process_index()]


def barrier() -> None:
    """Block until every process reaches this point (no-op for one)."""
    if process_count() > 1:
        dist.barrier()


def host_put(array: np.ndarray, device, shard: int = 0, num_shards: int = 1) -> torch.Tensor:
    """Rows [shard * n / num_shards, (shard + 1) * n / num_shards) of a
    global host array (the same on every process) as a tensor on `device`;
    the whole array for one shard. n must divide by num_shards."""
    n = array.shape[0]
    if n % num_shards:
        raise ValueError(f"{n} rows do not split evenly over {num_shards} shards")
    k = n // num_shards
    return torch.from_numpy(np.ascontiguousarray(array[shard * k : (shard + 1) * k])).to(device)


def free_port() -> int:
    """A free TCP port on localhost, for a coordinator address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ collectives
def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the group's ranks (a new tensor); `t` itself
    when group is None."""
    if group is None:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_reduce_cat(group, *parts: torch.Tensor) -> List[torch.Tensor]:
    """Sum several 1-D (or 0-D) f32 tensors over the group in one
    all-reduce; returns them in order."""
    flat = all_reduce_sum(torch.cat([p.reshape(-1) for p in parts]), group)
    return [c.reshape(p.shape) for c, p in zip(flat.split([p.numel() for p in parts]), parts)]


def all_reduce_tree(tensors: Mapping[str, torch.Tensor], group) -> dict:
    """Sum a dict of same-dtype tensors over the group through one flat
    buffer and one all-reduce."""
    if group is None:
        return dict(tensors)
    keys = list(tensors)
    return dict(zip(keys, all_reduce_cat(group, *(tensors[k] for k in keys))))


def gather_shares(share: torch.Tensor, n: int, index: int, group) -> torch.Tensor:
    """Rows [index * k, (index + 1) * k) of an (n, ...) result, k =
    share.shape[0], from each rank of the group -> the whole result on
    every rank: an all-reduce of a zeroed buffer holding this rank's share,
    exact since every other row adds zeros."""
    if group is None:
        return share
    k = share.shape[0]
    full = share.new_zeros((n, *share.shape[1:]))
    full[index * k : (index + 1) * k] = share
    dist.all_reduce(full, group=group)
    return full


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def all_reduce_sum_autograd(t: torch.Tensor, group) -> torch.Tensor:
    """all_reduce_sum that autograd differentiates: its backward sums the
    cotangents over the group (each rank's output feeds every rank's
    loss), as torch.distributed.nn.functional.all_reduce does; `t` itself
    when group is None."""
    return t if group is None else _AllReduceSum.apply(t, group)


def tensor_digest(tensors: Mapping[str, torch.Tensor]) -> str:
    """sha256 over the names, dtypes, shapes and bytes of a dict of
    tensors in key order: equal digests mean bit-equal tensors."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().cpu().contiguous()
        h.update(f"{k}:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
