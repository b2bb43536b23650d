"""Data-parallel steps over a mesh of ranks (counterpart of unetseg_tpu/parallel/)."""
from unetseg_tpu_torch._exports import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "unetseg_tpu_torch.parallel.sharding": ("make_sharded_eval_step", "make_sharded_train_step",
                                            "shard_batch"),
})
