"""Data: CTC file layout and the in-memory dataset."""
from unetseg_tpu_torch._exports import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "unetseg_tpu_torch.data.dataset": ("Batch", "HeLaArrays", "iter_batches", "train_val_split"),
    "unetseg_tpu_torch.data.io": ("SequencePaths", "read_image", "write_mask_u16",
                                  "write_mask_u8"),
})
