"""The train step, its state and the loop (counterpart of unetseg_tpu/train/)."""
from unetseg_tpu_torch._exports import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "unetseg_tpu_torch.train.state": ("TrainState", "create_train_state"),
    "unetseg_tpu_torch.train.steps": ("make_eval_step", "make_train_step"),
    "unetseg_tpu_torch.train.loop": ("TrainResult", "train"),
})
