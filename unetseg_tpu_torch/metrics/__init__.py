from unetseg_tpu_torch.metrics.binary import batch_mean_iou, dice, iou  # noqa: F401
from unetseg_tpu_torch.metrics.rand import rand_index_and_error  # noqa: F401
from unetseg_tpu_torch.metrics import ctc  # noqa: F401
