from unetseg_tpu_torch.track.tracker import CellTrack, Tracker, track_sequence_masks  # noqa: F401
from unetseg_tpu_torch.track.ctc_io import read_track_file, write_res_track  # noqa: F401
from unetseg_tpu_torch.track.iou import pairwise_iou  # noqa: F401
