"""Configuration for the PyTorch port: copies of the JAX package's
`ModelConfig`, `DataConfig`, `TrainConfig`, `InferConfig`, `TrackConfig`,
`EvalConfig`, `MeshConfig` and the `Config` tree with its JSON writer and
loaders (unetseg_tpu/core/config.py), so that its config files (e.g.
configs/best_recipe.json) load here and a file either package writes
loads in both. `ModelConfig.skip_gates` is the port's own (PORT_ONLY): a
file leaves it out at its default, so only a gated net's file is the
port's alone.

Copied rather than imported because importing anything under
`unetseg_tpu` imports jax. tests/test_torch_port_bridge.py keeps the
fields and defaults equal to the originals, but for PORT_ONLY.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """U-Net architecture (reference: models/unet_model.py:65-85)."""

    in_channels: int = 1
    # The reference trains with n_classes=2 + softmax CE (scripts/train.py:93)
    # but some of its scripts build n_classes=1 + sigmoid — a documented defect
    # (SURVEY.md §2). We standardise on 2 everywhere; 1 remains supported.
    num_classes: int = 2
    base_features: int = 64          # channels double each level: 64..1024
    levels: int = 5                  # encoder depth incl. bottleneck
    bilinear: bool = False           # False => transposed-conv up path (reference default)
    # Numerics policy: params are always fp32; compute dtype is configurable.
    compute_dtype: str = "bfloat16"  # "bfloat16" | "float32"
    bn_momentum: float = 0.9         # flax convention; == torch momentum 0.1
    bn_epsilon: float = 1e-5
    # The port's own field (no JAX counterpart): an attention gate on every
    # skip (Oktay et al., arXiv:1804.03999), models/unet.py AttentionGate.
    skip_gates: bool = False


# Fields of the port alone, left out of Config.to_dict at their defaults so
# that a file an ungated run writes still loads in the JAX package.
PORT_ONLY = {"model": {"skip_gates": False}}


@dataclass(frozen=True)
class DataConfig:
    """Dataset layout & augmentation (reference: utils/dataset.py,
    utils/augmentations.py, scripts/preprocess_data.py)."""

    data_root: str = "./data/raw/train/DIC-C2DH-HeLa"
    sequence: str = "01"
    val_percent: float = 0.1
    augment: bool = True
    elastic_alpha: float = 2000.0    # scripts/train.py:35
    elastic_sigma: float = 20.0      # scripts/train.py:36
    # Weight-map parameters (scripts/preprocess_data.py:14-15)
    w0: float = 10.0
    sigma_w: float = 5.0
    image_size: int = 512            # training / predict resize target
    # Per-frame z-score standardization, applied inside the train step
    # after photometric augmentation (ops/intensity.py).
    standardize: bool = False
    # Photometric augmentation (ops/intensity.py); 0.0 disables each stage.
    aug_gamma: float = 0.0           # log-range of per-item random gamma
    aug_illum: float = 0.0           # low-freq multiplicative illumination
    aug_noise: float = 0.0           # max additive Gaussian noise std


@dataclass(frozen=True)
class TrainConfig:
    """Training loop (reference: scripts/train.py:22-36,97), read by
    train/loop.py. `remat`, `donate_state` and `async_save` are read by
    no ported code (JAX-only switches; the port writes checkpoints
    synchronously), kept so that config files of either package load in
    both; `device_data` keeps the dataset on the device and feeds each
    epoch by index (train/steps.make_epoch_train_step)."""

    batch_size: int = 4
    num_epochs: int = 20
    learning_rate: float = 1e-4
    momentum: float = 0.99
    optimizer: str = "sgd"           # "sgd" (reference) | "adam" | "adamw"
    weight_decay: float = 0.0        # adamw only
    cosine_decay: bool = False       # cosine lr schedule over num_epochs
    checkpoint_dir: str = "./checkpoints"
    save_checkpoint: bool = True
    keep_best_k: int = 3
    checkpoint_min_interval: int = 1
    async_save: bool = True
    full_save_interval: int = 5
    seed: int = 0
    log_every: int = 10
    metrics_jsonl: Optional[str] = None
    resume: bool = False
    donate_state: bool = True
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    border_boost: float = 5.0        # 3-class mode: loss multiplier on the
                                     # (rare) border class
    remat: Optional[str] = "dots"    # a jax.checkpoint policy; no effect here
    # Kernel train forward (models/train_forward.py): "auto" uses it on a
    # CUDA device when the kernels take the geometry; "on"/"off" force
    # (train/steps.lanes_active). The name is the JAX package's.
    lanes: str = "auto"
    # EMA of params + BN stats (0 disables), debiased decay
    # min(ema_decay, (1+t)/(10+t)) after every step (train/state.py).
    ema_decay: float = 0.0
    device_data: bool = True


@dataclass(frozen=True)
class InferConfig:
    """Inference (reference: scripts/inference.py, scripts/predict.py; plus the
    overlap-tile engine the reference only advertises)."""

    image_size: int = 512
    threshold: float = 0.5
    normalize_mean: float = 0.5      # scripts/predict.py:53
    normalize_std: float = 0.5
    # The reference TRAINS on ToTensor [0,1] inputs but predict.py applies
    # Normalize(0.5, 0.5) at inference — a train/infer skew (its inference.py
    # does not normalize). We default to the training distribution;
    # normalize=True reproduces predict.py's behavior.
    normalize: bool = False
    # Per-frame z-score at inference; must match DataConfig.standardize used
    # in training.
    standardize: bool = False
    min_cell_size: int = 15          # scripts/predict.py:47
    tile_input: int = 512            # overlap-tile input tile size
    tile_batch: int = 8              # tiles per device batch
    # Temporal-marker watershed for predict (post/temporal.py): re-seed the
    # watershed from the previous frame's instance cores where the distance
    # transform under-segments. The measured-best instance pipeline
    # (docs/RESULTS.md round 2); off here for reference-parity defaults,
    # on in configs/best_recipe.json.
    temporal_markers: bool = False
    # Fragment guard for the temporal re-split (post/temporal.py): drop a
    # re-seeded sub-instance below this fraction of its seeding previous
    # instance's area and re-flood with the surviving seeds. 0 disables.
    temporal_area_guard: float = 0.3
    # Backward temporal sweep (post/temporal.refine_backward): after the
    # forward pass, propagate later frames' instance boundaries BACKWARD so
    # early frames — which have no history — get their touching cells split
    # too. Adoption is strictly more-pieces-only (splits propagate, merges
    # never do). Requires temporal_markers.
    temporal_bidi: bool = False
    # sweep depth from the sequence start (post/temporal.refine_backward
    # max_frames): whole-sequence sweeps pre-split dividing parents — a
    # measured negative (docs/RESULTS.md round 7)
    temporal_bidi_frames: int = 8
    # test-time augmentation for tiled binary prediction: "none" | "flips"
    # (the 4 axis-flip transforms) | "flips8" (the full D4 group: 4 flips x
    # transpose, square frames only — best measured TRA/DET at a small SEG
    # cost, docs/RESULTS.md round 7). Probabilities combine per tta_merge
    # before thresholding (infer/tiling.TTA_TRANSFORMS). 4x/8x device
    # compute; the reference has no equivalent. Validated when the
    # Predictor is constructed.
    tta: str = "none"
    # how TTA probabilities merge (infer/tiling.py): "mean" (arithmetic —
    # smooths cell-cell boundaries), "gmean" (geometric — a near-zero
    # boundary probability under any flip keeps the pixel background, so
    # separating membranes survive), "vote" (per-flip threshold then strict
    # pixel majority, >half the flips), "max" (union — recall-maximizing).
    tta_merge: str = "mean"
    # load the EMA weight shadow instead of the raw weights (requires
    # checkpoints trained with TrainConfig.ema_decay > 0). CLI --ema also
    # turns this on per invocation. Measured round 8: per-seed SEG means
    # up ~+0.013 on both sequences and the seq-02 seed spread collapses
    # ~6x (docs/RESULTS.md round-8 table).
    use_ema: bool = False
    # grow every predicted instance up to this many px into BACKGROUND at
    # write time (post/boundary.grow_instances): nearest-label assignment,
    # labels never overwrite labels, so touching-cell membranes stay put.
    # Recovers the boundary ring the vote merges erode — measured round 5:
    # seq-01 grow 1.0 TRA +0.0039/DET +0.0039 (SEG +0.0002), seq-02 grow
    # 1.5 SEG +0.0067/TRA +0.0063/DET +0.0069, divisions intact. 0 = off.
    # The optimum is sequence-dependent; best_recipe.json ships 1.0 plus a
    # per-sequence override (Config.infer_per_sequence) of 1.5 for seq 02.
    boundary_grow: float = 0.0
    # how deep-ensemble MEMBER probabilities merge (infer/engine.py):
    # "mean" | "gmean" | "vote" — same trade-offs as tta_merge (member
    # disagreement concentrates on the membranes between touching cells).
    # Binary head only; 3-class ensembles always mean.
    ensemble_merge: str = "mean"


@dataclass(frozen=True)
class TrackConfig:
    """Tracker thresholds (reference: scripts/track.py:21-24), read by
    track/tracker.py's Tracker."""

    iou_threshold_track: float = 0.3
    iou_threshold_division: float = 0.1
    max_children: int = 2
    division_from_matched: bool = True
    matched_division_iou_cap: float = 0.6
    division_min_child_frac: float = 0.25
    division_child_cover: float = 0.25


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation (reference: scripts/evaluate.py, utils/metrics.py)."""

    threshold: float = 0.5
    penalize_extra_detections: bool = True  # DET FP weight on/off


@dataclass(frozen=True)
class MeshConfig:
    """Named mesh of ranks (data / tile / model axes), read by
    core/mesh.make_mesh: the train command's data-parallel run and
    tile-sharded serving."""

    data_axis: str = "data"
    tile_axis: str = "tile"
    model_axis: str = "model"
    # -1 => use all available devices on that axis
    data_parallel: int = -1
    tile_parallel: int = 1
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # per-sequence InferConfig field overrides, e.g. {"02": {"boundary_grow": 1.5}}
    infer_per_sequence: dict = field(default_factory=dict)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for section, fields in PORT_ONLY.items():
            for k, default in fields.items():
                if d[section][k] == default:
                    del d[section][k]
        return d

    def to_json(self, indent: int = 2) -> str:
        """The JSON text that from_json_file reads back (either package's)."""
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(tp, sub):
            names = {f.name for f in dataclasses.fields(tp)}
            kw = {}
            for k, v in sub.items():
                if k not in names:
                    raise KeyError(f"unknown config key {tp.__name__}.{k}")
                section = isinstance(v, dict) and k in _SECTION_TYPES
                kw[k] = build(_SECTION_TYPES[k], v) if section else v
            return tp(**kw)

        return build(cls, d)

    @classmethod
    def from_json_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))


_SECTION_TYPES = {
    "model": ModelConfig,
    "data": DataConfig,
    "train": TrainConfig,
    "infer": InferConfig,
    "track": TrackConfig,
    "eval": EvalConfig,
    "mesh": MeshConfig,
}
