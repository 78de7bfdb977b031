"""Config system of the PyTorch port: the port's own copy of `drn_tpu/config.py`.

Same dataclasses, field names, defaults and registry as the JAX package, so
a config name means the same model in both (tests/test_torch_config.py pins
the equality). The port imports nothing of `drn_tpu`, hence the copy. Why
each default was chosen is recorded beside the JAX package's copy.

Fields the port keeps only so that both copies stay equal:

  * `use_pallas_{fusion,conv_blocks,stem}`: the port does not read them. Its
    kernels are chosen by the tensor's device: a CUDA tensor goes through
    the hand-written kernel, a CPU tensor through the kernel's plain PyTorch
    version (drn_tpu_torch/ops/cuda/).
  * `iou_fold_mix_min_locations`: the port samples the IoU head per level
    for every grid size (models/heads.py).

Architectures the JAX package does not have live in a registry of their
own (`_ARCH_REGISTRY`), so that `_REGISTRY` and `list_configs()` stay the
JAX package's: `get_config` reaches both. Such a configuration's `model`
is its architecture's dataclass, whose `arch` names it (`architecture`);
the entry points that run DRN alone refuse it by name (`require_drn`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters."""

    feature_dim: int = 4096          # C3D fc6 = 4096, I3D = 1024
    hidden_dim: int = 512            # model width D
    embed_dim: int = 300             # GloVe 300-d
    vocab_size: int = 8000           # hashed-vocab buckets when GloVe absent
    num_lstm_layers: int = 3         # one level-specific representation per layer
    num_levels: int = 3              # temporal pyramid levels (strides 1/2/4)
    fusion_kernel_size: int = 3      # 1D conv width in the fusion block
    head_tower_layers: int = 2       # convs in loc/match towers (shared across levels)
    iou_head_layers: int = 2
    # max(d_start, d_end) range-of-interest per level, as fractions of the
    # base temporal grid (FCOS-style object_sizes_of_interest, 1-D analogue).
    level_ranges: Tuple[Tuple[float, float], ...] = (
        (0.0, 0.20),
        (0.20, 0.45),
        (0.45, 2.00),
    )
    dtype: str = "bfloat16"          # compute dtype for conv/matmul
    param_dtype: str = "float32"
    use_pallas_fusion: bool = False      # unread by the port (module docstring)
    use_pallas_conv_blocks: bool = False
    use_pallas_stem: bool = False
    iou_fold_mix_min_locations: int = 512  # unread by the port

    def __post_init__(self):
        assert len(self.level_ranges) == self.num_levels


@dataclass(frozen=True)
class DataConfig:
    """Dataset + host-pipeline knobs."""

    dataset: str = "charades"        # charades | activitynet | tacos | synthetic
    feature_type: str = "c3d"        # c3d | i3d
    feature_dir: str = ""            # dir of per-video .npy / single .h5
    annotation_path: str = ""        # charades_sta_{split}.txt or dataset JSON
    glove_path: str = ""             # optional GloVe .txt; hashed fallback if empty
    num_clips: int = 64              # fixed temporal grid T after sampling
    # Feature rows per second of video, used only when the annotation
    # format carries no duration (Charades-STA). 0.0 = unconfigured.
    feature_fps: float = 0.0
    max_query_len: int = 20          # queries padded/truncated to this
    # Split used for in-training periodic eval. "" → try "val", then "test".
    val_split: str = ""
    lowercase: bool = True
    batch_size: int = 32
    num_workers: int = 0             # >0 → worker processes for IO
    feature_cache_mb: float = 64.0   # host LRU of resampled per-video grids
    shuffle_buffer: int = 2048
    seed: int = 0
    # Synthetic-fixture knobs (dataset="synthetic" only): example count,
    # signal amplitude inside the GT span (2.0 = the easy fixture), and
    # decoy spans carrying another query's signal outside it.
    synthetic_examples: int = 256
    synthetic_snr: float = 2.0
    synthetic_distractors: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Two-stage recipe."""

    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip_norm: float = 10.0
    num_epochs: int = 30
    lr_decay_epochs: Tuple[int, ...] = (20,)
    lr_decay_rate: float = 0.1
    stage: int = 1                   # 1 = grounding heads, 2 = +IoU head
    stage2_iou_only: bool = True     # stage 2 trains only the IoU head
    accum_steps: int = 1             # micro-batches averaged per update
    match_loss_weight: float = 1.0
    reg_loss_weight: float = 1.0
    iou_loss_weight: float = 1.0
    focal_alpha: float = 0.25        # focal loss for matching head; alpha<0 → plain BCE
    focal_gamma: float = 2.0
    checkpoint_dir: str = "/tmp/drn_tpu_ckpt"
    checkpoint_every_steps: int = 500
    keep_checkpoints: int = 3
    log_every_steps: int = 50
    tensorboard_dir: str = ""        # empty → JSONL-to-stderr only
    eval_every_epochs: int = 1
    resume: bool = True
    seed: int = 0


@dataclass(frozen=True)
class EvalConfig:
    """Decode + NMS + recall."""

    top_k: int = 48                  # candidates kept before NMS (per query)
    nms_iou_threshold: float = 0.5
    recall_ns: Tuple[int, ...] = (1, 5)
    iou_thresholds: Tuple[float, ...] = (0.3, 0.5, 0.7)
    score_use_iou_head: bool = True  # score = sigmoid(match) * sigmoid(iou_pred)^w
    # Rescore blend exponent w: 0 ≡ rescoring off, 1 ≡ the full product.
    score_iou_weight: float = 0.25
    batch_size: int = 32


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: ranks of a process group as data × model × time
    (parallel/mesh.py); the train CLI's --model-axis / --time-axis
    override the two."""

    data_axis: int = -1              # -1 → all remaining devices
    model_axis: int = 1
    time_axis: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "charades_c3d"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TANModelConfig:
    """2D-TAN (Zhang et al., AAAI 2020; arXiv:1912.03590), models/tan.py:
    clip features → k=1 conv + ReLU → average pool of `frame_pool` clips
    (N = num_clips / frame_pool) → the sparse N×N moment map of the stacked
    max-pools `scale_layers` → fusion with a unidirectional LSTM's last
    valid state → `map_layers` masked 2-D convs of `map_kernel_size`
    (`map_paddings`, each followed by the count-weighted mask) → a 1×1
    prediction conv at the valid moments."""

    arch: str = "2d-tan"
    feature_dim: int = 4096
    hidden_dim: int = 512
    embed_dim: int = 300
    vocab_size: int = 8000
    num_lstm_layers: int = 3
    frame_pool: int = 2
    scale_layers: Tuple[int, ...] = (16, 8, 8, 8)
    map_layers: int = 8
    map_kernel_size: int = 5
    map_paddings: Tuple[int, ...] = (16, 0, 0, 0, 0, 0, 0, 0)
    dtype: str = "bfloat16"          # the frame, fusion and map convs
    param_dtype: str = "float32"

    def __post_init__(self):
        assert len(self.map_paddings) == self.map_layers


def _cfg(name: str, **sections: Dict[str, Any]) -> ExperimentConfig:
    base = ExperimentConfig(name=name)
    updates = {}
    for sec, kw in sections.items():
        updates[sec] = dataclasses.replace(getattr(base, sec), **kw)
    return dataclasses.replace(base, **updates)


_REGISTRY: Dict[str, ExperimentConfig] = {
    # Charades-STA, C3D features.
    "charades_c3d": _cfg(
        "charades_c3d",
        model=dict(feature_dim=4096),
        data=dict(dataset="charades", feature_type="c3d", num_clips=64),
    ),
    # Charades-STA, I3D features.
    "charades_i3d": _cfg(
        "charades_i3d",
        model=dict(feature_dim=1024),
        data=dict(dataset="charades", feature_type="i3d", num_clips=64),
        eval=dict(batch_size=64),
    ),
    # Charades-STA batched multi-query eval: the flagship eval step.
    "charades_c3d_batched_eval": _cfg(
        "charades_c3d_batched_eval",
        model=dict(feature_dim=4096),
        data=dict(dataset="charades", feature_type="c3d", num_clips=64, batch_size=384),
        eval=dict(batch_size=48),
    ),
    # ActivityNet-Captions: longer videos, deeper pyramid, I3D features.
    "activitynet_i3d": _cfg(
        "activitynet_i3d",
        model=dict(
            feature_dim=1024,
            num_levels=4,
            level_ranges=((0.0, 0.12), (0.12, 0.25), (0.25, 0.5), (0.5, 2.0)),
        ),
        data=dict(dataset="activitynet", feature_type="i3d", num_clips=256,
                  max_query_len=25),
        eval=dict(batch_size=16),
    ),
    "activitynet_c3d": _cfg(
        "activitynet_c3d",
        model=dict(
            feature_dim=500,  # ActivityNet release ships PCA-500 C3D features
            num_levels=4,
            level_ranges=((0.0, 0.12), (0.12, 0.25), (0.25, 0.5), (0.5, 2.0)),
        ),
        data=dict(dataset="activitynet", feature_type="c3d", num_clips=256,
                  max_query_len=25),
        eval=dict(batch_size=16),
    ),
    # TACoS: fine-grained dense moments, high-resolution temporal grid.
    "tacos_c3d": _cfg(
        "tacos_c3d",
        model=dict(
            feature_dim=4096,
            num_levels=4,
            level_ranges=((0.0, 0.08), (0.08, 0.18), (0.18, 0.4), (0.4, 2.0)),
        ),
        data=dict(dataset="tacos", feature_type="c3d", num_clips=512,
                  max_query_len=25),
        eval=dict(batch_size=32),
    ),
    # Two-stage recipe demonstration on a held-out synthetic val split.
    "synthetic_recipe": _cfg(
        "synthetic_recipe",
        model=dict(feature_dim=256, hidden_dim=128, vocab_size=512,
                   num_lstm_layers=2),
        data=dict(dataset="synthetic", num_clips=64, max_query_len=12,
                  batch_size=32, synthetic_examples=4096,
                  synthetic_snr=0.5, synthetic_distractors=2),
        train=dict(num_epochs=3, log_every_steps=32,
                   checkpoint_every_steps=10_000),
        eval=dict(top_k=32, batch_size=64),
    ),
    # The same demonstration at production width.
    "synthetic_recipe_flagship": _cfg(
        "synthetic_recipe_flagship",
        model=dict(feature_dim=1024, hidden_dim=512, vocab_size=512),
        data=dict(dataset="synthetic", num_clips=64, max_query_len=12,
                  batch_size=32, synthetic_examples=4096,
                  synthetic_snr=0.5, synthetic_distractors=2),
        train=dict(num_epochs=3, log_every_steps=32,
                   checkpoint_every_steps=10_000),
        eval=dict(top_k=32, batch_size=64),
    ),
    # Small end-to-end config (synthetic fixture runs everywhere).
    "synthetic_tiny": _cfg(
        "synthetic_tiny",
        model=dict(feature_dim=128, hidden_dim=64, vocab_size=128,
                   num_lstm_layers=2, num_levels=2,
                   level_ranges=((0.0, 0.3), (0.3, 2.0))),
        data=dict(dataset="synthetic", num_clips=32, max_query_len=8,
                  batch_size=8),
        train=dict(num_epochs=2, log_every_steps=10),
        eval=dict(top_k=16, batch_size=8),
    ),
}


# Architectures beside DRN. The 2D-TAN TACoS model "128x128-K5L8-pool":
# 256 sampled C3D clips pooled in pairs to a 128×128 map, every one of its
# 2,548 valid moments ranked (top_k) before NMS, scored by the match
# logit alone. Graded at the DRN configurations' tIoU (0.3, 0.5, 0.7);
# the published 2D-TAN configuration grades TACoS at (0.1, 0.3, 0.5).
_ARCH_REGISTRY: Dict[str, ExperimentConfig] = {
    "tacos_2dtan_c3d": ExperimentConfig(
        name="tacos_2dtan_c3d",
        model=TANModelConfig(),
        data=DataConfig(dataset="tacos", feature_type="c3d", num_clips=256,
                        max_query_len=25),
        eval=EvalConfig(top_k=2548, score_use_iou_head=False),
    ),
}


def get_config(name: str) -> ExperimentConfig:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _ARCH_REGISTRY:
        return _ARCH_REGISTRY[name]
    raise KeyError(f"unknown config {name!r}; available: "
                   f"{sorted(_REGISTRY) + sorted(_ARCH_REGISTRY)}")


def architecture(cfg: ExperimentConfig) -> str:
    """"drn", or the `arch` of another architecture's model config."""
    return getattr(cfg.model, "arch", "drn")


def require_drn(cfg: ExperimentConfig, entry: str) -> None:
    """Raise NotImplementedError when `cfg` is not a DRN configuration:
    `entry` (train, serve, export, infer, the mesh axes) runs DRN alone;
    `evaluate` runs every architecture."""
    arch = architecture(cfg)
    if arch != "drn":
        raise NotImplementedError(
            f"{entry} runs DRN only: {cfg.name} is a {arch} configuration, "
            "which the port evaluates (drn_tpu_torch.evaluate) and nothing "
            "else yet")


def list_configs():
    return sorted(_REGISTRY)
