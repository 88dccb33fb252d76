"""Configuration: frozen dataclasses and the two presets.

The port's own copy of what it uses from the JAX package's
`pigeon_tpu/config.py`, with the same names, defaults and presets
(`tests/test_torch_config.py` holds the two field by field):

* ``pigeon_config()``  — StreetView 4-image panorama model ("PIGEON"):
  geocell bounds 30/60, label-smoothing tau 75 km.
* ``pigeotto_config()`` — single-image planet-scale model ("PIGEOTTO",
  YFCC/MP-16): geocell bounds 1000/2000, tau 65 km, no month head.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

#: GeoGuessr exponential decay constant (km): score = 5000 exp(-d / DECAY).
GEOGUESSR_DECAY_KM = 1492.7

#: Max GeoGuessr score per round.
GEOGUESSR_MAX_SCORE = 5000.0


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP vision-tower architecture (ViT). Defaults are ViT-L/14-336,
    PIGEON's backbone."""

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    # CLIP uses "quick gelu": x * sigmoid(1.702 x)
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS token

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """CLIP text-tower architecture (a field of `PigeonConfig`; the port
    has no text tower yet)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


def vit_l14_336_vision() -> VisionConfig:
    """ViT-L/14 @336, PIGEON's production backbone."""
    return VisionConfig()


def vit_l14_text() -> TextConfig:
    return TextConfig()


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Geocell classification head and the auxiliary multi-task heads."""

    num_cells: int = 2203
    embed_dim: int = 1024

    #: 4-image StreetView panorama input.
    panorama: bool = False
    #: Aggregate panorama views with self-attention instead of mean.
    hierarchical: bool = False
    #: Haversine label smoothing of geocell targets.
    smooth_labels: bool = True
    #: Label smoothing temperature tau in km.
    label_smoothing_km: float = 75.0
    #: Enable multi-task (regression + climate [+ month]) heads.
    multi_task: bool = False
    #: Include compass heading (sin, cos) features.
    heading: bool = False
    #: Month head exists only for StreetView.
    predict_month: bool = True
    #: Number of geocell candidates surfaced for refinement.
    num_candidates: int = 5

    # Multi-task dimensions
    num_mt_vars: int = 6
    num_climates: int = 28
    num_months: int = 12
    # Loss scalings
    regression_loss_scale: float = 8.0
    climate_loss_scale: float = 2.0
    month_loss_scale: float = 1.0

    #: Cyclic month-label smoothing temperature (months); 0.0 is the
    #: hard-label month cross-entropy.
    month_smoothing: float = 0.0

    # Hierarchical aggregation
    num_attention_heads: int = 16
    attn_dropout: float = 0.1

    @property
    def views(self) -> int:
        return 4 if self.panorama else 1

    @property
    def input_dim(self) -> int:
        """Input width of the geocell layer: heading features are appended
        only when they survive aggregation (not for mean-aggregated
        panoramas)."""
        if self.heading and not (self.panorama and not self.hierarchical):
            return self.embed_dim + 2
        return self.embed_dim


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    """ProtoNet guess-refinement settings."""

    topk: int = 5
    max_refinement_km: float = 1000.0
    temperature: float = 1.6
    hedge: bool = False
    hedge_temperature: float = 5.0
    #: Padding bucket: max clusters per geocell after padding.
    max_protos_per_cell: int = 64
    #: Padding bucket: max members per cluster.
    max_members_per_cluster: int = 256


@dataclasses.dataclass(frozen=True)
class GeocellCreationConfig:
    """Semantic geocell creation bounds."""

    min_cell_size: int = 30
    max_cell_size: int = 60


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (head training: global batch 1024, lr
    2e-5, seed 330; CLIP pretraining's settings are kept for parity)."""

    # Head training
    batch_size_per_device: int = 256
    eval_batch_size_per_device: int = 256
    learning_rate: float = 2e-5
    num_epochs: int = 1000
    seed: int = 330
    early_stopping_patience: int = 10
    grad_accum_steps: int = 1

    # Pretraining (contrastive CLIP)
    pretrain_batch_size_per_device: int = 32
    pretrain_grad_accum_steps: int = 8
    pretrain_learning_rate: float = 1e-6
    pretrain_weight_decay: float = 1e-3
    pretrain_adam_b1: float = 0.9
    pretrain_adam_b2: float = 0.98
    pretrain_adam_eps: float = 1e-6
    pretrain_max_grad_norm: float = 1.0
    pretrain_num_epochs: int = 20
    pretrain_warmup_ratio: float = 0.2
    pretrain_seed: int = 42
    pretrain_save_steps: int = 50

    # Embedding sweep
    embed_batch_size_per_device: int = 512

    # Mesh layout: axis names for (data, model) parallelism.
    mesh_axes: Tuple[str, str] = ("data", "model")
    #: bfloat16 compute for the ViT towers.
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Filesystem layout."""

    data_dir: str = "data"
    geocell_csv: str = "data/geocells.csv"
    proto_csv: str = "data/prototypes.csv"
    embeddings_dir: str = "data/embeddings"
    checkpoint_dir: str = "saved_models"
    benchmark_registry: str = "data/benchmarks/benchmarks.json"
    scaler_path: str = "saved_models/scaler/regression.scaler.json"
    tensorboard_dir: str = "runs"


@dataclasses.dataclass(frozen=True)
class PigeonConfig:
    """Top-level configuration."""

    name: str = "pigeon"
    vision: VisionConfig = dataclasses.field(default_factory=vit_l14_336_vision)
    text: TextConfig = dataclasses.field(default_factory=vit_l14_text)
    head: HeadConfig = dataclasses.field(default_factory=HeadConfig)
    refiner: RefinerConfig = dataclasses.field(default_factory=RefinerConfig)
    geocell: GeocellCreationConfig = dataclasses.field(
        default_factory=GeocellCreationConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    paths: PathConfig = dataclasses.field(default_factory=PathConfig)

    def replace(self, **kwargs) -> "PigeonConfig":
        return dataclasses.replace(self, **kwargs)


def pigeon_config(num_cells: int = 2203) -> PigeonConfig:
    """PIGEON: StreetView 4-image panorama, 2203 geocells, tau=75 km."""
    return PigeonConfig(
        name="pigeon",
        head=HeadConfig(
            num_cells=num_cells,
            panorama=True,
            multi_task=True,
            heading=True,
            smooth_labels=True,
            label_smoothing_km=75.0,
            predict_month=True,
        ),
        geocell=GeocellCreationConfig(min_cell_size=30, max_cell_size=60),
    )


def pigeotto_config(num_cells: int = 2076) -> PigeonConfig:
    """PIGEOTTO: single-image planet-scale (YFCC/MP-16), tau=65 km, no
    month head."""
    return PigeonConfig(
        name="pigeotto",
        head=HeadConfig(
            num_cells=num_cells,
            panorama=False,
            multi_task=True,
            heading=False,
            smooth_labels=True,
            label_smoothing_km=65.0,
            predict_month=False,
        ),
        geocell=GeocellCreationConfig(min_cell_size=1000, max_cell_size=2000),
        train=TrainConfig(
            pretrain_learning_rate=5e-7,
            pretrain_num_epochs=4,
            pretrain_warmup_ratio=0.02,
        ),
    )
