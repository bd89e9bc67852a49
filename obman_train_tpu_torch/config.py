"""Configuration: the model-side dataclasses of the JAX package's
``config.py`` (:73-178) and its ``TrainConfig`` (:182-200), with the same
fields and defaults.

Only fp32 ``compute_dtype`` and the ``float32`` geometry path are ported so
far; :class:`~obman_train_tpu_torch.models.handnet.HandNet` raises on the
others.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ManoConfig:
    """MANO hand branch (reference: manobranch.py:11-113, handnet.py:128-155)."""

    ncomps: int = 6
    base_neurons: Tuple[int, ...] = (1024, 256)
    center_idx: int = 9
    use_shape: bool = False
    use_trans: bool = False
    use_pca: bool = True
    adapt_skeleton: bool = False
    dropout: float = 0.0
    # None disables the term entirely (the reference tells None from 0).
    lambda_verts: Optional[float] = 0.167
    lambda_joints3d: Optional[float] = 0.167
    lambda_joints2d: Optional[float] = None
    lambda_shape: Optional[float] = 0.167
    lambda_pose_reg: Optional[float] = 0.0
    lambda_pca: Optional[float] = 0.167


@dataclass(frozen=True)
class AtlasConfig:
    """AtlasNet object branch (reference: atlasbranch.py:13-150)."""

    use_residual: bool = False
    mode: str = "sphere"
    points_nb: int = 600
    ico_divisions: int = 3              # 642 verts / 1280 faces
    use_tanh: bool = False
    out_factor: float = 200.0
    predict_trans: bool = False
    predict_scale: bool = False
    separate_encoder: bool = False
    adapt_decoder: bool = False
    mesh: bool = True
    lambda_atlas: Optional[float] = 0.167
    final_lambda_atlas: Optional[float] = 0.167
    trans_weight: float = 0.167
    scale_weight: float = 0.167
    lambda_regul_edges: float = 0.0
    lambda_laplacian: float = 0.0


@dataclass(frozen=True)
class ContactConfig:
    """Contact/collision losses (reference: contactloss.py:149-308)."""

    contact_lambda: float = 0.0
    contact_thresh: float = 10.0
    contact_mode: str = "dist_tanh"     # dist_sq | dist | dist_tanh
    contact_target: str = "all"         # all | obj | hand
    contact_zones: str = "zones"        # all | tips | zones
    collision_lambda: float = 0.0
    collision_thresh: float = 20.0
    collision_mode: str = "dist_tanh"
    contact_sym: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Top-level HandNet configuration (reference: handnet.py:20-186)."""

    resnet_version: int = 18
    fc_dropout: float = 0.0
    absolute_lambda: Optional[float] = None
    mano: ManoConfig = field(default_factory=ManoConfig)
    atlas: AtlasConfig = field(default_factory=AtlasConfig)
    contact: ContactConfig = field(default_factory=ContactConfig)
    image_size: int = 256
    compute_dtype: str = "float32"
    geometry_dtype: str = "float32"
    sync_bn: bool = False

    @property
    def img_feature_size(self) -> int:
        return {18: 512, 50: 2048}[int(self.resnet_version)]

    @property
    def need_collisions(self) -> bool:
        return bool(self.contact.contact_lambda or self.contact.collision_lambda)

    @property
    def mano_lambdas(self) -> bool:
        m = self.mano
        return bool(
            m.lambda_verts or m.lambda_joints3d or m.lambda_joints2d or m.lambda_pca
        )


@dataclass(frozen=True)
class TrainConfig:
    """Optimization setup (reference: traineval.py:113-127,179-182 and
    options/nets3dopts.py:235-273)."""

    optimizer: str = "adam"             # adam | rms | sgd
    lr: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 0.0
    epochs: int = 30
    train_batch: int = 32
    test_batch: int = 32
    lr_decay_step: int = 300
    lr_decay_gamma: float = 0.5
    regul_decay_step: int = 300
    regul_decay_gamma: float = 1.0
    freeze_batchnorm: bool = True        # default training recipe (README.md:133)
    freeze_encoder: bool = False
    atlas_freeze_encoder: bool = False
    atlas_freeze_decoder: bool = False
    manual_seed: int = 0
    snapshot: int = 5
    # Gradient accumulation: microbatches per optimizer update (1 = off).
    grad_accum: int = 1
    # Parallelism: 1-D data mesh; batch is sharded, params replicated.
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
