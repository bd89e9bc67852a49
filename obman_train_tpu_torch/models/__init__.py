from obman_train_tpu_torch.models.branches import (
    AbsoluteBranch,
    AtlasBranch,
    ManoBranch,
    PointGenCon,
    PointGenConResidual,
)
from obman_train_tpu_torch.models.handnet import (
    INFER_SPEC,
    BatchSpec,
    HandNet,
    build_handnet,
)
from obman_train_tpu_torch.models.losses import compute_atlas_loss, compute_mano_loss
from obman_train_tpu_torch.models.mano import ManoLayer, mano_forward
from obman_train_tpu_torch.models.resnet import ResNet, resnet18, resnet50

__all__ = [
    "AbsoluteBranch",
    "AtlasBranch",
    "BatchSpec",
    "HandNet",
    "INFER_SPEC",
    "ManoBranch",
    "ManoLayer",
    "PointGenCon",
    "PointGenConResidual",
    "ResNet",
    "build_handnet",
    "compute_atlas_loss",
    "compute_mano_loss",
    "mano_forward",
    "resnet18",
    "resnet50",
]
