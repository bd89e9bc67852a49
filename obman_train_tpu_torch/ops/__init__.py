from obman_train_tpu_torch.ops.chamfer import (
    batch_pairwise_sqdist,
    chamfer_loss,
    chamfer_min_sqdist,
    chamfer_sym,
    min_sqdist_to,
)
from obman_train_tpu_torch.ops.contact import (
    compute_contact_loss,
    compute_naive_contact_loss,
    masked_mean_loss,
    thres_loss,
)
from obman_train_tpu_torch.ops.inside import batch_mesh_contains_points
from obman_train_tpu_torch.ops.mesh import edge_loss, laplacian_loss, meshiou, thresh_iou
from obman_train_tpu_torch.ops.nnsqdist import nn_dir, nn_dir_plain, nn_min_sqdist
from obman_train_tpu_torch.ops.raytri import (
    mesh_contains_points,
    mesh_contains_points_plain,
)
from obman_train_tpu_torch.ops.rotations import rodrigues, rotmat_to_axis_angle

__all__ = [
    "batch_mesh_contains_points",
    "batch_pairwise_sqdist",
    "chamfer_loss",
    "chamfer_min_sqdist",
    "chamfer_sym",
    "compute_contact_loss",
    "compute_naive_contact_loss",
    "edge_loss",
    "laplacian_loss",
    "masked_mean_loss",
    "mesh_contains_points",
    "mesh_contains_points_plain",
    "meshiou",
    "min_sqdist_to",
    "nn_dir",
    "nn_dir_plain",
    "nn_min_sqdist",
    "rodrigues",
    "rotmat_to_axis_angle",
    "thres_loss",
    "thresh_iou",
]
