"""Differentiable MANO hand layer (JAX package: models/mano.py:39-174).

Re-implements ``manopth.ManoLayer`` as the reference uses it
(manobranch.py:92-105, called at :169-182): PCA pose basis, quaternion
Rodrigues, shape and pose blendshapes, the 16-joint kinematic chain
unrolled over the static tree, linear blend skinning of 778 vertices,
21 joints with fingertip vertices, optional root-palm recentering,
trans-vs-``center_idx`` centering, and metres to millimetres (x1000).

All products run in IEEE float32 whatever the global TF32 setting is
(:func:`~obman_train_tpu_torch.device.full_fp32`), as the JAX package runs
them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from obman_train_tpu_torch.assets.mano_assets import (
    JOINT_REORDER,
    PALM_VERT_IDS,
    TIPS,
    ManoAssets,
)
from obman_train_tpu_torch.device import full_fp32
from obman_train_tpu_torch.ops.rotations import rodrigues

# MANO kinematic tree (static python ints so the chain unrolls).
_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

_TABLES = (
    "v_template", "shapedirs", "posedirs", "J_regressor", "weights",
    "hands_components", "hands_mean",
)


class ManoLayer(nn.Module):
    """The constant MANO tables of one side as (non-persistent) buffers:
    they come from the MANO assets, not from checkpoints."""

    def __init__(self, assets: ManoAssets):
        super().__init__()
        for name in _TABLES:
            self.register_buffer(
                name,
                torch.from_numpy(np.asarray(getattr(assets, name), np.float32).copy()),
                persistent=False,
            )
        self.register_buffer(
            "tips", torch.from_numpy(TIPS.astype(np.int64)), persistent=False
        )
        self.register_buffer(
            "joint_reorder",
            torch.from_numpy(JOINT_REORDER.astype(np.int64)),
            persistent=False,
        )


def _pose_to_rotmats(
    pose: torch.Tensor, layer: ManoLayer, use_pca: bool, ncomps: int
) -> torch.Tensor:
    """(B, ncomps+3) PCA/axis-angle or (B, 16, 3, 3) rotmats -> (B, 16, 3, 3)."""
    if pose.ndim == 4:  # rotation-matrix mode (reference manobranch.py:126-128)
        return pose
    root = pose[:, :3]
    if use_pca:
        hand = pose[:, 3 : 3 + ncomps] @ layer.hands_components[:ncomps]
    else:
        hand = pose[:, 3:48]
    full = layer.hands_mean + hand  # (B, 45)
    aa = torch.cat([root, full], dim=1).reshape(-1, 16, 3)
    return rodrigues(aa)


def mano_forward(
    layer: ManoLayer,
    pose: torch.Tensor,
    betas: Optional[torch.Tensor] = None,
    trans: Optional[torch.Tensor] = None,
    *,
    use_pca: bool = True,
    ncomps: int = 6,
    center_idx: Optional[int] = 9,
    root_palm: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MANO kinematics for one hand side.

    Args:
      pose: (B, ncomps+3) PCA coefficients after 3 global axis-angle params
        (use_pca=True), (B, 48) raw axis-angle (use_pca=False), or
        (B, 16, 3, 3) rotation matrices.
      betas: (B, 10) shape coefficients or None (zeros).
      trans: (B, 3) translation or None; when None the output is recentered
        on joint ``center_idx`` (manopth: trans and centering exclude each
        other).
    Returns:
      (verts (B, 778, 3), joints (B, 21, 3)) in millimetres.
    """
    with full_fp32(pose.device):
        return _mano_forward(
            layer, pose, betas, trans, use_pca, ncomps, center_idx, root_palm
        )


def _mano_forward(layer, pose, betas, trans, use_pca, ncomps, center_idx, root_palm):
    rots = _pose_to_rotmats(pose, layer, use_pca, ncomps)  # (B, 16, 3, 3)
    B = rots.shape[0]

    if betas is None:
        v_shaped = layer.v_template.expand(B, -1, -1)
    else:
        v_shaped = layer.v_template + torch.einsum(
            "vds,bs->bvd", layer.shapedirs, betas
        )
    joints_rest = torch.einsum("jv,bvd->bjd", layer.J_regressor, v_shaped)

    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    pose_feat = (rots[:, 1:] - eye).reshape(B, 135)
    v_posed = v_shaped + torch.einsum("vdp,bp->bvd", layer.posedirs, pose_feat)

    # Kinematic chain: world transform per joint, unrolled over the tree.
    def make_T(rot, t):
        top = torch.cat([rot, t[:, :, None]], dim=2)  # (B, 3, 4)
        bottom = torch.zeros((B, 1, 4), dtype=rot.dtype, device=rot.device)
        bottom[:, 0, 3] = 1.0
        return torch.cat([top, bottom], dim=1)

    transforms = [make_T(rots[:, 0], joints_rest[:, 0])]
    for j in range(1, 16):
        p = _PARENTS[j]
        local = make_T(rots[:, j], joints_rest[:, j] - joints_rest[:, p])
        transforms.append(torch.bmm(transforms[p], local))
    G = torch.stack(transforms, dim=1)  # (B, 16, 4, 4)

    joints_posed = G[:, :, :3, 3]

    # Remove the rest-pose reference from each joint transform so skinning
    # maps rest vertices directly ("A = G - pack(G R J)").
    corr = torch.einsum("bjik,bjk->bji", G[:, :, :3, :3], joints_rest)
    A = torch.cat([G[:, :, :3, :3], (G[:, :, :3, 3] - corr)[..., None]], dim=3)

    T = torch.einsum("vj,bjik->bvik", layer.weights, A)  # (B, 778, 3, 4)
    verts = torch.einsum("bvij,bvj->bvi", T[..., :3], v_posed) + T[..., 3]

    tips = verts[:, layer.tips]
    joints = torch.cat([joints_posed, tips], dim=1)[:, layer.joint_reorder]

    if root_palm:
        palm = (verts[:, PALM_VERT_IDS[0]] + verts[:, PALM_VERT_IDS[1]]) / 2.0
        joints = torch.cat([palm[:, None], joints[:, 1:]], dim=1)

    if trans is not None:
        verts = verts + trans[:, None, :]
        joints = joints + trans[:, None, :]
    elif center_idx is not None:
        center = joints[:, center_idx : center_idx + 1]
        verts = verts - center
        joints = joints - center

    return verts * 1000.0, joints * 1000.0
