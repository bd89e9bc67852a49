"""Branch losses as functions returning ``(final_loss, loss_dict)`` (JAX
package: models/losses.py).

- A lambda of ``None`` disables a term, and so does ``0``: both are tested
  for truth as the reference's ``if lambda:`` checks are
  (manobranch.py:251-324, atlasbranch.py:199-287).
- Which losses run also depends on which GT queries the batch carries,
  given statically by :class:`~obman_train_tpu_torch.models.handnet.BatchSpec`
  flags.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from obman_train_tpu_torch.config import AtlasConfig, ManoConfig
from obman_train_tpu_torch.ops.chamfer import chamfer_loss
from obman_train_tpu_torch.ops.mesh import edge_loss, laplacian_loss


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def compute_mano_loss(
    preds: Dict,
    batch: Dict,
    cfg: ManoConfig,
    has_verts3d: bool,
    has_joints3d: bool,
    has_pcas: bool,
) -> Tuple[torch.Tensor, Dict]:
    """ManoLoss.compute_loss (reference: manobranch.py:251-324)."""
    total = torch.zeros((), dtype=torch.float32, device=preds["verts"].device)
    losses = {}
    if has_verts3d and cfg.lambda_verts:
        v_loss = mse(preds["verts"], batch["verts3d"])
        total = total + cfg.lambda_verts * v_loss
        losses["mano_verts3d"] = v_loss
    if has_joints3d and cfg.lambda_joints3d:
        j_loss = mse(preds["joints"], batch["joints3d"])
        total = total + cfg.lambda_joints3d * j_loss
        losses["mano_joints3d"] = j_loss
    if cfg.lambda_shape and preds.get("shape") is not None:
        s_loss = mse(preds["shape"], torch.zeros_like(preds["shape"]))
        total = total + cfg.lambda_shape * s_loss
        losses["mano_shape"] = s_loss
    if cfg.lambda_pose_reg:
        p_loss = mse(preds["pose"][:, 3:], torch.zeros_like(preds["pose"][:, 3:]))
        total = total + cfg.lambda_pose_reg * p_loss
        losses["pose_reg"] = p_loss
    if has_pcas and cfg.lambda_pca:
        pca_loss = mse(preds["pose"], batch["hand_pcas"])
        total = total + cfg.lambda_pca * pca_loss
        losses["mano_pca"] = pca_loss
    losses["mano_total_loss"] = total
    return total, losses


def compute_atlas_loss(
    preds: Dict,
    batch: Dict,
    cfg: AtlasConfig,
    has_objpoints3d: bool,
    has_center3d: bool,
    obj_faces: Optional[torch.Tensor],
    laplacian: Optional[torch.Tensor],
    regul_scale=1.0,
) -> Tuple[torch.Tensor, Dict]:
    """AtlasLoss.compute_loss (reference: atlasbranch.py:199-287), with the
    centered and final Chamfer terms as two ``chamfer_loss`` calls.

    ``regul_scale`` multiplies the edge and Laplacian weights: the
    reference's per-epoch regul decay (decay_regul, handnet.py:188-196).
    """
    if os.environ.get("OBMAN_STACK_ATLAS", "0") == "1":
        raise NotImplementedError(
            "OBMAN_STACK_ATLAS=1 (one stacked Chamfer call for the centered "
            "and final pair) is not ported yet: a later slice")
    edge_regul_lambda = cfg.lambda_regul_edges
    lambda_laplacian = cfg.lambda_laplacian

    losses: Dict = {}
    run_main = has_objpoints3d and (cfg.lambda_atlas or cfg.final_lambda_atlas)
    run_trans_only = has_center3d and cfg.trans_weight
    device = preds["objpoints3d"].device
    if not (run_main or run_trans_only):
        return torch.zeros((), dtype=torch.float32, device=device), losses

    final = torch.zeros((), dtype=torch.float32, device=device)
    sym_loss = None
    obj_mesh = None
    if "objtrans" in preds and has_objpoints3d and "objpointscentered3d" in preds:
        target = batch["objpoints3d"]
        centroids = torch.mean(target, dim=1)  # (B, 3)
        trans_loss = mse(preds["objtrans"], centroids)
        losses["atlas_trans3d"] = trans_loss
        centered = target - centroids[:, None, :]
        scale_loss = torch.zeros((), dtype=torch.float32, device=target.device)
        if "objscale" in preds:
            scales_gt = torch.amax(
                torch.sqrt(torch.sum(centered**2, dim=2) + 1e-16), dim=1)
            scale_loss = mse(preds["objscale"], scales_gt[:, None])
            losses["atlas_scale3d"] = scale_loss
        l1, l2 = chamfer_loss(preds["objpointscentered3d"], centered)
        sym_loss = torch.mean(l1 + l2)
        f1, f2 = chamfer_loss(preds["objpoints3d"], target)
        sym_final = torch.mean(f1 + f2)
        obj_mesh = preds["objpointscentered3d"]
        losses["final_chamfer_loss"] = sym_final
        final = (
            (cfg.lambda_atlas or 0.0) * sym_loss
            + (cfg.final_lambda_atlas or 0.0) * sym_final
            + cfg.trans_weight * trans_loss
            + cfg.scale_weight * scale_loss
        )
    elif has_objpoints3d and cfg.lambda_atlas:
        l1, l2 = chamfer_loss(preds["objpoints3d"], batch["objpoints3d"])
        sym_loss = torch.mean(l1 + l2)
        final = cfg.lambda_atlas * sym_loss
        obj_mesh = preds["objpoints3d"]

    if obj_mesh is not None and edge_regul_lambda and obj_faces is not None:
        e_loss = edge_loss(obj_mesh, obj_faces)
        losses["atlas_edge_regul"] = e_loss
        final = final + edge_regul_lambda * regul_scale * e_loss
    if obj_mesh is not None and lambda_laplacian and laplacian is not None:
        l_loss = laplacian_loss(obj_mesh, laplacian)
        losses["atlas_laplac"] = l_loss
        final = final + lambda_laplacian * regul_scale * l_loss

    if sym_loss is not None:
        losses["atlas_objpoints3d"] = sym_loss
    return final, losses
