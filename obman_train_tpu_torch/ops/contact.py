"""Hand-object contact (attraction) and collision (repulsion) terms, forward
(JAX package: ops/contact.py:71-234; reference contactloss.py:149-308).

- nearest object point per hand vert from the dense float32 plane, or the
  ``geometry_dtype`` rung's selection plane (JAX :141-161);
- inside/outside from the ray-parity test on detached inputs (the reference
  detaches both, contactloss.py:170-172), through the CUDA kernel on the GPU;
- attraction on exterior hand verts near the object, repulsion on
  penetrating verts; value modes ``dist_sq | dist | dist_tanh``, target
  modes ``all | obj | hand`` by selective ``detach``;
- zone filters ``all | tips | zones``: per zone, the hand vert closest to
  the object, as a masked first-occurrence argmin.

Thresholds are in the reference's units: verts in millimetres, ``dist_sq``
compares squared mm against thresh^2.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from obman_train_tpu_torch.assets.contact_zones import tips_mask, zone_masks
from obman_train_tpu_torch.ops.chamfer import chamfer_min_sqdist, plane_dtype_for
from obman_train_tpu_torch.ops.raytri import mesh_contains_points

ContainsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# The cached masks are made outside inference mode even when the first
# call comes from inside it: an inference tensor cannot enter a graph that
# autograd records, so a cache filled by serving would break training.
@functools.lru_cache(maxsize=8)
def _zone_masks_on(device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(zone_masks().copy()).to(device)


@functools.lru_cache(maxsize=8)
def _tips_mask_on(device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(tips_mask()).to(device)


def masked_mean_loss(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``vals`` over ``mask``; 0 when the mask is empty
    (reference: contactloss.py:50-57)."""
    mask = mask.to(vals.dtype)
    denom = torch.sum(mask)
    mean = torch.sum(vals * mask) / torch.clamp(denom, min=1.0)
    return torch.where(denom > 0, mean, torch.zeros_like(mean))


def _target_diff(results_close, hand_verts, contact_target: str):
    if contact_target == "all":
        return results_close - hand_verts
    if contact_target == "obj":
        return results_close - hand_verts.detach()
    if contact_target == "hand":
        return results_close.detach() - hand_verts
    raise ValueError(f"contact_target {contact_target} not in [all|obj|hand]")


def _mode_vals(diff, anchor_dists, mode: str, thresh: float):
    if mode == "dist_sq":
        return torch.sum(diff**2, dim=2)
    if mode == "dist":
        return anchor_dists
    if mode == "dist_tanh":
        return thresh * torch.tanh(anchor_dists / thresh)
    raise ValueError(f"mode {mode} not in [dist_sq|dist|dist_tanh]")


def compute_contact_loss(
    hand_verts: torch.Tensor,
    obj_verts: torch.Tensor,
    obj_faces: torch.Tensor,
    contact_thresh: float = 25.0,
    contact_mode: str = "dist_sq",
    collision_thresh: float = 25.0,
    collision_mode: str = "dist_sq",
    contact_target: str = "all",
    contact_sym: bool = False,
    contact_zones: str = "all",
    geometry_dtype: str = "float32",
    contains: Optional[ContainsFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict, Dict]:
    """Attraction + repulsion terms between a hand and an object mesh.

    Args:
      hand_verts: (B, 778, 3) in mm.
      obj_verts:  (B, V_o, 3) in mm.
      obj_faces:  (F_o, 3) integer faces, on the verts' device.
      geometry_dtype: the nearest neighbours' selection plane
        (:func:`~obman_train_tpu_torch.ops.chamfer.plane_dtype_for`).
        Object vertices may be bf16 (a bf16 decoder): the differences to
        the float32 hand promote to float32, and the inside test takes
        float32 triangles whose edges are differenced in the input's
        dtype, as the JAX package computes them.
      contains: the exterior test, default the kernel path
        :func:`~obman_train_tpu_torch.ops.raytri.mesh_contains_points`; a
        test hook, not a fallback.
    Returns:
      ``(attraction_loss, penetration_loss, contact_info, metrics)`` as the
      JAX package returns them.
    """
    if contact_zones not in ("all", "tips", "zones"):
        raise ValueError(f"contact_zones {contact_zones} not in [tips|zones|all]")
    mins21, min21idxs, mins12, _ = chamfer_min_sqdist(
        hand_verts, obj_verts, plane_dtype=plane_dtype_for(geometry_dtype))

    obj_triangles = obj_verts[:, obj_faces.long()]  # (B, F, 3, 3)
    exterior = (contains or mesh_contains_points)(
        hand_verts.detach(), obj_triangles.detach()
    )
    penetr_mask = ~exterior

    # nearest object point per hand vert (the JAX one-hot matmul is a
    # TPU trick; a gather is the same selection)
    results_close = torch.gather(
        obj_verts, 1, min21idxs[..., None].expand(-1, -1, obj_verts.shape[-1])
    )

    diff = _target_diff(results_close, hand_verts, contact_target)
    anchor_dists = torch.sqrt(torch.sum(diff**2, dim=2) + 1e-16)

    contact_vals = _mode_vals(diff, anchor_dists, contact_mode, contact_thresh)
    if contact_mode == "dist_sq":
        below_dist = mins21 < contact_thresh**2
    elif contact_mode == "dist":
        below_dist = mins21 < contact_thresh
    else:  # dist_tanh takes all points into account
        below_dist = torch.ones_like(mins21, dtype=torch.bool)

    collision_vals = _mode_vals(
        diff, anchor_dists, collision_mode, collision_thresh
    )

    missed_mask = below_dist & exterior
    if contact_zones == "tips":
        missed_mask = missed_mask & _tips_mask_on(mins21.device)[None, :]
    elif contact_zones == "zones":
        zmasks = _zone_masks_on(mins21.device)  # (Z, H)
        # per zone, the zone's hand vert closest to the object
        masked = torch.where(
            zmasks[None, :, :], mins21[:, None, :],
            torch.full_like(mins21[:, None, :], float("inf")),
        )  # (B, Z, H)
        win = torch.argmin(masked, dim=2)  # (B, Z)
        matching = torch.zeros_like(missed_mask)
        matching.scatter_(1, win, True)
        missed_mask = missed_mask & matching

    missed_loss = masked_mean_loss(contact_vals, missed_mask)
    penetr_loss = masked_mean_loss(collision_vals, penetr_mask)
    if contact_sym:
        obj2hand = torch.sqrt(torch.clamp(mins12, min=0.0))
        missed_loss = missed_loss + masked_mean_loss(
            obj2hand, mins12 < contact_thresh
        )

    anchor_sg = anchor_dists.detach()
    pmask = penetr_mask.to(anchor_sg.dtype)
    max_penetr_depth = torch.mean(torch.amax(anchor_sg * pmask, dim=1))
    mean_penetr_depth = torch.mean(torch.mean(anchor_sg * pmask, dim=1))

    contact_info = {
        "attraction_masks": missed_mask,
        "repulsion_masks": penetr_mask,
        "contact_points": results_close,
        "min_dists": mins21,
    }
    metrics = {"max_penetr": max_penetr_depth, "mean_penetr": mean_penetr_depth}
    return missed_loss, penetr_loss, contact_info, metrics
