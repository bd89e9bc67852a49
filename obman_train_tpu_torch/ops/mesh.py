"""Mesh regularizers and the contact-IoU metric (JAX package: ops/mesh.py).

The edge loss is a gather and a reduction; the Laplacian loss is one small
matmul against the dense cotangent Laplacian of
:mod:`~obman_train_tpu_torch.assets.laplacian`.
"""

from __future__ import annotations

import functools

import torch

from obman_train_tpu_torch.device import full_fp32


def edge_loss(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Edge-length variance regularizer (reference: atlasbranch.py:153-167).

    Mean absolute deviation of squared edge lengths from their per-example
    mean, over all 3F face edges.

    Args:
      verts: (B, V, 3); faces: (F, 3) integer, on the verts' device.
    """
    faces = faces.long()
    va = verts[:, faces[:, 0]]
    vb = verts[:, faces[:, 1]]
    vc = verts[:, faces[:, 2]]
    e_a = torch.sum((vb - va) ** 2, dim=2)
    e_b = torch.sum((vc - vb) ** 2, dim=2)
    e_c = torch.sum((va - vc) ** 2, dim=2)
    all_edges = torch.cat([e_c, e_b, e_a], dim=1)  # (B, 3F)
    mean_edge = torch.mean(all_edges, dim=1, keepdim=True)
    return torch.mean(torch.abs(all_edges - mean_edge))


def laplacian_loss(verts: torch.Tensor, laplacian: torch.Tensor) -> torch.Tensor:
    """Mean curvature regularizer (reference: laplacianloss.py:36-41):
    ``mean_i ||(L @ verts)_i||_2`` over all batch-stacked vertices.

    Args:
      verts: (B, V, 3); laplacian: dense (V, V) from ``cotangent_laplacian``.
    """
    dt = torch.promote_types(laplacian.dtype, verts.dtype)
    with full_fp32(verts.device):
        lx = torch.einsum("vw,bwd->bvd", laplacian.to(dt), verts.to(dt))
    norms = torch.sqrt(torch.sum(lx * lx, dim=-1) + 1e-12)
    return torch.mean(norms)


def thresh_iou(gt_dists: torch.Tensor, pred_dists: torch.Tensor, thresh) -> torch.Tensor:
    """Contact IoU at one threshold (reference: contactloss.py:22-32). The
    reference feeds *squared* mm distances against mm thresholds; kept."""
    gt_c = gt_dists <= thresh
    pred_c = pred_dists <= thresh
    inter = torch.sum((gt_c & pred_c).to(torch.float32), dim=1)
    union = torch.sum((gt_c | pred_c).to(torch.float32), dim=1)
    return torch.where(union != 0, inter / torch.clamp(union, min=1.0),
                       torch.zeros_like(union))


# A tensor built on the device from Python data is a copy from pageable host
# memory that waits for the device to drain, so the abscissae are built once
# per (values, dtype, device) and kept. They are made outside inference mode
# even when the first call comes from inside it: an inference tensor cannot
# enter a graph that autograd records, so a cache filled by an evaluation
# would break a later training step.
@functools.lru_cache(maxsize=8)
def _abscissae(threshs: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(threshs, dtype=dtype, device=device)


def meshiou(gt_dists: torch.Tensor, pred_dists: torch.Tensor,
            threshs=tuple(range(1, 11))):
    """Contact IoU curve and AUC (reference: contactloss.py:35-47).

    Returns ``(batch_ious (num_threshs,), iou_auc scalar)``: the
    per-threshold batch mean, and the trapezoid integral over thresholds
    averaged across the batch.
    """
    ious = torch.stack([thresh_iou(gt_dists, pred_dists, t) for t in threshs], dim=0)
    xs = _abscissae(tuple(threshs), ious.dtype, ious.device)
    auc_per_example = torch.trapezoid(ious, x=xs, dim=0)
    return torch.mean(ious, dim=1), torch.mean(auc_per_example)

