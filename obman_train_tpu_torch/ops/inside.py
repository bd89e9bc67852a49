"""Batched point-in-mesh parity test, plain version (JAX package:
ops/inside.py:23-61; reference contactutils.py:62-159).

Cast the fixed ray ``RAY_DIRECTION`` from every query point, count the
triangles it crosses (Möller–Trumbore), and call the point exterior when
the count is even. This is the whole (B, P, T) computation broadcast in
one expression; the main path runs the CUDA kernel of
:mod:`obman_train_tpu_torch.ops.raytri` instead.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

# Fixed, shared ray direction (reference: contactutils.py:65).
RAY_DIRECTION = (0.4395064455, 0.617598629942, 0.652231566745)
TOL = 1e-7


@functools.lru_cache(maxsize=None)
def direction(dtype: torch.dtype) -> Tuple[float, float, float]:
    """``RAY_DIRECTION`` rounded to ``dtype``, as Python floats.

    A tensor times one of them rounds as it would times a tensor of
    ``dtype`` holding it, and the product needs no tensor on the points'
    device: a tensor built there from Python data is a copy from pageable
    host memory that waits for the device to drain."""
    return tuple(torch.tensor(RAY_DIRECTION, dtype=dtype).tolist())


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` on the last axis, with ``jnp.cross``'s expression order."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of products on the last axis of length 3, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def batch_mesh_contains_points(
    points: torch.Tensor, triangles: torch.Tensor
) -> torch.Tensor:
    """Ray-parity exterior test.

    Args:
      points:    (B, P, 3) query points (ray origins).
      triangles: (B, T, 3, 3) triangle vertex positions.
    Returns:
      exterior: bool (B, P); True when the point lies outside the mesh.
    """
    # the direction rounded to the points' dtype, its products in the
    # dtype that the points and the triangles promote to
    d0, d1, d2 = direction(points.dtype)
    dt = torch.promote_types(points.dtype, triangles.dtype)
    v0 = triangles[:, :, 0]
    v0v1 = triangles[:, :, 1] - v0
    v0v2 = triangles[:, :, 2] - v0

    ex, ey, ez = v0v2.to(dt).unbind(-1)
    # d x v0v2 in jnp.cross's order
    pvec = torch.stack([d1 * ez - d2 * ey, d2 * ex - d0 * ez, d0 * ey - d1 * ex],
                       dim=-1)  # (B, T, 3)
    dets = _dot(v0v1, pvec)
    parallel = torch.abs(dets) < TOL
    invdet = 1.0 / (dets + 0.1 * TOL)

    tvec = points[:, :, None, :] - v0[:, None, :, :]  # (B, P, T, 3)
    u = _dot(tvec, pvec[:, None]) * invdet[:, None, :]
    qvec = _cross(tvec, v0v1[:, None].expand_as(tvec))
    v = (qvec[..., 0] * d0 + qvec[..., 1] * d1 + qvec[..., 2] * d2) * invdet[:, None, :]
    t = _dot(qvec, v0v2[:, None]) * invdet[:, None, :]

    hit = (u > 0) & (u < 1) & (v > 0) & ((u + v) < 1) & (t >= TOL)
    hit = hit & ~parallel[:, None, :]
    n_hits = torch.sum(hit, dim=-1, dtype=torch.int32)
    return (n_hits % 2) == 0
