"""Axis-angle <-> rotation matrices (JAX package: ops/rotations.py).

``rodrigues`` is the quaternion form of the exponential map, as manopth
uses: smooth at the origin (no 0/0 from sin(t)/t), which matters because
learned pose parameters pass through zero. ``rotmat_to_axis_angle`` is its
inverse, operation for operation the JAX package's.
"""

from __future__ import annotations

import torch


def rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    angle = torch.sqrt(torch.sum(axisang * axisang, dim=-1) + 1e-16)
    half = angle * 0.5
    # sin(t/2)/t stays bounded; the 1e-16 under the sqrt keeps t > 0.
    sinc_half = torch.sin(half) / angle
    qw = torch.cos(half)
    qxyz = axisang * sinc_half[..., None]
    qx, qy, qz = qxyz[..., 0], qxyz[..., 1], qxyz[..., 2]

    w2, x2, y2, z2 = qw * qw, qx * qx, qy * qy, qz * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz

    rot = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * (xy - wz), 2 * (wy + xz),
            2 * (wz + xy), w2 - x2 + y2 - z2, 2 * (yz - wx),
            2 * (xz - wy), 2 * (wx + yz), w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return rot.reshape(axisang.shape[:-1] + (3, 3))


def rotmat_to_axis_angle(rot: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3), in the input's
    dtype (JAX :47-62). The cosine is clamped to ``[-1 + eps, 1 - eps]``,
    so in float32 (where ``1 - 1e-7`` rounds to ``1 - 2**-23``) the
    identity maps to a 4.9e-4 rad angle times a zero axis; near pi the
    skew part vanishes and the axis with it. Both are the JAX package's
    results, kept."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0 + eps, 1.0 - eps)
    angle = torch.arccos(cos)
    axis = torch.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        dim=-1,
    )
    scale = angle / torch.clamp_min(2.0 * torch.sin(angle), eps)
    return axis * scale[..., None]
