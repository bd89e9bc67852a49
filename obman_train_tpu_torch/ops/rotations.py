"""Axis-angle to rotation matrices (JAX package: ops/rotations.py:17-44).

The quaternion form of the exponential map, as manopth uses: smooth at the
origin (no 0/0 from sin(t)/t), which matters because learned pose
parameters pass through zero.
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
