"""Dense nearest-neighbour squared distances (JAX package: ops/chamfer.py).

Only the float32 dense-plane path is ported: the ``(B, N, M)`` plane is
built as ``rx + ry - 2 x.y`` (reference atlasutils.py:20-39), unclamped,
with a full-float32 batched product. The tiled nearest-neighbour kernels
(K2-K5) and the ``plane_dtype`` rungs belong to the training slice.
"""

from __future__ import annotations

import torch

from obman_train_tpu_torch.device import full_fp32


def batch_pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (B, N, M) between x (B, N, 3) and y (B, M, 3).

    Computed as rx + ry - 2 x.y^T like the reference, so values can be
    slightly negative from cancellation; the reference does not clamp.
    """
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    with full_fp32(x.device):
        xy = torch.bmm(x, y.transpose(1, 2))
    return xx[:, :, None] + yy[:, None, :] - 2.0 * xy


def chamfer_min_sqdist(x: torch.Tensor, y: torch.Tensor):
    """``(min_x2y (B,N), argmin_x2y (B,N), min_y2x (B,M), argmin_y2x (B,M))``.

    ``torch.min`` over a dim gives no guarantee on which index wins a tie,
    so the argmins come from ``torch.argmin``, which returns the first
    occurrence, as ``jnp.argmin`` does.
    """
    d = batch_pairwise_sqdist(x, y)
    return (
        torch.amin(d, dim=2),
        torch.argmin(d, dim=2),
        torch.amin(d, dim=1),
        torch.argmin(d, dim=1),
    )
