"""Nearest-neighbour squared distances and the Chamfer loss (JAX package:
ops/chamfer.py).

Two routes compute the same minima:

- the dense float32 plane ``rx + ry - 2 x.y`` (reference atlasutils.py:20-39),
  unclamped, with a full-float32 batched product, reduced by
  ``torch.amin`` / ``torch.argmin``; under autograd the gradient flows
  through the plane (``amin`` splits it evenly among ties, as XLA's
  ``reduce_min`` does);
- the nearest-neighbour kernel (:mod:`~obman_train_tpu_torch.ops.nnsqdist`,
  K2-K5), direct differences, exact and >= 0, never materializing the
  (B, N, M) plane, with the JAX package's O(BN + BM) custom VJP as
  ``torch.autograd.Function``\\ s (float32 on the kernel, as the Pallas
  wrapper casts): the gradient of each min goes to its
  argmin pair through a gather and an ``index_add_``.

``use_kernel`` picks the route: ``True`` and ``False`` are honoured;
``"auto"`` takes the kernel on CUDA tensors at every size and the plane on
CPU tensors. The JAX rule (``_use_pallas``, ops/chamfer.py:171-183) sends
only very large planes to the kernel, from v5e timings where the plane is
one MXU product; on the H100 the plane at the training shapes is
0.4-0.5 GB of fp32 that is written, re-read by each reduction and touched
again in the backward, while the kernel reads ~10 KB per example. On the
CPU ``"auto"`` keeps the plane, as the JAX package does off the TPU, so
the CPU port matches JAX's default path.
"""

from __future__ import annotations

import os

import torch

from obman_train_tpu_torch.device import full_fp32
from obman_train_tpu_torch.ops.nnsqdist import nn_dir, nn_min_sqdist


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


def _use_kernel(x: torch.Tensor, y: torch.Tensor, use_kernel) -> bool:
    """The counterpart of the JAX ``_use_pallas``: ``True``/``False`` are
    honoured, ``"auto"`` is the kernel exactly on CUDA tensors."""
    if use_kernel is True or use_kernel is False:
        return use_kernel
    if use_kernel != "auto":
        raise ValueError(f"use_kernel must be True, False or 'auto', got {use_kernel!r}")
    return x.device.type == "cuda" and y.device.type == "cuda"


def _unported(plane_dtype) -> None:
    if plane_dtype is not None:
        raise NotImplementedError(
            "plane_dtype (the geometry_dtype selection plane) is not ported "
            "yet: a later slice")
    if os.environ.get("OBMAN_SCATTER_BWD", "0") == "1":
        raise NotImplementedError(
            "OBMAN_SCATTER_BWD=1 (the plane route's scatter backward) is not "
            "ported yet: a later slice")


def _min_sqdists_bwd(x, y, argx, argy, g_minx, g_miny):
    """The JAX VJP (ops/chamfer.py:212-234): each min's cotangent reaches
    its selected pair as 2 (x_i - y_j*) and the negative, accumulated in
    at least float32."""
    acc = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.float32)
    B, N, _ = x.shape
    M = y.shape[1]
    xa, ya = x.to(acc), y.to(acc)
    if g_minx is None:
        g_minx = torch.zeros((B, N), dtype=acc, device=x.device)
    if g_miny is None:
        g_miny = torch.zeros((B, M), dtype=acc, device=x.device)
    g_minx, g_miny = g_minx.to(acc), g_miny.to(acc)
    offs_y = (torch.arange(B, device=x.device) * M)[:, None]
    offs_x = (torch.arange(B, device=x.device) * N)[:, None]

    y_sel = torch.gather(ya, 1, argx[..., None].expand(B, N, 3))
    dx_pairs = 2.0 * (xa - y_sel) * g_minx[..., None]
    gx = dx_pairs.contiguous()
    gy = torch.zeros((B, M, 3), dtype=acc, device=x.device)
    gy.view(B * M, 3).index_add_(0, (argx + offs_y).reshape(-1),
                                 -dx_pairs.reshape(B * N, 3))

    x_sel = torch.gather(xa, 1, argy[..., None].expand(B, M, 3))
    dy_pairs = 2.0 * (ya - x_sel) * g_miny[..., None]
    gy = gy + dy_pairs
    gx.view(B * N, 3).index_add_(0, (argy + offs_x).reshape(-1),
                                 -dy_pairs.reshape(B * M, 3))
    return gx.to(x.dtype), gy.to(y.dtype)


class _KernelMinSqdistsArgmin(torch.autograd.Function):
    """``(min_x2y, argmin_x2y, min_y2x, argmin_y2x)`` on the kernel, under
    autograd: the forward records the argmins (K3's role) for the
    O(BN + BM) backward; the integer argmins are not differentiable."""

    @staticmethod
    def forward(ctx, x, y):
        minx, argx, miny, argy = nn_min_sqdist(x.float(), y.float(), with_argmin=True)
        ctx.save_for_backward(x, y, argx, argy)
        ctx.mark_non_differentiable(argx, argy)
        return minx, argx, miny, argy

    @staticmethod
    def backward(ctx, g_minx, _g_argx, g_miny, _g_argy):
        x, y, argx, argy = ctx.saved_tensors
        return _min_sqdists_bwd(x, y, argx, argy, g_minx, g_miny)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _kernel_min_sqdists(x, y):
    """``(min_x2y, min_y2x)``, the port of the JAX ``_pallas_min_sqdists``
    (:186-237): min-only sweeps (K2's role) without a gradient to take, as
    the JAX primal; with one, the argmin sweeps its VJP needs."""
    if _needs_grad(x, y):
        minx, _, miny, _ = _KernelMinSqdistsArgmin.apply(x, y)
        return minx, miny
    return nn_min_sqdist(x.float(), y.float())


def _kernel_min_sqdists_argmin(x, y):
    """The port of the JAX ``_pallas_min_sqdists_argmin`` (:240-264)."""
    if _needs_grad(x, y):
        return _KernelMinSqdistsArgmin.apply(x, y)
    return nn_min_sqdist(x.float(), y.float(), with_argmin=True)


def chamfer_min_sqdist(x: torch.Tensor, y: torch.Tensor, use_kernel="auto",
                       plane_dtype=None):
    """``(min_x2y (B,N), argmin_x2y (B,N), min_y2x (B,M), argmin_y2x (B,M))``.

    On the plane route the argmins come from ``torch.argmin``, which
    returns the first occurrence as ``jnp.argmin`` does (``torch.min`` over
    a dim does not promise which index wins a tie).
    """
    if _use_kernel(x, y, use_kernel):
        return _kernel_min_sqdists_argmin(x, y)
    _unported(plane_dtype)
    d = batch_pairwise_sqdist(x, y)
    return (
        torch.amin(d, dim=2),
        torch.argmin(d, dim=2),
        torch.amin(d, dim=1),
        torch.argmin(d, dim=1),
    )


def min_sqdist_to(x: torch.Tensor, y: torch.Tensor, use_kernel="auto",
                  plane_dtype=None) -> torch.Tensor:
    """Per-x min squared distance to ``y`` (B, N), metric only: the inputs
    are detached, and on the kernel route one min-only sweep x->y is all
    it needs (the JAX package computes both directions and keeps one).
    Used for the GT hand-object distances feeding ``meshiou``."""
    x, y = x.detach(), y.detach()
    if _use_kernel(x, y, use_kernel):
        return nn_dir(x.float(), y.float())[0]
    _unported(plane_dtype)
    return torch.amin(batch_pairwise_sqdist(x, y), dim=2)


def chamfer_loss(preds: torch.Tensor, gts: torch.Tensor, use_kernel="auto",
                 plane_dtype=None):
    """Reference ChamferLoss.forward semantics (atlasutils.py:11-18).

    Returns ``(loss_1, loss_2)``, both (B,): the per-example means of the
    per-pred min squared distance to ``gts`` and of the per-gt min
    squared distance to ``preds``.
    """
    if _use_kernel(gts, preds, use_kernel):
        min_gt2pred, min_pred2gt = _kernel_min_sqdists(gts, preds)
        return torch.mean(min_pred2gt, dim=1), torch.mean(min_gt2pred, dim=1)
    _unported(plane_dtype)
    d = batch_pairwise_sqdist(gts, preds)
    min_gt2pred = torch.amin(d, dim=2)
    min_pred2gt = torch.amin(d, dim=1)
    return torch.mean(min_pred2gt, dim=1), torch.mean(min_gt2pred, dim=1)


def chamfer_sym(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Scalar symmetric Chamfer = mean(loss_1 + loss_2) (atlasbranch.py:232-243)."""
    loss_1, loss_2 = chamfer_loss(preds, gts)
    return torch.mean(loss_1 + loss_2)
