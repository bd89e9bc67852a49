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

Off the kernel route two more forms exist, in the JAX package's dispatch
order (:80-93): the kernel first, whatever ``plane_dtype`` is; then the
``geometry_dtype`` rung's selection plane (``plane_dtype``, from
:func:`plane_dtype_for`): neighbours chosen on a plane of that dtype
under ``no_grad``, the values recomputed from the chosen pairs, so the
backward never touches the plane; then, with ``OBMAN_SCATTER_BWD=1``, the
plane's forward with the kernel route's scatter-form backward; then the
plain plane under autograd. ``OBMAN_SCATTER_BWD`` is read once, when this
module is imported, as the JAX package reads it (:31); set
``_SCATTER_BWD`` to change it in a running process.

Inputs of mixed dtypes (bf16 object points against float32 targets) are
promoted where ``jnp`` promotes them: in the plane's product and in the
differences.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from obman_train_tpu_torch.device import full_fp32
from obman_train_tpu_torch.ops.nnsqdist import nn_dir, nn_min_sqdist

# the plane route's backward form (JAX :21-31): plane autograd by default,
# the scatter form with OBMAN_SCATTER_BWD=1; read at import, as in JAX
_SCATTER_BWD = os.environ.get("OBMAN_SCATTER_BWD", "0") == "1"

# --geometry_dtype -> the selection plane's dtype (None: the parity path)
PLANE_DTYPES = {"float32": None, "float32_select": torch.float32,
                "bfloat16": torch.bfloat16}


def plane_dtype_for(geometry_dtype: str) -> Optional[torch.dtype]:
    """The JAX ``plane_dtype_for`` (:143-168): ``float32`` is the parity
    path (the reference's rx + ry - 2xy values, autograd through the
    plane); ``float32_select`` the same full-float32 plane for selection
    only, values recomputed exactly from the selected pairs;
    ``bfloat16`` a one-pass bf16 selection plane with the same exact
    recompute (near-ties below bf16 resolution may pick another
    neighbour)."""
    if geometry_dtype not in PLANE_DTYPES:
        raise ValueError(
            f"geometry_dtype {geometry_dtype!r} not in {sorted(PLANE_DTYPES)}")
    return PLANE_DTYPES[geometry_dtype]


def batch_pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (B, N, M) between x (B, N, 3) and y (B, M, 3).

    Computed as rx + ry - 2 x.y^T like the reference, so values can be
    slightly negative from cancellation; the reference does not clamp.
    Each squared norm is taken in its input's dtype and the product in
    the promoted one, as ``jnp.einsum`` promotes.
    """
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    dt = torch.promote_types(x.dtype, y.dtype)
    with full_fp32(x.device):
        xy = torch.bmm(x.to(dt), y.to(dt).transpose(1, 2))
    return xx[:, :, None] + yy[:, None, :] - 2.0 * xy


def _use_kernel(x: torch.Tensor, y: torch.Tensor, use_kernel) -> bool:
    """The counterpart of the JAX ``_use_pallas``: ``True``/``False`` are
    honoured, ``"auto"`` is the kernel exactly on CUDA tensors."""
    if use_kernel is True or use_kernel is False:
        return use_kernel
    if use_kernel != "auto":
        raise ValueError(f"use_kernel must be True, False or 'auto', got {use_kernel!r}")
    return x.device.type == "cuda" and y.device.type == "cuda"


def _plane_argmin(x: torch.Tensor, y: torch.Tensor):
    """``(min_x2y, argmin_x2y, min_y2x, argmin_y2x)`` of the plane;
    ``torch.argmin`` returns the first occurrence as ``jnp.argmin`` does
    (``torch.min`` over a dim does not promise which index wins a tie)."""
    d = batch_pairwise_sqdist(x, y)
    return (torch.amin(d, dim=2), torch.argmin(d, dim=2),
            torch.amin(d, dim=1), torch.argmin(d, dim=1))


def _argmin_recompute_min_sqdist(x: torch.Tensor, y: torch.Tensor,
                                 plane_dtype: torch.dtype):
    """The JAX ``_argmin_recompute_min_sqdist`` (:97-140): neighbours
    selected on a ``plane_dtype`` plane of the detached inputs, under
    ``no_grad`` (the plane is dead in the backward), and the min values
    recomputed as ``|x_i - y_j*|^2`` from the selected pairs, so they are
    exact and >= 0 and their gradient is the min subgradient through the
    selected pair (gather, then its scatter-add in the backward). A
    float32 plane runs at full float32 as the parity path's; a bf16 one
    is the same expression in bf16 throughout, a plain bf16 ``torch.bmm``
    for the product (JAX computes it in XLA, not in Pallas), which selects
    what the JAX package's plane selects on the CPU."""
    with torch.no_grad():
        d = batch_pairwise_sqdist(x.detach().to(plane_dtype), y.detach().to(plane_dtype))
        argx = torch.argmin(d, dim=2)  # (B, N)
        argy = torch.argmin(d, dim=1)  # (B, M)
    B, N, _ = x.shape
    M = y.shape[1]
    y_sel = torch.gather(y, 1, argx[..., None].expand(B, N, 3))
    minx = torch.sum(torch.square(x - y_sel), dim=-1)
    x_sel = torch.gather(x, 1, argy[..., None].expand(B, M, 3))
    miny = torch.sum(torch.square(y - x_sel), dim=-1)
    return minx, argx, miny, argy


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


def _save(ctx, x, y, out):
    ctx.save_for_backward(x, y, out[1], out[3])
    ctx.mark_non_differentiable(out[1], out[3])
    return out


class _KernelMinSqdistsArgmin(torch.autograd.Function):
    """``(min_x2y, argmin_x2y, min_y2x, argmin_y2x)`` on the kernel, under
    autograd: the forward records the argmins (K3's role) for the
    O(BN + BM) backward; the integer argmins are not differentiable. The
    kernel takes float32, as the Pallas wrapper promotes its inputs
    (chamfer_kernel.py:220); the backward returns each input's dtype."""

    @staticmethod
    def forward(ctx, x, y):
        return _save(ctx, x, y, nn_min_sqdist(x.float(), y.float(), with_argmin=True))

    @staticmethod
    def backward(ctx, g_minx, _g_argx, g_miny, _g_argy):
        x, y, argx, argy = ctx.saved_tensors
        return _min_sqdists_bwd(x, y, argx, argy, g_minx, g_miny)


class _PlaneMinScatterArgmin(_KernelMinSqdistsArgmin):
    """The JAX ``_plane_min_scatter_argmin`` (:305-335), the
    ``OBMAN_SCATTER_BWD=1`` form: the plane's forward, values and argmins
    bit for bit, and the kernel route's backward, which routes each min's
    cotangent through its argmin pair without touching the plane again."""

    @staticmethod
    def forward(ctx, x, y):
        return _save(ctx, x, y, _plane_argmin(x, y))


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
    """``(min_x2y (B,N), argmin_x2y (B,N), min_y2x (B,M), argmin_y2x (B,M))``,
    by the JAX dispatch order (:80-93): the kernel, the ``plane_dtype``
    selection plane, the plane."""
    if _use_kernel(x, y, use_kernel):
        return _kernel_min_sqdists_argmin(x, y)
    if plane_dtype is not None:
        return _argmin_recompute_min_sqdist(x, y, plane_dtype)
    if _SCATTER_BWD and _needs_grad(x, y):
        return _PlaneMinScatterArgmin.apply(x, y)
    return _plane_argmin(x, y)


def min_sqdist_to(x: torch.Tensor, y: torch.Tensor, use_kernel="auto",
                  plane_dtype=None) -> torch.Tensor:
    """Per-x min squared distance to ``y`` (B, N), metric only: the inputs
    are detached, and on the kernel route one min-only sweep x->y is all
    it needs (the JAX package computes both directions and keeps one).
    Used for the GT hand-object distances feeding ``meshiou``."""
    x, y = x.detach(), y.detach()
    if _use_kernel(x, y, use_kernel):
        return nn_dir(x.float(), y.float())[0]
    if plane_dtype is not None:
        return _argmin_recompute_min_sqdist(x, y, plane_dtype)[0]
    return torch.amin(batch_pairwise_sqdist(x, y), dim=2)


def chamfer_loss(preds: torch.Tensor, gts: torch.Tensor, use_kernel="auto",
                 plane_dtype=None):
    """Reference ChamferLoss.forward semantics (atlasutils.py:11-18).

    Returns ``(loss_1, loss_2)``, both (B,): the per-example means of the
    per-pred min squared distance to ``gts`` and of the per-gt min
    squared distance to ``preds``. ``plane_dtype`` is the rung's selection
    plane, ignored on the kernel route (JAX :386-409).
    """
    if _use_kernel(gts, preds, use_kernel):
        min_gt2pred, min_pred2gt = _kernel_min_sqdists(gts, preds)
    elif plane_dtype is not None:
        min_gt2pred, _, min_pred2gt, _ = _argmin_recompute_min_sqdist(
            gts, preds, plane_dtype)
    elif _SCATTER_BWD and _needs_grad(gts, preds):
        min_gt2pred, _, min_pred2gt, _ = _PlaneMinScatterArgmin.apply(gts, preds)
    else:
        d = batch_pairwise_sqdist(gts, preds)
        min_gt2pred = torch.amin(d, dim=2)
        min_pred2gt = torch.amin(d, dim=1)
    return torch.mean(min_pred2gt, dim=1), torch.mean(min_gt2pred, dim=1)


def chamfer_sym(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Scalar symmetric Chamfer = mean(loss_1 + loss_2) (atlasbranch.py:232-243)."""
    loss_1, loss_2 = chamfer_loss(preds, gts)
    return torch.mean(loss_1 + loss_2)
