"""The frozen ResNet encoder with its BatchNorms folded into its
convolutions, for serving and for the frozen-BN train step.

With running statistics a BatchNorm after a convolution is an affine map
per output channel, so ``bn(conv(x, W))`` is ``conv(x, W') + b'`` exactly:

    s  = weight * rsqrt(running_var + eps)
    W' = W * s[:, None, None, None]
    b' = bias - running_mean * s

:func:`fold` computes that for every ``Conv2d -> BatchNorm2d`` pair of a
:class:`~obman_train_tpu_torch.models.resnet.ResNet` (the stem, each
:class:`BasicBlock` or :class:`Bottleneck`, and their downsample branches),
in the parameters' own dtype, with ``W'`` in channels-last memory format
(the encoder's activations are NHWC frames viewed as NCHW). The
per-channel vectors of all the pairs are computed at once, on their
concatenation. A block's downsample convolution keeps no bias: its ``b'``
joins the bias of the block's last convolution, so the residual is a bare
convolution.

:func:`features` runs the folded encoder with a pair of ops, each a
convolution with its folded bias and a ReLU, the second adding the
residual before the ReLU. :data:`CUDNN` is cuDNN's fused convolution
epilogue (``torch.cudnn_convolution_relu``,
``torch.cudnn_convolution_add_relu``): one kernel writes each activation
once, where the unfolded encoder runs a convolution, a BatchNorm, an add
and a ReLU as separate passes. :data:`PLAIN` writes the same chain out
with ``F.conv2d``; the CPU tests hold it to ``ResNet.forward``.

Training folds too. The fold is the same function of the convolutions'
weights and the BatchNorms' scale and shift as the unfolded chain, so
computed under autograd at every forward it gives them the same
gradients; the running statistics are buffers that frozen-BN training
never writes. :func:`train_features` runs the folded encoder for that as
a chain of autograd nodes with hand-written backwards, :class:`FoldedStem`
and one :class:`FoldedBlockOp` a block, each :func:`features`'s forward
on :data:`CUDNN` (:data:`PLAIN` on CPU tensors). Each node returns its
output twice, so a block's two gradients (its next block's first
convolution's and its residual's) reach its backward apart; at each
ReLU'd convolution one ``ops.relu_grad.relu_bias_grad`` sums them, masks
them with the saved output and reduces ``b'``'s gradient in one pass, and
one ``convolution_backward`` gives the input's and ``W'``'s.
``demo.inference.ServeNet`` and the train step (``train/steps.py``)
decide who takes the folded route.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from obman_train_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from obman_train_tpu_torch.ops import relu_grad


class FoldedConv(NamedTuple):
    weight: torch.Tensor  # (Cout, Cin, k, k), channels-last
    bias: Optional[torch.Tensor]  # (Cout,)
    stride: Tuple[int, int]
    padding: Tuple[int, int]


class FoldedBlock(NamedTuple):
    relu_convs: List[FoldedConv]  # conv1 (Basic); conv1, conv2 (Bottleneck)
    last: FoldedConv  # its bias holds the downsample's
    down: Optional[FoldedConv]  # bias None


class Folded(NamedTuple):
    stem: FoldedConv
    blocks: List[FoldedBlock]


class Ops(NamedTuple):
    """``conv_relu(x, c)`` and ``conv_add_relu(x, c, z)``: ``relu(conv(x,
    c.weight) + c.bias [+ z])`` at ``c``'s stride and padding."""
    conv_relu: Callable[[torch.Tensor, FoldedConv], torch.Tensor]
    conv_add_relu: Callable[[torch.Tensor, FoldedConv, torch.Tensor], torch.Tensor]


def _cudnn_relu(x, c: FoldedConv):
    return torch.cudnn_convolution_relu(x, c.weight, c.bias, c.stride, c.padding, (1, 1), 1)


def _cudnn_add_relu(x, c: FoldedConv, z):
    return torch.cudnn_convolution_add_relu(x, c.weight, z, 1.0, c.bias, c.stride, c.padding,
                                            (1, 1), 1)


def _plain_relu(x, c: FoldedConv):
    return F.relu(F.conv2d(x, c.weight, c.bias, c.stride, c.padding))


def _plain_add_relu(x, c: FoldedConv, z):
    return F.relu(F.conv2d(x, c.weight, c.bias, c.stride, c.padding) + z)


CUDNN = Ops(_cudnn_relu, _cudnn_add_relu)
PLAIN = Ops(_plain_relu, _plain_add_relu)


def _pairs(block: nn.Module):
    if isinstance(block, BasicBlock):
        return [(block.conv1, block.bn1), (block.conv2, block.bn2)]
    if isinstance(block, Bottleneck):
        return [(block.conv1, block.bn1), (block.conv2, block.bn2), (block.conv3, block.bn3)]
    raise TypeError(f"cannot fold a {type(block).__name__}")


def layers(net: ResNet) -> List[Tuple[nn.Conv2d, nn.BatchNorm2d]]:
    """Every ``(conv, bn)`` pair of ``net``, the stem first, then each
    block's in order, its downsample last."""
    out = [(net.conv1, net.bn1)]
    for stage in (net.layer1, net.layer2, net.layer3, net.layer4):
        for block in stage:
            out += _pairs(block)
            if block.downsample is not None:
                out.append((block.downsample[0], block.downsample[1]))
    return out


def sources(net: ResNet) -> List[torch.Tensor]:
    """The tensors a fold of ``net`` reads, as its modules hold them now
    (under ``functional_call`` the swapped-in ones)."""
    return [t for conv, bn in layers(net)
            for t in (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)]


def _fold_convs(pairs: List[Tuple[nn.Conv2d, nn.BatchNorm2d]]) -> List[FoldedConv]:
    """Each pair folded. ``s`` and ``b'`` of all the pairs come from one
    chain of ops on the concatenated BatchNorm vectors (each entry computed
    as a pair's own chain computes it), split into views, so a fold under
    autograd records a few ops for them and one multiply and one layout
    copy per weight."""
    bns = [bn for _, bn in pairs]
    eps = bns[0].eps
    if any(bn.eps != eps for bn in bns):
        raise ValueError("the encoder's BatchNorms differ in eps")
    s = torch.cat([bn.weight for bn in bns]) * torch.rsqrt(
        torch.cat([bn.running_var for bn in bns]) + eps)
    b = torch.cat([bn.bias for bn in bns]) - torch.cat([bn.running_mean for bn in bns]) * s
    sizes = [bn.num_features for bn in bns]
    return [FoldedConv((conv.weight * si).contiguous(memory_format=torch.channels_last),
                       bi, tuple(conv.stride), tuple(conv.padding))
            for (conv, _), si, bi in zip(pairs, s.view(-1, 1, 1, 1).split(sizes),
                                         b.split(sizes))]


def fold(net: ResNet) -> Folded:
    """``net``'s convolutions with their BatchNorms folded in (see the
    module's docstring). Reads the running statistics: ``net`` is meant
    to be in ``eval()``. Differentiable in the weights and the BatchNorms'
    scale and shift."""
    convs = iter(_fold_convs(layers(net)))  # in the order of layers(net)
    stem = next(convs)
    blocks = []
    for stage in (net.layer1, net.layer2, net.layer3, net.layer4):
        for block in stage:
            folded = [next(convs) for _ in _pairs(block)]
            last, down = folded[-1], None
            if block.downsample is not None:
                d = next(convs)
                down = d._replace(bias=None)
                last = last._replace(bias=last.bias + d.bias)
            blocks.append(FoldedBlock(folded[:-1], last, down))
    return Folded(stem, blocks)


def block(fb: FoldedBlock, x: torch.Tensor, ops: Ops = CUDNN) -> torch.Tensor:
    """One folded ``BasicBlock`` or ``Bottleneck`` on NCHW activations."""
    z = x
    if fb.down is not None:
        d = fb.down
        z = F.conv2d(x, d.weight, None, d.stride, d.padding)
    for c in fb.relu_convs:
        x = ops.conv_relu(x, c)
    return ops.conv_add_relu(x, fb.last, z)


def features(folded: Folded, x: torch.Tensor, ops: Ops = CUDNN):
    """``(features (B, C), None)`` of NCHW images ``x``, as
    ``ResNet.forward`` returns them."""
    x = F.max_pool2d(ops.conv_relu(x, folded.stem), 3, 2, 1)
    for fb in folded.blocks:
        x = block(fb, x, ops)
    return torch.mean(x, dim=(2, 3)), None


def _conv_grads(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, geometry, need_x: bool,
                need_w: bool):
    """The gradients of ``x`` and ``w`` given the gradient ``g`` of
    ``conv(x, w)`` at ``geometry`` (stride, padding); None where not
    needed."""
    return torch.ops.aten.convolution_backward(
        g, x, w, None, *geometry, (1, 1), False, (0, 0), 1, [need_x, need_w, False])[:2]


class FoldedStem(torch.autograd.Function):
    """The stem of :func:`train_features`: ``apply(x, W', b', stride,
    padding)`` is the max-pool of ``relu(conv(x, W') + b')``, returned
    twice (the output and a view of it), so that the first block's two
    users of it (its first convolution, its identity or downsample) hand
    their gradients back apart. It saves ``x``, ``W'``, the ReLU's output
    and the max-pool's indices, as the per-op chain's autograd would.

    The backward adds the two gradients (the max-pool output has no ReLU
    of its own to take them), runs the max-pool's backward, then one
    ``relu_bias_grad`` (mask and ``b'``'s gradient, written over the
    max-pool's fresh gradient) and one ``convolution_backward``."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        c = FoldedConv(w, b, stride, padding)
        s = (CUDNN if x.is_cuda else PLAIN).conv_relu(x, c)
        p, idx = torch.ops.aten.max_pool2d_with_indices(s, [3, 3], [2, 2], [1, 1])
        ctx.save_for_backward(x, w, s, idx)
        ctx.geometry = (stride, padding)
        ctx.set_materialize_grads(False)
        return p, p.view_as(p)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dp, dq):
        if dp is None and dq is None:
            return None, None, None, None, None
        x, w, s, idx = ctx.saved_tensors
        need = ctx.needs_input_grad
        dp = dq if dp is None else dp if dq is None else dp + dq
        ds = torch.ops.aten.max_pool2d_with_indices_backward(
            dp, s, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)
        ds = ds.contiguous(memory_format=torch.channels_last)
        g, db = relu_grad.relu_bias_grad(ds, None, s, out=ds)
        dx, dw = _conv_grads(g, x, w, ctx.geometry, need[0], need[1])
        return dx, dw, (db if need[2] else None), None, None


class FoldedBlockOp(torch.autograd.Function):
    """One block of :func:`train_features`: ``apply(geometry, x, xs,
    *params)`` is :func:`block` on ``x`` (its ReLU'd convolutions) and
    ``xs`` (its identity or downsample), the previous node's two outputs,
    which hold the same values. ``params`` are each convolution's ``W'``
    and ``b'`` in the order ReLU'd convolutions, last, downsample;
    ``geometry`` their (stride, padding) in that order and whether there
    is a downsample. The output comes back twice, as :class:`FoldedStem`'s.
    It saves each convolution's input, ``W'`` and output, as the per-op
    chain's autograd would, and autograd frees them once its backward has
    run, as it frees the chain's.

    The backward takes the output's two gradients apart (the next block's
    first convolution's, and its identity's or downsample's) and calls
    ``relu_bias_grad`` on them and the saved output: one pass gives the
    masked gradient ``g`` (written over the first gradient, which only the
    next node's backward or the mean's made) and the last convolution's
    ``b'`` gradient. Then ``convolution_backward`` for its input and ``W'``,
    the downsample's where there is one, and the same for each inner ReLU'd
    convolution; the block input's two gradients go back apart. ``g`` is
    bit for bit the per-op chain's; the convolutions' gradients come from
    the same calls on it; ``b'``'s sums in another order."""

    @staticmethod
    def forward(ctx, geometry, x, xs, *params):
        convs, has_down = geometry
        c = [FoldedConv(params[2 * i], params[2 * i + 1], *g) for i, g in enumerate(convs)]
        fb = FoldedBlock(c[:len(c) - 1 - has_down], c[len(c) - 1 - has_down],
                         c[-1] if has_down else None)
        ops = CUDNN if x.is_cuda else PLAIN
        z = xs
        if fb.down is not None:
            d = fb.down
            z = F.conv2d(xs, d.weight, None, d.stride, d.padding)
        outs = []
        for conv in fb.relu_convs:
            x = ops.conv_relu(x, conv)
            outs.append(x)
        y = ops.conv_add_relu(x, fb.last, z)
        ctx.save_for_backward(xs, *params, *outs, y)
        ctx.geometry = geometry
        ctx.set_materialize_grads(False)
        return y, y.view_as(y)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dys):
        convs, has_down = ctx.geometry
        n = 2 * len(convs)
        if dy is None and dys is None:
            return (None,) * (3 + n)
        x, *saved = ctx.saved_tensors
        params, acts = saved[:n], saved[n:]  # acts: each ReLU'd output, y last
        need = ctx.needs_input_grad[3:]  # each W' and b'
        grads = [None] * n
        k = len(acts) - 1  # ReLU'd convolutions before the last
        if dy is None:
            dy, dys = dys, None
        a = dy.contiguous(memory_format=torch.channels_last)
        g, db = relu_grad.relu_bias_grad(a, dys, acts[k], out=a)

        def conv(i, g, x, db=None):
            dx, dw = _conv_grads(g, x, params[2 * i], convs[i], True, need[2 * i])
            grads[2 * i], grads[2 * i + 1] = dw, (db if need[2 * i + 1] else None)
            return dx

        dh = conv(k, g, acts[k - 1] if k else x, db)
        dskip = conv(k + 1, g, x) if has_down else g
        for r in reversed(range(k)):
            g, db = relu_grad.relu_bias_grad(dh, None, acts[r], out=dh)
            dh = conv(r, g, acts[r - 1] if r else x, db)
        return (None, dh, dskip, *grads)


def _geometry(fb: FoldedBlock):
    convs = [*fb.relu_convs, fb.last] + ([fb.down] if fb.down is not None else [])
    return (tuple((c.stride, c.padding) for c in convs), fb.down is not None), [
        t for c in convs for t in (c.weight, c.bias)]


def train_features(folded: Folded, x: torch.Tensor):
    """:func:`features` of NCHW images ``x`` for training, as a chain of
    autograd nodes with hand-written backwards: :class:`FoldedStem`, one
    :class:`FoldedBlockOp` a block, then the mean. The same forward; the
    fold's own ops stay autograd's."""
    stem = folded.stem
    x, xs = FoldedStem.apply(x, stem.weight, stem.bias, stem.stride, stem.padding)
    for fb in folded.blocks:
        geometry, params = _geometry(fb)
        x, xs = FoldedBlockOp.apply(geometry, x, xs, *params)
    return torch.mean(x, dim=(2, 3)), None
