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
never writes. :data:`TRAIN` is the pair of ops for that:
:class:`ConvBiasReLU`, whose forward is :data:`CUDNN`'s on CUDA tensors
(:data:`PLAIN`'s elsewhere) and whose backward takes the ReLU's mask from
the saved output and runs one ``convolution_backward`` for the input,
``W'`` and ``b'``. ``demo.inference.ServeNet`` and the train step
(``train/steps.py``) decide who takes the folded route.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from obman_train_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet


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


class ConvBiasReLU(torch.autograd.Function):
    """``relu(conv(x, w) + b [+ z])`` with its own backward, for training.

    The forward is :data:`CUDNN`'s fused op on CUDA tensors and
    :data:`PLAIN`'s chain elsewhere; it saves only ``x``, ``w`` and its
    output ``y``. The backward masks the incoming gradient where ``y`` is 0
    (the ReLU's own backward, which also reads its output), runs one
    ``convolution_backward`` for the gradients of ``x``, ``w`` and ``b``
    that autograd asks for, and hands the masked gradient to ``z``."""

    @staticmethod
    def forward(ctx, x, w, b, z, stride, padding):
        ops = CUDNN if x.is_cuda else PLAIN
        c = FoldedConv(w, b, stride, padding)
        y = ops.conv_relu(x, c) if z is None else ops.conv_add_relu(x, c, z)
        ctx.save_for_backward(x, w, y)
        ctx.conv = (stride, padding, z is not None)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        stride, padding, has_z = ctx.conv
        need = ctx.needs_input_grad
        g = torch.ops.aten.threshold_backward(dy, y, 0)
        dx, dw, db = torch.ops.aten.convolution_backward(
            g, x, w, [w.shape[0]], stride, padding, (1, 1), False, (0, 0), 1,
            [need[0], need[1], need[2]])
        return dx, dw, db, (g if has_z and need[3] else None), None, None


def _train_relu(x, c: FoldedConv):
    return ConvBiasReLU.apply(x, c.weight, c.bias, None, c.stride, c.padding)


def _train_add_relu(x, c: FoldedConv, z):
    return ConvBiasReLU.apply(x, c.weight, c.bias, z, c.stride, c.padding)


TRAIN = Ops(_train_relu, _train_add_relu)


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
