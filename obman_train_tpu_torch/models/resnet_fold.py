"""The frozen ResNet encoder with its BatchNorms folded into its
convolutions, for serving.

With running statistics a BatchNorm after a convolution is an affine map
per output channel, so ``bn(conv(x, W))`` is ``conv(x, W') + b'`` exactly:

    s  = weight * rsqrt(running_var + eps)
    W' = W * s[:, None, None, None]
    b' = bias - running_mean * s

:func:`fold` computes that once for every ``Conv2d -> BatchNorm2d`` pair of
a :class:`~obman_train_tpu_torch.models.resnet.ResNet` (the stem, each
:class:`BasicBlock` or :class:`Bottleneck`, and their downsample branches),
in the parameters' own dtype, with ``W'`` in channels-last memory format
(the encoder's activations are NHWC frames viewed as NCHW). A block's
downsample convolution keeps no bias: its ``b'`` joins the bias of the
block's last convolution, so the residual is a bare convolution.

:func:`features` runs the folded encoder with a pair of ops, each a
convolution with its folded bias and a ReLU, the second adding the
residual before the ReLU. :data:`CUDNN` is cuDNN's fused convolution
epilogue (``torch.cudnn_convolution_relu``,
``torch.cudnn_convolution_add_relu``): one kernel writes each activation
once, where the unfolded encoder runs a convolution, a BatchNorm, an add
and a ReLU as separate passes. :data:`PLAIN` writes the same chain out
with ``F.conv2d``; the CPU tests hold it to ``ResNet.forward``.

Training cannot fold: the convolutions' weights and the BatchNorms' scale
and shift take gradients every step. ``demo.inference.ServeNet`` decides
who takes the folded route.
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


def _fold_pair(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> FoldedConv:
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    w = (conv.weight * s[:, None, None, None]).contiguous(memory_format=torch.channels_last)
    b = bn.bias - bn.running_mean * s
    return FoldedConv(w, b, tuple(conv.stride), tuple(conv.padding))


def fold(net: ResNet) -> Folded:
    """``net``'s convolutions with their BatchNorms folded in (see the
    module's docstring). Reads the running statistics: ``net`` is meant
    to be in ``eval()``."""
    blocks = []
    for stage in (net.layer1, net.layer2, net.layer3, net.layer4):
        for block in stage:
            convs = [_fold_pair(c, b) for c, b in _pairs(block)]
            last, down = convs[-1], None
            if block.downsample is not None:
                d = _fold_pair(block.downsample[0], block.downsample[1])
                down = d._replace(bias=None)
                last = last._replace(bias=last.bias + d.bias)
            blocks.append(FoldedBlock(convs[:-1], last, down))
    return Folded(_fold_pair(net.conv1, net.bn1), blocks)


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
