"""ResNet-18/50 image encoder, NCHW (JAX package: models/resnet.py:34-201).

The reference's vendored torchvision-style ResNet (bases/resnet.py:25-224):
conv7x7/2 + BN + ReLU + maxpool3x3/2, four stages of Basic/Bottleneck
blocks, global average pool. Module names are torchvision's, so the
state_dict keys are the ones release checkpoints carry (``conv1``,
``bn1``, ``layer{s}.{b}.conv1``, ``layer{s}.{b}.downsample.{0,1}``, ...).
BN is frozen in inference: call ``.eval()``. The JAX package's stem and
max-pool custom backwards (ops/stemconv.py, ops/maxpool.py) change only the
backward and are off by default, so the forward is the stock
``nn.Conv2d`` / ``nn.MaxPool2d(3, 2, 1)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn


def _bn(c: int) -> nn.BatchNorm2d:
    # flax BatchNorm(momentum=0.9, epsilon=1e-5) == torch momentum 0.1
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                          _bn(planes))
            if downsample else None
        )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, out, 1, stride, bias=False), _bn(out))
            if downsample else None
        )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class ResNet(nn.Module):
    """Returns pooled features (B, 512|2048) and, with ``return_inter``,
    the output of each of the four stages (NCHW)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (n_blocks, width) in enumerate(
            zip(stage_sizes, (64, 128, 256, 512))
        ):
            blocks = []
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                out = width * block_cls.expansion
                needs_down = block == 0 and (stride != 1 or inplanes != out)
                blocks.append(block_cls(inplanes, width, stride, needs_down))
                inplanes = out
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(
        self, x: torch.Tensor, return_inter: bool = False
    ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        inters = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            inters.append(x)
        feats = torch.mean(x, dim=(2, 3))
        return (feats, inters) if return_inter else (feats, None)


def resnet18() -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock)


def resnet50() -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck)
