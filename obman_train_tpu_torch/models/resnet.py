"""ResNet-18/50 image encoder, NCHW (JAX package: models/resnet.py:34-201).

The reference's vendored torchvision-style ResNet (bases/resnet.py:25-224):
conv7x7/2 + BN + ReLU + maxpool3x3/2, four stages of Basic/Bottleneck
blocks, global average pool. Module names are torchvision's, so the
state_dict keys are the ones release checkpoints carry (``conv1``,
``bn1``, ``layer{s}.{b}.conv1``, ``layer{s}.{b}.downsample.{0,1}``, ...).
``eval()`` is frozen BN (running statistics), the JAX ``train=False``;
``train()`` is the JAX ``train=True`` with flax's BatchNorm semantics
(:class:`BatchNorm2d`). The JAX package's stem and
max-pool custom backwards (ops/stemconv.py, ops/maxpool.py) change only the
backward and are off by default, so the forward is the stock
convolution / ``nn.MaxPool2d(3, 2, 1)``.

``compute_dtype`` (the config's ``compute_dtype``, JAX :40-201) is expressed
as flax expresses ``nn.Conv``/``nn.Dense(dtype=...)``: the parameters stay
float32 and every call casts its input, weight and bias to the compute
dtype (``promote_dtype``, JAX :55). :class:`Conv2d`, :class:`Conv1d` and
:class:`Linear` do that, and the BatchNorms normalize in float32 and cast
their output. ``torch.autocast`` is not used: it picks per op from its own
lists and would compute another function than the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# ModelConfig.compute_dtype -> the dtype the layers compute in; None computes
# in the parameters' own dtype (float32, or float64 for a copy made with
# ``.double()`` as a reference on the CPU), the float32 path as it was
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> Optional[torch.dtype]:
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r} not in {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def _cast_call(layer: nn.Module, op, x: torch.Tensor, bias_shape) -> torch.Tensor:
    """``op(x, weight, bias)`` in the layer's compute dtype (flax
    ``promote_dtype``): the float32 parameters are cast, not stored. In a
    compute dtype the bias is added after the product, a rounding of its
    own, as flax adds it (``y += bias``); a fused bias would round once."""
    dt = layer.compute_dtype
    if dt is None:
        return op(x, layer.weight, layer.bias)
    y = op(x.to(dt), layer.weight.to(dt), None)
    return y if layer.bias is None else y + layer.bias.to(dt).view(bias_shape)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``nn.Dense(dtype=)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _cast_call(self, F.linear, x, (-1,))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _cast_call(self, self._conv_forward, x, (-1, 1))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (flax ``nn.Conv(dtype=)``)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _cast_call(self, self._conv_forward, x, (-1, 1, 1))


class _FlaxTrainBN:
    """Training-mode BatchNorm as flax's ``nn.BatchNorm(use_running_average=
    False, momentum=0.9)`` computes it (JAX models/resnet.py:70-160,
    branches.py:180-225): ``(x - mean) * (rsqrt(var + eps) * weight) + bias``
    with the biased batch variance, differentiated through the statistics
    by autograd, and that same biased variance folded into ``running_var``
    (torch's own BatchNorm folds the unbiased one, n/(n-1) larger). Eval
    mode is torch's, unchanged. ``momentum`` is torch's, 1 - flax's.

    The normalization is written out rather than taken from
    ``F.batch_norm``: on the CPU, on the one-step inputs of
    ``tests/test_torch_train_bn.py`` (ResNet-18, 64 px, B=4), torch's fused
    float32 training backward was 7.5e-2 of a gradient's scale off a float64
    reference, the written-out chain 1.3e-3 and JAX's 9.1e-4.

    With a ``compute_dtype`` (flax ``BatchNorm(dtype=bf16)``) the
    statistics and the normalization run in at least float32, as flax's
    ``_compute_stats`` (``force_float32_reductions``) and ``_normalize``
    promote them, and the output is cast to the compute dtype; the
    parameters and running statistics stay float32. In ``eval()`` that is
    torch's own BatchNorm on the low-precision input with float32
    parameters (cuDNN on the GPU), which computes in float32 inside."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if not self.training:
            y = super().forward(x)
            return y if dt is None else y.to(dt)
        if dt is not None:
            x = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(x, dim=[0, *range(2, x.dim())], unbiased=False)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y if dt is None else y.to(dt)


class BatchNorm2d(_FlaxTrainBN, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxTrainBN, nn.BatchNorm1d):
    pass


def _bn(c: int, dtype: Optional[torch.dtype] = None) -> BatchNorm2d:
    # flax BatchNorm(momentum=0.9, epsilon=1e-5) == torch momentum 0.1
    return BatchNorm2d(c, eps=1e-5, momentum=0.1, compute_dtype=dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          dtype: Optional[torch.dtype] = None) -> Conv2d:
    return Conv2d(cin, cout, k, stride, padding, bias=False, compute_dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, dtype)
        self.bn1 = _bn(planes, dtype)
        self.conv2 = _conv(planes, planes, 3, 1, 1, dtype)
        self.bn2 = _bn(planes, dtype)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes, 1, stride, dtype=dtype),
                          _bn(planes, dtype))
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
                 downsample: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = _bn(planes, dtype)
        self.conv2 = _conv(planes, planes, 3, stride, 1, dtype)
        self.bn2 = _bn(planes, dtype)
        self.conv3 = _conv(planes, out, 1, dtype=dtype)
        self.bn3 = _bn(out, dtype)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(_conv(inplanes, out, 1, stride, dtype=dtype), _bn(out, dtype))
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
    the output of each of the four stages (NCHW), in ``dtype`` (the
    parameters' own with None)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype)
        self.bn1 = _bn(64, dtype)
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
                blocks.append(block_cls(inplanes, width, stride, needs_down, dtype))
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


def resnet18(dtype: Optional[torch.dtype] = None) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, dtype)


def resnet50(dtype: Optional[torch.dtype] = None) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, dtype)
