"""The model's weights from the run's seed, made on the device in one
draw: LeCun-normal convolution and linear weights (normal / sqrt(fan_in),
flax's default), zero biases, identity batch norms with running
statistics (0, 1), the object scale head's last bias 1. Both the program
and the reference receive these tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.core import sub_seed

WEIGHT_STREAM = 11


def make(specs: List[Tuple[str, tuple, str]], seed: int, device: str) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``specs`` (``reference.handnet.param_specs``)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHT_STREAM))
    total = sum(math.prod(shape) for _, shape, kind in specs if kind == "lecun")
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape, kind in specs:
        if kind == "lecun":
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape) / math.sqrt(math.prod(shape[1:]))
            offset += n
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
    return out
