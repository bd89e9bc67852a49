"""Device resolution and float32 precision scopes.

The port's entry points default to CUDA. A caller that wants the CPU says
so with ``device="cpu"``; with no GPU present and no explicit CPU request
they raise rather than carry on quietly on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA. A CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "obman_train_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the port on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_fp32(device: Optional[torch.device] = None) -> Iterator[None]:
    """Run float32 matmuls at full precision inside the block.

    The JAX package computes MANO and the geometry at
    ``Precision.HIGHEST`` (models/mano.py:26-28, ops/chamfer.py:34-37). On
    the GPU, ``torch.set_float32_matmul_precision("high")`` or
    ``torch.backends.cuda.matmul.allow_tf32 = True`` would route these
    products through TF32, which keeps ~3 decimal digits; this scope pins
    them to IEEE float32 whatever the global setting is, and restores it.
    """
    if device is not None and torch.device(device).type != "cuda":
        yield
        return
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
