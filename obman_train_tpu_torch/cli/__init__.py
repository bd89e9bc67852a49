"""CLI entry points of the port (the JAX package's ``cli/``).

The CLIs run on the GPU. ``OBMAN_PLATFORM=cpu``, the JAX CLIs' own
override (``cli/__init__.py::apply_platform_override``), puts them on the
CPU, which is how the tests reach them; without it and without a GPU they
raise.
"""

from __future__ import annotations

import os

import torch

from obman_train_tpu_torch.device import resolve_device


def apply_platform_override() -> torch.device:
    """The device named by ``$OBMAN_PLATFORM`` (``cpu``, or ``gpu``/``cuda``),
    CUDA when it is unset; CUDA without a GPU raises."""
    platform = os.environ.get("OBMAN_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "gpu", "cuda"):
        raise ValueError(f"OBMAN_PLATFORM={platform!r}: expected cpu, gpu or cuda")
    return resolve_device(None)
