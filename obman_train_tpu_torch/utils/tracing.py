"""Spans on the profiler's timeline, at the port's layer boundaries.

``span(name)`` is a ``torch.profiler.record_function`` range while a torch
profiler records, and a shared null context otherwise (~85 ns for the
check), so the spans cost next to nothing when no one traces. The
profiler session is both the switch and the store: whoever opens one
(``cli.traineval --profile_dir``, a benchmark's traced run) finds the
spans in its trace as ``user_annotation`` ranges, on the same clock as
the device's kernels and the CUDA runtime's calls. A span brackets host
time only: it never synchronizes with the device.

Names start with their module's prefix (``train.``, ``handnet.``,
``serve.``, ``loop.``); the sites are listed in PERF.md section 3.
Under ``torch.compile`` or ``torch.export`` a span is the null context,
so a traced program holds no profiler op.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_NULL = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """A context manager: the range ``name`` (with ``args`` in its record)
    on the profiler's timeline while a profiler records and nothing is
    being compiled, else a shared no-op."""
    if not torch._C._autograd._profiler_enabled() or torch.compiler.is_compiling():
        return _NULL
    return torch.profiler.record_function(name, args)
