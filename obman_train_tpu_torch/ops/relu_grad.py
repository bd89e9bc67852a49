"""The backward epilogue of a ReLU convolution on the CUDA kernel
``kernels/relu_grad.cu``: the two incoming gradients of the ReLU's output
summed, masked where the output is 0, and reduced over the rows for the
bias gradient, in one pass over memory.

It replaces no TPU kernel (the JAX package leaves the backward of its
convolutions to XLA, which fuses such passes). The folded encoder's
hand-written backward (``models/resnet_fold.py``, ``FoldedStem`` and
``FoldedBlockOp``) calls it once per ReLU'd convolution, where ATen ran an
add, ``threshold_backward``
and the bias sum of ``convolution_backward``, three passes over the same
gradient.

Dispatch goes by the tensor's device: a CUDA tensor launches the kernel
(and raises if it cannot be built or launched), a CPU tensor takes the
plain version :func:`relu_bias_grad_plain`. ``g`` is bit for bit the same
on both; ``db`` sums in another order (the kernel's is fixed by its launch
plan, so it repeats exactly from run to run).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from obman_train_tpu_torch.ops.kernels import LAUNCHES
from obman_train_tpu_torch.ops.nnsqdist import H100_SMS, _sms

KERNEL = "relu_bias_grad"

# The launch plan (relu_grad.cu): a block of THREADS threads owns up to
# STRIP float4 columns (4 channels each) and THREADS / width row lanes; the
# row groups are chosen so that the grid is one round of MIN_BLOCKS blocks
# a SM, the residency the kernel's launch bounds promise.
THREADS = 256  # kThreads of relu_grad.cu
MIN_BLOCKS = 2  # kMinBlocks
STRIP = 32  # kStrip
_MAX_GROUPS = 65535  # the grid's y limit


def relu_bias_grad_plain(a: torch.Tensor, b: Optional[torch.Tensor], y: torch.Tensor,
                         out: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(g, db)``: ``g = threshold_backward(a + b, y, 0)`` (``a`` alone
    without ``b``), written into ``out`` where given, and ``db`` its sum
    over every dimension but 1 (the channels of NCHW)."""
    g = torch.ops.aten.threshold_backward(a if b is None else a + b, y, 0)
    if out is not None:
        g = out.copy_(g)
    return g, g.sum(dim=[d for d in range(g.ndim) if d != 1])


def relu_bias_grad(a: torch.Tensor, b: Optional[torch.Tensor], y: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """As :func:`relu_bias_grad_plain`, on NCHW tensors of one shape in
    channels-last memory (the folded encoder's activations). CUDA tensors
    launch the kernel: float32 only, C a multiple of 4; ``out`` may be
    ``a`` itself, which the caller then no longer needs. CPU tensors take
    :func:`relu_bias_grad_plain`."""
    if a.device.type == "cpu":
        return relu_bias_grad_plain(a, b, y, out)
    if a.device.type != "cuda":
        raise ValueError(f"relu_bias_grad: unsupported device {a.device}")
    tensors = [t for t in (a, b, y, out) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"relu_bias_grad wants float32, got {[t.dtype for t in tensors]}")
    if any(t.shape != a.shape or t.device != a.device for t in tensors) or a.ndim != 4:
        raise ValueError(
            f"relu_bias_grad wants NCHW tensors of one shape on one device, got "
            f"{[(tuple(t.shape), str(t.device)) for t in tensors]}")
    if any(not t.is_contiguous(memory_format=torch.channels_last) or t.data_ptr() % 16
           for t in tensors):
        raise ValueError("relu_bias_grad wants 16-byte aligned channels-last tensors")
    N, C, H, W = a.shape
    if C % 4:
        raise ValueError(f"relu_bias_grad: {C} channels, not a multiple of 4")
    rows = N * H * W
    g = torch.empty_like(a) if out is None else out
    if rows == 0:
        return g, torch.zeros(C, dtype=torch.float32, device=a.device)
    groups, group_rows = _launch_plan(rows, C, _sms(a.device))
    scratch = torch.empty(C * (groups + 1), dtype=torch.float32, device=a.device)
    db, partial = scratch[:C], scratch[C:]  # partial 16-byte aligned: 4 | C
    with torch.cuda.device(a.device):
        err = _library().relu_bias_grad(
            a.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(), g.data_ptr(),
            partial.data_ptr(), db.data_ptr(), rows, C, groups, group_rows,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"relu_bias_grad kernel launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return g, db


def _launch_plan(rows: int, C: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """``(groups, group_rows)`` of one launch on a card of ``sms`` SMs: the
    row groups of the grid ``(strips, groups)`` and the rows of each (the
    last one ragged). ``strips * groups`` is about ``MIN_BLOCKS * sms``,
    with at least one row a row lane."""
    c4 = C // 4
    width = min(c4, STRIP)
    strips = -(-c4 // width)
    lanes = THREADS // width
    groups = max(1, min(MIN_BLOCKS * sms // strips, -(-rows // lanes), _MAX_GROUPS))
    group_rows = -(-rows // groups)
    return -(-rows // group_rows), group_rows


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``relu_grad.cu`` with its C interface declared."""
    from obman_train_tpu_torch.ops.kernels import build

    lib = build.load("relu_grad")
    lib.relu_bias_grad.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.relu_bias_grad.restype = ctypes.c_int
    return lib
