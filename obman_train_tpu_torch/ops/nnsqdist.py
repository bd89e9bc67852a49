"""Nearest-neighbour squared distances on the CUDA kernel ``kernels/nnsqdist.cu``.

The port of the Pallas kernels K2-K5 (JAX package:
ops/pallas/chamfer_kernel.py). One kernel, ``nn_dir``, does one direction:
for each query point, the min of ``(dx*dx + dy*dy) + dz*dz`` over the search
set, and optionally the first index that reaches it. The bidirectional
entry :func:`nn_min_sqdist` (the counterpart of
``pallas_chamfer_min_sqdist``) runs it twice, x->y and y->x: a fused pass
would need, for every search point, a reduction of its per-y min across the
block's threads, which costs more than recomputing three differences (the
TPU's split layout computes every distance twice as well,
chamfer_kernel.py:294-295). Inside one direction the search set is split
where that pays: across the warps of a block always, and across blocks
(``S`` slices, :func:`_launch_plan`) when the query tiles alone leave the
card short of blocks, as on one large cloud. Each split is merged exactly:
values equal the plain version bit for bit, argmins keep the first
occurrence.

Dispatch goes by the tensor's device: a CUDA tensor launches the kernel
(and raises if it cannot be built or launched), a CPU tensor takes the
plain version :func:`nn_dir_plain`, which repeats the kernel's arithmetic
operation for operation so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from obman_train_tpu_torch.ops.kernels import LAUNCHES

KERNEL_MIN = "nn_dir_min"
KERNEL_ARGMIN = "nn_dir_argmin"
# Pairs per step of the plain version: each (b, n, M) temporary stays
# ~64 MB (chunked over the batch, and over query rows of a large example).
_PLAIN_PAIRS = 1 << 24

# The launch plan (nnsqdist.cu): a block holds 32 * ROWS queries. Below
# _SPLIT_BELOW blocks per SM the search set is cut into slices, each a
# block of its own, until the grid has about _BLOCKS_PER_SM blocks per SM,
# but with slices of about _MIN_SLICE points (one staged chunk) or more,
# a multiple of 32 long.
ROWS = 4  # queries per thread, kR of nnsqdist.cu
H100_SMS = 132
_SPLIT_BELOW = 4
_BLOCKS_PER_SM = 16
_MIN_SLICE = 512


def _dir_plain_block(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(b, n, 3) x (b, m, 3) -> (b, n, m) in the kernel's operation order."""
    dx = q[:, :, None, 0] - s[:, None, :, 0]
    dy = q[:, :, None, 1] - s[:, None, :, 1]
    dz = q[:, :, None, 2] - s[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def nn_dir_plain(
    query: torch.Tensor, search: torch.Tensor, with_argmin: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch ``(min (B, N) float32, argmin (B, N) int64 or None)``:
    the kernel's per-pair expression, ``torch.amin`` / ``torch.argmin``
    (first occurrence) over the search axis."""
    _check(query, search)
    B, N, _ = query.shape
    M = search.shape[1]
    mins = torch.empty((B, N), dtype=torch.float32, device=query.device)
    args = (torch.empty((B, N), dtype=torch.int64, device=query.device)
            if with_argmin else None)
    rows = max(1, _PLAIN_PAIRS // M)
    bstep = max(1, rows // max(1, N))
    for b0 in range(0, B, bstep):
        for n0 in range(0, N, rows):
            d = _dir_plain_block(query[b0:b0 + bstep, n0:n0 + rows],
                                 search[b0:b0 + bstep])
            mins[b0:b0 + bstep, n0:n0 + rows] = torch.amin(d, dim=2)
            if with_argmin:
                args[b0:b0 + bstep, n0:n0 + rows] = torch.argmin(d, dim=2)
    return mins, args


def _check(query: torch.Tensor, search: torch.Tensor) -> None:
    if query.dtype != torch.float32 or search.dtype != torch.float32:
        raise TypeError(
            f"nn_dir wants float32, got {query.dtype} and {search.dtype}")
    if query.ndim != 3 or query.shape[-1] != 3:
        raise ValueError(f"query must be (B, N, 3), got {tuple(query.shape)}")
    if (search.ndim != 3 or search.shape[-1] != 3
            or search.shape[0] != query.shape[0]):
        raise ValueError(
            f"search must be (B, M, 3) with B={query.shape[0]}, "
            f"got {tuple(search.shape)}")
    if search.shape[1] == 0:
        raise ValueError("nn_dir: the search set is empty")
    if query.device != search.device:
        raise ValueError(f"query on {query.device}, search on {search.device}")


def nn_dir(
    query: torch.Tensor, search: torch.Tensor, with_argmin: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-query min squared distance (B, N) float32 over the search set of
    its batch element, and with ``with_argmin`` the first index (B, N)
    int64 reaching it. CUDA tensors launch the kernel; CPU tensors take
    :func:`nn_dir_plain`. No gradient: see ``ops/chamfer.py``."""
    if query.device.type == "cpu":
        return nn_dir_plain(query, search, with_argmin)
    _check(query, search)
    if query.device.type != "cuda":
        raise ValueError(f"nn_dir: unsupported device {query.device}")
    B, N, _ = query.shape
    M = search.shape[1]
    dev = query.device
    _, slices, slice_len, _ = _launch_plan(B, N, M, _sms(dev))
    query = query.detach().contiguous()
    search = search.detach().contiguous()
    mins = torch.empty((B, N), dtype=torch.float32, device=dev)
    args = torch.empty((B, N), dtype=torch.int64, device=dev) if with_argmin else None
    part_min = part_arg = None  # the slice merge's scratch
    if slices > 1:
        part_min = torch.empty((slices, B, N), dtype=torch.float32, device=dev)
        if with_argmin:
            part_arg = torch.empty((slices, B, N), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nn_dir(
            query.data_ptr(), search.data_ptr(), B, N, M, int(with_argmin),
            slices, slice_len, _ptr(part_min), _ptr(part_arg), mins.data_ptr(),
            _ptr(args), stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_dir kernel launch failed: CUDA error {err}")
    LAUNCHES[KERNEL_ARGMIN if with_argmin else KERNEL_MIN] += 1
    return mins, args


def _launch_plan(B: int, N: int, M: int, sms: int = H100_SMS):
    """``(ROWS, S, slice_len, blocks)`` of one ``nn_dir`` launch on a card
    of ``sms`` SMs: queries per thread, slices of the search set, points per
    slice (the last one ragged), and the blocks of the grid
    ``(ceil(N / (32 ROWS)), S, B)``.
    ``S`` is 1 unless the query tiles alone give fewer than
    ``_SPLIT_BELOW`` blocks per SM. Raises where the grid or the kernel's
    int32 indices cannot hold the launch."""
    if B > 65535:
        raise ValueError(f"nn_dir: batch {B} exceeds the grid's z limit")
    if max(N, M) >= 2**31 // 3:
        raise ValueError(f"nn_dir: {max(N, M)} points exceed the int32 index")
    tiles = -(-N // (32 * ROWS))
    base = tiles * B
    slices = 1
    if base < _SPLIT_BELOW * sms:
        slices = min(-(-_BLOCKS_PER_SM * sms // base), -(-M // _MIN_SLICE))
    slice_len = -(-M // slices)
    if slices > 1:
        slice_len = -(-slice_len // 32) * 32
    slices = -(-M // slice_len)
    return ROWS, slices, slice_len, tiles * slices * B


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _library() -> ctypes.CDLL:
    from obman_train_tpu_torch.ops.kernels import build

    lib = build.load("nnsqdist")
    lib.nn_dir.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.nn_dir.restype = ctypes.c_int
    return lib


def tie_across_slices(query: torch.Tensor, search: torch.Tensor,
                      sms: int = H100_SMS) -> None:
    """A test scene: where the launch plan on a card of ``sms`` SMs splits
    the search set into 3 or more slices, plants in place, for query point
    0 of every batch element, a minimum whose first occurrence lies in a
    middle slice and whose repeats lie in every later slice."""
    B, N, _ = query.shape
    M = search.shape[1]
    _, slices, slice_len, _ = _launch_plan(B, N, M, sms)
    if slices < 3:
        return
    first = (slices // 2) * slice_len + 5
    for j in [*range(first + slice_len, M, slice_len), M - 1]:
        search[:, j] = search[:, first]
    query[:, 0] = search[:, first] + 0.25


def nn_min_sqdist(x: torch.Tensor, y: torch.Tensor, with_argmin: bool = False):
    """Both directions, the counterpart of ``pallas_chamfer_min_sqdist``:
    ``(min_x2y (B, N), min_y2x (B, M))``, or with ``with_argmin``
    ``(min_x2y, argmin_x2y, min_y2x, argmin_y2x)`` (int64)."""
    minx, argx = nn_dir(x, y, with_argmin)
    miny, argy = nn_dir(y, x, with_argmin)
    if with_argmin:
        return minx, argx, miny, argy
    return minx, miny
