"""Ray-parity point-in-mesh test on the CUDA kernel ``kernels/raytri.cu``.

The port of the Pallas kernel K1 (JAX package:
ops/pallas/raytri_kernel.py, ``pallas_mesh_contains_points``). Triangle-only
quantities are precomputed in PyTorch exactly as the Pallas wrapper does in
XLA (raytri_kernel.py:86-94); the kernel counts hits per query point; the
parity of the count gives the exterior mask.

Each thread of the kernel holds several points, the warps of a block
split the triangles, and when the point tiles alone leave the card short of
blocks (one voxel grid), :func:`_launch_plan` also splits the triangles
across blocks (``S`` slices whose integer counts add exactly).

Dispatch goes by the tensor's device: a CUDA tensor launches the kernel
(and raises if it cannot be built or launched), a CPU tensor takes the
plain version :func:`raytri_count_plain`, which repeats the kernel's
arithmetic operation for operation so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from obman_train_tpu_torch.ops.inside import RAY_DIRECTION, TOL
from obman_train_tpu_torch.ops.kernels import LAUNCHES
from obman_train_tpu_torch.ops.nnsqdist import H100_SMS, _sms

KERNEL = "raytri_count"
# Floats per triangle in the table: four float4 rows (see raytri.cu).
TABLE_WIDTH = 16
# The ray direction and tolerance as the float32 values both versions use.
_DIR_F32 = tuple(torch.tensor(RAY_DIRECTION, dtype=torch.float32).tolist())
_TOL_F32 = torch.tensor(TOL, dtype=torch.float32).item()
# (point, triangle) pairs per step of the plain version: its temporaries
# stay ~64 MB each (chunked over the batch, and over the points of a
# large example such as a voxel grid).
_PLAIN_ELEMS = 1 << 24

# The launch plan (raytri.cu): a block holds 32 * ROWS points, and its
# WARPS warps split each staged chunk of CHUNK triangles. When the point
# tiles give fewer than _SPLIT_BELOW blocks per SM and, dealt to the SMs,
# keep them less than _FILL busy (the SMs that get one block more set the
# time), the triangles are cut into slices, each a block of its own, until
# the grid has about _BLOCKS_PER_SM blocks per SM, but with slices of
# _MIN_SLICE triangles or more, a multiple of 32 long.
ROWS = 4  # points per thread, kR of raytri.cu
WARPS = 8  # kWarps of raytri.cu
CHUNK = 384  # kChunk of raytri.cu
_SPLIT_BELOW = 4
_FILL = 0.9
_BLOCKS_PER_SM = 8
_MIN_SLICE = 64


def triangle_table(triangles: torch.Tensor) -> torch.Tensor:
    """(B, T, 3, 3) triangles -> (B, T, 16) float32 kernel table.

    Rows: (v0, invdet), (e1, ok), (e2, 0), (pvec, 0), with pvec = d x e2,
    det = e1 . pvec, ok = |det| >= TOL and invdet = 1 / (det + 0.1 TOL).
    The edges are differenced in the triangles' own dtype and then cast,
    as the Pallas wrapper (raytri_kernel.py:87-89) and the JAX inside test
    compute them for bf16 object vertices.
    """
    d0, d1, d2 = _direction(triangles.device)
    v0 = triangles[:, :, 0].to(torch.float32)
    e1 = (triangles[:, :, 1] - triangles[:, :, 0]).to(torch.float32)
    e2 = (triangles[:, :, 2] - triangles[:, :, 0]).to(torch.float32)
    e2x, e2y, e2z = e2.unbind(-1)
    # jnp.cross(d, e2), component by component in its order
    pvx = d1 * e2z - d2 * e2y
    pvy = d2 * e2x - d0 * e2z
    pvz = d0 * e2y - d1 * e2x
    dets = e1[..., 0] * pvx + e1[..., 1] * pvy + e1[..., 2] * pvz
    ok = (torch.abs(dets) >= TOL).to(torch.float32)
    invdet = 1.0 / (dets + 0.1 * TOL)
    zero = torch.zeros_like(invdet)
    return torch.stack(
        [v0[..., 0], v0[..., 1], v0[..., 2], invdet,
         e1[..., 0], e1[..., 1], e1[..., 2], ok,
         e2x, e2y, e2z, zero,
         pvx, pvy, pvz, zero],
        dim=-1,
    ).contiguous()


def _direction(device: torch.device):
    d = torch.tensor(RAY_DIRECTION, dtype=torch.float32, device=device)
    return d[0], d[1], d[2]


def raytri_count_plain(points: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch hit counts (B, P) int32, the kernel's arithmetic in
    the kernel's order (one rounding per operation, no FMA)."""
    B, P, _ = points.shape
    T = table.shape[1]
    d0, d1, d2 = _direction(points.device)
    tol = torch.tensor(TOL, dtype=torch.float32, device=points.device)
    counts = torch.empty((B, P), dtype=torch.int32, device=points.device)
    rows = max(1, _PLAIN_ELEMS // max(1, T))
    step = max(1, rows // max(1, P))
    for b0, p0 in ((b, p) for b in range(0, B, step) for p in range(0, P, rows)):
        pts = points[b0 : b0 + step, p0 : p0 + rows, None, :]  # (b, p, 1, 3)
        tb = table[b0 : b0 + step, None, :, :]                 # (b, 1, T, 16)
        px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
        invdet = tb[..., 3]
        tx = px - tb[..., 0]
        ty = py - tb[..., 1]
        tz = pz - tb[..., 2]
        u = (tx * tb[..., 12] + ty * tb[..., 13] + tz * tb[..., 14]) * invdet
        e1x, e1y, e1z = tb[..., 4], tb[..., 5], tb[..., 6]
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (d0 * qx + d1 * qy + d2 * qz) * invdet
        t = (tb[..., 8] * qx + tb[..., 9] * qy + tb[..., 10] * qz) * invdet
        hit = (u > 0) & (u < 1) & (v > 0) & ((u + v) < 1) & (t >= tol)
        hit = hit & (tb[..., 7] > 0)
        counts[b0 : b0 + step, p0 : p0 + rows] = torch.sum(hit, dim=-1, dtype=torch.int32)
    return counts


def _check(points: torch.Tensor, table: torch.Tensor) -> None:
    if points.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(
            f"raytri_count wants float32, got {points.dtype} and {table.dtype}"
        )
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, P, 3), got {tuple(points.shape)}")
    if (table.ndim != 3 or table.shape[0] != points.shape[0]
            or table.shape[-1] != TABLE_WIDTH):
        raise ValueError(
            f"table must be (B, T, {TABLE_WIDTH}) with B={points.shape[0]}, "
            f"got {tuple(table.shape)}"
        )
    if points.device != table.device:
        raise ValueError(f"points on {points.device}, table on {table.device}")


def raytri_count(points: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Hit counts (B, P) int32 of the ray from each point against the
    triangle table of its batch element. CUDA tensors launch the kernel;
    CPU tensors take :func:`raytri_count_plain`."""
    _check(points, table)
    if points.device.type == "cpu":
        return raytri_count_plain(points, table)
    if points.device.type != "cuda":
        raise ValueError(f"raytri_count: unsupported device {points.device}")
    B, P, _ = points.shape
    T = table.shape[1]
    _, slices, slice_len, _ = _launch_plan(B, P, T, _sms(points.device))
    points = points.contiguous()
    table = table.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("raytri_count: the table must be 16-byte aligned")
    counts = torch.empty((B, P), dtype=torch.int32, device=points.device)
    lib = _library()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.raytri_count(
            points.data_ptr(), table.data_ptr(), B, P, T, *_DIR_F32, _TOL_F32,
            slices, slice_len, counts.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"raytri_count kernel launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return counts


def _launch_plan(B: int, P: int, T: int, sms: int = H100_SMS):
    """``(rows, S, slice_len, blocks)`` of one ``raytri_count`` launch on a
    card of ``sms`` SMs: points per thread, slices of the triangles,
    triangles per slice (the last one ragged), and the blocks of the grid
    ``(ceil(P / (32 rows)), S, B)``. ``S`` is 1 unless the point tiles
    alone give fewer than ``_SPLIT_BELOW`` blocks per SM and fill the SMs'
    last round less than ``_FILL``. Raises where the grid or the kernel's
    int32 indices cannot hold the launch."""
    if B > 65535:
        raise ValueError(f"raytri_count: batch {B} exceeds the grid's z limit")
    if P >= 2**31 // 3:
        raise ValueError(f"raytri_count: {P} points exceed the int32 index")
    if T >= 2**31 // 4:
        raise ValueError(f"raytri_count: {T} triangles exceed the int32 index")
    rows = ROWS
    tiles = -(-P // (32 * rows))
    base = tiles * B
    slices = 1
    if 0 < base < _SPLIT_BELOW * sms and base < _FILL * sms * -(-base // sms):
        slices = max(1, min(-(-_BLOCKS_PER_SM * sms // base), -(-T // _MIN_SLICE)))
    slice_len = -(-T // slices)
    if slices > 1:
        slice_len = -(-slice_len // 32) * 32
        slices = -(-T // slice_len)
    return rows, slices, slice_len, tiles * slices * B


def _library() -> ctypes.CDLL:
    from obman_train_tpu_torch.ops.kernels import build

    return bind(build.load("raytri"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a built ``raytri.cu`` on ``lib``."""
    lib.raytri_count.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.raytri_count.restype = ctypes.c_int
    return lib


def mesh_contains_points(points: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """Exterior test: points (B, P, 3), triangles (B, T, 3, 3) -> bool (B, P)."""
    counts = raytri_count(points.to(torch.float32), triangle_table(triangles))
    return (counts % 2) == 0


def mesh_contains_points_plain(
    points: torch.Tensor, triangles: torch.Tensor
) -> torch.Tensor:
    """:func:`mesh_contains_points` through the plain counts on any device;
    the test hook that holds the kernel's path against the plain one."""
    counts = raytri_count_plain(points.to(torch.float32), triangle_table(triangles))
    return (counts % 2) == 0
