"""g++ build and ctypes loaders of the host C++ (the JAX package's
``native/build.py``): the image warp ``imageproc.cpp`` and the grasp
simulation's rigid-body stepper ``physics.cpp``.

Each source is compiled at first use into the git-ignored ``native/lib/``,
under a name that carries a hash of the source, the flags and the host CPU
(the build uses ``-march=native``, so a library built on one machine is
not loaded on another), and loaded through ctypes. A failed build of the
warp raises: the training path has no quiet switch to the numpy warp. A
failed build of the stepper returns ``None``, the JAX package's semantics:
``simulation.simulate`` then warns and takes its coarse numpy integrator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_DIR = os.path.join(_DIR, "lib")
_LOCK = threading.Lock()
_PHYSICS_LOCK = threading.Lock()  # its own, so the two builds can overlap
_imageproc = None  # the loaded library, once built
_physics = None  # the loaded stepper; False once its build failed


_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native"]


def _cpu_tag() -> bytes:
    """The host CPU's model and feature flags (Linux), for the cache key."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        return platform.processor().encode()


def _build(src_name: str, lib_base: str) -> str:
    src = os.path.join(_DIR, src_name)
    with open(src, "rb") as f:
        key = f.read() + " ".join(_FLAGS).encode() + _cpu_tag()
    digest = hashlib.sha256(key).hexdigest()[:16]
    os.makedirs(_LIB_DIR, exist_ok=True)
    lib_path = os.path.join(_LIB_DIR, f"{lib_base}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    # a unique temporary name renamed into place: another process may build
    # the same library at the same time, and a half-written .so must never
    # become loadable under the final name
    tmp_path = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *_FLAGS, src, "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp_path, lib_path)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n{detail}") from e
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    return lib_path


def load_imageproc_lib() -> ctypes.CDLL:
    """Build (once per source) and load the image-warp library; raises
    ``RuntimeError`` when g++ fails or is missing."""
    global _imageproc
    with _LOCK:
        if _imageproc is None:
            lib = ctypes.CDLL(_build("imageproc.cpp", "libobman_torch_imageproc"))
            lib.warp_affine_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ]
            lib.warp_affine_f32.restype = None
            _imageproc = lib
    return _imageproc


def load_physics_lib() -> Optional[ctypes.CDLL]:
    """Build (once per source) and load the rigid-body stepper; ``None``
    when g++ fails or is missing (not retried in this process)."""
    global _physics
    with _PHYSICS_LOCK:
        if _physics is None:
            try:
                lib = ctypes.CDLL(_build("physics.cpp", "libobman_torch_physics"))
            except (RuntimeError, OSError):
                _physics = False
                return None
            c_dp = ctypes.POINTER(ctypes.c_double)
            c_ip = ctypes.POINTER(ctypes.c_int32)
            lib.run_grasp_simulation.argtypes = [
                c_dp, ctypes.c_int, c_ip, ctypes.c_int,    # hand verts, faces
                c_dp, ctypes.c_int, c_ip, ctypes.c_int,    # object verts, faces
                ctypes.c_double, ctypes.c_int, ctypes.c_int,  # dt, steps, substeps
                ctypes.c_double,                           # gravity on y
                ctypes.c_double, ctypes.c_double,          # friction (hand, object)
                ctypes.c_double, ctypes.c_double,          # restitution (hand, object)
                ctypes.c_double,                           # contact margin
                c_dp, c_dp,                                # displacement, trajectory
            ]
            lib.run_grasp_simulation.restype = ctypes.c_int
            _physics = lib
    return _physics or None
