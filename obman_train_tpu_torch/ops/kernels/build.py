"""Build a CUDA source of this directory into a shared library and load it.

Each ``.cu`` file exports plain ``extern "C"`` launchers; it is compiled by
``nvcc`` for ``sm_90a`` (Hopper) into ``build/lib<name>-<hash>.so`` beside
the sources at first use, then loaded with :mod:`ctypes`. The hash covers
the source and the flags, so an edited source is rebuilt. A failed build
raises with nvcc's output; there is no fallback.

Nothing happens at import time: the CPU-only test environment has no
``nvcc``, and it never calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "build")

# -fmad=false: no a*b+c contraction into FMA, so kernels stay bit-identical
# to their plain PyTorch versions (each PyTorch op rounds on its own).
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "--ptxas-options=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_loaded: dict = {}
BUILD_LOGS: dict = {}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
            "and on PATH): the port's CUDA kernels cannot be built"
        )
    return nvcc


def build(name: str) -> str:
    """Compile ``<name>.cu`` (if not built yet) and return the library path."""
    src = os.path.join(KERNEL_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name, then rename: a concurrent build never sees
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
