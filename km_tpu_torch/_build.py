"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into
``km_tpu_torch/build/`` (git-ignored), and loaded with ``ctypes``. The
sources include no PyTorch header, so a build takes seconds. The library
is rebuilt when a source is newer than it.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libkm_tpu_torch.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build(ptxas_verbose: bool = False) -> tuple[float, str]:
    """Compile every source into LIB_PATH; returns (seconds, compiler
    output). Writes to a temporary name first so a killed build never
    leaves a half-written library behind."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIB_PATH + ".tmp.%d" % os.getpid()
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, *sources()]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelError("nvcc failed (%d):\n%s%s"
                          % (proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, LIB_PATH)
    return dt, proc.stdout + proc.stderr


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def lib():
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        handle = ctypes.CDLL(LIB_PATH)
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        handle.km_pack_windows.argtypes = [vp, vp, i64, i32, i32, vp, vp]
        handle.km_pack_windows.restype = i32
        handle.km_sort_runs.argtypes = [vp, i64, i32, vp, vp, vp]
        handle.km_sort_runs.restype = i32
        handle.km_sort_chunks.argtypes = [vp, i64, i32, vp, vp]
        handle.km_sort_chunks.restype = i32
        _lib = handle
    return _lib


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelError("%s launch failed: CUDA error %d" % (what, code))
