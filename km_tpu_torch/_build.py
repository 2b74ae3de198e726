"""Build and load the port's CUDA kernels and its native host library.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together) and linked into one shared library
with a plain C interface, at first use, into ``km_tpu_torch/build/``
(git-ignored), and loaded with ``ctypes``. The sources include no
PyTorch header, so a build takes seconds. The library is rebuilt when a
source is newer than it.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

``native/kmio.cpp`` (host parsing, merging, Dijkstra) is built by the
host C++ compiler into the same directory (:func:`build_native`); the
``native`` package loads it.
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
NATIVE_SRC = os.path.join(_DIR, "native", "kmio.cpp")
NATIVE_LIB_PATH = os.path.join(BUILD_DIR, "libkmio.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


class NativeLibraryError(RuntimeError):
    """The native host library could not be built."""


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
    """Compile every source (in parallel) and link LIB_PATH; returns
    (seconds, compiler output). Links to a temporary name first so a
    killed build never leaves a half-written library behind."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = ".tmp.%d" % os.getpid()
    tmp = LIB_PATH + tag
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + tag + ".o")
            for s in sources()]
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if ptxas_verbose:
        flags += ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    out = ""
    try:
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources(), objs)]
        done = [(p.communicate()[0], p.returncode) for p in procs]
        out = "".join(text for text, _ in done)
        if any(rc != 0 for _, rc in done):
            raise KernelError("nvcc failed:\n%s" % out)
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        out += link.stdout + link.stderr
        if link.returncode != 0:
            raise KernelError("nvcc link failed (%d):\n%s"
                              % (link.returncode, out))
        os.replace(tmp, LIB_PATH)
    finally:
        for path in objs:
            if os.path.exists(path):
                os.remove(path)
    return time.perf_counter() - t0, out


def build_native() -> float:
    """Compile native/kmio.cpp with the host C++ compiler ($CXX, g++ or
    c++) into NATIVE_LIB_PATH; returns the seconds it took. Raises
    NativeLibraryError, with the compiler's output, when it cannot."""
    cxx = (os.environ.get("CXX") or shutil.which("g++")
           or shutil.which("c++"))
    if not cxx:
        raise NativeLibraryError("no C++ compiler found (CXX, g++, c++): "
                               "%s cannot be built" % NATIVE_SRC)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = NATIVE_LIB_PATH + ".tmp.%d" % os.getpid()
    cmd = [cxx, "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
           "-pthread", "-shared", "-o", tmp, NATIVE_SRC]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise NativeLibraryError("%s: %s" % (" ".join(cmd), exc)) from exc
    if proc.returncode != 0:
        raise NativeLibraryError("%s failed (%d):\n%s%s" % (
            " ".join(cmd), proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, NATIVE_LIB_PATH)
    return time.perf_counter() - t0


def native_stale() -> bool:
    if not os.path.exists(NATIVE_LIB_PATH):
        return True
    return os.path.getmtime(NATIVE_SRC) > os.path.getmtime(NATIVE_LIB_PATH)


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
        handle.km_chunk_runs_scratch.argtypes = [i64, i32]
        handle.km_chunk_runs_scratch.restype = i64
        handle.km_chunk_runs.argtypes = [vp, vp, i64, i32, vp, vp, vp, i64,
                                         vp, vp, vp]
        handle.km_chunk_runs.restype = i32
        handle.km_merge_accum_scratch.argtypes = [i64, i64]
        handle.km_merge_accum_scratch.restype = i64
        handle.km_merge_accum.argtypes = [vp, vp, vp, i64, vp, vp, vp, i64,
                                          vp, vp, vp, vp, i64, vp]
        handle.km_merge_accum.restype = i32
        handle.km_cut_scratch.argtypes = [i64]
        handle.km_cut_scratch.restype = i64
        handle.km_cut.argtypes = [vp, vp, vp, i64, i64, vp, vp, vp, vp, i64,
                                  vp]
        handle.km_cut.restype = i32
        handle.km_parse_fastq_scratch.argtypes = [i64]
        handle.km_parse_fastq_scratch.restype = i64
        handle.km_parse_fastq_device.argtypes = [vp, i64, i32, i64, vp, vp, vp,
                                                 vp, i64, vp]
        handle.km_parse_fastq_device.restype = i32
        _lib = handle
    return _lib


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelError("%s launch failed: CUDA error %d" % (what, code))
