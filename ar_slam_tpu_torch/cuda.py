"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``: one
``nvcc`` per source, all run in parallel, then one link build them into
``build/kernels/`` at the root of the checkout, at first use, in seconds
(a PyTorch C++ extension would take minutes to compile against PyTorch's
headers).  The library's file name
carries a hash of the sources, so an edited kernel is rebuilt and a stale
library is never loaded.

Every pointer and the stream cross as ``c_void_p``; every entry point
launches on the caller's stream, allocates nothing, and returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

import ar_slam_tpu_torch.device  # noqa: F401  (switches TF32 off)

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("box.cu", "ccl.cu", "ccl_strip.cu", "extract.cu", "localize.cu",
           "rank.cu")
HEADERS = ("ccl_lines.cuh",)  # included by the sources; part of the hash
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "kernels")
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "arslam_box_sum": [_P, _P, _I, _I, _I, _I, _P],
    "arslam_box_max_radius": [],
    "arslam_threshold": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _P],
    "arslam_threshold_max_windows": [],
    "arslam_ccl": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "arslam_ccl_resident_planes": [_I, _I, _I],
    "arslam_ccl_strip": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "arslam_extract": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "arslam_localize_lm": [_P] * 10 + [_I] * 4 + [_D, _I] + [_D] * 6 + [_P],
    "arslam_run_scores": [_P] * 5 + [_I] * 4 + [_D, _P],
}

_LIB = None
# the pipelined serve loop detects on a worker thread: one build and load
_LIB_LOCK = threading.Lock()
build_seconds = 0.0  # wall time of the nvcc call this process made (0 = cached)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libarslam_kernels_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this source state is already built: one
    ``nvcc`` per source, all started together, then one link."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in SOURCES:
        obj = f"{tmp}.{os.path.splitext(src)[0]}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-c",
             "-Xcompiler", "-fPIC", "-o", obj, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for src, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src} ({proc.returncode}):\n{err}")
    if not errors:
        res = subprocess.run([nvcc, "-gencode", ARCH, "-shared", "-o", tmp,
                              *objs], capture_output=True, text=True)
        if res.returncode != 0:
            errors.append(f"link ({res.returncode}):\n{res.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Wrapper-side argument checks for a kernel launch."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
