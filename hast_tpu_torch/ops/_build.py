"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

All sources under ``csrc/`` compile in one ``nvcc`` call for ``sm_90a``
into one shared library with a plain C interface (no PyTorch headers,
so the build takes seconds).  The library lands in
``hast_tpu_torch/build/`` under a name derived from a hash of the
sources and flags, so an edited kernel is rebuilt and an unchanged one
is loaded as it is.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.  The
launch counters count kernel launches made by the wrappers, the twin
counters calls of the plain PyTorch twins; ``chip_smoke.py`` reads both
to show which of the two ran the main path.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES: collections.Counter = collections.Counter()
TWIN_CALLS: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_SIGNATURES = {
    "hast_canonical_windows": [_P, _P, _I64, _I, _I, _P, _P, _P],
    "hast_probe": [_P, _I64, _I, _I, _I, _I, _P, _I64, _P, _P],
    "hast_classify_tally": [_P, _I64, _I, _I, _I, _I, _P, _P, _P, _P, _I64,
                            _I, _P, _I64, _P],
}

_lib = None


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or PATH)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libhast_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(s for s in _sources() if s.endswith(".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a refused launch (the C entry's cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError "
                           f"{rc}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A wrapper's guard: its kernel takes contiguous tensors on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """The current stream of t's device, for a C entry's stream argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
