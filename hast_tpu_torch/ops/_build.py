"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each ``.cu`` under ``csrc/`` compiles for ``sm_90a`` in its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects
into a shared library with a plain C interface (no PyTorch headers, so
the build takes seconds).  The library lands in ``hast_tpu_torch/build/``
under a name derived from a hash of the sources and flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``.  A wrapper calls its entry through
:func:`launch`, which makes the tensors' card the current device when
another one is (the ctypes entries have no device guard of their own),
hands the entry that card's current stream, raises when the entry
returns an error and counts the launch.  The launch counters
``LAUNCHES`` count the wrappers' calls of their C entries, one each (an
entry may launch several kernels: K5 launches a histogram, a plan and
one sweep a radix pass), the twin counters calls of the plain
PyTorch twins; ``chip_smoke.py`` reads both to show which of the two ran
the main path.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

LAUNCHES: collections.Counter = collections.Counter()
TWIN_CALLS: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_I = ctypes.c_int
_SIGNATURES = {
    "hast_canonical_windows": [_P, _P, _I64, _I, _I, _P, _P, _P],
    "hast_count_windows": [_P, _P, _P, _I, _I64, _I, _I, _I, _U64, _U64, _P,
                           _P],
    "hast_sort_geometry": [_P],
    "hast_sort_scratch_bytes": [_I64, _I, _I64],
    "hast_sort_pairs": [_P, _P, _P, _P, _P, _P, _I64, _I, _I64, _P, _P],
    "hast_fold_runs": [_P, _P, _I64, _P, _P, _P, _P, _P],
    "hast_count_stats": [_P, _I64, _I, _P, _P],
    "hast_marker_filter": [_P, _P, _I64, _I64, _P, _P, _I64, _I64, _I64,
                           _I64, _I64, _I64, _P, _P, _P, _P, _P],
    "hast_probe": [_P, _I64, _I, _I, _I, _I, _P, _I64, _P, _P],
    "hast_segment_votes": [_P, _I64, _I, _I, _I, _I, _P, _P, _P, _I64, _I64,
                           _P, _P],
    "hast_classify_tally": [_P, _I64, _I, _I, _I, _I, _P, _P, _P, _P, _I64,
                            _I, _P, _I64, _P],
    "hast_grow_tally": [_P, _I64, _P, _I64, _P],
    "hast_pack_tally": [_P, _I64, _P, _P, _P, _P],
    "hast_shrink_run": [_P, _P, _I64, _P, _P, _P],
    "hast_vote_reads": [_P, _I64, _I, _I, _I, _I, _I64, _I64, _P, _P, _I64,
                        _I, _I, _P, _P],
    "hast_tally_votes": [_P, _P, _P, _I64, _P, _I64, _P],
    "hast_route_kmers": [_P, _P, _I64, _I, _I, _I, _I, _I64, _P, _P, _P],
    "hast_broadcast_probe": [_P, _P, _I64, _P, _P, _I64, _I, _P, _P],
    "hast_read_tile_geometry": [_P],
    "hast_count_stats_shared_high": [],
}

_lib = None
_LOCK = threading.Lock()   # stage 00 counts two parents on two threads


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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands together; wait for all, then raise on a failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> str:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = {src: f"{tmp}.{os.path.basename(src)}.o"
            for src in _sources() if src.endswith(".cu")}
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                  for src, obj in objs.items()])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                   *objs.values()]])
        os.replace(tmp, out)
    finally:
        for obj in objs.values():
            if os.path.exists(obj):
                os.remove(obj)
    return out


_RESTYPES = {"hast_sort_scratch_bytes": _I64}   # the others return an int


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use (once, across threads).

    Each entry is bound once, when the library loads: the CDLL keeps the
    bound function as an attribute, so a wrapper's call costs a global
    read and an attribute read, and takes the lock only before the load.
    """
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = lib
    return _lib


def read_tile_geometry() -> tuple[int, int, int, int]:
    """K3's and K13's read tiles as the library has them (csrc/reads.cuh):
    windows a tile, rows a tile, the most windows a long-form warp votes
    alone, and reads a long-form block takes."""
    out = (ctypes.c_int * 4)()
    load_library().hast_read_tile_geometry(out)
    return tuple(out)


def sort_geometry() -> tuple[int, int]:
    """K5's tile (the keys a pass block ranks together) and digit bits as
    the library has them (csrc/sort.cu kTile, kBits)."""
    out = (ctypes.c_int * 2)()
    load_library().hast_sort_geometry(out)
    return tuple(out)


def count_stats_shared_high() -> int:
    """The most high whose bins K7 keeps in shared memory, as the library
    has it (csrc/stats.cu kSharedHigh); past it, global atomics."""
    return load_library().hast_count_stats_shared_high()


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


def raw_stream(index: int) -> int:
    """The current stream of card `index` as the int a C entry takes
    (read without building a torch.cuda.Stream)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, dev: torch.device, *args) -> None:
    """Call C entry ``hast_<name>`` for a wrapper whose tensors are
    checked and lie on card dev: args, then dev's current stream, with no
    device switch when dev is the current card; raises on a refused
    launch and counts the launch."""
    fn = getattr(_lib or load_library(), "hast_" + name)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, raw_stream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, raw_stream(dev.index))
    if rc:
        check(rc, name)
    LAUNCHES[name] += 1
