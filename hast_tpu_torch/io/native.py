"""ctypes binding of the native host library ``libhastio`` (port of
hast_tpu/io/native.py).

``native/hastio.cpp`` is a repository source that both packages share:
the fastq/fasta readers (decode and 2-bit pack on C++ threads), the
marker-table builders, the barcode sort and the phased.barcodes
decision.  The port compiles it with ``g++`` and ``native/Makefile``'s
flags into ``hast_tpu_torch/build/`` under a name keyed by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  It never writes ``native/libhastio.so``.

:func:`get_lib` returns None when the library cannot be built or loaded;
callers then take their numpy or pure-Python path, which gives the same
bytes, and a one-line notice says so.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Iterator

import numpy as np

from hast_tpu_torch.utils.profiling import count, notice_fallback, span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "hastio.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread"]  # Makefile's

_lib = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhastio-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile libhastio unless a library for this source exists.

    A file lock lets one process build while others (test workers) wait
    for it; the library appears under its final name in one rename.
    """
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
            tmp = f"{out}.{os.getpid()}.tmp"
            try:
                subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", tmp,
                                SOURCE, "-lz"], check=True,
                               capture_output=True)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return out


def get_lib():
    """Load (building if needed) libhastio; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.CalledProcessError) as e:
        notice_fallback("libhastio build/load", e)
        return None
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    anyarr = np.ctypeslib.ndpointer(dtype=None, flags="C_CONTIGUOUS")
    lib.hastio_open_packed.restype = ctypes.c_void_p
    lib.hastio_open_packed.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
    lib.hastio_next_batch.restype = ctypes.c_long
    lib.hastio_next_batch.argtypes = [ctypes.c_void_p, u8, i32, u8, i32,
                                      ctypes.POINTER(ctypes.c_int32)]
    lib.hastio_num_barcodes.restype = ctypes.c_long
    lib.hastio_num_barcodes.argtypes = [ctypes.c_void_p]
    lib.hastio_close.argtypes = [ctypes.c_void_p]
    lib.hastio_max_barcode_len.restype = ctypes.c_long
    lib.hastio_max_barcode_len.argtypes = [ctypes.c_void_p]
    lib.hastio_get_barcodes_fixed.restype = ctypes.c_long
    lib.hastio_get_barcodes_fixed.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int]
    lib.hastio_truncated.restype = ctypes.c_long
    lib.hastio_truncated.argtypes = [ctypes.c_void_p]
    lib.hastio_open_count.restype = ctypes.c_void_p
    lib.hastio_open_count.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
    lib.hastio_next_batch_count.restype = ctypes.c_long
    lib.hastio_next_batch_count.argtypes = [
        ctypes.c_void_p, u8, i32, u8, i32, u8,
        ctypes.POINTER(ctypes.c_int32)]
    lib.hastio_bad_fasta.restype = ctypes.c_long
    lib.hastio_bad_fasta.argtypes = [ctypes.c_void_p]
    lib.hastio_place2.restype = ctypes.c_longlong
    lib.hastio_place2.argtypes = [
        u32, u32, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_ulonglong, i64,
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")]
    lib.hastio_sort_dedup_or.restype = ctypes.c_longlong
    lib.hastio_sort_dedup_or.argtypes = [u32, u32, u32, ctypes.c_longlong]
    lib.hastio_build_quot.restype = ctypes.c_longlong
    lib.hastio_build_quot.argtypes = [
        u32, u32, u32, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_ulonglong, u32]
    lib.hastio_quarter.restype = ctypes.c_int
    lib.hastio_quarter.argtypes = [ctypes.c_char_p] * 6 + [
        ctypes.POINTER(ctypes.c_long)]
    lib.hastio_sort_fixed.restype = ctypes.c_long
    lib.hastio_sort_fixed.argtypes = [anyarr, ctypes.c_long, ctypes.c_int,
                                      i64]
    lib.hastio_decide_format.restype = ctypes.c_long
    lib.hastio_decide_format.argtypes = [
        anyarr, ctypes.c_long, ctypes.c_int, i64, i64, i64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        u8, ctypes.c_long]
    _lib = lib
    return _lib


def argsort_fixed(keys_s: np.ndarray) -> np.ndarray | None:
    """Multithreaded bytewise argsort of an S-dtype array (width<=16);
    same order as np.argsort(kind='stable').  None if unavailable."""
    lib = get_lib()
    w = keys_s.dtype.itemsize
    if lib is None or w > 16:
        return None
    order = np.empty(keys_s.shape[0], np.int64)
    got = lib.hastio_sort_fixed(np.ascontiguousarray(keys_s),
                                keys_s.shape[0], w, order)
    if got != keys_s.shape[0]:
        return None
    return order


def place2(b1: np.ndarray, b2: np.ndarray, n_buckets: int,
           bucket: int, seed: int):
    """Native greedy 2-choice placement + cuckoo walk.

    Returns (row int64, slot int64) on success, the string "failed"
    when some keys could not be placed (caller doubles the table), or
    None when the library is unavailable (caller falls back to numpy).
    """
    lib = get_lib()
    if lib is None:
        return None
    n = b1.shape[0]
    row = np.empty(n, np.int64)
    slot = np.empty(n, np.int8)
    failed = lib.hastio_place2(
        np.ascontiguousarray(b1, np.uint32),
        np.ascontiguousarray(b2, np.uint32),
        n, n_buckets, bucket, seed, row, slot)
    if failed < 0:
        return None
    if failed > 0:
        return "failed"
    return row, slot.astype(np.int64)


def sort_dedup_or(hi: np.ndarray, lo: np.ndarray, pay: np.ndarray):
    """In-place key sort + duplicate-payload OR; returns the distinct
    count m (arrays' first m entries are the result) or None."""
    lib = get_lib()
    if lib is None:
        return None
    m = lib.hastio_sort_dedup_or(hi, lo, pay, hi.shape[0])
    return None if m < 0 else int(m)


def build_quot(hi: np.ndarray, lo: np.ndarray, pay: np.ndarray,
               k: int, bbits: int, seed: int):
    """Fused native quot-table build; returns the filled
    (n_buckets, 4) uint32 data, "failed" when placement needs a bigger
    table, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.zeros(((1 << bbits), 4), np.uint32)
    rc = lib.hastio_build_quot(hi, lo, pay, hi.shape[0], k, bbits,
                               seed, data.reshape(-1))
    if rc == 0:
        return data
    if rc > 0:
        return "failed"
    return None


def decide_format_phased(bcs_s: np.ndarray, order: np.ndarray,
                         c0: np.ndarray, c1: np.ndarray,
                         size0: int, size1: int,
                         w0: float, w1: float) -> bytes | None:
    """Sort-order emit of phased.barcodes with the getHap decision done
    natively (double math identical to pipeline.classify.decide_haps).
    None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = bcs_s.shape[0]
    w = bcs_s.dtype.itemsize
    cap = n * (w + 3 * 21 + 4) + 16
    out = np.empty(cap, np.uint8)
    got = lib.hastio_decide_format(
        np.ascontiguousarray(bcs_s), n, w,
        np.ascontiguousarray(order, np.int64),
        np.ascontiguousarray(c0, np.int64),
        np.ascontiguousarray(c1, np.int64),
        float(size0), float(size1), float(w0), float(w1), out, cap)
    if got < 0:
        return None
    return out[:got].tobytes()


class NativeBatch:
    """View over one packed batch from the native reader."""

    __slots__ = ("seqs", "lengths", "has_n", "barcode_ids", "n")

    def __init__(self, seqs, lengths, has_n, barcode_ids, n):
        self.seqs = seqs
        self.lengths = lengths
        self.has_n = has_n
        self.barcode_ids = barcode_ids
        self.n = n


class ReadTooLong(RuntimeError):
    """A read longer than the reader's len_cap (the batch holding it is
    not yielded)."""


class NativeFastqReader:
    """Iterate batches; barcode strings available after drain.

    With packed=True the seqs rows are 2-bit packed (4 bases/byte,
    identical to ops/encode.pack_codes_np) with stride max_len/4 —
    the pack runs on the C++ prefetch thread, off the GIL.
    """

    def __init__(self, path: str, batch_size: int = 1 << 16,
                 len_cap: int = 1024, fastq: bool = True,
                 packed: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("libhastio unavailable")
        self._lib = lib
        self._h = lib.hastio_open_packed(path.encode(), batch_size,
                                         len_cap, 1 if fastq else 0,
                                         1 if packed else 0)
        if not self._h:
            raise FileNotFoundError(path)
        count("io.reader_opens")
        self._bs = batch_size
        # scratch covers the staging stride (round-128 of len_cap);
        # emitted batch strides are rounded to 16 bases
        self._cap = ((len_cap + 127) // 128) * 128
        self._packed = packed

    def __iter__(self) -> Iterator[NativeBatch]:
        lib, h, bs = self._lib, self._h, self._bs
        # one reusable cap-sized buffer; each batch yields a compact
        # copy of the used (bs, stride) region
        scratch = np.empty(bs * self._cap, np.uint8)
        div = 4 if self._packed else 1
        while True:
            # the wait for the parse thread's next batch, and its copy
            with span("io.read_wait"):
                lengths = np.empty(bs, np.int32)
                has_n = np.empty(bs, np.uint8)
                bids = np.empty(bs, np.int32)
                max_len = ctypes.c_int32()
                n = lib.hastio_next_batch(h, scratch, lengths, has_n, bids,
                                          ctypes.byref(max_len))
                if n <= 0:
                    return
                if lib.hastio_truncated(h):
                    raise ReadTooLong(
                        "reads longer than len_cap encountered; rerun with "
                        "a larger len_cap or engine='python'")
                stride = max_len.value // div
                batch = NativeBatch(
                    scratch[:bs * stride].reshape(bs, stride).copy(),
                    lengths, has_n.astype(bool), bids, int(n))
            count("io.reads", batch.n)
            count("io.batches")
            yield batch

    def barcodes_array(self) -> np.ndarray:
        """Barcodes in id order as a numpy S-array (no python objects)."""
        width = max(1, int(self._lib.hastio_max_barcode_len(self._h)))
        n = int(self._lib.hastio_num_barcodes(self._h))
        buf = np.zeros(n * width, np.uint8)
        got = self._lib.hastio_get_barcodes_fixed(
            self._h, buf.ctypes.data_as(ctypes.c_char_p), buf.size, width)
        if got != n:
            raise RuntimeError(f"libhastio returned {got} of {n} barcodes")
        return buf.view(f"S{width}")

    def close(self):
        if self._h:
            self._lib.hastio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_quarter(fastq_path: str, prefix: str, pat_list: str,
                   mat_list: str, homo_list: str,
                   log_path: str) -> dict[str, int] | None:
    """C++ quartering; returns stats dict or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    stats = (ctypes.c_long * 6)()
    rc = lib.hastio_quarter(fastq_path.encode(), prefix.encode(),
                            pat_list.encode(), mat_list.encode(),
                            homo_list.encode(), log_path.encode(), stats)
    if rc != 0:
        raise RuntimeError(f"hastio_quarter failed with code {rc}")
    return dict(total=stats[0], no_reads=stats[1], pa_reads=stats[2],
                ma_reads=stats[3], ho_reads=stats[4], un_reads=stats[5])


class NativeCountBatch:
    """2-bit packed rows + ACGT-validity bitmask from the count reader."""

    __slots__ = ("packed", "good", "lengths", "n")

    def __init__(self, packed, good, lengths, n):
        self.packed = packed      # (B, stride/4) uint8
        self.good = good          # (B, stride/8) uint8 bitmask
        self.lengths = lengths    # (B,) int32
        self.n = n


class NativeCountReader:
    """Counting-mode reader: decode, 2-bit pack and validity bitmask all
    on the C++ threads.  Mid-iteration it raises :class:`ReadTooLong` on
    a read longer than len_cap (the same file may open again under a
    larger cap) and RuntimeError on multi-line fasta (only the python
    reader takes it); the batch that holds either is not yielded.

    The parse thread zeroes its staging rows at len_cap's stride before
    every batch, whatever the reads' length: a cap just above the reads
    keeps that fill small."""

    def __init__(self, path: str, batch_size: int = 1 << 14,
                 len_cap: int = 8192, fastq: bool = True):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("libhastio unavailable")
        self._lib = lib
        self._h = lib.hastio_open_count(path.encode(), batch_size,
                                        len_cap, 1 if fastq else 0)
        if not self._h:
            raise FileNotFoundError(path)
        count("io.reader_opens")
        self._bs = batch_size
        self._len_cap = len_cap
        self._cap = ((len_cap + 127) // 128) * 128

    def __iter__(self):
        lib, h, bs = self._lib, self._h, self._bs
        scratch = np.empty(bs * (self._cap // 4), np.uint8)
        gscratch = np.empty(bs * (self._cap // 8), np.uint8)
        while True:
            # the wait for the parse thread's next batch, and its copy
            with span("io.read_wait"):
                lengths = np.empty(bs, np.int32)
                has_n = np.empty(bs, np.uint8)
                bids = np.empty(bs, np.int32)
                max_len = ctypes.c_int32()
                n = lib.hastio_next_batch_count(h, scratch, lengths, has_n,
                                                bids, gscratch,
                                                ctypes.byref(max_len))
                if n <= 0:
                    return
                if lib.hastio_bad_fasta(h):
                    raise RuntimeError("multi-line fasta needs the python "
                                       "reader")
                if lib.hastio_truncated(h):
                    raise ReadTooLong(f"reads longer than len_cap "
                                      f"{self._len_cap}")
                sp = max_len.value // 4
                sg = max_len.value // 8
                batch = NativeCountBatch(
                    scratch[:bs * sp].reshape(bs, sp).copy(),
                    gscratch[:bs * sg].reshape(bs, sg).copy(),
                    lengths, int(n))
            count("io.reads", batch.n)
            count("io.batches")
            yield batch

    def close(self):
        if self._h:
            self._lib.hastio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
