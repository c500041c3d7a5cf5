"""Sort-based canonical k-mer counting, stage 00 (port of
hast_tpu/ops/kmer_count.py).

Host side, copied without jax: the ACGT mask packing and clean-batch
test, the run-length encoder, the host :class:`CountTable` and
:class:`Counter` and the jellyfish-style string dump.  Host tables
keep the JAX layout: uint64 words ``(hi << 32) | lo``, int64 counts.

Device side: a key is one int64 word per canonical k-mer, the same word
(below 2^62, as k <= 31); invalid or out-of-range windows are the
sentinel ``INT64_MAX``, which sorts after every real key (the JAX pair
(0xFFFFFFFF, 0xFFFFFFFF) read as int64 would be -1 and sort first).
Counts are int32, as in the JAX package.  Six kernels in ``csrc/``:

  K4 count_windows   count.cu    packed reads -> window keys
  K5 sort_pairs      sort.cu     stable radix sort, int32 payload
  K6 fold_runs       fold.cu     counts of equal keys summed to the front
  K12 shrink_run     shrink.cu   a fold's distinct rows, copied out
  K7 count_stats     stats.cu    histogram bins and total, int64
  K8 marker_filter   markers.cu  unique, in-bounds keys, compacted

Each wrapper runs its plain PyTorch twin (``*_ref``) for CPU tensors and
launches its kernel for CUDA tensors; the twins carry everything in int64
because torch on the CPU has no uint32/uint64 shifts or compares.
:class:`DeviceCounter` folds chunks of keys into one resident sorted run
(K5 + K6 + K12), :class:`DeviceCountTable` is that run, and
:func:`device_marker_algebra` is the marker algebra over two of them
(K8); only the final markers come to the host.
:class:`_FileRead` reads a file as K4 takes it, a reader batch a step,
through the native reader or else the python one, and
:func:`read_in_turn` steps several files' readers in turn on one
thread; :func:`count_file` counts a file so read, and
:class:`PackedSpill` keeps a parent's files so read in host files, a
part a file, from which its boundary sample and every key-range pass
read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import sys
import threading
from typing import Callable, Iterable

import numpy as np
import torch

from hast_tpu_torch.io import fastq as FQ
from hast_tpu_torch.io import native as N
from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.utils.profiling import count, span

SENT = torch.iinfo(torch.int64).max
FOLD_ABOVE = 48_000_000   # DeviceCounter's smallest fold, in keys
_KEY_LIMIT = 1 << 62      # every canonical key (k <= 31) is below it
_REF_SENT = np.uint32(0xFFFFFFFF)

_ACGT = np.zeros(256, bool)
for _c in b"ACGTacgt":
    _ACGT[_c] = True
_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


# ---------------------------------------------------------------------------
# host side (numpy)
# ---------------------------------------------------------------------------


def batch_is_clean(good: np.ndarray, lengths: np.ndarray) -> bool:
    """True iff every in-length base is ACGT.

    Exact via popcount: the native reader sets mask bits only for
    positions < length, so the batch is clean iff the number of set bits
    equals the number of bases."""
    set_bits = int(_POPCNT8[good].sum(dtype=np.int64))
    return set_bits == int(np.minimum(
        lengths.astype(np.int64), good.shape[1] * 8).sum())


def pack_good_np(seqs_u8: np.ndarray) -> np.ndarray:
    """(..., L) ASCII -> (..., L/8) uint8 ACGT-validity bitmask."""
    good = _ACGT[seqs_u8].astype(np.uint8)
    out = good[..., 0::8]
    for j in range(1, 8):
        out = out | (good[..., j::8] << np.uint8(j))
    return out


def _rle_sorted(words: np.ndarray, weights: np.ndarray | None = None):
    """Run-length encode a sorted uint64 array -> (unique, counts)."""
    if words.size == 0:
        return words, np.zeros(0, np.int64)
    new = np.empty(words.size, bool)
    new[0] = True
    np.not_equal(words[1:], words[:-1], out=new[1:])
    idx = np.flatnonzero(new)
    if weights is None:
        counts = np.diff(np.append(idx, words.size)).astype(np.int64)
    else:
        csum = np.concatenate([[0], np.cumsum(weights, dtype=np.int64)])
        counts = csum[np.append(idx[1:], words.size)] - csum[idx]
    return words[idx], counts


@dataclasses.dataclass
class CountTable:
    """Sorted (canonical k-mer -> count) table, host resident.

    words: uint64 = (hi << 32) | lo, strictly ascending; counts: int64.
    """

    words: np.ndarray
    counts: np.ndarray
    k: int

    @classmethod
    def from_reference(cls, ref) -> "CountTable":
        """A hast_tpu.ops.kmer_count.CountTable, copied."""
        return cls(np.array(ref.words, np.uint64),
                   np.array(ref.counts, np.int64), int(ref.k))

    def to_reference(self) -> tuple:
        """(words, counts, k): the fields of hast_tpu's CountTable."""
        return self.words.copy(), self.counts.copy(), self.k

    @property
    def n_distinct(self) -> int:
        return int(self.words.size)

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def histo(self, low: int = 1, high: int = 10000) -> np.ndarray:
        """jellyfish-histo bins: index v holds #kmers with count v for
        v in [low, high]; index high+1 lumps every count > high."""
        clipped = np.clip(self.counts, 0, high + 1)
        return np.bincount(clipped, minlength=high + 2)

    def filter_range(self, lower: int, upper: int) -> "CountTable":
        """Keep counts in [lower, upper] inclusive (jellyfish dump -L -U)."""
        m = (self.counts >= lower) & (self.counts <= upper)
        return CountTable(self.words[m], self.counts[m], self.k)

    def difference(self, other: "CountTable") -> "CountTable":
        """Keys of self not present in other (meryl difference)."""
        m = ~np.isin(self.words, other.words, assume_unique=True)
        return CountTable(self.words[m], self.counts[m], self.k)

    def dump_mer_text(self, path: str) -> int:
        """Write one-kmer-per-line text (the .mer interface file)."""
        return dump_words(self.words, self.k, path)

    def save(self, path: str) -> None:
        """Binary snapshot, the format of hast_tpu's .counts.npz."""
        np.savez(path, words=self.words, counts=self.counts,
                 k=np.int64(self.k))

    @classmethod
    def load(cls, path: str) -> "CountTable":
        with np.load(path, allow_pickle=False) as z:
            return cls(z["words"], z["counts"], int(z["k"]))


def words_to_strings(words: np.ndarray, k: int) -> np.ndarray:
    """uint64 canonical words -> jellyfish-representative byte strings."""
    n = words.size
    arr = np.empty((n, k), np.uint8)
    int2base = np.frombuffer(b"ACTG", np.uint8)  # HAST encoding order
    for i in range(k):
        arr[:, k - 1 - i] = int2base[
            (words >> np.uint64(2 * i)).astype(np.uint32) & 3]
    # jellyfish emits min(s, revcomp(s)) under ASCII (A<C<G<T) order
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rc = comp[arr[:, ::-1]]
    fwd_b = np.ascontiguousarray(arr).view(f"S{k}").reshape(n)
    rc_b = np.ascontiguousarray(rc).view(f"S{k}").reshape(n)
    return np.where(fwd_b <= rc_b, fwd_b, rc_b)


def dump_words(words: np.ndarray, k: int, path: str) -> int:
    """One jellyfish-style k-mer a line, in the order of words."""
    with span("markers.dump_words"):
        s = words_to_strings(words, k)
        with open(path, "wb") as f:
            if s.size:
                f.write(b"\n".join(s.tolist()) + b"\n")
    return int(s.size)


class Counter:
    """Host union-sum of sorted chunks and finalized tables.

    Each chunk becomes a run of distinct words and counts; the runs merge
    in finalize(), and once they hold more than compact_above words (host
    memory), as the JAX Counter does."""

    def __init__(self, k: int, compact_above: int = 200_000_000):
        self.k = k
        self._runs: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending = 0
        self._compact_above = compact_above

    def add_sorted_chunk(self, keys: np.ndarray) -> None:
        """A sorted chunk of int64 keys, INT64_MAX pads at its end (what
        parallel.mesh.sharded_count_chunk gives a shard), count 1 each."""
        keys = np.asarray(keys, np.int64)
        n_valid = int(np.searchsorted(keys, SENT))
        u, c = _rle_sorted(keys[:n_valid].astype(np.uint64))
        if u.size:
            self._runs.append((u, c))
            self._pending += u.size
            if self._pending > self._compact_above:
                self.finalize()
                self._pending = self._runs[0][0].size if self._runs else 0

    def add_table(self, table: CountTable) -> None:
        if table.words.size:
            self._runs.append((table.words, table.counts))

    def finalize(self) -> CountTable:
        if not self._runs:
            return CountTable(np.zeros(0, np.uint64), np.zeros(0, np.int64),
                              self.k)
        words = np.concatenate([u for u, _ in self._runs])
        counts = np.concatenate([c for _, c in self._runs])
        order = np.argsort(words, kind="stable")
        u, c = _rle_sorted(words[order], counts[order])
        self._runs = [(u, c)]
        return CountTable(u, c, self.k)


# ---------------------------------------------------------------------------
# K4: window keys of packed reads
# ---------------------------------------------------------------------------


def _check_range(key_range) -> tuple[int, int]:
    lo, hi = (int(b) for b in key_range)
    if not (0 <= lo < 1 << 64 and 0 <= hi < 1 << 64):
        raise ValueError(f"key_range bounds must be uint64, got {key_range}")
    return lo, hi


def count_windows_ref(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                      good: torch.Tensor | None = None,
                      key_range=None) -> torch.Tensor:
    """Plain PyTorch twin of :func:`count_windows`."""
    _build.TWIN_CALLS["count_windows_ref"] += 1
    keys, valid = E.canonical_windows_ref(packed, lengths, k)
    n_win = keys.shape[1]
    if good is not None and n_win:
        shifts = torch.arange(8, device=good.device)
        bits = ((good.to(torch.int64)[..., None] >> shifts) & 1).reshape(
            good.shape[0], -1).to(torch.bool)
        for j in range(k):
            valid &= bits[:, j:j + n_win]
    if key_range is not None:
        # every real key is below 2^62, so clamping the uint64 bounds
        # there keeps the int64 compare exact (2^64 - 1 read as int64
        # would be -1 and drop every key)
        lo, hi = (min(b, _KEY_LIMIT) for b in _check_range(key_range))
        valid &= (keys >= lo) & (keys < hi)
    return torch.where(valid, keys, SENT).reshape(-1)


def count_windows(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                  good: torch.Tensor | None = None,
                  key_range=None) -> torch.Tensor:
    """Canonical window keys of packed reads, invalid ones the sentinel (K4).

    packed: (N, Lp) uint8, 4 bases a byte; lengths: (N,) int32; good:
    None (every in-length base is ACGT) or (N, Lp/2) uint8, bit j of
    byte m for base 8m+j; key_range: None or uint64 bounds [lo, hi).
    Returns (N * (4*Lp - k + 1),) int64, read-major: a window is its key
    iff it lies in the read, its bases are all good and its key is in
    range, else INT64_MAX.
    """
    E._check_k(k)
    E.check_packed(packed, lengths)
    n, lp = packed.shape
    if good is not None and (good.dtype != torch.uint8
                             or good.shape != (n, lp // 2) or lp % 2):
        raise ValueError(f"good must be ({n}, {lp // 2}) uint8 for an even "
                         f"packed stride, got {tuple(good.shape)} "
                         f"{good.dtype} for stride {lp}")
    lo, hi = _check_range(key_range) if key_range is not None else (0, 0)
    if packed.device.type == "cpu":
        return count_windows_ref(packed, lengths, k, good, key_range)
    _build.require_cuda("count_windows", packed, lengths,
                        *(() if good is None else (good,)))
    n_win = max(4 * lp - k + 1, 0)
    keys = torch.empty(n * n_win, dtype=torch.int64, device=packed.device)
    if keys.numel() == 0:
        return keys
    _build.launch("count_windows", packed.device, packed.data_ptr(),
                  lengths.data_ptr(),
                  None if good is None else good.data_ptr(),
                  0 if good is None else good.shape[1], n, lp, k,
                  int(key_range is not None), lo, hi, keys.data_ptr())
    return keys


# ---------------------------------------------------------------------------
# K5: stable sort of keys with an int32 payload
# ---------------------------------------------------------------------------

SORT_TILE = 4096      # sort.cu kTile: the keys a block ranks together
SORT_DIGIT_BITS = 8   # sort.cu kBits: the widest digit of a radix pass
# sort.cu sweeps the input in portions of this many keys (a multiple of
# SORT_TILE, at most 2^27), each with its own look-back
_SORT_PORTION = 1 << 27


def sort_passes(k: int) -> int:
    """K5's radix passes at k: the low 2k + 1 bits, at most
    SORT_DIGIT_BITS a pass (4 at k = 15, 6 at k = 21, 8 at k = 31)."""
    return -(-(2 * k + 1) // SORT_DIGIT_BITS)


def _check_keys(name: str, keys: torch.Tensor, *int32s) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"{name}: keys must be 1-D int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    for t in int32s:
        if t is not None and (t.dtype != torch.int32
                              or t.shape != keys.shape):
            raise ValueError(f"{name}: counts must be {tuple(keys.shape)} "
                             f"int32, got {tuple(t.shape)} {t.dtype}")


def sort_pairs_ref(keys: torch.Tensor, payload: torch.Tensor | None,
                   k: int, scratch=None):
    """Plain PyTorch twin of :func:`sort_pairs` (new tensors always)."""
    _build.TWIN_CALLS["sort_pairs_ref"] += 1
    out, order = torch.sort(keys, stable=True)
    return out, None if payload is None else payload[order]


def sort_pairs(keys: torch.Tensor, payload: torch.Tensor | None, k: int,
               scratch=None):
    """Stable ascending sort of int64 keys carrying an int32 payload (K5).

    Every key must be a canonical k-mer word (below 2^(2k)) or INT64_MAX:
    the kernel sorts the low 2k+1 bits only, which orders such keys as a
    full sort does.  payload may be None.  Returns (keys, payload) sorted;
    equal keys keep their input order.

    scratch: None, or a (keys, payload) pair of buffers shaped like the
    input.  Without it the sort allocates two buffer pairs and leaves the
    input as it was.  With it the passes alternate between scratch and
    the input itself, which is overwritten: the result is returned as
    one of the two pairs (``result[0] is keys`` after an even number of
    passes, :func:`sort_passes`) and the other is free.  The twin
    ignores it.
    """
    E._check_k(k)
    _check_keys("sort_pairs", keys, payload)
    if scratch is not None:
        _check_keys("sort_pairs", scratch[0], scratch[1])
        if scratch[0].shape != keys.shape or (payload is None) != (
                scratch[1] is None):
            raise ValueError("sort_pairs: scratch must be shaped like the "
                             "keys and the payload")
    if keys.device.type == "cpu":
        return sort_pairs_ref(keys, payload, k)
    tensors = (keys,) if payload is None else (keys, payload)
    _build.require_cuda("sort_pairs", *tensors,
                        *(t for t in scratch or () if t is not None))
    n = keys.numel()
    if n >= 1 << 31:
        raise ValueError(f"sort_pairs: {n} keys, at most 2^31 - 1")
    if n == 0:
        return keys.clone(), None if payload is None else payload.clone()
    dev = keys.device
    if scratch is None:
        ka, kb = torch.empty_like(keys), torch.empty_like(keys)
        pa, pb = ((None, None) if payload is None else
                  (torch.empty_like(payload), torch.empty_like(payload)))
    else:
        (ka, pa), (kb, pb) = scratch, (keys, payload)
    lib = _build.load_library()
    # the look-back's status words, the digit bins, the tile counters and
    # the plan of the passes
    scratch_bytes = lib.hast_sort_scratch_bytes(n, 2 * k + 1, _SORT_PORTION)
    if scratch_bytes < 0:
        raise ValueError(f"sort_pairs: refused n = {n}, portion "
                         f"{_SORT_PORTION}")
    work = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch("sort_pairs", keys.device, keys.data_ptr(), ptr(payload),
                  ka.data_ptr(), ptr(pa), kb.data_ptr(), ptr(pb), n, 2 * k + 1,
                  _SORT_PORTION, work.data_ptr())
    if sort_passes(k) % 2:
        return ka, pa
    return kb, pb


# ---------------------------------------------------------------------------
# K6: fold a sorted run
# ---------------------------------------------------------------------------


# fold.cu kTile: the elements a block folds together
FOLD_TILE = 2048
# The look-back scratch of fold.cu and markers.cu, int64 words: word 0
# holds the tile counter and a second count (fold.cu's group total,
# markers.cu's edge counter), then a status word a tile (markers.cu: then
# a split a tile edge), zero before a call (fold.cu's total aside) and
# left so by it.  Each kernel keeps one a card and
# stream, grown when a call needs more words, so that a call launches no
# memset; calls on one stream run in order, so they never share it at
# once.
_STATUS_SCRATCH: dict[tuple[str, int, int], torch.Tensor] = {}
_STATUS_SCRATCH_LOCK = threading.Lock()


def _status_scratch(kernel: str, words: int,
                    device: torch.device) -> torch.Tensor:
    key = (kernel, device.index, _build.raw_stream(device.index))
    with _STATUS_SCRATCH_LOCK:
        buf = _STATUS_SCRATCH.get(key)
        if buf is None or buf.numel() < words:
            buf = torch.zeros(words, dtype=torch.int64, device=device)
            _STATUS_SCRATCH[key] = buf
    return buf


def fold_runs_ref(keys: torch.Tensor, counts: torch.Tensor, out=None):
    """Plain PyTorch twin of :func:`fold_runs` (new tensors always)."""
    _build.TWIN_CALLS["fold_runs_ref"] += 1
    n = keys.numel()
    out_keys = torch.full_like(keys, SENT)
    if n == 0:
        return out_keys, torch.zeros_like(counts), \
            torch.zeros((), dtype=torch.int64, device=keys.device)
    start = torch.ones(n, dtype=torch.bool, device=keys.device)
    start[1:] = keys[1:] != keys[:-1]
    group = torch.cumsum(start, 0) - 1
    is_sent = keys == SENT
    out_keys[group[start]] = keys[start]
    sums = torch.zeros(n, dtype=torch.int64, device=keys.device).index_add_(
        0, group, torch.where(is_sent, 0, counts).to(torch.int64))
    # the kernel's uint32 sums wrap as this cast does
    return out_keys, sums.to(torch.int32), (start & ~is_sent).sum()


def fold_runs(keys: torch.Tensor, counts: torch.Tensor, out=None):
    """Sum the counts of equal keys of a sorted run into the front (K6).

    keys: (n,) int64 ascending (real keys, then INT64_MAX pads), n <
    2^31; counts: (n,) int32.  Returns (out_keys, out_counts, n_unique): slot g < groups
    holds the g-th distinct key and its count sum, the pads' group keeps
    INT64_MAX with count 0, other slots are (INT64_MAX, 0); n_unique is a
    0-d int64 tensor on the keys' device counting the real groups.
    out: None, or an (out_keys, out_counts) pair of buffers shaped like
    the input and apart from it, which the kernel fills and returns; the
    twin ignores it.
    """
    _check_keys("fold_runs", keys, counts)
    if out is not None:
        _check_keys("fold_runs", out[0], out[1])
        if out[0].shape != keys.shape:
            raise ValueError("fold_runs: out must be shaped like the keys")
    if keys.device.type == "cpu":
        return fold_runs_ref(keys, counts)
    _build.require_cuda("fold_runs", keys, counts, *(out or ()))
    if out is None:
        out_keys, out_counts = torch.empty_like(keys), torch.empty_like(counts)
    else:
        out_keys, out_counts = out
        if keys.numel() and out_keys.data_ptr() == keys.data_ptr():
            raise ValueError("fold_runs: out must not be the input")
    n = keys.numel()
    if n == 0:
        return out_keys, out_counts, torch.zeros((), dtype=torch.int64,
                                                 device=keys.device)
    if n >= 1 << 31:
        raise ValueError(f"fold_runs: {n} keys, at most 2^31 - 1")
    n_unique = torch.empty((), dtype=torch.int64, device=keys.device)
    scratch = _status_scratch("fold_runs", -(-n // FOLD_TILE) + 1,
                              keys.device)
    _build.launch("fold_runs", keys.device, keys.data_ptr(), counts.data_ptr(),
                  n, out_keys.data_ptr(), out_counts.data_ptr(),
                  n_unique.data_ptr(), scratch.data_ptr())
    return out_keys, out_counts, n_unique


# ---------------------------------------------------------------------------
# K12: the folded run cut to its distinct rows
# ---------------------------------------------------------------------------


def shrink_run_ref(keys: torch.Tensor, counts: torch.Tensor, n: int):
    """Plain PyTorch twin of :func:`shrink_run`."""
    _build.TWIN_CALLS["shrink_run_ref"] += 1
    return keys[:n].clone(), counts[:n].clone()


def shrink_run(keys: torch.Tensor, counts: torch.Tensor, n: int):
    """The first n rows of a fold's (keys int64, counts int32), copied into
    tensors of their own (K12), so that the fold buffer can be freed.
    CPU tensors take the twin; CUDA tensors launch the kernel."""
    _check_keys("shrink_run", keys, counts)
    if not 0 <= n <= keys.numel():
        raise ValueError(f"shrink_run: n = {n} outside [0, {keys.numel()}]")
    if keys.device.type == "cpu":
        return shrink_run_ref(keys, counts, n)
    _build.require_cuda("shrink_run", keys, counts)
    out_keys = torch.empty(n, dtype=torch.int64, device=keys.device)
    out_counts = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n:
        _build.launch("shrink_run", keys.device, keys.data_ptr(),
                      counts.data_ptr(), n, out_keys.data_ptr(),
                      out_counts.data_ptr())
    return out_keys, out_counts


# ---------------------------------------------------------------------------
# K7: histogram and total
# ---------------------------------------------------------------------------


def count_stats_ref(counts: torch.Tensor, high: int):
    """Plain PyTorch twin of :func:`count_stats`."""
    _build.TWIN_CALLS["count_stats_ref"] += 1
    bins = torch.bincount(counts.clamp(0, high + 1).to(torch.int64),
                          minlength=high + 2)
    bins[0] = 0
    return bins, counts.sum(dtype=torch.int64)


def count_stats(counts: torch.Tensor, high: int):
    """Histogram bins and total of a count table (K7).

    Returns bins, (high+2,) int64 with bins[v] = #counts equal to v for
    1 <= v <= high, bins[high+1] = #counts above high and bins[0] = 0,
    and the 0-d int64 total of the counts, both on counts' device (on
    the card, views of one buffer).  Up to
    _build.count_stats_shared_high() the kernel bins in shared memory,
    past it with global atomics.
    """
    if counts.dtype != torch.int32 or counts.dim() != 1:
        raise ValueError(f"count_stats: counts must be 1-D int32, got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if not 0 <= high < 1 << 30:
        raise ValueError(f"count_stats: high must be in [0, 2^30), got "
                         f"{high}")
    if counts.device.type == "cpu":
        return count_stats_ref(counts, high)
    _build.require_cuda("count_stats", counts)
    # bins and total in one zeroed buffer: one fill, then the kernel
    out = torch.zeros(high + 3, dtype=torch.int64, device=counts.device)
    _build.launch("count_stats", counts.device, counts.data_ptr(),
                  counts.numel(), high, out.data_ptr())
    return out[:high + 2], out[high + 2]


# ---------------------------------------------------------------------------
# K8: the marker algebra
# ---------------------------------------------------------------------------

MARKER_TILE = 2048    # markers.cu kTile: the merged rows a block tests


def _filter_side_ref(x_keys, x_counts, y_keys, y_n: int, lower: int,
                     upper: int):
    if y_n:
        y = y_keys[:y_n]
        pos = torch.searchsorted(y, x_keys).clamp_(max=y_n - 1)
        shared = y[pos] == x_keys
    else:
        shared = torch.zeros(x_keys.shape, dtype=torch.bool,
                             device=x_keys.device)
    keep = (~shared & (x_keys != SENT) & (x_counts >= lower)
            & (x_counts <= upper))
    kept = x_keys[keep]
    out = torch.full_like(x_keys, SENT)
    out[:kept.numel()] = kept
    return out, torch.tensor(kept.numel(), dtype=torch.int64,
                             device=x_keys.device)


def marker_filter_ref(a_keys, a_counts, a_n: int, b_keys, b_counts,
                      b_n: int, bounds):
    """Plain PyTorch twin of :func:`marker_filter`."""
    _build.TWIN_CALLS["marker_filter_ref"] += 1
    a_lower, a_upper, b_lower, b_upper = bounds
    return (*_filter_side_ref(a_keys, a_counts, b_keys, b_n, a_lower,
                              a_upper),
            *_filter_side_ref(b_keys, b_counts, a_keys, a_n, b_lower,
                              b_upper))


def marker_filter(a_keys: torch.Tensor, a_counts: torch.Tensor, a_n: int,
                  b_keys: torch.Tensor, b_counts: torch.Tensor, b_n: int,
                  bounds):
    """Keys unique to each of two count tables, within its bounds (K8).

    a_keys / b_keys: ascending distinct int64 runs whose first a_n / b_n
    rows are real and the rest INT64_MAX pads; counts int32 beside them;
    bounds = (a_lower, a_upper, b_lower, b_upper), inclusive.  Returns
    (a_out, a_kept, b_out, b_kept): each out holds the kept keys
    ascending at its front and INT64_MAX after them; each kept is a 0-d
    int64 tensor on the device.  A key is kept iff it is real, absent
    from the other table and its count lies within the bounds.  a and b
    may be the same tensors.  On the card it is one C call (two kernels,
    one merge of both runs) on a status scratch kept a card and stream.
    """
    _check_keys("marker_filter", a_keys, a_counts)
    _check_keys("marker_filter", b_keys, b_counts)
    if not (0 <= a_n <= a_keys.numel() and 0 <= b_n <= b_keys.numel()):
        raise ValueError(f"marker_filter: n_valid {a_n}, {b_n} outside the "
                         f"tables ({a_keys.numel()}, {b_keys.numel()})")
    a_lower, a_upper, b_lower, b_upper = (int(b) for b in bounds)
    if a_keys.device.type == "cpu":
        return marker_filter_ref(a_keys, a_counts, a_n, b_keys, b_counts,
                                 b_n, (a_lower, a_upper, b_lower, b_upper))
    _build.require_cuda("marker_filter", a_keys, a_counts, b_keys, b_counts)
    a_len, b_len = a_keys.numel(), b_keys.numel()
    if max(a_len, b_len) >= 1 << 31:
        raise ValueError(f"marker_filter: {a_len} and {b_len} rows, at most "
                         "2^31 - 1 each")
    dev = a_keys.device
    a_out, b_out = torch.empty_like(a_keys), torch.empty_like(b_keys)
    kept = torch.empty(2, dtype=torch.int64, device=dev)
    scratch = _status_scratch(
        "marker_filter", 2 * -(-(a_n + b_n) // MARKER_TILE) + 2, dev)
    _build.launch("marker_filter", dev, a_keys.data_ptr(), a_counts.data_ptr(),
                  a_len, a_n, b_keys.data_ptr(), b_counts.data_ptr(), b_len,
                  b_n, a_lower, a_upper, b_lower, b_upper, a_out.data_ptr(),
                  b_out.data_ptr(), kept.data_ptr(), scratch.data_ptr())
    return a_out, kept[0], b_out, kept[1]


# ---------------------------------------------------------------------------
# device-resident count tables
# ---------------------------------------------------------------------------


def _words_np(keys: torch.Tensor) -> np.ndarray:
    return keys.cpu().numpy().astype(np.uint64)


@dataclasses.dataclass
class DeviceCountTable:
    """Sorted (canonical k-mer -> count) table resident on a device.

    keys: (n,) int64 ascending, real for the first n_valid rows and
    INT64_MAX after; counts: (n,) int32, 0 on pads.  Histogram and total
    reduce on the device (K7), the marker algebra runs there (K8), and
    only its result comes to the host.
    """

    keys: torch.Tensor
    counts: torch.Tensor
    n_valid: int
    k: int

    @classmethod
    def from_reference(cls, ref, device="cuda") -> "DeviceCountTable":
        """A hast_tpu DeviceCountTable's (hi, lo, counts) on ``device``."""
        hi = np.asarray(ref.hi).astype(np.int64)
        lo = np.asarray(ref.lo).astype(np.int64)
        sent = (hi == _REF_SENT) & (lo == _REF_SENT)
        keys = np.where(sent, SENT, (hi << 32) | lo)
        return cls(torch.from_numpy(keys).to(device),
                   torch.from_numpy(np.array(ref.counts, np.int32)).to(
                       device), int(ref.n_valid), int(ref.k))

    def to_reference(self) -> tuple:
        """(hi, lo, counts, n_valid, k): hast_tpu's DeviceCountTable fields
        as numpy, sentinel pads as (0xFFFFFFFF, 0xFFFFFFFF)."""
        keys = self.keys.cpu().numpy()
        sent = keys == SENT
        hi = np.where(sent, _REF_SENT, keys >> 32).astype(np.uint32)
        lo = np.where(sent, _REF_SENT, keys & 0xFFFFFFFF).astype(np.uint32)
        return hi, lo, self.counts.cpu().numpy(), self.n_valid, self.k

    @property
    def n_distinct(self) -> int:
        return self.n_valid

    @property
    def total(self) -> int:
        return int(count_stats(self.counts, 0)[1])

    def histo(self, low: int = 1, high: int = 10000) -> np.ndarray:
        """:meth:`CountTable.histo` computed on the device, int64 bins."""
        with span("markers.histo"):
            return count_stats(self.counts, high)[0].cpu().numpy()

    def fetch(self) -> CountTable:
        """Full device->host copy (tests and the host engine)."""
        n = self.n_valid
        return CountTable(_words_np(self.keys[:n]),
                          self.counts[:n].cpu().numpy().astype(np.int64),
                          self.k)


def device_marker_algebra(pat: DeviceCountTable, mat: DeviceCountTable,
                          p_lower: int, p_upper: int,
                          m_lower: int, m_upper: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    """unique(parent) ∩ count-range(parent) for both parents, on device.

    The reference stage-00 algebra (jellyfish dump -L/-U range filters,
    the 2*mat+1*pat mix-count uniqueness trick and the count==2
    intersection) as one K8 call over the two resident tables; only the
    kept words come to the host.  Returns (paternal_words,
    maternal_words), ascending uint64.
    """
    with span("markers.algebra"):
        p_out, p_n, m_out, m_n = marker_filter(
            pat.keys, pat.counts, pat.n_valid, mat.keys, mat.counts,
            mat.n_valid, (p_lower, p_upper, m_lower, m_upper))
        return _words_np(p_out[:int(p_n)]), _words_np(m_out[:int(m_n)])


class DeviceCounter:
    """Streaming counter whose table stays on the device.

    Chunks of window keys pile up on the device and fold into one sorted
    run of distinct keys and their counts (K5 sort + K6 fold); only
    finalize() copies distinct rows to the host.  The jellyfish
    "-s MEM in-memory hash" analog.
    """

    # A fold holds twice its concatenated input: the sort ping-pongs
    # between the concat and one more buffer pair, and the fold writes
    # into whichever pair the sort left free (12 B an element each), as
    # the JAX fold budgets.  One fold at a time across counters bounds
    # the peak to one such transient plus the resident runs when two
    # parents count on two threads.  Each fold waits for its n_unique, so
    # its buffers are free when it releases the lock.
    _FOLD_LOCK = threading.Lock()

    def __init__(self, k: int, device="cuda", fold_above: int = FOLD_ABOVE):
        self.k = k
        self.device = torch.device(device)
        self._chunks: list[tuple[torch.Tensor, torch.Tensor | None]] = []
        self._chunk_elems = 0
        self._run: tuple[torch.Tensor, torch.Tensor] | None = None
        self._run_valid = 0
        self._fold_above = fold_above
        self.n_folds = 0

    def _fold_threshold(self) -> int:
        """Amortized fold trigger: let chunks pile up to about the size of
        the resident run (about 2 sorted rows per new row), capping the
        fold's concat at 250M elements while the run is below 250M -
        fold_above, so that its transient (two buffer pairs of 12 B an
        element) stays near 6 GB.  Past that the trigger is fold_above
        and the concat is the run plus fold_above: the transient then
        grows with the run."""
        run = self._run_valid
        cap = 250_000_000
        return max(self._fold_above, min(run, max(0, cap - run)))

    def add_sorted_chunk(self, keys: torch.Tensor) -> None:
        """Queue a chunk of window keys (pads INT64_MAX), count 1 each."""
        keys = keys.reshape(-1)
        self._chunks.append((keys, None))
        self._chunk_elems += keys.numel()
        if self._chunk_elems >= self._fold_threshold():
            self._fold()

    def merge_device(self, other: "DeviceCounter") -> None:
        """Union-sum another counter's run into this one, on the device
        (its run enters the next fold as a weighted chunk)."""
        other._fold()
        if other._run is not None:
            self._chunks.append(other._run)
            self._chunk_elems += other._run[0].numel()
            other._run = None
            other._run_valid = 0
            if self._chunk_elems >= self._fold_threshold():
                self._fold()

    def _fold(self) -> None:
        with self._FOLD_LOCK:
            if not self._chunks:
                return
            with span("kmer_count.fold"):
                parts = self._chunks
                if self._run is not None:
                    parts.append(self._run)
                self._chunks = []
                self._chunk_elems = 0
                keys = torch.cat([c for c, _ in parts])
                counts = torch.cat([
                    n if n is not None else
                    torch.ones(c.numel(), dtype=torch.int32, device=c.device)
                    for c, n in parts])
                del parts
                self._run = None
                spare = (torch.empty_like(keys), torch.empty_like(counts))
                sorted_ = sort_pairs(keys, counts, self.k, scratch=spare)
                free = spare if sorted_[0] is keys else (keys, counts)
                del keys, counts, spare
                keys, counts, n_unique = fold_runs(*sorted_, out=free)
                del sorted_, free
                n = int(n_unique)
                # a copy: the slice alone would keep the whole fold
                # buffer alive
                self._run = shrink_run(keys, counts, n) if n else None
                self._run_valid = n
                self.n_folds += 1

    def finalize_device(self) -> DeviceCountTable:
        """Finish folding and keep the table on the device."""
        self._fold()
        if self._run is None:
            return DeviceCountTable(
                torch.zeros(0, dtype=torch.int64, device=self.device),
                torch.zeros(0, dtype=torch.int32, device=self.device), 0,
                self.k)
        return DeviceCountTable(*self._run, self._run_valid, self.k)

    def finalize(self) -> CountTable:
        return self.finalize_device().fetch()


# ---------------------------------------------------------------------------
# counting over batches and files
# ---------------------------------------------------------------------------


def _assemble_ascii(buf: list):
    """Packed reads, ACGT mask and lengths of ASCII ReadBatches, stacked
    row-wise with the stride padded to 8 bases (8 mask bits a byte)."""
    L = max(b.seqs.shape[1] for b in buf)
    L = -(-L // 8) * 8
    seqs = np.zeros((sum(b.seqs.shape[0] for b in buf), L), np.uint8)
    lengths = np.zeros(seqs.shape[0], np.int32)
    r = 0
    for b in buf:
        rows = b.seqs.shape[0]
        seqs[r:r + rows, :b.seqs.shape[1]] = b.seqs
        lengths[r:r + b.lengths.shape[0]] = b.lengths
        r += rows
    return E.pack_codes_np(seqs), pack_good_np(seqs), lengths


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _groups(items: Iterable, n: int):
    """items in lists of n, the last one shorter when they run out."""
    buf: list = []
    for x in items:
        buf.append(x)
        if len(buf) >= n:
            yield buf
            buf = []
    if buf:
        yield buf


def _ascii_staged(buf: list):
    """(packed, lengths, good) of ASCII ReadBatches, as _assemble_ascii
    stacks them."""
    packed, good, lengths = _assemble_ascii(buf)
    return packed, lengths, good


def _count_staged(dcounter: "DeviceCounter", staged, key_range) -> None:
    """A super batch (packed, lengths, good or None) to the device, its
    window keys (K4) into dcounter.  The staged tensors are held until
    the chunk is queued, so a fold it sets off runs with them held."""
    packed, lengths, good = staged
    with span("kmer_count.stage"):
        packed_t, lengths_t = _on(dcounter.device, packed, lengths)
        good_t = None if good is None else _on(dcounter.device, good)[0]
        keys = count_windows(packed_t, lengths_t, dcounter.k, good_t,
                             key_range)
    dcounter.add_sorted_chunk(keys)


def count_batches(batches: Iterable, k: int, super_batch: int = 8,
                  finalize: bool = True, key_range=None,
                  fold_above: int = FOLD_ABOVE, device="cuda"
                  ) -> "CountTable | DeviceCounter":
    """Count canonical k-mers over an iterable of ASCII ReadBatches.

    Every super_batch batches are packed on the host and go to the
    device as one K4 launch; the keys fold in a :class:`DeviceCounter`.
    key_range=(lo, hi) keeps only canonical keys in [lo, hi) (one pass
    of the partitioned counter).  finalize=False returns the counter,
    still on the device.
    """
    dcounter = DeviceCounter(k, device, fold_above)
    for buf in _groups(batches, super_batch):
        _count_staged(dcounter, _ascii_staged(buf), key_range)
    return dcounter if not finalize else dcounter.finalize()


def _sample_bounds(staged_batches: Iterable, k: int, n_parts: int,
                   device) -> np.ndarray:
    """(n_parts + 1,) uint64 split points at the quantiles of the real
    window keys of the sampled batches, each (packed, lengths, good or
    None), [0, 2^64) padded: canonical keys skew low, so even splits
    would unbalance the passes, and are taken only when the sample holds
    no key.
    The keys are sorted and picked on the device: only the split points
    come to the host.  Each batch goes to the device before the next is
    taken, so a batch may be a view its source then reuses."""
    chunks = []
    for packed, lengths, good in staged_batches:
        tensors = _on(device, packed, lengths,
                      *(() if good is None else (good,)))
        chunks.append(count_windows(tensors[0], tensors[1], k,
                                    *tensors[2:]))
    bounds = np.empty(n_parts + 1, np.uint64)
    bounds[0] = 0
    bounds[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    keys = sort_pairs(torch.cat(chunks), None, k)[0] if chunks else None
    # the sentinels sort after every real key
    n = 0 if keys is None else int((keys != SENT).sum())
    if n:
        at = torch.tensor([min(n - 1, n * p // n_parts)
                           for p in range(1, n_parts)], dtype=torch.int64,
                          device=keys.device)
        bounds[1:-1] = keys[at].cpu().numpy().astype(np.uint64)
    else:
        for p in range(1, n_parts):
            # python-int arithmetic: uint64 p * 2^62 would wrap
            bounds[p] = np.uint64((p * 2**64) // n_parts)
    return bounds


def _strided(items: Iterable, n_sample: int, scan_cap: int) -> list:
    """Every (scan_cap // n_sample)-th of the first scan_cap items."""
    stride = max(1, scan_cap // n_sample)
    return [x for i, x in zip(range(scan_cap), items) if i % stride == 0]


# The native counting reader's read-length caps, tried in turn: a file
# with a longer read is redone natively from its start under the next,
# and one with a read past the last goes to the python reader.  The
# reader's parse thread zeroes its staging rows at the cap's stride
# before every batch, whatever the reads' length: at 8,192 that is 48
# MiB a batch of 16,384 reads, 3,072 bytes a read.  256 first: every
# short-read parental library HAST takes fits in it (2x100, 2x150,
# 2x250).  8,192 for longer reads, at that fill.
COUNT_LEN_CAPS = (256, 8192)


def open_count_reader(path: str, batch_size: int = 1 << 14,
                      len_cap: int = COUNT_LEN_CAPS[0]):
    """The native counting reader of a fasta/fastq file at len_cap, or
    None when it cannot take the file (no library, unreadable or unknown
    format).

    Iterating it yields batches of packed reads, their ACGT masks and
    lengths, decoded on its C++ threads; the caller closes it.  It
    raises N.ReadTooLong on a read longer than len_cap, and
    RuntimeError on multi-line fasta."""
    try:
        if N.get_lib() is None:
            return None
        fmt = FQ.detect_format(path)
        return N.NativeCountReader(path, batch_size, len_cap,
                                   fastq=(fmt == "fastq"))
    except (RuntimeError, FileNotFoundError, ValueError):
        return None


class _ReaderBroke(Exception):
    """The native counting reader stopped partway through a file
    (multi-line fasta): the python reader redoes the whole file."""


class _CapTooSmall(Exception):
    """The native counting reader met a read beyond its length cap: the
    next of COUNT_LEN_CAPS redoes the file natively, and past the last
    the python reader does."""


def _native_batches(reader):
    """The reader's batches.  Only the reader's own errors become
    _CapTooSmall or _ReaderBroke; an error of the caller's work between
    two batches (the device's, say) propagates as it is."""
    it = iter(reader)
    while True:
        try:
            batch = next(it)
        except StopIteration:
            return
        except N.ReadTooLong as e:
            raise _CapTooSmall(str(e)) from e
        except RuntimeError as e:
            raise _ReaderBroke(str(e)) from e
        yield batch


def _stack_native(batches: list):
    """A super batch of the native reader's batches as K4 takes it:
    (packed rows at the widest stride, lengths, the ACGT mask), the mask
    None when every base is ACGT (the common case)."""
    sp = max(b.packed.shape[1] for b in batches)
    rows = sum(b.packed.shape[0] for b in batches)
    packed = np.zeros((rows, sp), np.uint8)
    lengths = np.zeros(rows, np.int32)
    clean = all(batch_is_clean(b.good, b.lengths) for b in batches)
    good = None if clean else np.zeros((rows, sp // 2), np.uint8)
    r = 0
    for b in batches:
        n = b.packed.shape[0]
        packed[r:r + n, :b.packed.shape[1]] = b.packed
        lengths[r:r + n] = b.lengths
        if good is not None:
            good[r:r + n, :b.good.shape[1]] = b.good
        r += n
    return packed, lengths, good


class _FileRead:
    """A fasta/fastq file read as K4 takes it, one reader batch a
    :meth:`step`: super batches of super_batch reader batches, each
    (packed, lengths, good or None), with the (rows, reads) of each
    reader batch in it.

    The native counting reader takes the file when it can: its C++
    threads decode, 2-bit pack and build the ACGT mask, and a super
    batch whose bases are all ACGT (the common case) comes without its
    mask (_stack_native).  It opens at the first of COUNT_LEN_CAPS; a
    read beyond the cap redoes the file natively from its start under
    the next (``markers.cap_redos`` counts each), and the batches are
    those any larger cap gives.  When the native reader cannot take the
    file, meets a read beyond the last cap or breaks on multi-line
    fasta, the python reader's batches come instead, from the file's
    start (_ascii_staged).  attempt() is called before each reading and
    returns the take(staged, batches) that gets its super batches in
    order; a later attempt means that what the one before took is
    dropped.
    """

    def __init__(self, path: str, k: int, attempt: Callable,
                 batch_size: int = 1 << 14, super_batch: int = 8):
        self.path, self._k, self._bs = path, k, batch_size
        self._attempt, self._super_batch = attempt, super_batch
        self._reader = None
        self._caps = iter(COUNT_LEN_CAPS)
        self._open(next(self._caps))

    @property
    def native(self) -> bool:
        """Whether the native reader is reading the file."""
        return self._reader is not None

    def _open(self, cap: int | None) -> None:
        """Read the file from its start: natively under cap, or by the
        python reader when cap is None or the native reader cannot take
        the file.  What an earlier reading took is dropped."""
        self.close()
        self._cap = cap
        if cap is not None:
            self._reader = open_count_reader(self.path, self._bs, cap)
        self._pending = []
        self._take = self._attempt()
        self._batches = (
            FQ.sequence_batches(self.path, self._k, self._bs)
            if self._reader is None else _native_batches(self._reader))

    def step(self) -> bool:
        """Take the file's next reader batch, and hand on the super batch
        it fills; False at the file's end, with its last super batch
        handed on and its reader closed."""
        try:
            batch = next(self._batches, None)
        except _CapTooSmall:
            bigger = next(self._caps, None)
            if bigger is not None:
                print(f"[hast_tpu_torch] NOTE: {self.path} has reads longer "
                      f"than {self._cap} bases; redoing it with len_cap "
                      f"{bigger}", file=sys.stderr)
                count("markers.cap_redos")
            self._open(bigger)
            return True
        except _ReaderBroke:
            self._open(None)
            return True
        if batch is not None:
            self._pending.append(batch)
        if self._pending and (batch is None
                              or len(self._pending) >= self._super_batch):
            buf, self._pending = self._pending, []
            if self.native:
                self._take(_stack_native(buf),
                           [(b.packed.shape[0], b.n) for b in buf])
            else:
                self._take(_ascii_staged(buf),
                           [(b.seqs.shape[0], b.n) for b in buf])
        if batch is None:
            self.close()
        return batch is not None

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None


def read_in_turn(openers: Iterable[Callable], width: int) -> None:
    """Read up to width files at once on this one thread, a reader batch
    from each open file in turn (_FileRead.step), so that their readers'
    threads decode side by side.

    Each opener is a callable that returns a :class:`_FileRead`, a lane
    a file: the files open in the openers' order, and a file that ends
    gives its place to the next, so with width 1 they are read one after
    the other.  Each turn that takes a batch adds one to
    ``markers.turns`` and the files open then to
    ``markers.open_readers``; a native reader's batch taken while
    another file is open counts as ``markers.overlapped_batches``."""
    pending = iter(openers)
    live: list = []
    turn = 0
    try:
        for opener in itertools.islice(pending, width):
            live.append(opener())
        while live:
            f = live[turn]
            if f.step():
                count("markers.turns")
                count("markers.open_readers", len(live))
                if f.native and len(live) > 1:
                    count("markers.overlapped_batches")
                turn += 1
            else:
                opener = next(pending, None)
                if opener is None:
                    del live[turn]
                else:
                    live[turn] = opener()
                    turn += 1
            turn = turn % len(live) if live else 0
    finally:
        for f in live:
            f.close()


def count_file(path: str, k: int, batch_size: int = 1 << 14,
               super_batch: int = 8, finalize: bool = True,
               key_range=None, fold_above: int = FOLD_ABOVE,
               device="cuda") -> "CountTable | DeviceCounter":
    """Count one fasta/fastq file: each super batch of its
    :class:`_FileRead` is one K4 launch into a :class:`DeviceCounter`,
    which is dropped whole if the native reader breaks.
    key_range=(lo, hi) keeps only canonical keys in [lo, hi);
    finalize=False returns the counter, still on the device."""
    counter = None

    def attempt():
        nonlocal counter
        dcounter = counter = DeviceCounter(k, device, fold_above)
        return lambda staged, _: _count_staged(dcounter, staged, key_range)

    read_in_turn([functools.partial(_FileRead, path, k, attempt,
                                    batch_size, super_batch)], 1)
    return counter if not finalize else counter.finalize()


@dataclasses.dataclass(frozen=True)
class _SpillRecord:
    """A super batch in a spill file: at offset, the lengths (int32 a
    row), the packed rows (stride bytes each), then, when masked, the
    ACGT mask (stride / 2 bytes a row); batches holds the (rows, reads)
    of each reader batch in it, in order."""

    offset: int
    stride: int
    masked: bool
    batches: tuple

    @property
    def rows(self) -> int:
        return sum(rows for rows, _ in self.batches)

    @property
    def nbytes(self) -> int:
        return self.rows * (4 + self.stride
                            + (self.stride // 2 if self.masked else 0))


class PackedSpill:
    """One parent's reads as K4 takes them, read once from its files and
    then served from files on the host to every key-range pass (meryl
    splits its input once: meryl.sh, split.pl).

    Each input file becomes a part of the spill: a file of its own,
    named after path with the file's index before the extension
    (``parts``), holding the file's records back to back, one a super
    batch of :class:`_FileRead`, as :func:`count_file` counts them; the
    records' shapes stay in memory (``files``, in the input files'
    order).  When the native reader breaks partway, the part is
    truncated and the python reader's records take its place.  A pass
    reads each part's records in order into one reused host buffer and
    sends each to the device as one K4 launch, into a
    :class:`DeviceCounter` a part, the parts' runs merged into one, as a
    pass over the input files does, so the launches, shapes and tables
    are those of reading the files again.  :meth:`write_in_turn` writes
    several parents' spills at once, a reader a file.

    Counters: ``io.spill_reads`` the reads a pass or the sample takes
    from the spill, ``io.spill_bytes`` the bytes read back from it; the
    input readers alone count ``io.reads``.  A spill is for one thread
    at a time; its owner calls :meth:`remove`, which deletes every part.
    If the write fails, the constructor removes the parts before it
    raises.
    """

    def __init__(self, path: str, sources, k: int,
                 batch_size: int = 1 << 14, super_batch: int = 8):
        self._start(path, sources, k)
        self._write([self], batch_size, super_batch, 1)

    def _start(self, path: str, sources, k: int) -> None:
        self.sources = list(sources)
        root, ext = os.path.splitext(path)
        self.parts = [f"{root}.{i}{ext}" for i in range(len(self.sources))]
        self.k = k
        self.files: list[list[_SpillRecord]] = [[] for _ in self.sources]
        self._buf = np.empty(0, np.uint8)

    @classmethod
    def write_in_turn(cls, specs, k: int, batch_size: int = 1 << 14,
                      super_batch: int = 8, width: int = 1
                      ) -> list["PackedSpill"]:
        """A spill of each (path, sources) in specs, up to width files
        read at once on this one thread, a lane a file
        (:func:`read_in_turn`): the spills' first files, then their
        second ones, and so on, so that a width of at least the number
        of spills opens a file of each first.  Each part holds the bytes
        and records that writing its file alone gives.  If a write
        fails, every part of every spill is removed before it raises."""
        spills = []
        for path, sources in specs:
            spill = cls.__new__(cls)
            spill._start(path, sources, k)
            spills.append(spill)
        cls._write(spills, batch_size, super_batch, width)
        return spills

    @staticmethod
    def _write(spills: list, batch_size: int, super_batch: int,
               width: int) -> None:
        try:
            with span("markers.spill_write"), \
                    contextlib.ExitStack() as stack:
                lanes = [[functools.partial(
                    s._open_source, i, stack.enter_context(open(part, "wb")),
                    batch_size, super_batch)
                    for i, part in enumerate(s.parts)] for s in spills]
                read_in_turn([opener for nth in itertools.zip_longest(*lanes)
                              for opener in nth if opener is not None],
                             width)
        except BaseException:
            for s in spills:
                s.remove()
            raise

    def _open_source(self, i: int, f, batch_size: int,
                     super_batch: int) -> _FileRead:
        """Source i's :class:`_FileRead`, whose records go into its part,
        open as f."""
        records = self.files[i]

        def attempt():
            f.seek(0)
            f.truncate()
            records.clear()
            return lambda staged, batches: records.append(
                self._append(f, staged, batches))

        return _FileRead(self.sources[i], self.k, attempt, batch_size,
                         super_batch)

    @staticmethod
    def _append(f, staged, batches) -> _SpillRecord:
        packed, lengths, good = staged
        rec = _SpillRecord(f.tell(), packed.shape[1], good is not None,
                           tuple(batches))
        for a in (lengths, packed, good):
            if a is not None:
                f.write(np.ascontiguousarray(a).data)
        return rec

    def _read(self, f, rec: _SpillRecord):
        """A record's (packed, lengths, good or None) from its part f,
        views of the reused buffer: valid until the next read."""
        with span("markers.spill_read"):
            n = rec.nbytes
            if self._buf.size < n:
                self._buf = np.empty(n, np.uint8)
            f.seek(rec.offset)
            if f.readinto(memoryview(self._buf)[:n]) != n:
                raise EOFError(f"{f.name}: spill ends inside a record")
            rows, sp = rec.rows, rec.stride
            lengths = self._buf[:4 * rows].view(np.int32)
            packed = self._buf[4 * rows:(4 + sp) * rows].reshape(rows, sp)
            good = (self._buf[(4 + sp) * rows:n].reshape(rows, sp // 2)
                    if rec.masked else None)
        count("io.spill_bytes", n)
        return packed, lengths, good

    def count_pass(self, key_range, fold_above: int = FOLD_ABOVE,
                   device="cuda") -> DeviceCountTable:
        """One key-range pass over the spill: the window keys in
        key_range = (lo, hi), counted on the device: a run a part, and
        the parts' runs unioned into one (span ``markers.file_merge``;
        ``markers.merged_runs`` counts the parts)."""
        total = DeviceCounter(self.k, device, fold_above)
        for part, records in zip(self.parts, self.files):
            dcounter = DeviceCounter(self.k, device, fold_above)
            with open(part, "rb") as f:
                for rec in records:
                    _count_staged(dcounter, self._read(f, rec), key_range)
                    count("io.spill_reads", sum(r for _, r in rec.batches))
            total.merge_device(dcounter)
        with span("markers.file_merge"):
            table = total.finalize_device()
        count("markers.merged_runs", len(self.files))
        return table

    def sample_boundaries(self, n_parts: int, n_sample: int = 16,
                          scan_cap: int = 512, device="cuda") -> np.ndarray:
        """Key-space split points at the quantiles of a strided sample
        of the spill's reader batches, each sliced out of its record:
        every (scan_cap // n_sample)-th of the first scan_cap, the parts
        in order, since genomic input is locally correlated.  For fastq,
        batch i of the native reader holds the reads of batch i of
        FQ.sequence_batches, so the split points are those of sampling
        the python reader."""
        with span("markers.sample_boundaries"), \
                contextlib.ExitStack() as stack:
            parts = [stack.enter_context(open(p, "rb")) for p in self.parts]
            picked = _strided(((f, rec, i)
                               for f, records in zip(parts, self.files)
                               for rec in records
                               for i in range(len(rec.batches))),
                              n_sample, scan_cap)
            return _sample_bounds(self._batches(picked), self.k, n_parts,
                                  device)

    def _batches(self, picked):
        """The (packed, lengths, good) of each picked (part, record,
        batch), sliced out of its record: views, valid until the next
        read."""
        for f, rec, i in picked:
            r0 = sum(rows for rows, _ in rec.batches[:i])
            rows, reads = rec.batches[i]
            count("io.spill_reads", reads)
            yield tuple(None if a is None else a[r0:r0 + rows]
                        for a in self._read(f, rec))

    def remove(self) -> None:
        """Delete every part (nothing for a part that is gone)."""
        for part in self.parts:
            try:
                os.unlink(part)
            except FileNotFoundError:
                pass
