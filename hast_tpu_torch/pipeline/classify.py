"""Stage 01 read classification (port of hast_tpu/pipeline/classify.py).

Reads stream from the native reader as 2-bit packed batches.  Each batch
is one launch of K3 :func:`tally_step` (``csrc/classify.cu``): canonical
windows, the two-bucket probe of the combined marker table (payload
bit 0 = hap0/paternal, bit 1 = hap1/maternal), per-read votes and a
scatter-add into a device-resident int32 (cap, 3) tally, which K10
:func:`grow_tally` doubles as barcode ids grow.  The tally comes to the
host once per file, as the narrowest exact image that K11
:func:`pack_tally` makes of it; the host merges files by barcode name,
takes the float64 getHap decision and writes ``phased.barcodes``.

Parity with the reference classify binary (classify.cpp) is the JAX
package's: votes count k-mer positions per haplotype set (a position can
hit both), N-containing reads go to the unknown bucket before voting,
adaptor k-mers are erased from the sets and shrink the set sizes, and
output rows are sorted bytewise by barcode.  Reads shorter than k vote
(0, 0, 1) where the reference asserts.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
from typing import Iterable

import numpy as np
import torch

from hast_tpu_torch.io import fastq as FQ
from hast_tpu_torch.io import native as N
from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.ops import hashtable as H
from hast_tpu_torch.utils.profiling import count, span

ADAPTOR_F = "CTGTCTCTTATACACATCTTAGGAAGACAAGCACTGACGACATGA"
ADAPTOR_R = "TCTGCTGAGTCGAGAACGTCTCTGTGAGCCAAGGAGTTGCTCTGG"
NULL_BARCODES = (b"0_0_0", b"0_0", b"0")
LOAD = 0.7               # table load factor, part of the snapshot key
SNAPSHOT_VERSION = 5.0   # shared with the JAX package's .probetable.npz


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


# ---------------------------------------------------------------------------
# marker table
# ---------------------------------------------------------------------------


def load_marker_table(hap0_path: str, hap1_path: str) -> H.KmerTable:
    """Two one-kmer-per-line marker files -> one combined host table.

    k comes from hap0's first line; set sizes are the distinct canonical
    k-mers per haplotype.  The table is cached beside hap0 as
    ``<hap0>.probetable.npz`` in the JAX package's format and under its
    key (both files' size and whole-second mtime, the load factor, the
    format version), so the JAX package reuses the port's snapshot.  The
    port also stores both files' st_mtime_ns and requires them on load:
    a file rewritten within one second at the same size is parsed again,
    and so is a snapshot the JAX package wrote (it lacks the field).
    """
    cache_path = hap0_path + ".probetable.npz"
    stats = [os.stat(p) for p in (hap0_path, hap1_path)]
    key = tuple(float(x) for st in stats
                for x in (st.st_size, int(st.st_mtime))) + (LOAD,
                                                            SNAPSHOT_VERSION)
    mtime_ns = [st.st_mtime_ns for st in stats]
    if os.path.exists(cache_path):
        try:
            with np.load(cache_path, allow_pickle=False) as z:
                if tuple(z["key"].tolist()) == key and "mtime_ns" in z \
                        and z["mtime_ns"].tolist() == mtime_ns:
                    table = H.from_reference(
                        z["data"], int(z["n_buckets"]), int(z["max_probe"]),
                        int(z["k"]), int(z["n_keys"]), z["set_sizes"],
                        str(z["fmt"]) if "fmt" in z else "full",
                        device="cpu")
                    for h, n in enumerate(z["line_counts"].tolist()):
                        _log(f"Recorded {n} haplotype {h} specific "
                             f"{table.k}-mers")
                    return table
        except (OSError, KeyError, ValueError) as e:
            _log(f"[hast_tpu_torch] NOTE: snapshot {cache_path} unreadable, "
                 f"rebuilding: {e}")
    h0_hi, h0_lo, k = E.load_mer_file(hap0_path)
    h1_hi, h1_lo, _ = E.load_mer_file(hap1_path, k_expect=k)
    n0 = np.unique((h0_hi.astype(np.uint64) << np.uint64(32))
                   | h0_lo.astype(np.uint64)).size
    n1 = np.unique((h1_hi.astype(np.uint64) << np.uint64(32))
                   | h1_lo.astype(np.uint64)).size
    table = H.build_table(
        np.concatenate([h0_hi, h1_hi]), np.concatenate([h0_lo, h1_lo]),
        np.concatenate([np.ones(h0_hi.size, np.uint32),
                        np.full(h1_hi.size, 2, np.uint32)]),
        k, load=LOAD, set_sizes=(n0, n1))
    _log(f"Recorded {h0_hi.size} haplotype 0 specific {k}-mers")
    _log(f"Recorded {h1_hi.size} haplotype 1 specific {k}-mers")
    # written aside and renamed: processes that classify shards of one
    # run (HAST_NUM_PROCESSES) load the same files at once
    tmp = f"{cache_path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, data=table.data_np(),
                     n_buckets=table.n_buckets, max_probe=table.max_probe,
                     k=table.k, n_keys=table.n_keys,
                     set_sizes=np.asarray(table.set_sizes),
                     line_counts=np.asarray([h0_hi.size, h1_hi.size]),
                     key=np.asarray(key),
                     mtime_ns=np.asarray(mtime_ns, np.int64), fmt=table.fmt)
        os.replace(tmp, cache_path)
    except OSError as e:
        _log(f"[hast_tpu_torch] NOTE: snapshot {cache_path} not written: {e}")
        if os.path.exists(tmp):
            os.remove(tmp)
    return table


def erase_adaptors(table: H.KmerTable, adaptor_f: str = ADAPTOR_F,
                   adaptor_r: str = ADAPTOR_R) -> None:
    """Erase adaptor k-mers from both marker sets (InitAdaptor parity)."""
    _log(f"Adaptor forward :{adaptor_f}")
    _log(f"Adaptor reverse :{adaptor_r}")
    k = table.k
    for adaptor in (adaptor_f, adaptor_r):
        if len(adaptor) < k:
            continue
        codes = E.encode_np(np.frombuffer(adaptor.encode(), np.uint8))
        hi, lo = E.canonical_kmers_np(codes[None, :], k)
        for chi, clo, bits in H.remove_keys(table, hi[0], lo[0],
                                            payload_mask=3):
            for hap in (0, 1):
                if bits & (1 << hap):
                    _log(" INFO : erase a adaptor kmer from hap "
                         f"{hap} ; kmer= {E.kmer_to_str(chi, clo, k)}")


# ---------------------------------------------------------------------------
# K3: votes + tally of one packed batch
# ---------------------------------------------------------------------------


def tally_step_ref(table: H.KmerTable, acc: torch.Tensor,
                   packed: torch.Tensor, lengths: torch.Tensor,
                   ids: torch.Tensor, has_n: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of :func:`tally_step` (updates acc in place)."""
    _build.TWIN_CALLS["tally_step_ref"] += 1
    keys, valid = E.canonical_windows_ref(packed, lengths, table.k)
    pay = torch.where(valid, H.probe_ref(table, keys), 0)
    hn = has_n.to(torch.bool)
    v0 = torch.where(hn, 0, (pay & 1).sum(dim=-1))
    v1 = torch.where(hn, 0, ((pay >> 1) & 1).sum(dim=-1))
    unk = (hn | ((v0 == 0) & (v1 == 0))).to(v0.dtype)
    upd = torch.stack([v0, v1, unk], dim=-1).to(torch.int32)
    keep = (ids >= 0) & (ids < acc.shape[0])
    acc.index_add_(0, ids[keep].to(torch.int64), upd[keep])
    return acc


def tally_step(table: H.KmerTable, acc: torch.Tensor, packed: torch.Tensor,
               lengths: torch.Tensor, ids: torch.Tensor,
               has_n: torch.Tensor) -> torch.Tensor:
    """Vote a packed batch and add (v0, v1, unknown) into acc[id] (K3).

    acc: (cap, 3) int32, updated in place and returned.  packed: (N, Lp)
    uint8; lengths and ids: (N,) int32; has_n: (N,) bool or uint8.  Rows
    whose id lies outside [0, cap) are dropped.  CPU tensors take the
    twin; CUDA tensors launch the kernel.
    """
    H.check_table(table)
    E.check_packed(packed, lengths)
    n = packed.shape[0]
    if acc.dtype != torch.int32 or acc.dim() != 2 or acc.shape[1] != 3:
        raise ValueError(f"acc must be (cap, 3) int32, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    if ids.dtype != torch.int32 or tuple(ids.shape) != (n,):
        raise ValueError(f"ids must be ({n},) int32")
    if has_n.dtype not in (torch.bool, torch.uint8) or \
            tuple(has_n.shape) != (n,):
        raise ValueError(f"has_n must be ({n},) bool or uint8")
    if packed.device.type == "cpu":
        return tally_step_ref(table, acc, packed, lengths, ids, has_n)
    _build.require_cuda("tally_step", table.data, acc, packed, lengths, ids,
                        has_n)
    if n == 0:
        return acc
    _build.launch("classify_tally", acc.device, *H.kernel_table_args(table),
                  packed.data_ptr(), lengths.data_ptr(), ids.data_ptr(),
                  has_n.data_ptr(), n, packed.shape[1], acc.data_ptr(),
                  acc.shape[0])
    return acc


# ---------------------------------------------------------------------------
# per-barcode tally and decision
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BarcodeTally:
    """barcode -> (count_hap0, count_hap1, count_unknown).

    The native engine folds per-file count tables keyed by S-dtype name
    arrays (merge_names); the python engine numbers barcodes through the
    host dict (ids) and adds one count table at the end (add_counts).
    finalize() reconciles both into one (names, counts) pair.
    """

    index: dict[bytes, int] = dataclasses.field(default_factory=dict)
    counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((1024, 3), np.int64))
    _pending: list = dataclasses.field(default_factory=list)

    def ids(self, barcodes: list[bytes]) -> np.ndarray:
        """Dense ids, numbering new barcodes in order of first sight."""
        idx = self.index
        out = np.empty(len(barcodes), np.int32)
        for i, bc in enumerate(barcodes):
            v = idx.get(bc)
            if v is None:
                v = idx[bc] = len(idx)
            out[i] = v
        return out

    def add_counts(self, counts: np.ndarray) -> None:
        """Add an (n, 3) table indexed by the ids of :meth:`ids`."""
        n = len(self.index)
        if n > self.counts.shape[0]:
            self.counts = np.vstack([self.counts, np.zeros(
                (n - self.counts.shape[0], 3), np.int64)])
        self.counts[:n] += counts[:n]

    def merge_names(self, names: np.ndarray, counts: np.ndarray) -> None:
        """Queue a (n,) S-dtype name array + (n, 3) count table."""
        if names.size:
            self._pending.append((names, counts))

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Deduplicated (names S-array, (n, 3) int64 counts), unsorted."""
        parts = list(self._pending)
        if self.index:
            names = np.array(list(self.index.keys()), dtype=bytes)
            parts.append((names, self.counts[:names.size]))
        if not parts:
            return np.empty(0, "S1"), np.zeros((0, 3), np.int64)
        if len(parts) == 1:
            return parts[0]
        width = max(p[0].dtype.itemsize for p in parts)
        all_names = np.concatenate([p[0].astype(f"S{width}") for p in parts])
        all_counts = np.concatenate([p[1] for p in parts]).astype(np.int64)
        order = N.argsort_fixed(all_names)
        if order is None:
            order = np.argsort(all_names, kind="stable")
        s = all_names[order]
        new = np.empty(s.size, bool)
        new[0] = True
        new[1:] = s[1:] != s[:-1]
        uniq = s[new]
        counts = np.add.reduceat(all_counts[order], np.flatnonzero(new),
                                 axis=0)
        self._pending = [(uniq, counts)]
        self.index = {}
        self.counts = np.zeros((1024, 3), np.int64)
        return uniq, counts


def decide_haps(bcs_s: np.ndarray, c0: np.ndarray, c1: np.ndarray,
                size0: int, size1: int, w0: float = 1.0,
                w1: float = 1.0) -> np.ndarray:
    """Vectorized getHap (classify.cpp:66-86), the same double math."""
    with np.errstate(divide="ignore", invalid="ignore"):
        df0 = (c0.astype(np.float64) / float(size0)) * w0
        df1 = (c1.astype(np.float64) / float(size1)) * w1
    hap = np.full(bcs_s.shape, -1, np.int64)
    both = (c0 > 0) & (c1 > 0)
    hap[both & (df0 > df1)] = 0
    hap[both & (df1 > df0)] = 1
    hap[(c0 > 0) & (c1 <= 0)] = 0
    hap[(c1 > 0) & (c0 <= 0)] = 1
    null = np.zeros(bcs_s.shape, bool)
    for nb in NULL_BARCODES:
        null |= bcs_s == nb
    hap[null] = -1
    return hap


def get_hap(barcode: bytes, c0: int, c1: int, size0: int, size1: int,
            w0: float = 1.0, w1: float = 1.0) -> int:
    """The getHap decision (classify.cpp:66-86) for one barcode, in the
    same double math as :func:`decide_haps`."""
    if barcode in NULL_BARCODES:
        return -1
    if c0 > 0 and c1 > 0:
        df0 = (float(c0) / float(size0)) * w0
        df1 = (float(c1) / float(size1)) * w1
        if df0 > df1:
            return 0
        if df1 > df0:
            return 1
        return -1
    if c0 > 0:
        return 0
    if c1 > 0:
        return 1
    return -1


def write_phased_barcodes(tally: BarcodeTally, table: H.KmerTable, out,
                          w0: float = 1.0, w1: float = 1.0) -> None:
    """Write "barcode\\thap\\tcount0\\tcount1" rows sorted bytewise."""
    size0, size1 = table.set_sizes
    with span("classify.sort_barcodes"):
        bcs, counts = tally.finalize()
        if bcs.size == 0:
            return
        order = N.argsort_fixed(bcs)
    with span("classify.decide_format"):
        buf = None
        if order is not None:
            buf = N.decide_format_phased(
                bcs, order, np.ascontiguousarray(counts[:, 0]),
                np.ascontiguousarray(counts[:, 1]), size0, size1, w0, w1)
        if buf is None:  # libhastio absent: the numpy decision, same bytes
            if order is None:
                order = np.argsort(bcs, kind="stable")
            bcs = bcs[order]
            c0 = counts[order, 0]
            c1 = counts[order, 1]
            hap = decide_haps(bcs, c0, c1, size0, size1, w0, w1)
            buf = b"".join(b"%s\t%d\t%d\t%d\n" % t for t in
                           zip(bcs.tolist(), hap.tolist(), c0.tolist(),
                               c1.tolist()))
    with span("classify.write"):
        out.write(buf)


# ---------------------------------------------------------------------------
# streaming drivers
# ---------------------------------------------------------------------------


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# K10 and K11: growth of the device tally and its narrow fetch
# ---------------------------------------------------------------------------

# The native reader's first tally.  The JAX driver starts at 2^20 rows so
# that the TPU compiles one tally shape; a launch compiles nothing, so the
# port starts small and doubles as barcode ids grow.
TALLY_ROWS = 1 << 16


def _check_tally(acc: torch.Tensor) -> None:
    if acc.dtype != torch.int32 or acc.dim() != 2 or acc.shape[1] != 3:
        raise ValueError(f"the tally must be (rows, 3) int32, got "
                         f"{tuple(acc.shape)} {acc.dtype}")


def _grown_rows(rows: int, max_id: int) -> int:
    """rows doubled until max_id < rows (rows 0 counts as 1)."""
    rows = max(rows, 1)
    return rows if max_id < rows else rows << (max_id // rows).bit_length()


def grow_tally_ref(acc: torch.Tensor, max_id: int) -> torch.Tensor:
    """Plain PyTorch twin of :func:`grow_tally` (always a new tensor)."""
    _build.TWIN_CALLS["grow_tally_ref"] += 1
    rows = _grown_rows(acc.shape[0], max_id)
    return torch.cat([acc, acc.new_zeros((rows - acc.shape[0], 3))])


def grow_tally(acc: torch.Tensor, max_id: int) -> torch.Tensor:
    """The (rows, 3) int32 tally doubled until it has a row for max_id
    (K10): its rows, then zero rows.  acc itself when it has the row
    already.  CPU tensors take the twin; CUDA tensors launch the kernel.

    The kernel takes a few µs at 2^20 rows, so the wrapper's Python is
    most of a call: it keeps to the checks, one allocation and one call
    of :func:`_build.launch`."""
    _check_tally(acc)
    rows = _grown_rows(acc.shape[0], max_id)
    if rows == acc.shape[0]:
        return acc
    dev = acc.device
    if dev.type == "cpu":
        return grow_tally_ref(acc, max_id)
    if dev.type != "cuda" or not acc.is_contiguous():
        _build.require_cuda("grow_tally", acc)
    out = torch.empty((rows, 3), dtype=torch.int32, device=dev)
    _build.launch("grow_tally", dev, acc.data_ptr(), acc.numel(),
                  out.data_ptr(), out.numel())
    return out


def _int16_bits(x: torch.Tensor) -> torch.Tensor:
    """Values 0..65535 as the int16 with the same 16 bits."""
    return ((x ^ 0x8000) - 0x8000).to(torch.int16)


def pack_tally_ref(acc: torch.Tensor):
    """Plain PyTorch twin of :func:`pack_tally`."""
    _build.TWIN_CALLS["pack_tally_ref"] += 1
    over = torch.stack([((acc >> 8) != 0).sum(), ((acc >> 16) != 0).sum()])
    return ((acc & 0xFF).to(torch.uint8), _int16_bits(acc & 0xFFFF),
            over.to(torch.int64))


def pack_tally(acc: torch.Tensor):
    """The low-byte images of the (rows, 3) int32 tally (K11): (lo8 uint8,
    lo16 int16 holding the uint16 bits, over (2,) int64), where over
    counts the entries with v >> 8 != 0 and those with v >> 16 != 0.
    CPU tensors take the twin; CUDA tensors launch the kernel."""
    _check_tally(acc)
    if acc.device.type == "cpu":
        return pack_tally_ref(acc)
    _build.require_cuda("pack_tally", acc)
    lo8 = torch.empty(acc.shape, dtype=torch.uint8, device=acc.device)
    lo16 = torch.empty(acc.shape, dtype=torch.int16, device=acc.device)
    over = torch.zeros(2, dtype=torch.int64, device=acc.device)
    if acc.numel():
        _build.launch("pack_tally", acc.device, acc.data_ptr(), acc.numel(),
                      lo8.data_ptr(), lo16.data_ptr(), over.data_ptr())
    return lo8, lo16, over


def fetch_tally(acc: torch.Tensor) -> np.ndarray:
    """The tally on the host as int64 through the narrowest exact image
    (the JAX `_fetch_acc`): uint8 when every entry fits 8 bits, else
    uint16 when they fit 16, else the int32 tally itself."""
    lo8, lo16, over = pack_tally(acc)
    n8, n16 = over.tolist()
    if not n8:
        return lo8.cpu().numpy().astype(np.int64)
    if not n16:
        return lo16.cpu().numpy().view(np.uint16).astype(np.int64)
    return acc.cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# K13: per-read votes without a tally
# ---------------------------------------------------------------------------


def vote_reads_ref(table: H.KmerTable, reads: torch.Tensor,
                   lengths: torch.Tensor, packed: bool,
                   row_lo: int | None = None) -> torch.Tensor:
    """Plain PyTorch twin of :func:`vote_reads`."""
    _build.TWIN_CALLS["vote_reads_ref"] += 1
    codes = E.unpack_ref(reads) if packed else (reads.to(torch.int64) >> 1) & 3
    keys, valid = E.code_windows_ref(codes, lengths, table.k)
    pay = torch.where(valid, H.probe_ref(table, keys, row_lo or 0), 0)
    votes = torch.stack([(pay & 1).sum(dim=-1), ((pay >> 1) & 1).sum(dim=-1)],
                        dim=-1)
    return _int16_bits(votes & 0xFFFF) if packed else votes.to(torch.int32)


def vote_reads(table: H.KmerTable, reads: torch.Tensor,
               lengths: torch.Tensor, packed: bool,
               row_lo: int | None = None) -> torch.Tensor:
    """Each read's (v0, v1) marker votes, with no tally (K13).

    reads: (N, stride) uint8, 2-bit packed (packed=True, 4 bases a byte)
    or ASCII (each byte a base, coded (b >> 1) & 3 whatever it is);
    lengths: (N,) int32.  A window counts iff it lies inside the read;
    v0 counts the windows whose payload has bit 0, v1 those with bit 1.
    Returns (N, 2): int16 holding the uint16 bits for packed reads (the
    JAX `vote_kernel_packed`), int32 for ASCII (`vote_kernel`).
    With row_lo, table.data may be the slice of rows [row_lo, row_lo +
    len) that one tp shard holds; a window then counts only the hits in
    its buckets.  Without it, table.data must be the whole table.
    CPU tensors take the twin; CUDA tensors launch the kernel.
    """
    H.check_table(table, row_lo)
    if reads.dtype != torch.uint8 or reads.dim() != 2:
        raise ValueError(f"reads must be (N, stride) uint8, got "
                         f"{tuple(reads.shape)} {reads.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != reads.shape[:1]:
        raise ValueError(f"lengths must be ({reads.shape[0]},) int32")
    E._check_k(table.k)
    if reads.device.type == "cpu":
        return vote_reads_ref(table, reads, lengths, packed, row_lo)
    _build.require_cuda("vote_reads", table.data, reads, lengths)
    n = reads.shape[0]
    out = torch.empty((n, 2), dtype=torch.int16 if packed else torch.int32,
                      device=reads.device)
    if n == 0:
        return out
    _build.launch("vote_reads", reads.device, *H.kernel_table_args(table),
                  row_lo or 0, table.data.shape[0], reads.data_ptr(),
                  lengths.data_ptr(), n, reads.shape[1], int(not packed),
                  out.data_ptr())
    return out


def _data_table(data: torch.Tensor, k: int, max_probe: int,
                fmt: str) -> H.KmerTable:
    return H.KmerTable(data, data.shape[0], max_probe, k, 0, (), fmt)


def vote_kernel(data: torch.Tensor, seqs_u8: torch.Tensor,
                lengths: torch.Tensor, k: int, max_probe: int,
                fmt: str = "full"):
    """(v0, v1), each (B,) int32, of a padded ASCII batch (B, L): the JAX
    `vote_kernel`'s signature on tensors, through K13."""
    v = vote_reads(_data_table(data, k, max_probe, fmt), seqs_u8, lengths,
                   packed=False)
    return v[:, 0], v[:, 1]


def vote_kernel_multi(data: torch.Tensor, seqs_u8: torch.Tensor,
                      lengths: torch.Tensor, k: int, max_probe: int,
                      fmt: str = "full") -> torch.Tensor:
    """(S, B, L) ASCII reads -> (S, B, 2) int32 votes (the JAX
    `vote_kernel_multi`), one K13 launch over the S*B rows."""
    s, b, L = seqs_u8.shape
    return vote_reads(_data_table(data, k, max_probe, fmt),
                      seqs_u8.reshape(s * b, L), lengths.reshape(s * b),
                      packed=False).reshape(s, b, 2)


def vote_kernel_packed(data: torch.Tensor, packed: torch.Tensor,
                       lengths: torch.Tensor, k: int, max_probe: int,
                       fmt: str = "full") -> torch.Tensor:
    """(S, B, L/4) packed reads -> (S, B, 2) votes as int16 holding the
    uint16 bits (the JAX `vote_kernel_packed`), one K13 launch."""
    s, b, lp = packed.shape
    return vote_reads(_data_table(data, k, max_probe, fmt),
                      packed.reshape(s * b, lp), lengths.reshape(s * b),
                      packed=True).reshape(s, b, 2)


# ---------------------------------------------------------------------------
# K15: votes into a barcode tally
# ---------------------------------------------------------------------------


def tally_votes_ref(votes: torch.Tensor, has_n: torch.Tensor,
                    ids: torch.Tensor, num_barcodes: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of :func:`tally_votes` (adds into out too)."""
    _build.TWIN_CALLS["tally_votes_ref"] += 1
    hn = has_n.to(torch.bool)
    v0 = torch.where(hn, 0, votes[:, 0])
    v1 = torch.where(hn, 0, votes[:, 1])
    unk = (hn | ((v0 == 0) & (v1 == 0))).to(torch.int32)
    upd = torch.stack([v0, v1, unk], dim=-1).to(torch.int32)
    keep = (ids >= 0) & (ids < num_barcodes)
    tally = out if out is not None else torch.zeros(
        (num_barcodes, 3), dtype=torch.int32, device=votes.device)
    return tally.index_add_(0, ids[keep].to(torch.int64), upd[keep])


def tally_votes(votes: torch.Tensor, has_n: torch.Tensor, ids: torch.Tensor,
                num_barcodes: int,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """The (num_barcodes, 3) int32 tally of per-read votes (K15): N reads
    vote (0, 0), unknown = has_n or no vote, and (v0, v1, unknown) add
    into row ids[r] as `jax.ops.segment_sum` adds them, dropping every id
    outside [0, num_barcodes), negative ones included.

    votes: (N, 2) int32; has_n: (N,) bool or uint8; ids: (N,) int32.
    out: None, or a (num_barcodes, 3) int32 tally on the votes' device
    that the votes are added into (and which is returned); int32 sums
    are exact in any order, so tallying in parts and adding equals one
    tally.  CPU tensors take the twin; CUDA tensors launch the kernel.
    """
    n = votes.shape[0]
    if votes.dtype != torch.int32 or votes.dim() != 2 or votes.shape[1] != 2:
        raise ValueError(f"votes must be (N, 2) int32, got "
                         f"{tuple(votes.shape)} {votes.dtype}")
    if ids.dtype != torch.int32 or tuple(ids.shape) != (n,):
        raise ValueError(f"ids must be ({n},) int32")
    if has_n.dtype not in (torch.bool, torch.uint8) or \
            tuple(has_n.shape) != (n,):
        raise ValueError(f"has_n must be ({n},) bool or uint8")
    if num_barcodes < 0:
        raise ValueError(f"num_barcodes must be >= 0, got {num_barcodes}")
    if out is not None and (out.dtype != torch.int32 or tuple(out.shape)
                            != (num_barcodes, 3)
                            or out.device != votes.device):
        raise ValueError(f"out must be ({num_barcodes}, 3) int32 on "
                         f"{votes.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    if votes.device.type == "cpu":
        return tally_votes_ref(votes, has_n, ids, num_barcodes, out)
    tally = out if out is not None else torch.zeros(
        (num_barcodes, 3), dtype=torch.int32, device=votes.device)
    _build.require_cuda("tally_votes", votes, has_n, ids, tally)
    if votes.data_ptr() % 8:
        raise ValueError("tally_votes: votes must be 8-byte aligned (the "
                         "kernel loads a read's two votes as one word)")
    if n and num_barcodes:
        _build.launch("tally_votes", votes.device, votes.data_ptr(),
                      has_n.data_ptr(), ids.data_ptr(), n, tally.data_ptr(),
                      num_barcodes)
    return tally


def classify_fastqs(table: H.KmerTable, paths: Iterable[str],
                    batch_size: int = 1 << 15,
                    engine: str = "auto") -> BarcodeTally:
    """Stream fastq files through K3 into a barcode tally.

    The device is the table's.  engine "native" reads with libhastio
    (decode, 2-bit pack and barcode ids off the GIL), several files'
    readers open at once so that their inflates run side by side
    (:func:`_classify_native`); "python" with the pure-Python reader and
    the host barcode dict, "auto" native when the library builds.  Both
    feed the same kernel and give the same output.
    """
    tally = BarcodeTally()
    if engine == "auto":
        engine = "native" if N.get_lib() is not None else "python"
    if engine == "native" and N.get_lib() is None:
        raise RuntimeError("libhastio.so unavailable")
    device = table.data.device
    _log(f"[hast_tpu_torch] classify engine: {engine} reader on {device}")
    if engine == "native":
        paths = list(paths)
        _classify_native(table, paths, batch_size, tally, device,
                         _reader_width(len(paths)))
        return tally
    acc = torch.zeros((1 << 12, 3), dtype=torch.int32, device=device)
    for path in paths:
        _log(f"__process read: {path}")
        for b in FQ.fastq_batches(path, batch_size):
            ids = tally.ids(b.barcodes)
            acc = grow_tally(acc, len(tally.index) - 1)
            n = b.n
            packed = E.pack_codes_np(b.seqs[:n])
            tally_step(table, acc, _tensor(packed, device),
                       _tensor(b.lengths[:n], device), _tensor(ids, device),
                       _tensor(b.has_n[:n], device))
        _log("__process read done__")
    tally.add_counts(fetch_tally(acc[:len(tally.index)]))
    return tally


# The native classify reader's read-length caps, tried in turn: a file
# with a longer read is redone from its start under the next.  K13's
# packed votes are uint16, exact while len_cap - k + 1 < 2^16.
LEN_CAPS = (1024, 8192, 1 << 16)


def _redo_note(path: str, cap: int, bigger: int) -> None:
    _log(f"[hast_tpu_torch] NOTE: {path} has reads longer than {cap} "
         f"bases; redoing it with len_cap {bigger}")


def _with_len_caps(path: str, run):
    """run(len_cap) under each of LEN_CAPS until the native reader takes
    every read of path; a read past the last cap raises."""
    for cap, bigger in zip(LEN_CAPS, LEN_CAPS[1:]):
        try:
            return run(cap)
        except N.ReadTooLong:
            _redo_note(path, cap, bigger)
    return run(LEN_CAPS[-1])


def _reader_width(n_paths: int) -> int:
    """How many files' native readers classify keeps open at once: each
    reader runs two threads (inflate, parse), so half the usable cores,
    and at least one."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    return min(n_paths, max(1, cores // 2))


class _NativeFile:
    """One file's native reader and its own device tally.  A read past
    len_cap drops both and reopens the file from its start under the
    next of LEN_CAPS."""

    def __init__(self, index: int, path: str, batch_size: int, device):
        self.index, self.path = index, path
        self._bs, self._device = batch_size, device
        self._caps = iter(LEN_CAPS)
        self._open(next(self._caps))

    def _open(self, cap: int) -> None:
        self._cap = cap
        self._reader = N.NativeFastqReader(self.path, self._bs, len_cap=cap,
                                           packed=True)
        self._batches = iter(self._reader)
        self._acc = torch.zeros((TALLY_ROWS, 3), dtype=torch.int32,
                                device=self._device)

    def next_batch(self):
        """The file's next batch, or None at its end."""
        while True:
            try:
                return next(self._batches, None)
            except N.ReadTooLong:
                bigger = next(self._caps, None)
                if bigger is None:
                    raise
                self.close()
                _redo_note(self.path, self._cap, bigger)
                self._open(bigger)

    def stage(self, table, b) -> None:
        """One batch through K3 into the file's tally."""
        with span("classify.stage"):
            n, device = b.n, self._device
            ids = b.barcode_ids[:n]
            self._acc = grow_tally(self._acc, int(ids.max(initial=-1)))
            tally_step(table, self._acc, _tensor(b.seqs[:n], device),
                       _tensor(b.lengths[:n], device), _tensor(ids, device),
                       _tensor(b.has_n[:n], device))

    def fetch(self):
        """(barcode names, (n, 3) int64 counts) at the file's end; closes
        the reader."""
        with span("classify.fetch_tally"):
            names = self._reader.barcodes_array()
            counts = fetch_tally(self._acc[:names.size])
        self.close()
        return names, counts

    def close(self) -> None:
        self._reader.close()
        self._acc = None


def _classify_native(table, paths, batch_size, tally, device,
                     width: int) -> None:
    """The files through the native reader, up to width readers open at
    once on this one thread: a batch from each open reader in turn, the
    next file opening in the place of one that ends.  Each reader's own
    threads inflate and parse while this thread serves the others; with
    width 1 the files go one after the other.  Each file has its own
    device tally, fetched at its end and merged by barcode name in file
    order.  A batch taken while another file's reader is open counts as
    ``classify.overlapped_batches``."""
    waiting = collections.deque(enumerate(paths))
    ended: dict = {}        # file index -> (path, names, counts)
    live: list = []
    merged = turn = 0
    try:
        with span("classify.files"):
            while waiting and len(live) < width:
                live.append(_NativeFile(*waiting.popleft(), batch_size,
                                        device))
            while live:
                f = live[turn]
                b = f.next_batch()
                if b is not None:
                    if len(live) > 1:
                        count("classify.overlapped_batches")
                    f.stage(table, b)
                else:
                    ended[f.index] = (f.path, *f.fetch())
                    if waiting:
                        live[turn] = _NativeFile(*waiting.popleft(),
                                                 batch_size, device)
                    else:
                        del live[turn]
                        turn -= 1
                    while merged in ended:
                        path, names, counts = ended.pop(merged)
                        tally.merge_names(names, counts)
                        _log(f"__process read: {path}")
                        _log("__process read done__")
                        merged += 1
                turn = (turn + 1) % len(live) if live else 0
    finally:
        for f in live:
            f.close()


def _classify_fastqs_native(table: H.KmerTable, paths: Iterable[str],
                            batch_size: int, tally: BarcodeTally | None,
                            super_batch: int, vote_fn=None) -> BarcodeTally:
    """Native reader, per-read votes to the host, host tally (the JAX
    function of the same name, which its mesh classify runs).

    Each super-batch of S packed batches is one vote_fn call, (S, B, Lp)
    uint8 and (S, B) int32 numpy in, (S, B, 2) votes (int16 holding the
    uint16 bits) out; by default K13 on the table's device.  Votes come
    to the host six super-batches late; the per-read rows fold into the
    file's (barcodes, 3) int64 table by bincount every 2^22 reads, and
    each file merges by barcode name.  Each fold is a span,
    ``classify.host_fold``.
    """
    tally = tally or BarcodeTally()
    if vote_fn is None:
        data, k, mp, fmt = table.data, table.k, table.max_probe, table.fmt
        vote_fn = lambda packed, lengths: vote_kernel_packed(  # noqa: E731
            data, _tensor(packed, data.device), _tensor(lengths, data.device),
            k, mp, fmt)
    S = super_batch

    def one_file(path, len_cap):
        """(barcode names, (n, 3) int64 tally) of one file."""
        reader = N.NativeFastqReader(path, batch_size, len_cap=len_cap,
                                     packed=True)
        local = np.zeros((1 << 12, 3), np.int64)
        inflight: list = []   # [(votes tensor, [(n, ids, has_n)])]
        buf: list = []
        acc: list = []        # [(ids, v0, v1, unk)] drained, not folded
        acc_reads = 0

        def fold():
            nonlocal acc, acc_reads, local
            if not acc:
                return
            with span("classify.host_fold"):
                ids = np.concatenate([a[0] for a in acc])
                cols = [np.concatenate([a[c] for a in acc])
                        for c in (1, 2, 3)]
                acc, acc_reads = [], 0
                if ids.size:
                    top = int(ids.max())
                    if top >= local.shape[0]:
                        grown = max(top + 1, 2 * local.shape[0])
                        local = np.vstack([local, np.zeros(
                            (grown - local.shape[0], 3), np.int64)])
                    nb = local.shape[0]
                    # float64 sums of these small ints are exact (<< 2^53)
                    for c, w in enumerate(cols):
                        local[:, c] += np.bincount(
                            ids, weights=w, minlength=nb).astype(np.int64)

        def drain(p):
            nonlocal acc_reads
            votes = p[0].cpu().numpy().view(np.uint16)
            for s, (n, ids, hn) in enumerate(p[1]):
                v0 = np.where(hn, 0, votes[s, :n, 0].astype(np.int64))
                v1 = np.where(hn, 0, votes[s, :n, 1].astype(np.int64))
                unk = (hn | ((v0 == 0) & (v1 == 0))).astype(np.int64)
                acc.append((ids, v0, v1, unk))
                acc_reads += n
            if acc_reads >= 1 << 22:
                fold()

        def flush():
            nonlocal buf
            if not buf:
                return
            # zero pad bytes decode to A, as the ASCII zero pad does
            lp = max(b.seqs.shape[1] for b in buf)
            seqs = np.zeros((S, batch_size, lp), np.uint8)
            lengths = np.zeros((S, batch_size), np.int32)
            for s, b in enumerate(buf):
                seqs[s, :, :b.seqs.shape[1]] = b.seqs
                lengths[s] = b.lengths
            meta = [(b.n, b.barcode_ids[:b.n], b.has_n[:b.n]) for b in buf]
            inflight.append((vote_fn(seqs, lengths), meta))
            buf = []
            if len(inflight) > 6:
                drain(inflight.pop(0))

        try:
            for batch in reader:
                buf.append(batch)
                if len(buf) >= S:
                    flush()
            flush()
            for p in inflight:
                drain(p)
            fold()
            return reader.barcodes_array(), local
        finally:
            reader.close()

    for path in paths:
        _log(f"__process read: {path}")
        names, local = _with_len_caps(
            path, lambda cap, p=path: one_file(p, cap))
        tally.merge_names(names, local[:names.size])
        _log("__process read done__")
    return tally


def classify_fastqs_mesh(mesh, table: H.KmerTable, paths: Iterable[str],
                         batch_size: int = FQ.DEFAULT_BATCH,
                         tally: BarcodeTally | None = None,
                         super_batch: int = 8) -> BarcodeTally:
    """Classify on a dp×tp mesh (the JAX `classify_fastqs_mesh`): the table
    (host or any device) is sharded over tp by rows, each super-batch's
    reads split over dp, and parallel.mesh.sharded_vote_step gives the
    votes (K13 per shard, a sum over tp); the tally stays on the host.
    batch_size must be a multiple of dp.  The same tally as
    :func:`classify_fastqs`."""
    from hast_tpu_torch.parallel import mesh as PM

    if N.get_lib() is None:
        raise RuntimeError("mesh classify requires libhastio.so")
    if batch_size % mesh.dp:
        raise ValueError(f"batch_size {batch_size} is not a multiple of the "
                         f"mesh's dp {mesh.dp}")
    shards = PM.shard_table(mesh, table)
    k, mp, nb, fmt = table.k, table.max_probe, table.n_buckets, table.fmt

    def vote_fn(packed, lengths):
        return PM.sharded_vote_step(mesh, shards, packed, lengths, k, mp, nb,
                                    fmt)

    return _classify_fastqs_native(table, paths, batch_size, tally,
                                   super_batch, vote_fn=vote_fn)


def run_classify(hap0: str, hap1: str, reads: list[str], out,
                 w0: float = 1.0, w1: float = 1.0,
                 adaptor_f: str = ADAPTOR_F, adaptor_r: str = ADAPTOR_R,
                 batch_size: int = FQ.DEFAULT_BATCH, device="cuda",
                 engine: str = "auto", mesh=None) -> BarcodeTally:
    """Full stage-01 classify (the reference binary's main()).

    mesh: a parallel.mesh.Mesh; the probes then run over it
    (:func:`classify_fastqs_mesh`, which shards the host table itself)
    and device and engine are not used.
    """
    _log("__START__")
    _log(f" use hap0 weight {w0:g}")
    _log(f" use hap1 weight {w1:g}")
    table = load_marker_table(hap0, hap1)
    erase_adaptors(table, adaptor_f, adaptor_r)
    if mesh is None:
        table = table.to(device)
        tally = classify_fastqs(table, reads, batch_size, engine=engine)
    else:
        tally = classify_fastqs_mesh(mesh, table, reads, batch_size)
    _log("__print result__")
    write_phased_barcodes(tally, table, out, w0, w1)
    _log("__END__")
    return tally
