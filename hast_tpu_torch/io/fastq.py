"""Streaming FASTQ/FASTA readers and batch packing (a copy of
hast_tpu/io/fastq.py, so that the port imports nothing of it).

Host-side input pipeline: reads are packed into uint8 ASCII batches
(padded to a length bucket), with per-read lengths, N-flags and barcode
strings parsed on the host.

Parity notes (vs the reference HAST 01.classify_stlfr_reads/classify.cpp):
  * gz detection is by ".gz" filename suffix (classify.cpp:245-250).
  * fastq parsing is plain 4-line records via getline (classify.cpp:257-268);
    no format validation, same as the reference.
  * barcode = text between the LAST '#' and the LAST '/' of the head
    line; missing '#' starts from 0, missing-or-misplaced '/' runs to
    end of line (classify.cpp:112-119 substr semantics).
  * a read counts as N-containing iff it has a literal uppercase 'N'
    (classify.cpp:182-184).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator

import numpy as np

DEFAULT_BATCH = 1 << 14
LEN_BUCKET = 128


def open_text(path: str, mode: str = "rb"):
    """Open plain or gzip file by ".gz" suffix (reference convention)."""
    if str(path).endswith(".gz"):
        f = gzip.open(path, mode)
        if "r" in mode:
            return io.BufferedReader(f, buffer_size=1 << 20)
        return f
    return open(path, mode, buffering=1 << 20)


def parse_barcode(head: bytes) -> bytes:
    """stLFR barcode from a fastq head line (classify.cpp:112-119).

    '@...#203_1533_1069/1' -> b'203_1533_1069'.  Uses the last '#' and
    last '/'; degenerate heads fall back exactly like the reference's
    substr with a negative (huge) length: everything after the '#'.
    """
    s = head.rfind(b"#")
    e = head.rfind(b"/")
    if e > s:
        return head[s + 1:e]
    return head[s + 1:]


def fastq_records(path: str) -> Iterator[tuple[bytes, bytes, bytes, bytes]]:
    """Yield (head, seq, plus, qual) tuples, newline-stripped."""
    with open_text(path) as f:
        while True:
            head = f.readline()
            if not head:
                return
            seq = f.readline()
            if not seq:
                # truncated record at EOF: drop it (the reference
                # crashes on the empty read; the native reader drops)
                return
            plus = f.readline()
            qual = f.readline()
            yield (head.rstrip(b"\r\n"), seq.rstrip(b"\r\n"),
                   plus.rstrip(b"\r\n"), qual.rstrip(b"\r\n"))


def fasta_records(path: str) -> Iterator[tuple[bytes, bytes]]:
    """Yield (head_line_without_gt, seq) from (multi-line) fasta."""
    head = None
    chunks: list[bytes] = []
    with open_text(path) as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if not line:
                continue
            if line.startswith(b">"):
                if head is not None:
                    yield head, b"".join(chunks)
                head = line[1:]
                chunks = []
            else:
                chunks.append(line)
        if head is not None:
            yield head, b"".join(chunks)


@dataclasses.dataclass
class ReadBatch:
    """A padded batch of reads ready for device transfer."""

    seqs: np.ndarray        # (B, L) uint8 ASCII, zero-padded
    lengths: np.ndarray     # (B,) int32
    has_n: np.ndarray       # (B,) bool — read contains literal 'N'
    barcodes: list[bytes]   # per-read barcode strings
    n: int                  # valid reads (== len(barcodes))


def _bucket_len(max_len: int) -> int:
    return max(LEN_BUCKET, -(-max_len // LEN_BUCKET) * LEN_BUCKET)


def pack_reads(heads: list[bytes], seqs: list[bytes],
               batch_size: int | None = None) -> ReadBatch:
    """Pack raw (head, seq) lists into a fixed-shape ReadBatch."""
    n = len(seqs)
    b = batch_size or n
    L = _bucket_len(max((len(s) for s in seqs), default=1))
    buf = np.zeros((b, L), np.uint8)
    lengths = np.zeros(b, np.int32)
    has_n = np.zeros(b, bool)
    for i, s in enumerate(seqs):
        a = np.frombuffer(s, np.uint8)
        buf[i, :a.size] = a
        lengths[i] = a.size
        has_n[i] = b"N" in s
    return ReadBatch(seqs=buf, lengths=lengths, has_n=has_n,
                     barcodes=[parse_barcode(h) for h in heads], n=n)


def detect_format(path: str) -> str:
    """'fasta' or 'fastq' by first byte (jellyfish-style autodetect)."""
    with open_text(path) as f:
        first = f.read(1)
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    raise ValueError(f"{path}: cannot detect fasta/fastq (starts {first!r})")


def sequence_batches(path: str, k: int, batch_size: int = DEFAULT_BATCH,
                     seg_len: int = 1024) -> Iterator[ReadBatch]:
    """Stream sequences of a fasta/fastq file for k-mer counting.

    Long fasta sequences (genomes) are chopped into <= seg_len segments
    overlapping by k-1 bases so no k-mer window is lost or duplicated.
    Barcodes are not parsed (counting doesn't need them).
    """
    fmt = detect_format(path)

    skip = 0  # records already yielded by the native reader (fallback resume)
    if fmt == "fastq":
        # native fast path: decode + pack off the GIL
        reader = None
        try:
            from hast_tpu_torch.io.native import NativeFastqReader
            reader = NativeFastqReader(path, batch_size, len_cap=8192)
            it = iter(reader)
        except (ImportError, RuntimeError, FileNotFoundError):
            reader = None
        if reader is not None:
            try:
                for b in it:
                    yield ReadBatch(seqs=b.seqs, lengths=b.lengths,
                                    has_n=b.has_n, barcodes=[], n=b.n)
                    skip += b.n
                reader.close()
                return
            except RuntimeError:
                # a read longer than len_cap mid-file: the batch that
                # tripped the flag was NOT yielded.  Fall back to the
                # python reader but resume AFTER the `skip` records
                # already emitted, so nothing is double counted.
                reader.close()

    def gen():
        if fmt == "fastq":
            for i, (_, seq, _, _) in enumerate(fastq_records(path)):
                if i < skip:
                    continue
                yield seq
        else:
            for _, seq in fasta_records(path):
                if len(seq) <= seg_len:
                    yield seq
                else:
                    step = seg_len - (k - 1)
                    for p in range(0, len(seq) - (k - 1), step):
                        yield seq[p:p + seg_len]

    heads: list[bytes] = []
    seqs: list[bytes] = []
    for seq in gen():
        heads.append(b"")
        seqs.append(seq)
        if len(seqs) >= batch_size:
            yield pack_reads(heads, seqs, batch_size)
            heads, seqs = [], []
    if seqs:
        yield pack_reads(heads, seqs, batch_size)


def fastq_batches(path: str, batch_size: int = DEFAULT_BATCH
                  ) -> Iterator[ReadBatch]:
    """Stream a fastq file as fixed-size ReadBatches (last may be short)."""
    heads: list[bytes] = []
    seqs: list[bytes] = []
    for head, seq, _, _ in fastq_records(path):
        heads.append(head)
        seqs.append(seq)
        if len(seqs) >= batch_size:
            yield pack_reads(heads, seqs, batch_size)
            heads, seqs = [], []
    if seqs:
        yield pack_reads(heads, seqs, batch_size)
