"""Pieces the generators share: seeds, the 2-bit code, canonical words,
planting and fastq text.

The generators keep an encoder of canonical words of their own, apart
from the references' (``reference/classify.canonical_words``): a fault
in one then cannot hide by making the inputs and the expected answers
alike."""

from __future__ import annotations

import concurrent.futures
import struct
import zlib

import numpy as np
import torch

BASES = np.frombuffer(b"ACGT", np.uint8)
CODE_BASES = np.frombuffer(b"ACTG", np.uint8)   # 2-bit code -> base
COMP = np.zeros(256, np.uint8)
COMP[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run's seed (any
    whole number, larger than 32 bits too)."""
    ss = np.random.SeedSequence([seed % (1 << 64), zlib.crc32(
        stream.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def revcomp_rows(rows: np.ndarray) -> np.ndarray:
    return COMP[rows[:, ::-1]]


def canonical_t(words: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical form of int64 k-mer words (A=0 C=1 T=2 G=3, first base
    highest): the smaller of the word and its reverse complement."""
    rc = torch.zeros_like(words)
    for j in range(k):
        rc |= (((words >> (2 * j)) & 3) ^ 2) << (2 * (k - 1 - j))
    return torch.minimum(words, rc)


def canonical_words_np(seqs: np.ndarray, k: int) -> np.ndarray:
    """(n, L) ASCII rows -> (n, L - k + 1) canonical int64 words."""
    codes = torch.from_numpy((seqs.astype(np.int64) >> 1) & 3)
    P = seqs.shape[1] - k + 1
    fwd = torch.zeros((seqs.shape[0], P), dtype=torch.int64)
    for j in range(k):
        fwd = (fwd << 2) | codes[:, j:j + P]
    return canonical_t(fwd, k).numpy()


def words_to_bytes(words: np.ndarray, k: int) -> np.ndarray:
    """(n,) words -> (n, k) ASCII rows."""
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.int64)
    return CODE_BASES[(np.asarray(words, np.int64)[:, None] >> shifts) & 3]


def plant(rng, reads: np.ndarray, rows: np.ndarray, frags: np.ndarray,
          flip: bool = True) -> None:
    """Write frags[i] into reads[rows[i]] at a random offset, each in a
    random orientation when flip."""
    if rows.size == 0:
        return
    frags = frags.copy()
    if flip:
        rev = rng.random(rows.size) < 0.5
        frags[rev] = revcomp_rows(frags[rev])
    w = frags.shape[1]
    pos = rng.integers(0, reads.shape[1] - w + 1, rows.size)
    reads[rows[:, None], pos[:, None] + np.arange(w)] = frags


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    return ((values[:, None] // 10 ** np.arange(width - 1, -1, -1)) % 10
            + ord("0")).astype(np.uint8)


def write_fastq(f, prefix: bytes, index: np.ndarray, names, suffix: bytes,
                seqs: np.ndarray, chunk: int = 1 << 17) -> None:
    """Write fastq_bytes of the records to f, chunk records at a time."""
    for s in range(0, seqs.shape[0], chunk):
        f.write(fastq_bytes(prefix, index[s:s + chunk],
                            None if names is None else names[s:s + chunk],
                            suffix, seqs[s:s + chunk]))


def fastq_bytes(prefix: bytes, index: np.ndarray, names, suffix: bytes,
                seqs: np.ndarray) -> bytes:
    """Fastq records '@<prefix><index, 9 digits>[#<name>]<suffix>', the
    sequence, '+' and a quality line of 'F'.  names: None or an S-dtype
    array, one a record."""
    n, L = seqs.shape
    head = [np.broadcast_to(np.frombuffer(b"@" + prefix, np.uint8),
                            (n, 1 + len(prefix))), _digits(index, 9)]
    if names is not None:
        head.append(np.full((n, 1), ord("#"), np.uint8))
    head = np.concatenate(head, axis=1)
    tail = np.concatenate([
        np.broadcast_to(np.frombuffer(suffix + b"\n", np.uint8),
                        (n, len(suffix) + 1)), seqs,
        np.broadcast_to(np.frombuffer(b"\n+\n", np.uint8), (n, 3)),
        np.full((n, L), ord("F"), np.uint8),
        np.full((n, 1), ord("\n"), np.uint8)], axis=1)
    if names is None:
        return np.concatenate([head, tail], axis=1).tobytes()
    bc = np.frombuffer(names.tobytes(), np.uint8).reshape(
        n, names.dtype.itemsize)
    width = (bc != 0).sum(axis=1)
    rec = head.shape[1] + width + tail.shape[1]
    start = np.concatenate([[0], np.cumsum(rec)[:-1]])
    out = np.empty(int(rec.sum()), np.uint8)
    out[start[:, None] + np.arange(head.shape[1])] = head
    cols = np.arange(bc.shape[1])
    keep = cols[None, :] < width[:, None]
    out[(start[:, None] + head.shape[1] + cols)[keep]] = bc[keep]
    out[(start + head.shape[1] + width)[:, None]
        + np.arange(tail.shape[1])] = tail
    return out.tobytes()


def gzip_member(data: bytes, level: int, threads: int = 8,
                block: int = 1 << 24) -> bytes:
    """data as one gzip member (RFC 1952) whose deflate stream is made of
    independently compressed blocks, each ended by a sync flush, on
    several threads (as pigz does): any inflater reads it as one stream."""
    parts = [data[i:i + block] for i in range(0, len(data), block)] or [b""]

    def deflate(i: int) -> bytes:
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        end = zlib.Z_FINISH if i == len(parts) - 1 else zlib.Z_SYNC_FLUSH
        return c.compress(parts[i]) + c.flush(end)

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        body = b"".join(pool.map(deflate, range(len(parts))))
    head = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"
    return head + body + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                     len(data) & 0xFFFFFFFF)
