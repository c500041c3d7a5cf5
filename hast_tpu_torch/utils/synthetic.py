"""Seeded synthetic marker files, stLFR reads and parental reads, numpy only.

The inputs of ``bench.py``'s classify and stage-00 workloads, made without
jax and without a per-read Python loop, so a million reads take seconds:

* :func:`make_marker_files`: two disjoint sets of random distinct
  canonical k-mers, each line in a random orientation (as jellyfish dumps
  them), plus the adaptor k-mers that the erase step removes.
* :func:`make_stlfr_fastq`: 100-bp stLFR reads, 15% with a planted hap0
  marker and 15% with a hap1 marker (either orientation), 2% with an N,
  1% with a null barcode (0_0_0, 0_0 or 0); the others carry
  ``@V<index>#<a>_<b>_<c>/1`` heads with a, b, c drawn from [1000, 1500),
  so almost every read has a barcode of its own, as in ``bench.py``.
* :func:`make_trio_genomes` and :func:`make_parent_reads_vectorized`: a
  child's two haplotypes and shotgun fasta reads of a parent, the same
  bytes for the same seed as ``hast_tpu.utils.synthetic``'s.
"""

from __future__ import annotations

import numpy as np

from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.pipeline.classify import (ADAPTOR_F, ADAPTOR_R,
                                              NULL_BARCODES)

BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def _revcomp_rows(rows: np.ndarray) -> np.ndarray:
    return _COMP[rows[:, ::-1]]


def make_marker_files(seed: int, n_markers: int, k: int, hap0_path: str,
                      hap1_path: str, plant_adaptor: bool = True):
    """Write n_markers distinct k-mers per haplotype; return the two
    (n_markers, k) uint8 ASCII row arrays as written (adaptors excluded)."""
    rng = np.random.default_rng(seed)
    words = np.empty(0, np.uint64)
    while words.size < 2 * n_markers:
        codes = rng.integers(0, 4, (2 * n_markers + 1024, k), np.uint8)
        hi, lo = E.canonical_kmers_np(codes, k)
        new = (hi[:, 0].astype(np.uint64) << np.uint64(32)) | lo[:, 0]
        words = np.unique(np.concatenate([words, new]))
    rng.shuffle(words)
    rows = E.words_to_bytes(words[:2 * n_markers], k)
    flip = rng.random(rows.shape[0]) < 0.5
    rows[flip] = _revcomp_rows(rows[flip])
    sets = [rows[:n_markers], rows[n_markers:]]
    for h, (path, ad) in enumerate(((hap0_path, ADAPTOR_F),
                                    (hap1_path, ADAPTOR_R))):
        out = sets[h]
        if plant_adaptor and len(ad) >= k:
            ad_rows = np.frombuffer(ad.encode(), np.uint8)
            out = np.concatenate([out] + [ad_rows[None, i:i + k] for i in
                                          (0, 5, len(ad) - k)])
        lines = np.concatenate(
            [out, np.full((out.shape[0], 1), ord("\n"), np.uint8)], axis=1)
        with open(path, "wb") as f:
            f.write(lines.tobytes())
    return sets[0], sets[1]


def make_stlfr_fastq(seed: int, path: str, markers0: np.ndarray,
                     markers1: np.ndarray, n_reads: int,
                     read_len: int = 100, chunk: int = 1 << 16) -> None:
    """Write n_reads stLFR fastq records (see the module docstring)."""
    rng = np.random.default_rng(seed)
    k = markers0.shape[1]
    with open(path, "wb", buffering=1 << 22) as f:
        for s in range(0, n_reads, chunk):
            n = min(chunk, n_reads - s)
            seqs = BASES[rng.integers(0, 4, (n, read_len))]
            which = rng.random(n)
            pos = rng.integers(0, read_len - k + 1, n)
            cols = pos[:, None] + np.arange(k)
            for sel, markers in ((which < 0.15, markers0),
                                 ((which >= 0.15) & (which < 0.30),
                                  markers1)):
                rows = np.flatnonzero(sel)
                m = markers[rng.integers(0, markers.shape[0], rows.size)]
                flip = rng.random(rows.size) < 0.5
                m[flip] = _revcomp_rows(m[flip])
                seqs[rows[:, None], cols[rows]] = m
            n_rows = np.flatnonzero((which >= 0.30) & (which < 0.32))
            seqs[n_rows, pos[n_rows]] = ord("N")
            f.write(_records(s, seqs, _barcodes(rng, n)))


def make_trio_genomes(seed: int, length: int, het_rate: float = 0.01):
    """A child diploid: a shared backbone plus per-haplotype SNPs.

    Returns (paternal, maternal) genome byte strings.
    """
    rng = np.random.default_rng(seed)
    base = BASES[rng.integers(0, 4, length)]
    pat, mat = base.copy(), base.copy()
    pos = rng.choice(length, size=int(length * het_rate), replace=False)
    for p in pos:
        alt = BASES[rng.integers(0, 4)]
        while alt == pat[p]:
            alt = BASES[rng.integers(0, 4)]
        if rng.integers(0, 2):
            pat[p] = alt
        else:
            mat[p] = alt
    return pat.tobytes(), mat.tobytes()


def make_parent_reads_vectorized(seed: int, genome: bytes, path: str,
                                 coverage: float, read_len: int = 100,
                                 err_rate: float = 0.0) -> int:
    """Write shotgun fasta reads of a genome (">r" heads, i.i.d. per-base
    substitution errors, a reverse-complement coin per read); return how
    many."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome, np.uint8)
    n = int(len(genome) * coverage / read_len)
    pos = rng.integers(0, len(genome) - read_len + 1, n)
    reads = g[pos[:, None] + np.arange(read_len)]
    if err_rate > 0:
        err = rng.random((n, read_len)) < err_rate
        reads = np.where(err, BASES[rng.integers(0, 4, (n, read_len))],
                         reads)
    flip = rng.integers(0, 2, n).astype(bool)
    reads[flip] = _revcomp_rows(reads[flip])
    head = np.frombuffer(b">r\n", np.uint8)
    with open(path, "wb", buffering=1 << 22) as f:
        for s in range(0, n, 1 << 18):
            e = min(n, s + (1 << 18))
            f.write(np.concatenate(
                [np.broadcast_to(head, (e - s, 3)), reads[s:e],
                 np.full((e - s, 1), ord("\n"), np.uint8)], axis=1).tobytes())
    return n


def _barcodes(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, 14) ASCII barcode rows and their (n,) widths."""
    parts = rng.integers(1000, 1500, (n, 3))
    digits = (parts[:, :, None] // np.array([1000, 100, 10, 1])) % 10
    bc = np.full((n, 3, 5), ord("_"), np.uint8)
    bc[:, :, :4] = digits + ord("0")
    bc = bc.reshape(n, 15)[:, :14].copy()
    width = np.full(n, 14)
    null = np.flatnonzero(rng.random(n) < 0.01)
    choice = rng.integers(0, len(NULL_BARCODES), null.size)
    for i, nb in enumerate(NULL_BARCODES):
        rows = null[choice == i]
        bc[rows, :len(nb)] = np.frombuffer(nb, np.uint8)
        width[rows] = len(nb)
    return bc, width


def _records(first: int, seqs: np.ndarray, barcodes) -> bytes:
    """Assemble "@V<8-digit index>#<barcode>/1\\n<seq>\\n+\\n<qual>\\n"."""
    bc, width = barcodes
    n, L = seqs.shape
    idx = first + np.arange(n)
    head = np.empty((n, 11), np.uint8)
    head[:, :2] = np.frombuffer(b"@V", np.uint8)
    head[:, 2:10] = (idx[:, None] // 10 ** np.arange(7, -1, -1)) % 10 \
        + ord("0")
    head[:, 10] = ord("#")
    tail = np.concatenate([
        np.broadcast_to(np.frombuffer(b"/1\n", np.uint8), (n, 3)), seqs,
        np.broadcast_to(np.frombuffer(b"\n+\n", np.uint8), (n, 3)),
        np.full((n, L), ord("F"), np.uint8),
        np.full((n, 1), ord("\n"), np.uint8)], axis=1)
    rec_len = head.shape[1] + width + tail.shape[1]
    start = np.concatenate([[0], np.cumsum(rec_len)[:-1]])
    out = np.empty(int(rec_len.sum()), np.uint8)
    out[start[:, None] + np.arange(head.shape[1])] = head
    cols = np.arange(bc.shape[1])
    keep = cols[None, :] < width[:, None]
    out[(start[:, None] + head.shape[1] + cols)[keep]] = bc[keep]
    out[(start + head.shape[1] + width)[:, None]
        + np.arange(tail.shape[1])] = tail
    return out.tobytes()
