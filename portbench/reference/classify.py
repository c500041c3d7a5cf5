"""Plain reference of stage 01 classify (HAST's classify.cpp), written
from its statement in SURVEY.md; NumPy and PyTorch only.

* barcode: the text between the last '#' and the last '/' of the head
  line; with no '/' after the '#', everything after the '#'
  (classify.cpp:112-119);
* a read with a literal 'N' adds 1 to its barcode's unknown count and
  does not vote (:190-192);
* every k-window of a read is coded (c >> 1) & 3 (A=0 C=1 T=2 G=3) and
  taken in canonical form, the smaller of it and its reverse complement;
  vote[h] counts the windows found in marker set h, and a window may be
  in both (:186-209); the adaptor k-mers are erased from both sets first
  and the sizes shrink with them (InitAdaptor, :314-339);
* per barcode the votes add up, and getHap decides in double precision
  (:66-86): a null barcode (0, 0_0, 0_0_0) is -1; with both counts
  present, c_h / |set_h| * weight_h compared, the strictly larger wins,
  a tie is -1; with one present, its haplotype; none, -1;
* rows 'barcode\\thap\\tc0\\tc1' in bytewise barcode order (:93-102).
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

NULL_BARCODES = (b"0_0_0", b"0_0", b"0")


def canonical_words(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(n, L) int64 codes -> (n, L - k + 1) canonical words."""
    P = codes.shape[1] - k + 1
    fwd = torch.zeros((codes.shape[0], P), dtype=torch.int64,
                      device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[:, j:j + P]
        fwd = (fwd << 2) | c
        rc |= (c ^ 2) << (2 * j)
    return torch.minimum(fwd, rc)


def erase(keys: torch.Tensor, adaptor: np.ndarray) -> torch.Tensor:
    """A sorted key set without the adaptor k-mers."""
    a = torch.from_numpy(np.asarray(adaptor, np.int64)).to(keys.device)
    return keys[~torch.isin(keys, a)]


def member(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if sorted_keys.numel() == 0:
        return torch.zeros_like(q, dtype=torch.bool)
    i = torch.searchsorted(sorted_keys, q).clamp(max=sorted_keys.numel() - 1)
    return sorted_keys[i] == q


def votes(reads: np.ndarray, lengths: np.ndarray, k: int,
          set0: torch.Tensor, set1: torch.Tensor,
          block: int = 1 << 18) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(v0, v1, has_n) a read: reads (n, L) uint8 ASCII, padded past
    lengths; set0 and set1 sorted int64 on the device that computes."""
    dev = set0.device
    n, L = reads.shape
    v0 = np.zeros(n, np.int64)
    v1 = np.zeros(n, np.int64)
    has_n = (reads == ord("N")) & (np.arange(L)[None, :]
                                   < lengths[:, None])
    has_n = has_n.any(axis=1)
    if L < k:
        return v0, v1, has_n
    for s in range(0, n, block):
        r = torch.from_numpy(reads[s:s + block]).to(dev)
        ln = torch.from_numpy(lengths[s:s + block].astype(np.int64)).to(dev)
        w = canonical_words((r.to(torch.int64) >> 1) & 3, k)
        inside = (torch.arange(w.shape[1], device=dev)[None, :] + k
                  <= ln[:, None])
        v0[s:s + block] = ((member(set0, w) & inside).sum(1)).cpu().numpy()
        v1[s:s + block] = ((member(set1, w) & inside).sum(1)).cpu().numpy()
    v0[has_n] = 0
    v1[has_n] = 0
    return v0, v1, has_n


def tally(read_bc: np.ndarray, v0: np.ndarray, v1: np.ndarray,
          n_names: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-barcode sums of the haplotype votes (the unknown bucket is not
    printed)."""
    c0 = np.bincount(read_bc, weights=v0, minlength=n_names)
    c1 = np.bincount(read_bc, weights=v1, minlength=n_names)
    return np.rint(c0).astype(np.int64), np.rint(c1).astype(np.int64)


def decide(c0: np.ndarray, c1: np.ndarray, size0: int, size1: int,
           w0: float, w1: float, dtype=np.float64) -> np.ndarray:
    """getHap for non-null barcodes, its arithmetic in dtype."""
    with np.errstate(divide="ignore", invalid="ignore"):
        d0 = (c0.astype(dtype) / dtype(size0)) * dtype(w0)
        d1 = (c1.astype(dtype) / dtype(size1)) * dtype(w1)
    hap = np.full(c0.shape, -1, np.int64)
    both = (c0 > 0) & (c1 > 0)
    hap[both & (d0 > d1)] = 0
    hap[both & (d1 > d0)] = 1
    hap[(c0 > 0) & (c1 == 0)] = 0
    hap[(c1 > 0) & (c0 == 0)] = 1
    return hap


def phased_bytes(names: np.ndarray, read_bc: np.ndarray, v0, v1,
                 size0: int, size1: int, w0: float, w1: float,
                 dtype=np.float64) -> bytes:
    """The phased.barcodes text of reads whose barcode is names[read_bc]:
    every barcode that has a read, in bytewise order."""
    uniq, inv = np.unique(names, return_inverse=True)
    seen = np.zeros(uniq.size, bool)
    seen[inv[read_bc]] = True
    c0, c1 = tally(inv[read_bc], v0, v1, uniq.size)
    hap = decide(c0, c1, size0, size1, w0, w1, dtype)
    hap[np.isin(uniq, np.array(NULL_BARCODES, uniq.dtype))] = -1
    rows = np.flatnonzero(seen)
    return b"".join(b"%s\t%d\t%d\t%d\n" % (uniq[i], hap[i], c0[i], c1[i])
                    for i in rows.tolist())


# ---------------------------------------------------------------------------
# text inputs (the goldens)
# ---------------------------------------------------------------------------


def parse_barcode(head: bytes) -> bytes:
    s = head.rfind(b"#")
    e = head.rfind(b"/")
    return head[s + 1:e] if e > s else head[s + 1:]


def read_fastq(path: str) -> tuple[list[bytes], list[bytes]]:
    """(barcodes, sequences) of a fastq file, gzip by its '.gz' suffix."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    heads = lines[0::4]
    seqs = lines[1::4]
    n = min(len(heads), len(seqs))
    pairs = [(h.rstrip(b"\r"), s.rstrip(b"\r"))
             for h, s in zip(heads[:n], seqs[:n]) if h]
    return [parse_barcode(h) for h, _ in pairs], [s for _, s in pairs]


def read_mer(path: str) -> tuple[np.ndarray, int]:
    """Sorted distinct canonical words of a one-k-mer-a-line file; k is
    the first line's length."""
    with open(path, "rb") as f:
        lines = [x for x in f.read().split(b"\n") if x]
    k = len(lines[0])
    rows = np.frombuffer(b"".join(lines), np.uint8).reshape(len(lines), k)
    codes = torch.from_numpy((rows.astype(np.int64) >> 1) & 3)
    return np.unique(canonical_words(codes, k)[:, 0].numpy()), k


def pad(seqs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    L = max(1, max((len(s) for s in seqs), default=1))
    out = np.zeros((len(seqs), L), np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = np.frombuffer(s, np.uint8)
    return out, np.array([len(s) for s in seqs], np.int64)


def classify_files(hap0: str, hap1: str, fastqs: list[str],
                   adaptors: tuple[str, str], w0: float, w1: float = 1.0,
                   dtype=np.float64) -> bytes:
    """The phased.barcodes text of the reference binary on these files."""
    set0, k = read_mer(hap0)
    set1, _ = read_mer(hap1)
    adapt = np.unique(np.concatenate([
        canonical_words(torch.from_numpy(
            (np.frombuffer(a.encode(), np.uint8).astype(np.int64)[None]
             >> 1) & 3), k)[0].numpy() for a in adaptors if len(a) >= k]))
    s0 = erase(torch.from_numpy(set0), adapt)
    s1 = erase(torch.from_numpy(set1), adapt)
    bcs, seqs = [], []
    for path in fastqs:
        b, s = read_fastq(path)
        bcs += b
        seqs += s
    reads, lengths = pad(seqs)
    v0, v1, _ = votes(reads, lengths, k, s0, s1)
    names = np.array(bcs, dtype=bytes)
    return phased_bytes(names, np.arange(names.size), v0, v1, s0.numel(),
                        s1.numel(), w0, w1, dtype)
