"""Plain reference of stage 00 (HAST's build_unshared_kmers.sh with
--auto_bounds), written from its statement in SURVEY.md; NumPy and
PyTorch only.

* count: every k-window of a read whose k bases are all ACGT (either
  case) counts once, in canonical form (jellyfish count -C);
* histo: a row 'v n' for each count v in 1..high with n > 0 k-mers, and
  the k-mers counted more than high lumped into row high + 1 (jellyfish
  histo, high 10,000);
* bounds: find_bounds.awk walks the rows down to the first row that does
  not set a new minimum (MIN_INDEX), then takes the largest row after it
  (MAX_INDEX); LOWER = MIN_INDEX + 1, UPPER = 3 MAX_INDEX - 2 MIN_INDEX -
  1 (find_bounds.awk:26-30);
* markers of a parent: its k-mers absent from the other parent's whole
  count table, with a count in [LOWER, UPPER] (dump -L -U and the 2*mat
  + 1*pat count), one k-mer a line as jellyfish prints it: the smaller
  of the k-mer and its reverse complement in ASCII order (A < C < G <
  T); the rows here are in ascending order of the canonical words;
* the log's totals: distinct k-mers and the sum of their counts.
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

from portbench.reference.classify import canonical_words

HIGH = 10000
_CODE_BASES = np.frombuffer(b"ACTG", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
_ACGT = np.zeros(256, bool)
_ACGT[np.frombuffer(b"ACGTacgt", np.uint8)] = True


def count(reads: np.ndarray, lengths: np.ndarray, k: int, device,
          block: int = 1 << 18, count_bits: int | None = None):
    """(sorted distinct canonical words, their counts) of the reads'
    valid windows, int64 tensors on device.  count_bits: keep only the
    low bits of each count, as a narrower count would (the control)."""
    good_t = torch.from_numpy(_ACGT)
    keys = []
    n, L = reads.shape
    for s in range(0, n, block):
        r = torch.from_numpy(reads[s:s + block]).to(device)
        ln = torch.from_numpy(lengths[s:s + block].astype(np.int64)).to(
            device)
        good = good_t.to(device)[r.to(torch.int64)]
        good &= torch.arange(L, device=device)[None, :] < ln[:, None]
        P = L - k + 1
        run = good[:, :P].clone()
        for j in range(1, k):
            run &= good[:, j:j + P]
        keys.append(canonical_words((r.to(torch.int64) >> 1) & 3, k)[run])
    words, counts = torch.unique(torch.cat(keys), return_counts=True)
    if count_bits is not None:
        counts = counts & ((1 << count_bits) - 1)
        words, counts = words[counts > 0], counts[counts > 0]
    return words, counts


def histo_rows(counts: torch.Tensor, high: int = HIGH):
    bins = torch.bincount(counts.clamp(0, high + 1),
                          minlength=high + 2).cpu().numpy()
    return [(v, int(bins[v])) for v in range(1, high + 2) if bins[v] > 0]


def find_bounds(rows) -> dict:
    lo = lo_i = hi = hi_i = 0
    state = 0
    for i, c in rows:
        if state == 0:
            if lo == 0 or c < lo:
                lo, lo_i = c, i
            else:
                state = 1
        elif hi == 0 or c > hi:
            hi, hi_i = c, i
    return {"MIN_INDEX": lo_i, "MAX_INDEX": hi_i, "LOWER_INDEX": lo_i + 1,
            "UPPER_INDEX": 3 * hi_i - 2 * lo_i - 1}


def markers(words, counts, other_words, lower: int, upper: int):
    """Words of one parent absent from the other's table, count in
    [lower, upper], ascending."""
    keep = (~torch.isin(words, other_words)) & (counts >= lower) \
        & (counts <= upper)
    return words[keep]


def mer_bytes(words: torch.Tensor, k: int) -> bytes:
    w = words.cpu().numpy()
    if w.size == 0:
        return b""
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.int64)
    fwd = _CODE_BASES[(w[:, None] >> shifts) & 3]
    rc = _COMP[fwd[:, ::-1]]
    # the first base where the two differ decides which one prints
    diff = fwd != rc
    first = diff.argmax(axis=1)
    take_rc = rc[np.arange(w.size), first] < fwd[np.arange(w.size), first]
    rows = np.where(take_rc[:, None], rc, fwd)
    rows = np.concatenate([rows, np.full((w.size, 1), ord("\n"), np.uint8)],
                          axis=1)
    return rows.tobytes()


def histo_bytes(rows) -> bytes:
    return b"".join(b"%d %d\n" % r for r in rows)


def bounds_bytes(b: dict) -> bytes:
    return b"".join(b"%s=%d\n" % (key.encode(), b[key]) for key in
                    ("MIN_INDEX", "MAX_INDEX", "LOWER_INDEX", "UPPER_INDEX"))


def build(parents: dict, k: int, device, count_bits: int | None = None
          ) -> dict:
    """Stage 00 on parents {"paternal": (reads, lengths), "maternal":
    ...}: {file name: bytes} of the six files, and "totals": {parent:
    (distinct, total)}."""
    tables = {p: count(*rl, k, device, count_bits=count_bits)
              for p, rl in parents.items()}
    out = {"totals": {}}
    rows = {}
    for p, (w, c) in tables.items():
        rows[p] = histo_rows(c)
        out["totals"][p] = (int(w.numel()), int(c.sum()))
        out[f"{p}.kmercount.histo"] = histo_bytes(rows[p])
        out[f"{p}.bounds.txt"] = bounds_bytes(find_bounds(rows[p]))
    for p, other in (("paternal", "maternal"), ("maternal", "paternal")):
        b = find_bounds(rows[p])
        w, c = tables[p]
        out[f"{p}.unique.filter.mer"] = mer_bytes(markers(
            w, c, tables[other][0], b["LOWER_INDEX"], b["UPPER_INDEX"]), k)
    return out


def read_sequences(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(reads padded with 0, lengths) of a single-line fasta or a fastq
    file, gzip by its '.gz' suffix."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines and lines[0].startswith(b">"):
        seqs = lines[1::2]
    else:
        seqs = lines[1::4]
    seqs = [s.rstrip(b"\r") for s in seqs]
    L = max(k for k in map(len, seqs)) if seqs else 1
    out = np.zeros((len(seqs), L), np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = np.frombuffer(s, np.uint8)
    return out, np.array([len(s) for s in seqs], np.int64)
