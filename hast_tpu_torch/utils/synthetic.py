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
* :func:`make_pseudohap2_assembly`: a Supernova pseudohap2 assembly
  (two fastas and their .idx) of scaffolds alternating homozygous and
  phased spans, with marker files drawn from the phased branches, the
  stage-03 input at scale (the shape of scripts/make_golden_stage03.py's
  fixture).
* :func:`write_fake_supernova`: a stand-in Supernova install that hands
  out a given pseudohap2 assembly, for driving ``run`` without the real
  one.
* :func:`sort_edge_cases`, :func:`marker_edge_cases`,
  :func:`window_edge_reads`, :func:`barcode_sorted_ids` and
  :func:`read_tile_edge_batches`: the inputs that K5's look-back sort,
  K8's merge-path filter, K4's rolled windows, K15's warp-aggregated
  tally and the read tiles of K3 and K13 could get wrong.
"""

from __future__ import annotations

import os
import shutil

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


def _fasta_record(head: bytes, seq: np.ndarray, width: int = 60) -> bytes:
    """'>head' and seq wrapped at width columns, newline-terminated."""
    rows = seq.size // width
    body = np.concatenate([seq[:rows * width].reshape(rows, width),
                           np.full((rows, 1), ord("\n"), np.uint8)], axis=1)
    parts = [b">" + head + b"\n", body.tobytes()]
    if seq.size % width:
        parts += [seq[rows * width:].tobytes(), b"\n"]
    return b"".join(parts)


def make_pseudohap2_assembly(seed: int, out_dir: str, paternal_mer: str,
                             maternal_mer: str, n_scaffolds: int = 2000,
                             phased_bases: int = 100_000_000,
                             n_markers: int = 10_000_000, k: int = 21,
                             span: tuple[int, int] = (1000, 100_000),
                             prefix: str = "output") -> dict:
    """Write ``<prefix>.{1,2}.fasta`` and ``.idx`` into out_dir and the
    two marker files; return counts of what was made.

    Phased spans of branch 1 have lengths drawn from ``span`` until they
    total phased_bases; branch 2's differ by up to 100 bases.  They are
    dealt over the scaffolds at random (a scaffold with none is a single
    homozygous span), and every scaffold alternates homozygous and phased
    spans, homozygous first and last.  Sequence is random ACGT; one
    homozygous span in ten holds a run of 100 N and one phased span in a
    hundred a run of 50 N.  Each scaffold flips a coin for which branch is
    paternal, and each phased span falls in one of five cases so that
    every branch of MergePhaseResult is taken: 80 % carry markers of their
    own parent on each branch, 5 % none on either, 5 % only on branch 1,
    5 % only on branch 2, and 5 % markers of one parent on both branches.
    n_markers distinct-position k-mers per parent are drawn from the
    branches assigned to it (windows with an N are skipped), each line in
    a random orientation.
    """
    rng = np.random.default_rng(seed)
    lo, hi = span
    lens1 = []
    total = 0
    while total < phased_bases:
        n = min(int(rng.integers(lo, hi + 1)), max(phased_bases - total, k))
        lens1.append(n)
        total += n
    lens1 = np.array(lens1, np.int64)
    n_spans = lens1.size
    lens2 = np.maximum(lens1 + rng.integers(-100, 101, n_spans), k)
    owner = np.sort(rng.integers(0, n_scaffolds, n_spans))
    per_scaffold = np.bincount(owner, minlength=n_scaffolds)
    n_homo = per_scaffold + 1
    homo_lens = rng.integers(lo, hi + 1, int(n_homo.sum()))

    def rand_seq(n):
        return BASES[rng.integers(0, 4, n, dtype=np.uint8)]

    homo = rand_seq(int(homo_lens.sum()))
    branch = [rand_seq(int(lens1.sum())), rand_seq(int(lens2.sum()))]
    homo_off = np.concatenate([[0], np.cumsum(homo_lens)])
    offs = [np.concatenate([[0], np.cumsum(x)]) for x in (lens1, lens2)]
    for i in np.flatnonzero(rng.random(homo_lens.size) < 0.1):
        p = homo_off[i] + int(rng.integers(0, homo_lens[i] - 100))
        homo[p:p + 100] = ord("N")
    for b, lens in enumerate((lens1, lens2)):
        for i in np.flatnonzero((rng.random(n_spans) < 0.01)
                                & (lens > 100)):
            p = offs[b][i] + int(rng.integers(0, lens[i] - 50))
            branch[b][p:p + 50] = ord("N")

    # parent of each (span, branch): 0 paternal, 1 maternal, -1 none
    pat_branch = rng.integers(0, 2, n_scaffolds)[owner]
    parent = np.stack([pat_branch, 1 - pat_branch], axis=1)
    case = rng.random(n_spans)
    parent[(case >= 0.80) & (case < 0.85)] = -1
    parent[(case >= 0.85) & (case < 0.90), 1] = -1
    parent[(case >= 0.90) & (case < 0.95), 0] = -1
    same = case >= 0.95
    parent[same] = rng.integers(0, 2, int(same.sum()))[:, None]

    paths = (paternal_mer, maternal_mer)
    for who in (0, 1):
        starts, n_win = [], []
        for b in (0, 1):
            sel = np.flatnonzero(parent[:, b] == who)
            starts.append((b, offs[b][sel]))
            n_win.append((lens1, lens2)[b][sel] - k + 1)
        seg_start = np.concatenate([s for _, s in starts])
        seg_branch = np.concatenate([np.full(s.size, b) for b, s in starts])
        cum = np.concatenate([[0], np.cumsum(np.concatenate(n_win))])
        draw = np.unique(rng.integers(0, cum[-1], int(n_markers * 1.2)))
        rng.shuffle(draw)
        with open(paths[who], "wb") as f:
            kept = 0
            for c in range(0, draw.size, 1 << 20):
                u = draw[c:c + (1 << 20)]
                seg = np.searchsorted(cum, u, side="right") - 1
                pos = seg_start[seg] + (u - cum[seg])
                rows = np.empty((u.size, k), np.uint8)
                for b in (0, 1):
                    m = seg_branch[seg] == b
                    rows[m] = branch[b][pos[m, None] + np.arange(k)]
                rows = rows[~(rows == ord("N")).any(axis=1)]
                rows = rows[:n_markers - kept]
                flip = rng.random(rows.shape[0]) < 0.5
                rows[flip] = _revcomp_rows(rows[flip])
                f.write(np.concatenate(
                    [rows, np.full((rows.shape[0], 1), ord("\n"), np.uint8)],
                    axis=1).tobytes())
                kept += rows.shape[0]
                if kept == n_markers:
                    break
        if kept != n_markers:
            raise ValueError(f"only {kept} marker positions for parent {who}")

    span_of = np.concatenate([[0], np.cumsum(per_scaffold)])
    for w, lens in ((1, lens1), (2, lens2)):
        seqs = branch[w - 1]
        with open(os.path.join(out_dir, f"{prefix}.{w}.fasta"), "wb") as fa, \
                open(os.path.join(out_dir, f"{prefix}.{w}.idx"), "w") as ix:
            h = 0
            for sid in range(n_scaffolds):
                parts = []
                for j in range(per_scaffold[sid] + 1):
                    parts.append(homo[homo_off[h]:homo_off[h + 1]])
                    h += 1
                    if j < per_scaffold[sid]:
                        i = span_of[sid] + j
                        parts.append(seqs[offs[w - 1][i]:offs[w - 1][i + 1]])
                coords = np.concatenate([[0], np.cumsum([p.size for p in
                                                         parts])])
                fa.write(_fasta_record(b"%d pseudohap2 style=%d"
                                       % (sid + 1, w), np.concatenate(parts)))
                ix.write(" ".join(str(x) for x in [sid + 1, *coords]) + "\n")
    return dict(scaffolds=n_scaffolds, phased_spans=n_spans,
                phased_bases=(int(lens1.sum()), int(lens2.sum())),
                homo_bases=int(homo_lens.sum()), markers=n_markers,
                cases={name: int(((case >= a) & (case < b)).sum())
                       for name, a, b in (("own", 0, 0.8),
                                          ("none", 0.8, 0.85),
                                          ("branch1_only", 0.85, 0.9),
                                          ("branch2_only", 0.9, 0.95),
                                          ("same_parent", 0.95, 1.0))})


# A stand-in Supernova for driving `run` and `assemble` without the real
# one: `run` makes the outs tree, `mkoutput` writes a given pseudohap2
# assembly (output.{1,2}.fasta and .idx) under the requested prefix.
FAKE_SUPERNOVA = """#!/bin/bash
set -e
cmd="$1"; shift
case "$cmd" in
  run)
    mkdir -p haplotype/outs/assembly
    ;;
  mkoutput)
    prefix=output
    for a in "$@"; do
      case "$a" in --outprefix=*) prefix="${a#--outprefix=}";; esac
    done
    for w in 1 2; do
      gzip -c "%(asm)s/output.$w.fasta" > "$prefix.$w.fasta.gz"
      cp "%(asm)s/output.$w.idx" "$prefix.$w.idx"
    done
    ;;
  *) echo "fake supernova: unknown subcommand $cmd" >&2; exit 1;;
esac
"""


def write_fake_supernova(root: str, assembly: str, whitelist: str) -> str:
    """An install tree under root that `run` and `assemble` accept: the
    stand-in executable, which hands out the assembly in directory
    `assembly`, and the 10X whitelist copied where `assemble` globs for
    it.  Returns the tree's path (the --supernova argument)."""
    sn = os.path.join(root, "supernova_install")
    bcdir = os.path.join(sn, "supernova-cs", "2.1.1", "tenkit", "lib",
                         "python", "tenkit", "barcodes")
    os.makedirs(bcdir)
    shutil.copy(whitelist,
                os.path.join(bcdir, "4M-with-alts-february-2016.txt"))
    exe = os.path.join(sn, "supernova")
    with open(exe, "w") as f:
        f.write(FAKE_SUPERNOVA % {"asm": os.path.abspath(assembly)})
    os.chmod(exe, 0o755)
    return sn


def sort_edge_cases(seed: int, k: int, tile: int, digit_bits: int = 8
                    ) -> list:
    """(name, int64 keys) that a radix sort with decoupled look-back, a
    tile-local shuffle and skipped constant digits could get wrong:
    lengths around one tile (1, tile - 1, tile, tile + 1), every key
    equal (one hot digit in every pass), every key the INT64_MAX
    sentinel, ascending and descending runs, real keys before a tail of
    more than a tile of sentinels, three distinct keys drawn many times
    (stability of equal keys), and keys that differ in one field of
    digit_bits bits only (the lowest, the second, the top one below 2k),
    so that the passes it does not reach are skipped; canonical k-mer
    words with 10 % sentinels elsewhere."""
    rng = np.random.default_rng(seed)
    sent = np.iinfo(np.int64).max
    top = 1 << (2 * k)

    def words(n):
        w = rng.integers(0, top, n, dtype=np.int64)
        w[rng.random(n) < 0.1] = sent
        return w

    n = 5 * tile + 3
    cases = [(f"random n={m}", words(m))
             for m in (1, tile - 1, tile, tile + 1)]
    cases += [("all equal", np.full(n, rng.integers(0, top), np.int64)),
              ("all sentinels", np.full(n, sent, np.int64)),
              ("sorted", np.sort(words(n))),
              ("reverse sorted", np.sort(words(n))[::-1].copy())]
    real = rng.integers(0, top, n - tile - 5, dtype=np.int64)
    cases.append(("sentinel tail",
                  np.concatenate([real, np.full(tile + 5, sent, np.int64)])))
    cases.append(("three keys", rng.choice(
        rng.integers(0, top, 3, dtype=np.int64), n)))
    base = int(rng.integers(0, top))
    for shift in sorted({0, digit_bits, (2 * k - 1) // digit_bits
                         * digit_bits}):
        width = min(digit_bits, 2 * k - shift)
        mask = ((1 << width) - 1) << shift
        cases.append((f"one digit at bit {shift}", (base & ~mask) | (
            rng.integers(0, 1 << width, n, dtype=np.int64) << shift)))
    return cases


def _count_run(rng, keys: np.ndarray, pads: int):
    """(keys, counts, n_valid) of a count table: ascending keys with
    counts 1-11, then `pads` INT64_MAX rows of count 0."""
    sent = np.iinfo(np.int64).max
    return (np.concatenate([keys, np.full(pads, sent, np.int64)]),
            np.concatenate([rng.integers(1, 12, keys.size),
                            np.zeros(pads, np.int64)]).astype(np.int32),
            keys.size)


def marker_edge_cases(seed: int, tile: int, n_tiles: int = 4) -> list:
    """(name, a, b) where a and b are (keys int64, counts int32, n_valid)
    count tables, that a marker filter over tiles of `tile` rows of the
    merged order could get wrong: a shared key (an a row, then the equal b
    row) ending at, straddling or starting at every multiple of tile / 2
    in the merged order; a_n = 0, b_n = 0 or both; every key shared; none
    shared; a and b the very same arrays; runs of unequal length.  Keys
    are distinct 21-mer words, each run padded with 1-40 sentinel rows.
    About n_tiles * tile merged rows a case."""
    rng = np.random.default_rng(seed)
    m = n_tiles * tile + tile // 3

    def words(n):
        w = np.unique(rng.integers(0, 1 << 42, n + n // 8 + 16,
                                   dtype=np.int64))
        return np.sort(rng.choice(w, n, replace=False))

    def pads():
        return int(rng.integers(1, 41))

    def pairs_at(offset):
        # walk the merged order: a shared key takes two rows (a, then b)
        # starting at each multiple of tile / 2 plus offset; every other
        # key is a's or b's
        starts = {t + offset for t in range(tile // 2, m, tile // 2)}
        keys = words(m)
        a, b, pos = [], [], 0
        for key in keys:
            if pos >= m:
                break
            if pos in starts:
                a.append(key)
                b.append(key)
                pos += 2
            else:
                (a if rng.random() < 0.5 else b).append(key)
                pos += 1
        a, b = np.array(a, np.int64), np.array(b, np.int64)
        return _count_run(rng, a, pads()), _count_run(rng, b, pads())

    empty = np.zeros(0, np.int64)
    shared = words(m // 2)
    merged = words(m)
    same = _count_run(rng, words(m // 2), pads())
    long_a = words(3 * m // 4)
    return [
        ("shared pairs ending at each edge", *pairs_at(-2)),
        ("shared pairs across each edge", *pairs_at(-1)),
        ("shared pairs starting at each edge", *pairs_at(0)),
        ("a_n = 0", _count_run(rng, empty, pads()),
         _count_run(rng, words(m // 2), pads())),
        ("b_n = 0", _count_run(rng, words(m // 2), pads()),
         _count_run(rng, empty, pads())),
        ("a_n = b_n = 0", _count_run(rng, empty, pads()),
         _count_run(rng, empty, pads())),
        ("every key shared", _count_run(rng, shared, pads()),
         _count_run(rng, shared, pads())),
        ("no key shared", _count_run(rng, merged[0::2], pads()),
         _count_run(rng, merged[1::2], pads())),
        ("a and b the same arrays", same, same),
        ("unequal lengths", _count_run(rng, long_a, pads()),
         _count_run(rng, np.union1d(long_a[::7], words(m // 8)), pads())),
    ]


def window_edge_reads(seed: int, k: int, lp: int, n: int = 64):
    """(seqs (n, 4*lp) uint8 ASCII, zero past each length; lengths (n,)
    int32) whose windows a rolled-window counter could get wrong: lengths
    0, k - 1, k and 4*lp first, then random ones; an N at the first and
    at the last base of a window, and bases in both cases, elsewhere 1 %
    N."""
    rng = np.random.default_rng(seed)
    L = 4 * lp
    letters = np.frombuffer(b"ACGTacgt", np.uint8)
    seqs = letters[rng.integers(0, letters.size, (n, L))]
    seqs[rng.random((n, L)) < 0.01] = ord("N")
    lengths = rng.integers(k, L + 1, n).astype(np.int32)
    lengths[:4] = (0, k - 1, k, L)
    for r in range(4, n):
        p = int(rng.integers(0, max(lengths[r] - k + 1, 1)))
        seqs[r, p] = ord("N")                        # first base of window p
        if p + 2 * k - 1 < L:
            seqs[r, p + 2 * k - 1] = ord("N")        # last of window p + k
    seqs[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return seqs, lengths


def peaked_counts(seed: int, n: int, high: int) -> np.ndarray:
    """(n,) int32 counts shaped as a k-mer count table's: about 30 % count
    1 (sequencing errors), Poisson(26) for the rest (the coverage peak of
    a 33x sample), 1 % above high, and the table's last tenth pads of 0."""
    rng = np.random.default_rng(seed)
    c = np.where(rng.random(n) < 0.3, 1, rng.poisson(26, n))
    above = rng.random(n) < 0.01
    c[above] = rng.integers(high + 1, 4 * high + 2, int(above.sum()))
    c[n - n // 10:] = 0
    return c.astype(np.int32)


def count_stats_edge_cases(seed: int, high: int, n: int = 4099) -> dict:
    """{name: (m,) int32 counts}, the same names for any arguments, that a
    histogram over 16-byte loads, lane-private low bins and a shared
    histogram of the rest could get wrong: no count, one count, 4,099 (a
    partial int4 and a scalar tail), the values -1, 0, 1, high, high + 1
    and 2^31 - 1 among peaked ones, every count equal (in bin 1, at the
    peak, 26, and in the middle, high / 2), and n peaked counts
    (peaked_counts)."""
    rng = np.random.default_rng(seed)
    edge = np.array([-1, 0, 1, high, high + 1, 2**31 - 1], np.int64)
    mixed = peaked_counts(seed + 1, n, high)
    at = rng.random(n) < 0.2
    mixed[at] = edge[rng.integers(0, edge.size, int(at.sum()))]
    return {"n0": np.zeros(0, np.int32),
            "n1": np.array([high], np.int32),
            "n4099": peaked_counts(seed + 2, 4099, high),
            "edge_values": mixed,
            "all_equal_1": np.ones(n, np.int32),
            "all_equal_peak": np.full(n, min(26, high + 1), np.int32),
            "all_equal_mid": np.full(n, max(high // 2, 1), np.int32),
            "peaked": peaked_counts(seed + 3, n, high)}


def barcode_sorted_ids(seed: int, n: int, num_barcodes: int) -> np.ndarray:
    """(n,) int32 barcode ids in runs of 20-60 reads a barcode, as stLFR
    fastqs hold them, ascending (mod num_barcodes), with about 1 % of ids
    -1 and 1 % past the tally inside the runs."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(20, 61, n // 20 + 1)
    bars = np.cumsum(rng.integers(1, 3, runs.size)) % num_barcodes
    ids = np.repeat(bars, runs)[:n].astype(np.int32)
    ids[rng.random(n) < 0.01] = -1
    ids[rng.random(n) < 0.01] = num_barcodes + 3
    return ids


# the read tiles of K3 and K13 (csrc/reads.cuh; ops/_build.py
# read_tile_geometry reads them from the library): windows a tile, whole
# rows a tile at most, the most windows a long-form warp votes alone, and
# reads a long-form block takes
READ_TILE_GEOMETRY = (2048, 128, 256, 8)
READ_TILE, READ_TILE_ROWS, READ_WARP_TILE, READ_GROUP = READ_TILE_GEOMETRY
# read_tile_edge_batches' strides in packed bytes: under k bases, 100-104,
# 112 and 120 bases, 1,024 bases, just past one tile's windows (2,080
# bases), and the native paths' len_cap 8,192 and 65,536
READ_EDGE_STRIDES = (1, 25, 26, 28, 30, 256, 520, 2048, 16384)
# those the CPU tests take against JAX, whose compile grows with the row:
# under k bases, rows off 4-byte alignment, the main path's 28 bytes, and
# the long form
READ_EDGE_STRIDES_CPU = (1, 25, 28, 520)
EDGE_BYTES = np.frombuffer(b"ACGTACGTACGTACGTaNRU", np.uint8)


def read_tile_edge_batches(seed: int, k: int, lp: int, key_words,
                           cap: int = 512, tile: int = READ_TILE,
                           max_rows: int = READ_TILE_ROWS,
                           warp_tile: int = READ_WARP_TILE) -> list:
    """[(name, seqs (n, 4*lp) uint8 ASCII, lengths (n,) int32, ids (n,)
    int32, has_n (n,) uint8)] whose votes a read-tile kernel could get
    wrong, for rows of lp packed bytes (4*lp ASCII bytes).

    The reads mix A, C, G, T with a, N, R and U bytes and carry table
    keys (key_words) at their first and last window and at random
    places.  Where a tile holds whole rows (4*lp - k + 1 windows a row, at
    most `tile` windows and `max_rows` rows a tile), lengths 0, 1, k - 1,
    k, k + 1, 4*lp and past 4*lp come first, then three tiles and five
    rows more, the rows about each tile edge full.  A row of more than
    `tile` windows gets, in a shuffled order, lengths 0, k - 1, k, 4*lp,
    past 4*lp, lengths whose last window falls just before, on and just
    past the first, second and last multiple of `tile`, lengths of one
    window under, at and past `warp_tile` windows, and 12 short reads of
    at most 160 bases, 100 among them.
    About 10 % of the reads have has_n set.  Two batches, the same
    reads: "sorted", barcode runs of one id (barcode_sorted_ids), and
    "distinct", a different id a read (cap at least the rows); both hold
    ids -1, cap - 1 and cap."""
    rng = np.random.default_rng(seed)
    L = 4 * lp
    n_win = L - k + 1
    rows = tile // n_win if 0 < n_win and tile // n_win < max_rows \
        else max_rows
    if n_win > tile:
        ends = [t * tile + d for t in sorted({1, 2, n_win // tile})
                for d in (-1, 0, 1)]     # index of the last window
        lengths = [0, k - 1, k, L, L + 7] + [e + k for e in ends
                                             if e + k <= L]
        lengths += [warp_tile + d + k - 1 for d in (-1, 0, 1)]
        lengths += [100, *rng.integers(0, 161, 11)]
        lengths = rng.permutation(lengths)
    else:
        n = 3 * rows + 5
        lengths = rng.integers(0, L + 1, n)
        # the rows about each tile edge are full, the odd one past 4*lp
        edges = [t * rows + d for t in (1, 2, 3) for d in (-1, 0)]
        lengths[[e for e in edges if e < n]] = L
        lengths[:7] = (0, 1, k - 1, k, k + 1, L, L + 9)
    lengths = np.asarray(lengths, np.int32)
    n = lengths.size
    seqs = EDGE_BYTES[rng.integers(0, EDGE_BYTES.size, (n, L))]
    if L >= k and key_words.size:
        kmers = E.words_to_bytes(key_words[rng.integers(
            0, key_words.size, 3 * n)], k)
        for r in range(n):
            last = min(int(lengths[r]), L) - k
            if last < 0:
                continue
            for j, p in enumerate((0, last, int(rng.integers(0, last + 1)))):
                seqs[r, p:p + k] = kmers[3 * r + j]
    has_n = (rng.random(n) < 0.1).astype(np.uint8)
    sorted_ids = barcode_sorted_ids(seed, n, cap)
    distinct = rng.permutation(cap)[:n].astype(np.int32)
    for ids in (sorted_ids, distinct):
        ids[[1, n // 2, n - 1]] = (-1, cap - 1, cap)
    return [("sorted", seqs, lengths, sorted_ids, has_n),
            ("distinct", seqs, lengths, distinct, has_n)]
