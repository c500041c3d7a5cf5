"""One seeded stLFR library and its two marker sets, from the parameters
of a configuration and a traffic mix (a rewrite of
``hast_tpu_torch/utils/synthetic.py`` ``make_marker_files`` and
``make_stlfr_fastq`` to the traffic a human-trio library has).

Marker sets: ``markers_per_haplotype`` random distinct canonical k-mers
for haplotype 0 and ``hap1_extra_markers`` more for haplotype 1, drawn
on the device in a few large calls; both sets also hold every adaptor
k-mer, which classify erases (``InitAdaptor``), so that the sizes it
divides by are exactly the drawn counts.

Reads: ``read_pairs`` pairs of ``read_len``-bp reads in sequencer
order.  Read pairs a barcode are geometric with mean
``pairs_per_barcode_mean``; each barcode has a haplotype, and a share
``mixed_barcode_share`` of them draws each pair's molecule from either.
A read carries one k-mer of its molecule's haplotype set with
probability ``marker_read_share``, in either orientation; a share
``adaptor_read_share`` carries an adaptor stretch, ``n_read_share`` an N,
and a share ``null_barcode_share`` of the barcodes is one of the null
barcodes ``0_0_0``, ``0_0``, ``0``.  ``near_tie_barcodes`` barcodes hold
exactly c0 haplotype-0 and c1 haplotype-1 marker reads, with (c0, c1)
chosen so that the weighted decision in float64 differs from the same
decision in float32: what a narrower decision would get wrong.
"""

from __future__ import annotations

import io
import os

import numpy as np
import torch

from portbench.gen import common as G

NULL_BARCODES = (b"0_0_0", b"0_0", b"0")
BARCODE_PART = 1536          # stLFR barcodes: three of 1,536 sequences


def adaptor_keys(adaptors, k: int) -> np.ndarray:
    """Sorted distinct canonical words of every k-window of the adaptors."""
    words = [G.canonical_words_np(np.frombuffer(a.encode(), np.uint8)[None],
                                  k)[0] for a in adaptors if len(a) >= k]
    return np.unique(np.concatenate(words)) if words else \
        np.zeros(0, np.int64)


def marker_sets(cfg: dict, seed: int, device) -> dict:
    """Two disjoint sets of random distinct canonical k-mers (sorted int64
    tensors on device), none of them an adaptor k-mer, and the adaptor
    keys (numpy)."""
    k = cfg["k"]
    n0 = cfg["markers_per_haplotype"]
    n1 = n0 + cfg["hap1_extra_markers"]
    adapt = adaptor_keys((cfg["adaptor_f"], cfg["adaptor_r"]), k)
    g = torch.Generator(device=device)
    g.manual_seed(G.stream_seed(seed, "markers"))
    need = n0 + n1
    draw = need + need // 64 + 4096
    keys = G.canonical_t(torch.randint(0, 4 ** k, (draw,), generator=g,
                                       device=device), k)
    keys = torch.unique(keys)
    keys = keys[~torch.isin(keys, torch.from_numpy(adapt).to(device))]
    if keys.numel() < need:
        raise RuntimeError(f"drew {keys.numel()} distinct keys of {need}")
    keys = keys[torch.randperm(keys.numel(), generator=g, device=device)
                [:need]]
    return {"hap0": torch.sort(keys[:n0]).values,
            "hap1": torch.sort(keys[n0:]).values, "adaptor": adapt}


def near_tie_counts(size0: int, size1: int, w0: float, w1: float,
                    limit: int = 16) -> list[tuple[int, int]]:
    """(c0, c1) pairs near c0 * w0 / size0 = c1 * w1 / size1 whose float64
    and float32 getHap decisions differ, fewest reads first."""
    from portbench.reference.classify import decide
    pairs = []
    for c0 in range(1, 200):
        c1 = round(c0 * w0 * size1 / (w1 * size0))
        if c1 < 1:
            continue
        a = decide(np.array([c0]), np.array([c1]), size0, size1, w0, w1,
                   np.float64)
        b = decide(np.array([c0]), np.array([c1]), size0, size1, w0, w1,
                   np.float32)
        if a[0] != b[0]:
            pairs.append((c0, c1))
        if len(pairs) == limit:
            break
    if not pairs:
        raise ValueError("no near-tie counts for these set sizes and weights")
    return pairs


def _barcode_names(rng, n: int) -> np.ndarray:
    """n distinct a_b_c barcodes, a, b, c in [1, BARCODE_PART]."""
    space = BARCODE_PART ** 3
    idx = np.unique(rng.integers(0, space, n + n // 8 + 64))
    idx = rng.permutation(idx)[:n]
    if idx.size < n:
        raise RuntimeError("too few distinct barcodes drawn")
    a, rest = np.divmod(idx, BARCODE_PART ** 2)
    b, c = np.divmod(rest, BARCODE_PART)
    return np.array([b"%d_%d_%d" % t for t in
                     zip((a + 1).tolist(), (b + 1).tolist(),
                         (c + 1).tolist())], dtype="S14")


def make_library(cfg: dict, traffic: dict, seed: int, sets: dict,
                 out_dir: str) -> dict:
    """Write the R1 and R2 fastq files (plain or gzip, as the traffic
    says) and return the arrays the reference needs: reads (2P, L) uint8
    ASCII, R1 rows then R2 rows; bc (2P,) int32 into names; names, the
    barcode strings; paths."""
    rng = np.random.default_rng(G.stream_seed(seed, "library"))
    k, L, P = cfg["k"], cfg["read_len"], cfg["read_pairs"]
    w0, w1 = cfg["weight0"], cfg["weight1"]
    s0, s1 = sets["hap0"].numel(), sets["hap1"].numel()

    # barcodes: near ties first, then geometric sizes until P pairs
    n_tie = traffic["near_tie_barcodes"]
    ties = near_tie_counts(s0, s1, w0, w1) if n_tie else []
    tie_c = [ties[i % len(ties)] for i in range(n_tie)]
    tie_pairs = [-(-(c0 + c1) // 2) + 1 for c0, c1 in tie_c]
    rest = P - sum(tie_pairs)
    mean = traffic["pairs_per_barcode_mean"]
    sizes = rng.geometric(1.0 / mean, rest // mean * 2 + 1024)
    cut = int(np.searchsorted(np.cumsum(sizes), rest))
    sizes = sizes[:cut + 1]
    sizes[-1] -= int(sizes.sum()) - rest
    sizes = np.concatenate([tie_pairs, sizes]).astype(np.int64)
    n_bc = sizes.size
    names = _barcode_names(rng, n_bc)
    null = np.flatnonzero(rng.random(n_bc) < traffic["null_barcode_share"])
    null = null[null >= n_tie]
    names[null] = np.array(NULL_BARCODES, "S14")[
        rng.integers(0, len(NULL_BARCODES), null.size)]
    bc_hap = rng.integers(0, 2, n_bc)
    mixed = rng.random(n_bc) < traffic["mixed_barcode_share"]
    mixed[:n_tie] = False

    # pairs in sequencer order: barcodes interleaved
    pair_bc = rng.permutation(np.repeat(np.arange(n_bc), sizes))
    pair_hap = np.where(mixed[pair_bc], rng.integers(0, 2, P),
                        bc_hap[pair_bc])
    bc = np.concatenate([pair_bc, pair_bc]).astype(np.int32)
    hap = np.concatenate([pair_hap, pair_hap])

    # random bases, then the marker reads
    reads = G.BASES[rng.integers(0, 4, (2 * P, L), dtype=np.uint8)]
    marker = rng.random(2 * P) < traffic["marker_read_share"]
    in_tie = bc < n_tie
    marker[in_tie] = False
    tie_rows = np.flatnonzero(in_tie)
    tie_rows = tie_rows[np.argsort(bc[tie_rows], kind="stable")]
    starts = np.concatenate([[0], np.cumsum(2 * np.asarray(tie_pairs))])
    for i, (c0, c1) in enumerate(tie_c):
        rows = tie_rows[starts[i]:starts[i + 1]]
        marker[rows[:c0 + c1]] = True
        hap[rows[:c0]] = 0
        hap[rows[c0:c0 + c1]] = 1
    for h in (0, 1):
        rows = np.flatnonzero(marker & (hap == h))
        keys = sets[f"hap{h}"]
        pick = torch.from_numpy(rng.integers(0, keys.numel(), rows.size))
        words = keys[pick.to(keys.device)].cpu().numpy()
        G.plant(rng, reads, rows, G.words_to_bytes(words, k))

    # adaptor stretches and N bases, away from the near-tie barcodes
    free = ~in_tie
    rows = np.flatnonzero(free & (rng.random(2 * P)
                                  < traffic["adaptor_read_share"]))
    adaptors = [np.frombuffer(a.encode(), np.uint8)
                for a in (cfg["adaptor_f"], cfg["adaptor_r"])]
    span = min(L, min(a.size for a in adaptors))
    which = rng.integers(0, 2, rows.size)
    frag = np.stack([adaptors[w][:span] for w in which]) if rows.size else \
        np.zeros((0, span), np.uint8)
    G.plant(rng, reads, rows, frag, flip=False)
    rows = np.flatnonzero(free & (rng.random(2 * P)
                                  < traffic["n_read_share"]))
    reads[rows, rng.integers(0, L, rows.size)] = ord("N")

    suffix = ".fq.gz" if traffic["compression"] == "gzip" else ".fq"
    paths = [os.path.join(out_dir, f"library_R{m}{suffix}") for m in (1, 2)]
    _write_pairs(paths, reads, names, pair_bc, traffic)
    return {"reads": reads, "bc": bc, "names": names, "paths": paths,
            "near_ties": n_tie}


def _write_pairs(paths, reads, names, pair_bc, traffic) -> None:
    """R1 and R2 files, '@V<index>#<barcode>/<mate>' heads; gzip files
    are one member each, deflated on several threads."""
    P = pair_bc.size
    for mate, path in zip((1, 2), paths):
        args = (b"V", np.arange(P), names[pair_bc], b"/%d" % mate,
                reads[(mate - 1) * P: mate * P])
        if traffic["compression"] == "gzip":
            buf = io.BytesIO()
            G.write_fastq(buf, *args)
            with open(path, "wb") as f:
                f.write(G.gzip_member(buf.getbuffer(),
                                      traffic["gzip_level"]))
        else:
            with open(path, "wb", buffering=1 << 22) as f:
                G.write_fastq(f, *args)
