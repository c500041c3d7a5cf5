"""Two parents' paired-end libraries of a diploid segment, each as two
gzipped fastq files, R1 and R2, from the parameters of a configuration.

The genome and the haplotypes are those of ``gen/parents.py`` for the
same seed (its ``backbone`` and ``haplotype`` on the same random
streams).  Each parent's ``genome_length * coverage / read_len`` reads
come as half as many fragments, each from either haplotype at a uniform
offset, of a length drawn from N(``insert_mean``, ``insert_sd``) and
clipped to [read_len, the haplotype's length], on either strand.  R1 is
the fragment's first read_len bases, R2 the reverse complement of its
last read_len bases; substitution errors fall at ``error_rate`` a base,
as in ``parents.shotgun``.  Each file is one gzip member at
``gzip_level``.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.gen import common as G
from portbench.gen import parents as P

PARENTS = P.PARENTS


def fragments(rng, size: int, n: int, L: int, mean: float, sd: float):
    """(which haplotype, start, length, minus strand) of n fragments of
    a haplotype of size bases."""
    which = rng.integers(0, 2, n)
    length = np.clip(np.rint(rng.normal(mean, sd, n)), L, size).astype(
        np.int64)
    start = rng.integers(0, size - length + 1)
    minus = rng.random(n) < 0.5
    return which, start, length, minus


def read_pairs(rng, haps, n: int, cfg: dict) -> tuple:
    """(R1, R2): two (n, read_len) uint8 arrays, row i of each from
    fragment i."""
    L = cfg["read_len"]
    which, start, length, minus = fragments(
        rng, haps[0].size, n, L, cfg["insert_mean"], cfg["insert_sd"])
    first = np.empty((n, L), np.uint8)
    last = np.empty((n, L), np.uint8)
    for i, h in enumerate(haps):
        rows = np.flatnonzero(which == i)
        first[rows] = h[start[rows, None] + np.arange(L)]
        last[rows] = h[(start + length)[rows, None] - L + np.arange(L)]
    # a plus-strand fragment reads its first bases in R1 and the reverse
    # complement of its last in R2; a minus-strand one, the reverse
    # complement of the plus strand, the other way about
    r1 = np.where(minus[:, None], G.revcomp_rows(last), first)
    r2 = np.where(minus[:, None], first, G.revcomp_rows(last))
    both = np.concatenate([r1, r2])
    flat = both.reshape(-1)
    P._substitute(rng, flat, P._positions(rng, flat.size, cfg["error_rate"]))
    return both[:n], both[n:]


def make_parents(cfg: dict, seed: int, out_dir: str) -> dict:
    """Write <parent>_1.fq.gz and <parent>_2.fq.gz for both parents;
    return {parent: ((path_1, path_2), reads)} with reads (2n, read_len)
    uint8 ASCII, R1's rows and then R2's."""
    if cfg["compression"] != "gzip" or cfg["files_per_parent"] != 2:
        raise ValueError("paired libraries come as two gzipped files")
    rng = np.random.default_rng(G.stream_seed(seed, "genome"))
    base = P.backbone(cfg, rng)
    n = int(cfg["genome_length"] * cfg["coverage"] / cfg["read_len"]) // 2
    out = {}
    for p in PARENTS:
        prng = np.random.default_rng(G.stream_seed(seed, p))
        haps = [P.haplotype(prng, base, cfg["snp_rate"]) for _ in range(2)]
        r1, r2 = read_pairs(prng, haps, n, cfg)
        paths = []
        for mate, reads in ((1, r1), (2, r2)):
            path = os.path.join(out_dir, f"{p}_{mate}.fq.gz")
            with open(path, "wb") as f:
                f.write(G.gzip_member(G.fastq_bytes(
                    b"r", np.arange(n), None, b"/%d" % mate, reads),
                    cfg["gzip_level"]))
            paths.append(path)
        out[p] = (tuple(paths), np.concatenate([r1, r2]))
    return out
