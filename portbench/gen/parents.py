"""Two parents' shotgun reads of a diploid segment, from the parameters of
a configuration (a rewrite of ``hast_tpu_torch/utils/synthetic.py``
``make_trio_genomes`` and ``make_parent_reads_vectorized`` to human
shapes, with fastq out and a satellite array in).

A random backbone of ``genome_length`` bases carries a
``satellite_unit`` array of ``satellite_length`` bases at a random
offset.  Each parent has two haplotypes, each the backbone with its own
substitutions at ``snp_rate`` a base, so that two haplotypes differ at
about twice that rate: within a parent (heterozygosity) and between
parents alike.  A parent's ``genome_length * coverage / read_len`` reads
come from either haplotype at a uniform offset, in either orientation,
with substitution errors at ``error_rate`` a base.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from portbench.gen import common as G

PARENTS = ("paternal", "maternal")


def backbone(cfg: dict, rng) -> np.ndarray:
    g = G.BASES[rng.integers(0, 4, cfg["genome_length"], dtype=np.uint8)]
    unit = np.frombuffer(cfg["satellite_unit"].encode(), np.uint8)
    n = cfg["satellite_length"]
    at = int(rng.integers(0, cfg["genome_length"] - n + 1))
    g[at:at + n] = np.resize(unit, n)
    return g


def _substitute(rng, seq: np.ndarray, pos: np.ndarray) -> None:
    """A different base at each of pos."""
    code = np.searchsorted(G.BASES, seq[pos])
    seq[pos] = G.BASES[(code + rng.integers(1, 4, pos.size)) % 4]


def haplotype(rng, base: np.ndarray, rate: float) -> np.ndarray:
    h = base.copy()
    _substitute(rng, h, _positions(rng, h.size, rate))
    return h


def _positions(rng, size: int, rate: float) -> np.ndarray:
    """Distinct positions of [0, size), each in with about rate odds."""
    return np.unique(rng.integers(0, size, rng.binomial(size, rate)))


def shotgun(rng, haps, n: int, L: int, error_rate: float) -> np.ndarray:
    """(n, L) reads from either haplotype, either strand, with errors."""
    which = rng.integers(0, len(haps), n)
    pos = rng.integers(0, haps[0].size - L + 1, n)
    reads = np.empty((n, L), np.uint8)
    for i, h in enumerate(haps):
        rows = np.flatnonzero(which == i)
        reads[rows] = h[pos[rows, None] + np.arange(L)]
    flat = reads.reshape(-1)
    _substitute(rng, flat, _positions(rng, flat.size, error_rate))
    flip = rng.random(n) < 0.5
    reads[flip] = G.revcomp_rows(reads[flip])
    return reads


def make_parents(cfg: dict, seed: int, out_dir: str) -> dict:
    """Write <parent>.fq for both parents; return {parent: (path, reads)}
    with reads (n, read_len) uint8 ASCII."""
    rng = np.random.default_rng(G.stream_seed(seed, "genome"))
    base = backbone(cfg, rng)
    L = cfg["read_len"]
    n = int(cfg["genome_length"] * cfg["coverage"] / L)
    out = {}
    for p in PARENTS:
        prng = np.random.default_rng(G.stream_seed(seed, p))
        haps = [haplotype(prng, base, cfg["snp_rate"]) for _ in range(2)]
        out[p] = (os.path.join(out_dir, f"{p}.fq"),
                  shotgun(prng, haps, n, L, cfg["error_rate"]))
    errors = []

    def write(p: str) -> None:
        try:
            path, reads = out[p]
            with open(path, "wb", buffering=1 << 22) as f:
                G.write_fastq(f, b"r", np.arange(reads.shape[0]), None, b"",
                              reads)
        except BaseException as e:   # re-raised on the caller's thread
            errors.append(e)

    t = threading.Thread(target=write, args=(PARENTS[1],))
    t.start()
    write(PARENTS[0])
    t.join()
    if errors:
        raise errors[0]
    return out
