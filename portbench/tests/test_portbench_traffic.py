"""The traffic generators: seeded, and shaped as the mixes say."""

import hashlib
import pathlib

import numpy as np
import torch

from portbench.gen import common as G
from portbench.gen import parents as P
from portbench.gen import stlfr
from portbench.reference import classify as RC
from portbench.reference import markers as RM

CFG = {"k": 21, "weight0": 1.04, "weight1": 1.0, "read_len": 100,
       "adaptor_f": "CTGTCTCTTATACACATCTTAGGAAGACAAGCACTGACGACATGA",
       "adaptor_r": "TCTGCTGAGTCGAGAACGTCTCTGTGAGCCAAGGAGTTGCTCTGG",
       "markers_per_haplotype": 50000, "hap1_extra_markers": 1,
       "read_pairs": 40000}
MIX = {"compression": "none", "pairs_per_barcode_mean": 20,
       "mixed_barcode_share": 0.1, "marker_read_share": 0.1,
       "n_read_share": 0.02, "null_barcode_share": 0.01,
       "adaptor_read_share": 0.005, "near_tie_barcodes": 0}
SEED = 2**33 + 17


def _library(tmp, seed=SEED, mix=MIX):
    sets = stlfr.marker_sets(CFG, seed, "cpu")
    lib = stlfr.make_library(CFG, mix, seed, sets, str(tmp))
    return sets, lib


def _digest(paths):
    return [hashlib.sha256(pathlib.Path(p).read_bytes()).hexdigest()
            for p in paths]


def test_the_same_seed_gives_the_same_bytes(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "c").mkdir()
    _, a = _library(tmp_path / "a")
    _, b = _library(tmp_path / "b")
    _, c = _library(tmp_path / "c", seed=SEED + 1)
    assert _digest(a["paths"]) == _digest(b["paths"])
    assert _digest(a["paths"]) != _digest(c["paths"])
    pa = P.make_parents(_PARENT_CFG, SEED, str(tmp_path / "a"))
    pb = P.make_parents(_PARENT_CFG, SEED, str(tmp_path / "b"))
    assert _digest([pa[p][0] for p in P.PARENTS]) == \
        _digest([pb[p][0] for p in P.PARENTS])


def test_library_shape(tmp_path):
    sets, lib = _library(tmp_path)
    names, bc = lib["names"], lib["bc"]
    pairs = bc.size // 2
    sizes = np.bincount(bc[:pairs])
    assert abs(sizes.mean() - 20) < 1.5          # geometric, mean 20
    assert np.array_equal(bc[:pairs], bc[pairs:])  # R1 and R2 share it
    # interleaved: consecutive pairs rarely share a barcode
    assert (bc[1:pairs] == bc[:pairs - 1]).mean() < 0.1
    null = np.isin(names, np.array(RC.NULL_BARCODES, names.dtype))
    assert 0.003 < null.mean() < 0.03
    reads = lib["reads"]
    s0 = RC.erase(sets["hap0"], sets["adaptor"])
    s1 = RC.erase(sets["hap1"], sets["adaptor"])
    v0, v1, has_n = RC.votes(reads, np.full(reads.shape[0], 100), 21, s0, s1)
    assert abs(has_n.mean() - 0.02) < 0.005
    # a read with a marker votes; N reads do not, so divide them out
    voted = ((v0 + v1) > 0).sum() / (~has_n).sum()
    assert abs(voted - 0.1) < 0.01
    # adaptor stretches hit the erased adaptor k-mers
    a = torch.from_numpy(sets["adaptor"])
    va, _, _ = RC.votes(reads, np.full(reads.shape[0], 100), 21, a, a)
    assert abs((va > 0).mean() - 0.005) < 0.002
    heads = pathlib.Path(lib["paths"][1]).read_bytes().split(b"\n")[0]
    assert heads.startswith(b"@V000000000#") and heads.endswith(b"/2")


def test_near_tie_barcodes_decide_differently_in_float32():
    pairs = stlfr.near_tie_counts(50_000_000, 50_000_001, 1.04, 1.0)
    for c0, c1 in pairs:
        c0, c1 = np.array([c0]), np.array([c1])
        assert RC.decide(c0, c1, 50_000_000, 50_000_001, 1.04, 1.0,
                         np.float64) != RC.decide(
            c0, c1, 50_000_000, 50_000_001, 1.04, 1.0, np.float32)


_PARENT_CFG = {"k": 21, "read_len": 100, "coverage": 30,
               "genome_length": 40000, "snp_rate": 0.0005,
               "error_rate": 0.002, "satellite_unit": "GGAAT",
               "satellite_length": 4000}


def _satellite_count(cfg) -> float:
    """Expected count of each of the satellite's five 21-mers: its
    windows over the reads, error-free."""
    L, k = cfg["read_len"], cfg["k"]
    return (cfg["satellite_length"] * cfg["coverage"] * (L - k + 1) / L / 5
            * (1 - cfg["error_rate"]) ** k)


def test_satellite_counts_pass_2_21_at_full_size(tmp_path):
    full = _satellite_count({**_PARENT_CFG, "satellite_length": 600000})
    assert full > 1.25 * 2 ** 21
    out = P.make_parents(_PARENT_CFG, SEED, str(tmp_path))
    reads = out["paternal"][1]
    words, counts = RM.count(reads, np.full(reads.shape[0], 100), 21, "cpu")
    unit = np.frombuffer(b"GGAAT" * 6, np.uint8)[None]
    sat = np.unique(G.canonical_words_np(unit, 21))
    assert sat.size == 5
    got = counts[torch.isin(words, torch.from_numpy(sat))].numpy()
    want = _satellite_count(_PARENT_CFG)
    assert got.size == 5 and np.all(np.abs(got / want - 1) < 0.15)
