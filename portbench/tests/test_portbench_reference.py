"""The plain references against the reference binaries' goldens."""

import pathlib

import numpy as np

from portbench.reference import classify as RC
from portbench.reference import markers as RM

GOLD = pathlib.Path(__file__).resolve().parents[2] / "tests" / "golden"
ADAPTORS = ("CTGTCTCTTATACACATCTTAGGAAGACAAGCACTGACGACATGA",
            "TCTGCTGAGTCGAGAACGTCTCTGTGAGCCAAGGAGTTGCTCTGG")


def _classify(hap0, hap1, reads, dtype=np.float64):
    g = GOLD / "stage01"
    return RC.classify_files(str(g / hap0), str(g / hap1),
                             [str(g / r) for r in reads], ADAPTORS, 1.04,
                             dtype=dtype)


def test_classify_reproduces_phased_golden():
    got = _classify("hap0.mer", "hap1.mer", ["reads1.fq.gz", "reads2.fq"])
    assert got == (GOLD / "stage01" / "phased.barcodes.golden").read_bytes()


def test_classify_reproduces_edge_k15_k31_goldens():
    for stem in ("edge", "k15", "k31"):
        got = _classify(f"{stem}.hap0.mer", f"{stem}.hap1.mer", [f"{stem}.fq"])
        want = (GOLD / "stage01" / f"{stem}.phased.golden").read_bytes()
        assert got == want, stem


def test_stage00_reproduces_histo_bounds_and_markers():
    g = GOLD / "stage00"
    parents = {p: RM.read_sequences(str(g / f"{p}.reads.fa.gz"))
               for p in ("paternal", "maternal")}
    out = RM.build(parents, 21, "cpu")
    for p in parents:
        assert out[f"{p}.kmercount.histo"] == (g / f"{p}.histo").read_bytes()
        assert out[f"{p}.bounds.txt"] == (g / f"{p}.bounds.txt").read_bytes()
        # the golden lists jellyfish's hash order; the port and the
        # reference list ascending words: the same lines
        got = out[f"{p}.unique.filter.mer"].split()
        assert sorted(got) == sorted(
            (g / f"{p}.unique.filter.mer").read_bytes().split())
        assert len(got) == len(set(got))


def test_find_bounds_follows_the_awk_walk():
    rows = [(1, 100), (2, 50), (3, 60), (4, 10), (5, 90), (6, 80)]
    # 2 sets the minimum, 3 does not: the walk turns at 3, which is not a
    # candidate for the maximum
    assert RM.find_bounds(rows) == {"MIN_INDEX": 2, "MAX_INDEX": 5,
                                    "LOWER_INDEX": 3, "UPPER_INDEX": 10}


def test_decision_control_differs_only_in_float32():
    c0, c1 = np.array([25, 3, 0, 5]), np.array([26, 0, 7, 5])
    s0, s1 = 50_000_000, 50_000_001
    d64 = RC.decide(c0, c1, s0, s1, 1.04, 1.0, np.float64)
    d32 = RC.decide(c0, c1, s0, s1, 1.04, 1.0, np.float32)
    assert d64.tolist()[1:] == d32.tolist()[1:] == [0, 1, 0]
    assert d64[0] == 0 and d32[0] != 0
