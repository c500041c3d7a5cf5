"""markers-pe-gz-parts4: the paired-library generator, a tiny traced CPU
run against the plain reference, the metrics it reads, and its write
budget at full size."""

import collections
import gzip
import time

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.gen import common as G
from portbench.gen import parents as P
from portbench.gen import parents_pe as PE
from portbench.tests import tiny

CELL = "markers-pe-gz-parts4"
SMALL = dict(tiny.SMALL["markers"], batch_size=1024)


def _config(**kw) -> dict:
    """The cell's configuration at the tiny size."""
    return {**harness.resolve(harness.load_spec(), CELL).config, **SMALL,
            **kw}


def _fastq_seqs(path: str) -> list:
    with gzip.open(path, "rb") as f:
        return f.read().split(b"\n")[1::4]


def test_the_generator_is_deterministic_from_the_seed(tmp_path):
    cfg = _config()
    a, b, c = (tmp_path / x for x in "abc")
    for d in (a, b, c):
        d.mkdir()
    one = PE.make_parents(cfg, 2**33 + 7, str(a))
    again = PE.make_parents(cfg, 2**33 + 7, str(b))
    other = PE.make_parents(cfg, 2**33 + 8, str(c))
    for p in PE.PARENTS:
        paths, reads = one[p]
        assert [x.rsplit("/", 1)[1] for x in paths] == [
            f"{p}_1.fq.gz", f"{p}_2.fq.gz"]
        n = reads.shape[0] // 2
        assert reads.shape == (2 * n, cfg["read_len"]) and n == int(
            cfg["genome_length"] * cfg["coverage"] / cfg["read_len"]) // 2
        # R1's rows, then R2's, as the files hold them
        for mate, path in enumerate(paths):
            assert _fastq_seqs(path) == [
                r.tobytes() for r in reads[mate * n:(mate + 1) * n]]
        for x, y in zip(paths, again[p][0]):
            assert open(x, "rb").read() == open(y, "rb").read()
        assert np.array_equal(reads, again[p][1])
        assert not np.array_equal(reads, other[p][1])


def test_r1_and_r2_of_a_pair_come_from_one_fragment(tmp_path):
    """With no errors and no satellite, each R1 and the reverse
    complement of its R2 (or R2 and the reverse complement of R1, for a
    minus-strand fragment) lie on one haplotype of gen/parents.py's
    seed, in order, as far apart as the fragment's length."""
    cfg = _config(error_rate=0.0, satellite_length=0)
    seed = 2**31 + 5
    got = PE.make_parents(cfg, seed, str(tmp_path))
    base = P.backbone(cfg, np.random.default_rng(
        G.stream_seed(seed, "genome")))
    L, far = cfg["read_len"], cfg["insert_mean"] + 6 * cfg["insert_sd"]
    for p in PE.PARENTS:
        prng = np.random.default_rng(G.stream_seed(seed, p))
        haps = [P.haplotype(prng, base, cfg["snp_rate"]).tobytes()
                for _ in range(2)]
        reads = got[p][1]
        n = reads.shape[0] // 2
        strands = collections.Counter()
        for i in range(0, n, 7):
            r1, r2 = reads[i], reads[n + i]
            ends = {"plus": (r1.tobytes(), G.revcomp_rows(r2[None])[0]),
                    "minus": (r2.tobytes(), G.revcomp_rows(r1[None])[0])}
            found = set()
            for strand, (head, tail) in ends.items():
                for h in haps:
                    at = h.find(head)
                    if at >= 0 and 0 <= h.find(tail.tobytes(), at) - at \
                            <= far - L:
                        found.add(strand)
            assert found, i
            strands.update(found)
        assert strands["plus"] > 0 and strands["minus"] > 0


@pytest.fixture
def traced(monkeypatch, tmp_path):
    """A tiny traced CPU run of the cell (the session's CUDA calls
    stubbed), both parents' readers open at once: its metrics."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a, **k: None)
    monkeypatch.setitem(tiny.SMALL, "markers_pe", SMALL)
    from hast_tpu_torch.pipeline import classify as C
    monkeypatch.setattr(C, "_reader_width", lambda n: min(n, 2))

    def run(seed):
        c = tiny.cell(tmp_path, CELL)
        work = tmp_path / "work"
        work.mkdir(exist_ok=True)
        r = harness.run_cell(c, seed, 0.5, True, "cpu", str(work),
                             time.perf_counter())
        return c, r

    return run


def test_a_traced_tiny_run_is_correct_and_reads_the_metrics(traced):
    c, r = traced(3000000019)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(v["value"] == 0 for v in r["checks"].values())
    m = {k: v["value"] for k, v in r["metrics"].items()}
    listed = {e["name"] for e, _ in c.per_layer}
    # K5's share needs the card's kernel records: nothing to read here
    assert listed - {"markers.k5_roofline"} <= set(m)
    assert {"markers.readers_open_mean", "markers.file_merge_ms",
            "markers.reader_overlap_share"} <= listed
    assert "markers.reader_windows_per_s" not in listed
    assert m["markers.reads_per_input_read"] == 1.0
    assert m["markers.readers_open_mean"] == 2.0
    assert 0.0 < m["markers.reader_overlap_share"] <= 1.0
    assert m["markers.file_merge_ms"] > 0
    assert 0 < m["markers.read_wait_share"] < 1


def test_a_program_without_the_counters_and_span_reads_nothing(
        traced, monkeypatch):
    """The parent of the counters: no markers.turns, open_readers or
    file_merge span.  The two metrics are left out, with no error."""
    from hast_tpu_torch.ops import kmer_count as KC
    from hast_tpu_torch.utils import profiling as PR
    real_count, real_span = KC.count, KC.span
    monkeypatch.setattr(PR, "COUNTERS", collections.Counter())
    monkeypatch.setattr(KC, "count", lambda name, n=1: None if name in (
        "markers.turns", "markers.open_readers") else real_count(name, n))
    monkeypatch.setattr(KC, "span", lambda name: real_span(
        "kmer_count.fold" if name == "markers.file_merge" else name))
    c, r = traced(2**32 + 15)
    assert r["correct"]
    m = r["metrics"]
    assert "markers.readers_open_mean" not in m
    assert "markers.file_merge_ms" not in m
    assert m["markers.reads_per_input_read"]["value"] == 1.0


def test_the_control_fails_where_counts_pass_2_21(tmp_path, monkeypatch):
    """A segment that is mostly satellite: the reference with 21-bit
    counts misses the total of the paired libraries' reads."""
    monkeypatch.setitem(tiny.SMALL, "markers_pe", SMALL)
    c = tiny.cell(tmp_path, CELL, config={"genome_length": 500000,
                                          "satellite_length": 470000})
    r = control.readings(c, 11, "cpu", str(tmp_path))
    assert r["total_gap"][0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3100000011, 3100000012, 3100000013])
def test_the_control_fails_on_the_card_at_the_cell_s_size(seed, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = harness.resolve(harness.load_spec(), CELL)
    r = control.readings(c, seed, "cuda", str(tmp_path))
    print(CELL, seed, r)
    assert any(v > lim for v, lim in r.values())


def test_a_full_size_run_reckons_a_few_gib_at_most():
    spec = harness.load_spec()
    c = harness.resolve(spec, CELL)
    assert c.chips == 1 and c.traffic["count_parts"] == 4
    # a run of run_seconds holds at most a job every 0.5 s
    jobs = 2 * spec["run_seconds"]
    assert c.job.reckon_bytes(c.config, c.traffic, jobs) < 3 << 30
