"""hast_tpu_torch.pipeline.markers against the stage-00 goldens and
hast_tpu.pipeline.markers.

The port's build_unshared_markers on tests/golden/stage00 with
auto_bounds, for engines device, host and device with 3 key-range
passes (--device cpu: the kernels' plain twins): histos and bounds
byte-identical to the jellyfish goldens, marker lines equal to them when
sorted, and the .mer files byte-identical to hast_tpu's on the same
inputs (both write ascending canonical words).  Also the host engine's
sub-step resume, the multi-line fasta fallback, the native reader as
the port opens it and the port's parental-read generator against
hast_tpu's.  The key-range passes' spill (ops.kmer_count.PackedSpill):
outputs of both engines, its removal on success and on error, files of
both readers, its boundary sample against hast_tpu's over the ASCII
reader, and on the card its device peak against re-reading the files;
both parents' spills written a reader a file, their readers open at
once, against each file spilled alone, and a failed write removing every
part; the counting reader's ladder of length caps against the reader
opened at 8,192, and the files it redoes natively or hands to the python
reader.  Exact comparisons throughout.
"""

import collections
import gzip
import hashlib
import io
import itertools
import os
import pathlib

import numpy as np
import pytest
import torch

from hast_tpu_torch.io import fastq as FQ
from hast_tpu_torch.ops import kmer_count as KC
from hast_tpu_torch.pipeline import classify as C
from hast_tpu_torch.pipeline import markers as M
from hast_tpu_torch.utils import profiling as P

GOLD = pathlib.Path(__file__).parent / "golden" / "stage00"
PAT = [str(GOLD / "paternal.reads.fa.gz")]
MAT = [str(GOLD / "maternal.reads.fa.gz")]
PARENTS = ("maternal", "paternal")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """hast_tpu's marker files on the same inputs, made once."""
    pytest.importorskip("jax")
    from hast_tpu.pipeline import markers as JM
    out = tmp_path_factory.mktemp("stage00_jax")
    paths = JM.build_unshared_markers(paternal=PAT, maternal=MAT,
                                      out_dir=str(out), auto_bounds=True,
                                      batch_size=16384, engine="host")
    return {p: pathlib.Path(paths[p]).read_bytes() for p in PARENTS}


@pytest.fixture(scope="module",
                params=["device", "host", "device-parts"])
def built(tmp_path_factory, request):
    out = tmp_path_factory.mktemp(
        f"stage00_torch_{request.param.replace('-', '_')}")
    paths = M.build_unshared_markers(
        paternal=PAT, maternal=MAT, out_dir=str(out), auto_bounds=True,
        batch_size=16384, engine=request.param.split("-")[0],
        n_parts=3 if request.param.endswith("parts") else None,
        device="cpu")
    return out, paths


def test_histo_and_bounds_match_goldens(built):
    out, _ = built
    for parent in PARENTS:
        assert (out / f"{parent}.kmercount.histo").read_bytes() == \
            (GOLD / f"{parent}.histo").read_bytes(), parent
        assert (out / f"{parent}.bounds.txt").read_bytes() == \
            (GOLD / f"{parent}.bounds.txt").read_bytes(), parent


def test_marker_lines_match_jellyfish(built):
    _, paths = built
    for parent in PARENTS:
        ours = sorted(pathlib.Path(paths[parent]).read_bytes().split())
        golden = sorted(
            (GOLD / f"{parent}.unique.filter.mer").read_bytes().split())
        assert ours == golden, parent


def test_marker_files_byte_identical_to_jax(built, reference):
    _, paths = built
    for parent in PARENTS:
        assert pathlib.Path(paths[parent]).read_bytes() == \
            reference[parent], parent


@pytest.mark.parametrize("var,value", [("HAST_COUNT_PARTS", "3"),
                                       ("HAST_STAGE00_ENGINE", "host")])
def test_build_markers_reads_the_environment(tmp_path, monkeypatch, var,
                                             value):
    """Without --count-parts and --engine (and under `run`, which has
    neither flag), build-markers takes HAST_COUNT_PARTS and
    HAST_STAGE00_ENGINE as the JAX package does."""
    from hast_tpu_torch.cli import main
    log = io.StringIO()
    real = M.build_unshared_markers
    monkeypatch.setattr(M, "build_unshared_markers",
                        lambda *a, **kw: real(*a, log=log, **kw))
    monkeypatch.setenv(var, value)
    main(["build-markers", "--paternal", PAT[0], "--maternal", MAT[0],
          "--out-dir", str(tmp_path), "--auto_bounds", "--device", "cpu"])
    if var == "HAST_COUNT_PARTS":
        assert "count pass 1/3 maternal" in log.getvalue()
    else:
        assert (tmp_path / "maternal.counts.npz").exists()
    for parent in PARENTS:
        for ours, golden in ((f"{parent}.kmercount.histo", f"{parent}.histo"),
                             (f"{parent}.bounds.txt", f"{parent}.bounds.txt")):
            assert (tmp_path / ours).read_bytes() == \
                (GOLD / golden).read_bytes(), ours
        assert sorted((tmp_path / f"{parent}.unique.filter.mer").read_bytes()
                      .split()) == sorted(
            (GOLD / f"{parent}.unique.filter.mer").read_bytes().split())


def test_find_bounds_awk_quirks():
    rows = [(1, 100), (2, 50), (3, 50), (4, 80), (5, 200), (6, 90)]
    b = M.find_bounds(rows)
    assert (b["MIN_INDEX"], b["MAX_INDEX"]) == (2, 5)
    assert (b["LOWER_INDEX"], b["UPPER_INDEX"]) == (3, 3 * 5 - 2 * 2 - 1)
    b2 = M.find_bounds([(1, 10), (2, 5), (3, 1)])
    assert b2["MAX_INDEX"] == 0 and b2["MIN_INDEX"] == 3


def test_host_engine_resumes_after_a_crash(tmp_path, monkeypatch):
    """A crash after the maternal count: the rerun must not recount it
    (step_NN_done and <parent>.counts.npz, build_unshared_kmers.sh)."""
    real_count = M.count_files
    calls = []

    def crashing_count(paths, k, batch_size, n_parts=1, device="cpu",
                       spill_dir=None):
        calls.append(tuple(paths))
        if paths == PAT:
            raise KeyboardInterrupt("simulated crash mid-run")
        return real_count(paths, k, batch_size, n_parts, device, spill_dir)

    monkeypatch.setattr(M, "count_files", crashing_count)
    with pytest.raises(KeyboardInterrupt):
        M.build_unshared_markers(paternal=PAT, maternal=MAT,
                                 out_dir=str(tmp_path), auto_bounds=True,
                                 batch_size=16384, engine="host",
                                 device="cpu")
    assert (tmp_path / "step_00.1_count_maternal_done").exists()
    assert (tmp_path / "maternal.counts.npz").exists()
    assert not (tmp_path / "step_00.2_count_paternal_done").exists()

    def second_run_count(paths, k, batch_size, n_parts=1, device="cpu",
                         spill_dir=None):
        assert paths != MAT, "maternal count was redone after resume"
        calls.append(tuple(paths))
        return real_count(paths, k, batch_size, n_parts, device, spill_dir)

    monkeypatch.setattr(M, "count_files", second_run_count)
    paths = M.build_unshared_markers(paternal=PAT, maternal=MAT,
                                     out_dir=str(tmp_path),
                                     auto_bounds=True, batch_size=16384,
                                     engine="host", device="cpu")
    assert calls == [tuple(MAT), tuple(PAT), tuple(PAT)]
    for parent in PARENTS:
        assert sorted(pathlib.Path(paths[parent]).read_bytes().split()) == \
            sorted((GOLD / f"{parent}.unique.filter.mer").read_bytes()
                   .split())
    for s in ("00.1_count_maternal", "00.2_count_paternal", "00.3_bounds",
              "00.4_markers"):
        assert (tmp_path / f"step_{s}_done").exists()


def test_native_count_multiline_fasta_fallback(tmp_path):
    """Multi-line fasta falls back to the python reader for the whole
    file (the native counting parser takes 2-line records only)."""
    from hast_tpu_torch.io import native as N
    seq = b"ACGTACGTGGCCATTAGCAT" * 10
    single = tmp_path / "single.fa"
    multi = tmp_path / "multi.fa"
    single.write_bytes(b">r1\n" + seq + b"\n>r2\n" + seq[5:] + b"\n")
    multi.write_bytes(b">r1\n" + seq[:100] + b"\n" + seq[100:] +
                      b"\n>r2\n" + seq[5:] + b"\n")
    want = M.count_files([str(single)], 21, batch_size=64, device="cpu")
    if N.get_lib() is not None:
        native = KC.count_file(str(single), 21, batch_size=64, device="cpu")
        np.testing.assert_array_equal(native.words, want.words)
        np.testing.assert_array_equal(native.counts, want.counts)
    python = KC.count_batches(FQ.sequence_batches(str(multi), 21, 64), 21,
                              device="cpu")
    got = KC.count_file(str(multi), 21, batch_size=64, device="cpu")
    np.testing.assert_array_equal(got.words, python.words)
    np.testing.assert_array_equal(got.counts, python.counts)
    for table in (M.count_files([str(multi)], 21, batch_size=64,
                                device="cpu"),
                  M.count_files_device([str(multi)], 21, batch_size=64,
                                       device="cpu").fetch()):
        np.testing.assert_array_equal(table.words, want.words)
        np.testing.assert_array_equal(table.counts, want.counts)
    assert want.n_distinct > 0 and want.total > want.n_distinct


def test_open_count_reader(tmp_path):
    """The native reader as the port opens it: every batch's masks and
    lengths, and None for a file it cannot take."""
    from hast_tpu_torch.io import native as N
    if N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    reads = tmp_path / "r.fa"
    reads.write_bytes(b">a\nACGTNACGTACGT\n>b\nACGTACGTAC\n")
    reader = KC.open_count_reader(str(reads), 64)
    try:
        batches = list(reader)
    finally:
        reader.close()
    lengths = np.concatenate([b.lengths for b in batches])
    assert lengths[:2].tolist() == [13, 10]
    assert [KC.batch_is_clean(b.good, b.lengths) for b in batches] == [False]
    assert KC.open_count_reader(str(tmp_path / "absent.fa")) is None


@pytest.mark.parametrize("err_rate", [0.0, 0.01])
def test_synthetic_parent_reads_match_jax_package(tmp_path, err_rate):
    """The port's trio genomes and parental reads are the bytes that
    hast_tpu.utils.synthetic writes for the same seeds."""
    from hast_tpu.utils import synthetic as JS
    from hast_tpu_torch.utils import synthetic as S
    genomes = S.make_trio_genomes(5, 20_000, het_rate=0.01)
    assert genomes == JS.make_trio_genomes(5, 20_000, het_rate=0.01)
    assert genomes[0] != genomes[1]
    ours, theirs = tmp_path / "ours.fa", tmp_path / "theirs.fa"
    n = S.make_parent_reads_vectorized(3, genomes[0], str(ours), 8.0, 100,
                                       err_rate)
    assert n == JS.make_parent_reads_vectorized(3, genomes[0], str(theirs),
                                                8.0, 100, err_rate) == 1600
    assert ours.read_bytes() == theirs.read_bytes()


# ---------------------------------------------------------------------------
# key-range passes from the spill
# ---------------------------------------------------------------------------

OUTPUTS = tuple(f"{p}.{x}" for p in PARENTS
                for x in ("unique.filter.mer", "kmercount.histo",
                          "bounds.txt"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fastq(path: pathlib.Path, records) -> str:
    with open(path, "wb") as f:
        for head, seq in records:
            f.write(b"@%s\n%s\n+\n%s\n" % (head, seq, b"I" * len(seq)))
    return str(path)


@pytest.fixture(scope="module")
def golden_fastq(tmp_path_factory):
    """The stage-00 goldens as fastq, and their one-pass outputs."""
    d = tmp_path_factory.mktemp("stage00_fastq")
    fq = {p: _fastq(d / f"{p}.fq", FQ.fasta_records(
        str(GOLD / f"{p}.reads.fa.gz"))) for p in PARENTS}
    return fq, _build(d / "one_pass", [fq["paternal"]], [fq["maternal"]],
                      1, device="cpu")


def _build(out: pathlib.Path, paternal, maternal, n_parts: int,
           engine: str = "device", **kw) -> dict:
    """The six stage-00 files of a build into out."""
    out.mkdir()
    M.build_unshared_markers(paternal, maternal, str(out), auto_bounds=True,
                             n_parts=n_parts, engine=engine,
                             log=io.StringIO(), **kw)
    assert not list(out.glob("*.spill"))
    return {name: (out / name).read_bytes() for name in OUTPUTS}


def _assert_goldens(files: dict) -> None:
    for p in PARENTS:
        assert files[f"{p}.kmercount.histo"] == \
            (GOLD / f"{p}.histo").read_bytes(), p
        assert files[f"{p}.bounds.txt"] == \
            (GOLD / f"{p}.bounds.txt").read_bytes(), p
        assert sorted(files[f"{p}.unique.filter.mer"].split()) == sorted(
            (GOLD / f"{p}.unique.filter.mer").read_bytes().split()), p


@pytest.mark.parametrize("n_parts", [2, 3])
def test_spilled_passes_give_the_goldens(tmp_path, golden_fastq, n_parts):
    """Passes from the spill on the goldens as fastq: the histos and
    bounds are the goldens, the .mer files the one-pass run's bytes, and
    no spill is left beside them."""
    fq, one_pass = golden_fastq
    got = _build(tmp_path / "out", [fq["paternal"]], [fq["maternal"]],
                 n_parts, device="cpu")
    _assert_goldens(got)
    assert got == one_pass


@pytest.mark.parametrize("n_parts", [2, 3])
def test_spill_removed_when_a_pass_fails(tmp_path, golden_fastq,
                                         monkeypatch, n_parts):
    """A pass that raises (its merge on the device fails once): the
    error reaches the caller, no spill is left and the step is not
    marked done, so the rerun counts everything and gives the goldens."""
    fq, one_pass = golden_fastq
    real = KC.DeviceCounter.merge_device
    calls = []

    def fail_once(self, other):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("simulated device failure")
        return real(self, other)

    monkeypatch.setattr(KC.DeviceCounter, "merge_device", fail_once)
    out = tmp_path / "out"
    out.mkdir()
    with pytest.raises(RuntimeError, match="simulated"):
        M.build_unshared_markers([fq["paternal"]], [fq["maternal"]],
                                 str(out), auto_bounds=True,
                                 n_parts=n_parts, engine="device",
                                 device="cpu", log=io.StringIO())
    assert not list(out.glob("*.spill"))
    assert not list(out.glob("step_*_done"))
    M.build_unshared_markers([fq["paternal"]], [fq["maternal"]], str(out),
                             auto_bounds=True, n_parts=n_parts,
                             engine="device", device="cpu",
                             log=io.StringIO())
    assert not list(out.glob("*.spill"))
    assert {name: (out / name).read_bytes() for name in OUTPUTS} == \
        one_pass


def test_spill_takes_files_of_both_readers(tmp_path):
    """A paternal list of two files, fastq the native reader takes and
    multi-line fasta it refuses: the spill holds both, and the outputs
    are the one-pass run's and the goldens."""
    records = list(FQ.fasta_records(str(GOLD / "paternal.reads.fa.gz")))
    half = len(records) // 2
    first = _fastq(tmp_path / "pa1.fq", records[:half])
    second = tmp_path / "pa2.fa"
    with open(second, "wb") as f:
        for head, seq in records[half:]:
            f.write(b">%s\n%s\n%s\n" % (head, seq[:40], seq[40:]))
    paternal = [first, str(second)]
    spill = KC.PackedSpill(str(tmp_path / "pa.spill"), paternal, 21)
    try:
        assert spill.parts == [str(tmp_path / "pa.0.spill"),
                               str(tmp_path / "pa.1.spill")]
        assert all(os.path.exists(part) for part in spill.parts)
        assert [sum(reads for rec in recs for _, reads in rec.batches)
                for recs in spill.files] == [half, len(records) - half]
    finally:
        spill.remove()
    assert not list(tmp_path.glob("*.spill"))
    one = _build(tmp_path / "one", paternal, MAT, 1, device="cpu")
    got = _build(tmp_path / "parts", paternal, MAT, 2, device="cpu")
    assert got == one
    _assert_goldens(got)


def test_host_engine_counts_parts_from_a_spill(tmp_path):
    """The host engine in 2 key-range passes on the first 10,000 reads
    of each golden parent: the six files of the one-pass host build,
    each parent read once, into a spill that is gone afterwards."""
    fq = {p: _fastq(tmp_path / f"{p}.fq", itertools.islice(
        FQ.fasta_records(str(GOLD / f"{p}.reads.fa.gz")), 10_000))
        for p in PARENTS}
    one = _build(tmp_path / "one", [fq["paternal"]], [fq["maternal"]], 1,
                 engine="host", device="cpu")
    reads = P.COUNTERS["io.reads"]
    got = _build(tmp_path / "parts", [fq["paternal"]], [fq["maternal"]], 2,
                 engine="host", device="cpu")
    assert P.COUNTERS["io.reads"] - reads == 2 * 10_000
    assert got == one
    assert not list(tmp_path.glob("**/*.spill"))


def _n_reads_fastq(path: pathlib.Path, n: int, seed: int) -> str:
    """n reads of 40-130 bases off a random genome; N bases only in the
    first 512, so that the spill holds masked and clean records."""
    return _fastq(path, _n_reads(n, seed))


def _n_reads(n: int, seed: int) -> list:
    """The (name, sequence) records of _n_reads_fastq."""
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 20_000)]
    records = []
    for i in range(n):
        length = int(rng.integers(40, 131))
        start = int(rng.integers(0, genome.size - length))
        seq = genome[start:start + length].copy()
        if i < 512 and i % 3 == 0:
            seq[rng.integers(0, length, 2)] = ord("N")
        records.append((b"r%d" % i, seq.tobytes()))
    return records


@pytest.mark.parametrize("n_sample,scan_cap", [(16, 512), (4, 16), (3, 7)])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_spill_sample_matches_the_ascii_readers(tmp_path, n_sample,
                                                scan_cap, n_parts):
    """The boundaries sampled from the maternal spill are those of
    hast_tpu's sample_boundaries over the ASCII reader, on a fastq of 40
    batches of 64 reads (the last 5 short) with N bases in the first 8
    batches' reads; the sample counts only its batches' reads."""
    pytest.importorskip("jax")
    from hast_tpu.ops import kmer_count as JKC
    k, bs = 21, 64
    path = _n_reads_fastq(tmp_path / "ma.fq", 40 * bs - 5, 3)
    spill = KC.PackedSpill(str(tmp_path / "ma.spill"), [path], k, bs)
    try:
        assert {rec.masked for recs in spill.files for rec in recs} == \
            {True, False}
        before = P.COUNTERS["io.spill_reads"]
        got = spill.sample_boundaries(n_parts, n_sample, scan_cap,
                                      device="cpu")
        picked = range(0, min(scan_cap, 40), max(1, scan_cap // n_sample))
        assert P.COUNTERS["io.spill_reads"] - before == \
            sum(bs if i < 39 else bs - 5 for i in picked)
    finally:
        spill.remove()
    want = JKC.sample_boundaries(lambda: FQ.sequence_batches(path, k, bs),
                                 k, n_parts, n_sample, scan_cap)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and (got[1:] > got[:-1]).all()


def test_spill_redoes_a_file_the_native_reader_breaks_on(tmp_path):
    """A fastq whose read of 9,000 bases (past the native reader's cap)
    comes after more than a record of batches: the native records of the
    file are dropped and the python reader's take their place, so every
    read is in the spill once and a full-range pass counts what
    count_batches counts over the ASCII reader."""
    k, bs = 21, 64
    path = tmp_path / "long.fq"
    _n_reads_fastq(path, 20 * bs, 5)
    rng = np.random.default_rng(6)
    long_read = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 9000)]
    with open(path, "ab") as f:
        f.write(b"@long\n%s\n+\n%s\n" % (long_read.tobytes(),
                                          b"I" * 9000))
    spill = KC.PackedSpill(str(tmp_path / "long.spill"), [str(path)], k, bs)
    try:
        assert sum(reads for recs in spill.files for rec in recs
                   for _, reads in rec.batches) == 20 * bs + 1
        got = spill.count_pass((0, (1 << 64) - 1), device="cpu").fetch()
    finally:
        spill.remove()
    want = KC.count_batches(FQ.sequence_batches(str(path), k, bs), k,
                            device="cpu")
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert want.total > 20 * bs


# ---------------------------------------------------------------------------
# both parents' spills written at once
# ---------------------------------------------------------------------------


def _fasta(path: pathlib.Path, records, gz: bool = False,
           split_at: int | None = None) -> str:
    """records as two-line fasta, gzipped if gz; record split_at, if
    given, over two lines, which the native reader refuses."""
    data = b"".join(
        b">%s\n%s\n" % (head, seq if i != split_at
                        else seq[:30] + b"\n" + seq[30:])
        for i, (head, seq) in enumerate(records))
    path.write_bytes(gzip.compress(data) if gz else data)
    return str(path)


def _spill_inputs(tmp_path: pathlib.Path, case: str) -> tuple:
    """(maternal files, paternal files) of a case."""
    if case == "paired":
        # each parent's R1 and R2, fastq.gz of 70 reads each
        return tuple([_fastq_gz(tmp_path / f"{p}_{mate + 1}.fq.gz",
                                reads[70 * mate:70 * (mate + 1)])
                      for mate in range(2)]
                     for p, reads in (("ma", _n_reads(140, 11)),
                                      ("pa", _n_reads(140, 12))))
    ma = [_n_reads_fastq(tmp_path / "ma.fq", 150, 11)]
    pa = _n_reads(130, 12)
    if case == "two_files":
        return ma, [_fastq(tmp_path / "pa1.fq", pa[:80]),
                    _fastq(tmp_path / "pa2.fq", pa[80:])]
    if case == "fasta_gz":
        return ([_fasta(tmp_path / "ma.fa.gz", _n_reads(150, 11), gz=True)],
                [_fasta(tmp_path / "pa.fa.gz", pa, gz=True)])
    if case == "broken":
        # record 41 is multi-line: the reader's parse thread, at most a
        # queue of three batches of two ahead, flags it after at least 17
        # batches were taken, so records were written before it breaks
        return ma, [_fasta(tmp_path / "pa.fa", pa, split_at=40)]
    return ma, [_fastq(tmp_path / "pa.fq", pa)]


def _n_records(path: str) -> int:
    return sum(b.n for b in FQ.sequence_batches(path, 21))


def _sha256(path: str) -> str:
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def _spilled(spill: KC.PackedSpill) -> list:
    """Each part's (sha256, records), in the files' order."""
    return [(_sha256(part), records)
            for part, records in zip(spill.parts, spill.files)]


def _spilled_alone(tmp_path: pathlib.Path, files, *args) -> list:
    """_spilled of each file spilled alone by the PackedSpill
    constructor, its one part holding its records back to back."""
    alone = []
    for path in files:
        spill = KC.PackedSpill(str(tmp_path / "alone.spill"), [path], *args)
        (part,), (records,) = spill.parts, spill.files
        try:
            assert sum(reads for rec in records
                       for _, reads in rec.batches) == _n_records(path)
            assert [rec.offset for rec in records] == list(
                itertools.accumulate([0] + [r.nbytes for r in records[:-1]]))
            assert os.path.getsize(part) == sum(r.nbytes for r in records)
            alone.extend(_spilled(spill))
        finally:
            spill.remove()
        assert not os.path.exists(part)
    return alone


class _OpenFiles:
    """The input files open at each turn of read_in_turn that took a
    batch (a file is open from its _FileRead to the step that ends it),
    and every _FileRead made."""

    def __init__(self, monkeypatch):
        self.live: set = set()
        self.turns: list = []
        self.made: list = []
        init, step = KC._FileRead.__init__, KC._FileRead.step

        def opened(f, path, *args, **kw):
            self.live.add(path)
            self.made.append(f)
            init(f, path, *args, **kw)

        def stepped(f):
            took = step(f)
            if took:
                self.turns.append(frozenset(self.live))
            else:
                self.live.discard(f.path)
            return took

        monkeypatch.setattr(KC._FileRead, "__init__", opened)
        monkeypatch.setattr(KC._FileRead, "step", stepped)


@pytest.mark.parametrize("case", ["fastq", "two_files", "fasta_gz",
                                  "broken", "no_lib", "paired"])
def test_spills_written_in_turn_are_those_written_alone(tmp_path,
                                                        monkeypatch, case):
    """Both parents' spills written a lane a file, up to width readers
    open at once and a reader batch from each in turn: each part holds
    the bytes (sha256) and records of its file spilled alone, as the
    PackedSpill constructor's parts do.  One fastq a parent, two
    paternal files (in order), gzipped fasta, a paternal fasta the
    native reader breaks on after forty records while the maternal
    reader is open (only the paternal records are redone), no libhastio
    (the python reader alone), and each parent's R1 and R2 as fastq.gz of
    like size: at width 2 a file of each parent open at every turn, at
    width 4 all four.  markers.overlapped_batches grows iff width > 1 and
    a native reader reads; markers.open_readers over markers.turns reads
    the files open at each turn, at most the width."""
    from hast_tpu_torch.io import native as N
    if case == "no_lib":
        monkeypatch.setattr(N, "get_lib", lambda: None)
    elif N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    parents = _spill_inputs(tmp_path, case)
    n_files = sum(len(files) for files in parents)
    parent_of = {path: name for name, files in zip(PARENTS, parents)
                 for path in files}
    k, bs, sb = 21, 2, 2
    alone = [_spilled_alone(tmp_path, files, k, bs, sb) for files in parents]
    for name, files, want in zip(PARENTS, parents, alone):
        spill = KC.PackedSpill(str(tmp_path / f"{name}.all.spill"), files, k,
                               bs, sb)
        try:
            assert _spilled(spill) == want
        finally:
            spill.remove()
    appends: collections.Counter = collections.Counter()
    real = KC.PackedSpill._append

    def counted(f, staged, batches):
        appends[os.path.basename(f.name)] += 1
        return real(f, staged, batches)

    monkeypatch.setattr(KC.PackedSpill, "_append", staticmethod(counted))
    seen = _OpenFiles(monkeypatch)
    names = ("markers.overlapped_batches", "markers.turns",
             "markers.open_readers")
    for width in (1, 2, 4):
        monkeypatch.setattr(C, "_reader_width", lambda n: min(n, width))
        appends.clear()
        seen.turns.clear()
        before = {n: P.COUNTERS[n] for n in names}
        spills = KC.PackedSpill.write_in_turn(
            [(str(tmp_path / f"{name}.w{width}.spill"), files)
             for name, files in zip(PARENTS, parents)],
            k, bs, sb, C._reader_width(n_files))
        try:
            assert [_spilled(s) for s in spills] == alone
        finally:
            for s in spills:
                s.remove()
        grew = {n: P.COUNTERS[n] - before[n] for n in names}
        assert (grew["markers.overlapped_batches"] > 0) == \
            (width > 1 and case != "no_lib")
        assert grew["markers.turns"] == len(seen.turns)
        assert grew["markers.open_readers"] == sum(map(len, seen.turns))
        assert max(map(len, seen.turns)) == min(width, n_files)
        if case == "paired":
            assert {len(t) for t in seen.turns} == {width}
            assert all({parent_of[path] for path in t} == set(PARENTS)
                       for t in seen.turns) == (width > 1)
        redone = {os.path.basename(part): appends[os.path.basename(part)]
                  > len(records) for s in spills
                  for part, records in zip(s.parts, s.files)}
        assert redone == {f"{name}.w{width}.{i}.spill":
                          case == "broken" and name == "paternal"
                          for name, files in zip(PARENTS, parents)
                          for i in range(len(files))}
    assert not list(tmp_path.glob("*.spill"))


def _paired(tmp_path: pathlib.Path) -> dict:
    """Each golden parent's reads as R1 and R2, their first and second
    half, fastq in one gzip member each."""
    paired = {}
    for p in PARENTS:
        records = list(FQ.fasta_records(str(GOLD / f"{p}.reads.fa.gz")))
        half = len(records) // 2
        paired[p] = [_fastq_gz(tmp_path / f"{p}_1.fq.gz", records[:half]),
                     _fastq_gz(tmp_path / f"{p}_2.fq.gz", records[half:])]
    return paired


@pytest.mark.parametrize("layout", ["one_file", "paired"])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_device_engine_with_both_readers_open(tmp_path, golden_fastq,
                                              monkeypatch, n_parts, layout):
    """The device engine in n_parts key-range passes, a reader a file,
    readers open at once: each golden parent as one fastq at width 2, or
    as its R1 and R2 fastq.gz at width 4.  The goldens, the one-pass
    run's bytes (and, for R1 and R2, the width-1 run's files and parts),
    batches taken side by side, and each part, as the step removes it,
    the bytes of its file spilled alone."""
    fq, one_pass = golden_fastq
    files = ({p: [fq[p]] for p in PARENTS} if layout == "one_file"
             else _paired(tmp_path))
    removed = {}
    real = KC.PackedSpill.remove

    def hashed(self):
        for part in self.parts:
            if os.path.exists(part):
                removed[os.path.basename(part)] = _sha256(part)
        real(self)

    monkeypatch.setattr(KC.PackedSpill, "remove", hashed)

    def build(name: str, width: int) -> tuple:
        monkeypatch.setattr(C, "_reader_width", lambda n: min(n, width))
        removed.clear()
        got = _build(tmp_path / name, files["paternal"], files["maternal"],
                     n_parts, device="cpu")
        return got, dict(removed)

    before = P.COUNTERS["markers.overlapped_batches"]
    got, parts = build("out", 2 * len(files["paternal"]))
    assert P.COUNTERS["markers.overlapped_batches"] > before
    _assert_goldens(got)
    assert got == one_pass
    if layout == "paired":
        assert build("width1", 1) == (got, parts)
    alone = {f"{p}.reads.{i}.spill": sha
             for p in PARENTS for i, (sha, _) in enumerate(_spilled_alone(
                 tmp_path, files[p], 21, FQ.DEFAULT_BATCH))}
    assert parts == alone


@pytest.mark.cuda
def test_spilled_passes_hold_the_reread_peak_on_the_card(card, tmp_path,
                                                         monkeypatch):
    """A --count-parts 4 build of generated parents on the card: the same
    six files, and the same torch.cuda.max_memory_allocated(), as the
    build whose passes read the parents' files again, as they did
    before the spill."""
    from hast_tpu_torch.utils import synthetic as S
    bs = 4096
    pat_genome, mat_genome = S.make_trio_genomes(5, 400_000,
                                                 het_rate=0.002)
    pa, ma = str(tmp_path / "pa.fa"), str(tmp_path / "ma.fa")
    n_pa = S.make_parent_reads_vectorized(1, pat_genome, pa, 30.0, 100,
                                          0.002)
    n_ma = S.make_parent_reads_vectorized(2, mat_genome, ma, 30.0, 100,
                                          0.002)

    def reread(self, key_range, fold_above=KC.FOLD_ABOVE, device="cuda"):
        total = KC.DeviceCounter(self.k, device, fold_above)
        for path in self.sources:
            total.merge_device(KC.count_file(
                path, self.k, bs, finalize=False, key_range=key_range,
                fold_above=fold_above, device=device))
        return total.finalize_device()

    def build(name):
        reads = P.COUNTERS["io.reads"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        files = _build(tmp_path / name, [pa], [ma], 4, batch_size=bs,
                       device=card)
        torch.cuda.synchronize()
        return (files, torch.cuda.max_memory_allocated(),
                P.COUNTERS["io.reads"] - reads)

    spilled, spilled_peak, spilled_reads = build("spilled")
    with monkeypatch.context() as m:
        m.setattr(KC.PackedSpill, "count_pass", reread)
        reread_files, reread_peak, reread_reads = build("reread")
    assert spilled == reread_files
    assert spilled_peak == reread_peak
    assert spilled_reads == n_pa + n_ma
    assert reread_reads == 9 * (n_pa + n_ma)


# ---------------------------------------------------------------------------
# parents as paired, gzipped libraries
# ---------------------------------------------------------------------------


def _fastq_gz(path: pathlib.Path, records) -> str:
    """records as fastq in one gzip member."""
    path.write_bytes(gzip.compress(b"".join(
        b"@%s\n%s\n+\n%s\n" % (head, seq, b"I" * len(seq))
        for head, seq in records)))
    return str(path)


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    """Each parent's 6,000 reads of a 20-kb haplotype at 30X, as one
    plain fastq and as a paired library: R1 and R2 the first and the
    second half of the same reads, each fastq in one gzip member."""
    from hast_tpu_torch.utils import synthetic as S
    d = tmp_path_factory.mktemp("paired")
    genomes = dict(zip(("paternal", "maternal"),
                       S.make_trio_genomes(7, 20_000, het_rate=0.01)))
    plain, paired = {}, {}
    for i, p in enumerate(PARENTS):
        fa = d / f"{p}.fa"
        S.make_parent_reads_vectorized(11 + i, genomes[p], str(fa), 30.0,
                                       100, 0.002)
        records = [(b"r%d" % j, seq) for j, (_, seq) in
                   enumerate(FQ.fasta_records(str(fa)))]
        half = len(records) // 2
        plain[p] = [_fastq(d / f"{p}.fq", records)]
        paired[p] = [_fastq_gz(d / f"{p}_1.fq.gz", records[:half]),
                     _fastq_gz(d / f"{p}_2.fq.gz", records[half:])]
    return plain, paired


@pytest.mark.parametrize("n_parts", [1, 3])
def test_a_paired_gzipped_library_gives_the_plain_fastq_s_files(
        tmp_path, libraries, n_parts):
    """The device engine on the same reads, given as one plain fastq a
    parent or as its R1 and R2 fastq.gz: the six files byte for byte,
    in one pass (the files' tables merged) and in three key-range passes
    (each pass's union of the two files' runs)."""
    plain, paired = libraries
    one = _build(tmp_path / "plain", plain["paternal"], plain["maternal"],
                 n_parts, device="cpu")
    two = _build(tmp_path / "paired", paired["paternal"],
                 paired["maternal"], n_parts, device="cpu")
    assert two == one
    assert all(one[f"{p}.unique.filter.mer"] for p in PARENTS)


def test_a_paired_gzipped_library_gives_the_jax_package_s_files(
        tmp_path, libraries):
    """hast_tpu's stage 00 on the paired libraries writes the six files
    that the port's device engine writes in three key-range passes."""
    pytest.importorskip("jax")
    from hast_tpu.pipeline import markers as JM
    _, paired = libraries
    out = tmp_path / "jax"
    out.mkdir()
    JM.build_unshared_markers(paternal=paired["paternal"],
                              maternal=paired["maternal"], out_dir=str(out),
                              auto_bounds=True, batch_size=16384,
                              log=io.StringIO(), n_parts=1, engine="host")
    want = {name: (out / name).read_bytes() for name in OUTPUTS}
    assert _build(tmp_path / "port", paired["paternal"], paired["maternal"],
                  3, device="cpu") == want


@pytest.mark.parametrize("width", [1, 2, 4])
def test_a_second_file_the_native_reader_breaks_on_keeps_the_first_s(
        tmp_path, monkeypatch, width):
    """A parent's R1 and R2 as fastq.gz, R2's read 1,281 of 9,000 bases
    (past the native reader's cap), and the other parent's two files: R2
    goes to the python reader partway, at width 4 while R1 and both
    maternal files are open, and only R2's records are redone; R1's part
    and the maternal parts hold the records and bytes of each file
    spilled alone.  A full-range pass counts what count_batches counts
    over both paternal files."""
    from hast_tpu_torch.io import native as N
    if N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    k, bs = 21, 64
    r1 = _fastq_gz(tmp_path / "pa_1.fq.gz", _n_reads(30 * bs, 21))
    rng = np.random.default_rng(22)
    long_read = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 9000)].tobytes()
    r2 = _fastq_gz(tmp_path / "pa_2.fq.gz", _n_reads(20 * bs, 23)
                   + [(b"long", long_read)] + _n_reads(bs, 24))
    ma = [_n_reads_fastq(tmp_path / f"ma_{mate}.fq", 25 * bs, 25 + mate)
          for mate in (1, 2)]
    alone_r1 = _spilled_alone(tmp_path, [r1], k, bs)
    alone_ma = _spilled_alone(tmp_path, ma, k, bs)
    appends: collections.Counter = collections.Counter()
    real = KC.PackedSpill._append

    def counted(f, staged, batches):
        appends[os.path.basename(f.name)] += 1
        return real(f, staged, batches)

    monkeypatch.setattr(KC.PackedSpill, "_append", staticmethod(counted))
    seen = _OpenFiles(monkeypatch)
    spills = KC.PackedSpill.write_in_turn(
        [(str(tmp_path / "pa.spill"), [r1, r2]),
         (str(tmp_path / "ma.spill"), ma)], k, bs, width=width)
    pa = spills[0]
    try:
        assert _spilled(pa)[:1] == alone_r1
        assert _spilled(spills[1]) == alone_ma
        assert [sum(reads for rec in recs for _, reads in rec.batches)
                for recs in pa.files] == [30 * bs, 21 * bs + 1]
        # R2's native records were written, then dropped; no other's were
        assert appends["pa.1.spill"] > len(pa.files[1])
        assert appends["pa.0.spill"] == len(pa.files[0])
        assert [appends[f"ma.{i}.spill"] for i in (0, 1)] == \
            [len(recs) for recs in spills[1].files]
        assert max(map(len, seen.turns)) == width
        got = pa.count_pass((0, (1 << 64) - 1), device="cpu").fetch()
    finally:
        for s in spills:
            s.remove()
    want = KC.count_batches(itertools.chain(
        FQ.sequence_batches(r1, k, bs), FQ.sequence_batches(r2, k, bs)), k,
        device="cpu")
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert not list(tmp_path.glob("*.spill"))


# ---------------------------------------------------------------------------
# the counting reader's ladder of length caps
# ---------------------------------------------------------------------------


def _caps_opened(monkeypatch) -> list:
    """The len_cap of each native counting reader opened from now on."""
    from hast_tpu_torch.io import native as N
    opened = []
    real = N.NativeCountReader

    def recording(path, batch_size, len_cap, **kw):
        opened.append(len_cap)
        return real(path, batch_size, len_cap, **kw)

    monkeypatch.setattr(N, "NativeCountReader", recording)
    return opened


@pytest.mark.parametrize("layout", ["fastq", "fastq_gz", "paired"])
def test_spills_under_the_cap_ladder_are_those_at_8192(tmp_path, monkeypatch,
                                                       libraries, layout):
    """Both parents' 100-bp reads at 30X as one plain fastq, one fastq.gz
    or R1 and R2 fastq.gz a parent, spilled a lane a file: every file
    opens natively at the ladder's first cap and none is redone
    (markers.cap_redos 0), and each part has the sha256 and records of
    the part written with the reader opened at 8,192."""
    from hast_tpu_torch.io import native as N
    if N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    plain, paired = libraries
    files = {"fastq": plain, "paired": paired}.get(layout) or {
        p: [str(tmp_path / f"{p}.fq.gz")] for p in PARENTS}
    if layout == "fastq_gz":
        for p in PARENTS:
            pathlib.Path(files[p][0]).write_bytes(
                gzip.compress(pathlib.Path(plain[p][0]).read_bytes()))
    n_files = sum(map(len, files.values()))
    opened = _caps_opened(monkeypatch)

    def spilled(tag: str) -> list:
        spills = KC.PackedSpill.write_in_turn(
            [(str(tmp_path / f"{p}.{tag}.spill"), files[p])
             for p in PARENTS], 21, 256, width=n_files)
        try:
            return [_spilled(s) for s in spills]
        finally:
            for s in spills:
                s.remove()

    redos = P.COUNTERS["markers.cap_redos"]
    got = spilled("ladder")
    assert P.COUNTERS["markers.cap_redos"] == redos
    assert opened == [KC.COUNT_LEN_CAPS[0]] * n_files == [256] * n_files
    opened.clear()
    monkeypatch.setattr(KC, "COUNT_LEN_CAPS", (8192,))
    assert spilled("8192") == got
    assert opened == [8192] * n_files
    assert not list(tmp_path.glob("*.spill"))


def _long_read_input(tmp_path: pathlib.Path, case: str, bs: int) -> str:
    """A file of a case: 20 batches of reads, then one of 300 or 9,000
    bases, then a batch more, as fastq or fastq.gz; or a fasta whose
    record 1,270 is over two lines."""
    if case == "multiline_fasta":
        return _fasta(tmp_path / "ml.fa", _n_reads(21 * bs, 41),
                      split_at=20 * bs - 10)
    fmt, length = case.rsplit("_", 1)
    rng = np.random.default_rng(int(length))
    long_read = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, int(length))].tobytes()
    records = _n_reads(20 * bs, 41) + [(b"long", long_read)] + \
        _n_reads(bs, 42)
    write = _fastq_gz if fmt == "fastq_gz" else _fastq
    return write(tmp_path / f"long.{fmt.replace('_', '.')}", records)


@pytest.mark.parametrize("case,caps,python", [
    ("fastq_300", (256, 8192), False),
    ("fastq_gz_300", (256, 8192), False),
    ("fastq_9000", (256, 8192), True),
    ("multiline_fasta", (256,), True)])
def test_a_read_past_a_cap_is_redone_at_the_next(tmp_path, monkeypatch,
                                                 capsys, case, caps, python):
    """A read past the first cap after twenty batches: the file is redone
    natively from its start at 8,192 (one markers.cap_redos and a note),
    its first records dropped, and a read of 300 bases never reaches the
    python reader; one of 9,000 goes on to it, as multi-line fasta does
    from the first cap with no redo.  Each spill has the sha256 and
    records of the spill written with the reader opened at 8,192, and a
    full-range pass counts what count_batches counts over the python
    reader."""
    from hast_tpu_torch.io import native as N
    if N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    k, bs = 21, 64
    path = _long_read_input(tmp_path, case, bs)
    want = KC.count_batches(FQ.sequence_batches(path, k, bs), k,
                            device="cpu")
    with monkeypatch.context() as m:
        m.setattr(KC, "COUNT_LEN_CAPS", (8192,))
        spill = KC.PackedSpill(str(tmp_path / "at8192.spill"), [path], k, bs)
        at_8192 = _spilled(spill)
        spill.remove()
    capsys.readouterr()
    opened = _caps_opened(monkeypatch)
    natives, python_opens = [], []
    step, batches = KC._FileRead.step, FQ.sequence_batches

    def stepped(f):
        took = step(f)
        if took:
            natives.append(f.native)
        return took

    def python_reader(*args, **kw):
        python_opens.append(args[0])
        return batches(*args, **kw)

    monkeypatch.setattr(KC._FileRead, "step", stepped)
    monkeypatch.setattr(FQ, "sequence_batches", python_reader)
    redos = P.COUNTERS["markers.cap_redos"]
    spill = KC.PackedSpill(str(tmp_path / "ladder.spill"), [path], k, bs)
    try:
        assert _spilled(spill) == at_8192
        assert sum(reads for recs in spill.files for rec in recs
                   for _, reads in rec.batches) == 21 * bs + (
                       case != "multiline_fasta")
        got = spill.count_pass((0, (1 << 64) - 1), device="cpu").fetch()
    finally:
        spill.remove()
    assert tuple(opened) == caps
    assert P.COUNTERS["markers.cap_redos"] - redos == len(caps) - 1
    assert bool(python_opens) == python
    assert all(natives) == (not python)
    assert ("has reads longer than 256 bases; redoing it with len_cap "
            "8192" in capsys.readouterr().err) == (len(caps) > 1)
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert want.total > 20 * bs


@pytest.mark.parametrize("width", [1, 4])
def test_a_failed_write_removes_every_part_of_every_spill(tmp_path,
                                                          monkeypatch, width):
    """Both parents' R1 and R2 spilled a reader a file, and the third
    append to paternal R2's part raises (a full disk, say): the error
    reaches the caller, every reader is closed, and no part of either
    spill is left, the maternal parts and paternal R1's included."""
    files = {p: [_fastq_gz(tmp_path / f"{p}_{mate}.fq.gz",
                           _n_reads(8 * 64, seed + mate))
                 for mate in (1, 2)]
             for p, seed in (("ma", 31), ("pa", 33))}
    real = KC.PackedSpill._append
    appends: collections.Counter = collections.Counter()

    def failing(f, staged, batches):
        name = os.path.basename(f.name)
        appends[name] += 1
        if name == "pa.1.spill" and appends[name] == 3:
            raise OSError("simulated full disk")
        return real(f, staged, batches)

    monkeypatch.setattr(KC.PackedSpill, "_append", staticmethod(failing))
    seen = _OpenFiles(monkeypatch)
    with pytest.raises(OSError, match="simulated"):
        KC.PackedSpill.write_in_turn(
            [(str(tmp_path / "ma.spill"), files["ma"]),
             (str(tmp_path / "pa.spill"), files["pa"])], 21, 64, 1,
            width=width)
    assert appends["ma.0.spill"] > 0 and appends["pa.0.spill"] > 0
    assert len(seen.made) == 4 and not any(f.native for f in seen.made)
    assert max(map(len, seen.turns)) == width
    assert not list(tmp_path.glob("*.spill"))
