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
hast_tpu's.  Exact comparisons throughout.
"""

import pathlib

import numpy as np
import pytest

from hast_tpu_torch.ops import kmer_count as KC
from hast_tpu_torch.pipeline import markers as M

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
    import io
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

    def crashing_count(paths, k, batch_size, n_parts=1, device="cpu"):
        calls.append(tuple(paths))
        if paths == PAT:
            raise KeyboardInterrupt("simulated crash mid-run")
        return real_count(paths, k, batch_size, n_parts, device)

    monkeypatch.setattr(M, "count_files", crashing_count)
    with pytest.raises(KeyboardInterrupt):
        M.build_unshared_markers(paternal=PAT, maternal=MAT,
                                 out_dir=str(tmp_path), auto_bounds=True,
                                 batch_size=16384, engine="host",
                                 device="cpu")
    assert (tmp_path / "step_00.1_count_maternal_done").exists()
    assert (tmp_path / "maternal.counts.npz").exists()
    assert not (tmp_path / "step_00.2_count_paternal_done").exists()

    def second_run_count(paths, k, batch_size, n_parts=1, device="cpu"):
        assert paths != MAT, "maternal count was redone after resume"
        calls.append(tuple(paths))
        return real_count(paths, k, batch_size, n_parts, device)

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
        native = KC.count_file_native(str(single), 21, batch_size=64,
                                      device="cpu")
        np.testing.assert_array_equal(native.words, want.words)
        np.testing.assert_array_equal(native.counts, want.counts)
    assert KC.count_file_native(str(multi), 21, batch_size=64,
                                device="cpu") is None
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
