"""hast_tpu_torch.pipeline.tenx (stage 02, host only) against the
stage-02 goldens and hast_tpu.pipeline.tenx on the same inputs.

The barcode table against the awk golden, the fake-10X rewrite against
the perl golden (gzip compared decompressed: only the bytes inside are
the contract), merge_barcodes' semantics, and prepare_10x (library
file, merge table, both fastq.gz) against the JAX package's run and
through the port's CLI.  Exact equality throughout.
"""

import gzip
import pathlib

import pytest

from hast_tpu_torch.cli import main
from hast_tpu_torch.pipeline import tenx as T

GOLD = pathlib.Path(__file__).parent / "golden" / "stage02"
BINS = ([str(GOLD / "bin.r1.fq.gz")], [str(GOLD / "bin.r2.fq.gz")])
OUTPUTS = ("barcode_freq.txt", "merge.txt")
FASTQS = ("SampleName_S1_L001_R1_001.fastq.gz",
          "SampleName_S1_L001_R2_001.fastq.gz")


def test_barcode_freq_matches_awk():
    freq = T.barcode_freq(BINS[0])
    golden = {}
    for line in (GOLD / "barcode_freq.golden").read_bytes().splitlines():
        bc, n = line.split(b"\t")
        golden[bc] = int(n)
    assert freq == golden


def test_fake_10x_bit_identical(tmp_path):
    mapping = {}
    for line in (GOLD / "merge.txt").read_bytes().splitlines():
        cols = line.split(b"\t")
        mapping[cols[0]] = cols[1]
    total, used = T.fake_10x(BINS[0][0], BINS[1][0], mapping,
                             out_dir=str(tmp_path))
    assert total == 800 and 0 < used <= total
    for which in (1, 2):
        with gzip.open(tmp_path / FASTQS[which - 1]) as f:
            assert f.read() == \
                (GOLD / f"R{which}.fastq.golden").read_bytes(), which


def test_merge_barcodes_semantics(tmp_path):
    freq = {b"1_1_1": 5, b"2_2_2": 3, b"0_0_0": 9, b"3_3_3": 1,
            b"barcode_str": 4, b"4_4_4": 2}
    wl = tmp_path / "wl.txt"
    wl.write_bytes(b"AAAA\nCCCC\n")
    mapping = T.merge_barcodes(freq, str(wl), str(tmp_path / "merge.txt"),
                               min_rp=2)
    # 3 valid barcodes (freq >= 2, non-null), 2 whitelist -> ratio 2
    assert list(mapping.values()) == [b"AAAA", b"AAAA", b"CCCC"]


@pytest.mark.parametrize("min_rp", [1, 3])
def test_prepare_10x_matches_jax(tmp_path, min_rp):
    pytest.importorskip("jax")
    from hast_tpu.pipeline import tenx as JT
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    wl = str(GOLD / "whitelist.txt")
    got = T.prepare_10x(*BINS, wl, str(ours), min_rp)
    assert got == JT.prepare_10x(*BINS, wl, str(theirs), min_rp)
    for name in OUTPUTS:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    for name in FASTQS:
        with gzip.open(ours / name) as a, gzip.open(theirs / name) as b:
            assert a.read() == b.read(), name


def test_prepare_10x_cli_matches_goldens(tmp_path, capsys):
    """The CLI's barcode table equals awk's, and it maps the same stLFR
    barcodes as the perl golden (whose order is a perl hash's; the port
    and the JAX package use first-seen order)."""
    main(["prepare-10x", "--read1", BINS[0][0], "--read2", BINS[1][0],
          "--whitelist", str(GOLD / "whitelist.txt"),
          "--out-dir", str(tmp_path)])
    assert "Total 800 pairs and used" in capsys.readouterr().out
    assert T.load_barcode_freq(str(tmp_path / "barcode_freq.txt")) == \
        T.barcode_freq(BINS[0])

    def mapped(path):
        return sorted(line.split(b"\t")[0]
                      for line in path.read_bytes().splitlines())
    assert mapped(tmp_path / "merge.txt") == mapped(GOLD / "merge.txt")
    for name in FASTQS:
        assert (tmp_path / name).exists()
