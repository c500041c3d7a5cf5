"""The port's CLI: `python -m hast_tpu_torch build-markers | classify |
classify-reads`.

build-markers and classify-reads run end to end in a subprocess that
blocks jax before anything is imported, which shows the port never
imports it; their outputs must equal the stage-00 and stage-01 goldens
byte for byte (--device cpu: the plain twins).  The 00->01 chain runs
through the port's CLI on the e2e trio, as tests/test_e2e_trio.py runs
it through hast_tpu's.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from hast_tpu_torch.cli import main

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLD = ROOT / "tests" / "golden" / "stage01"
GOLD00 = ROOT / "tests" / "golden" / "stage00"
E2E = ROOT / "tests" / "golden" / "e2e"
INPUTS = ("hap0.mer", "hap1.mer", "reads1.fq.gz", "reads2.fq")

NO_JAX = """
import sys
sys.modules["jax"] = None
from hast_tpu_torch.cli import main
main(sys.argv[1:])
loaded = sorted(m for m, mod in sys.modules.items()
                if mod is not None and (m == "jax" or m.startswith("jax.")))
assert not loaded, loaded
"""


@pytest.fixture
def inputs(tmp_path):
    for f in INPUTS:
        shutil.copy(GOLD / f, tmp_path / f)
    return tmp_path


def classify_reads_argv(d: pathlib.Path, wd: pathlib.Path) -> list[str]:
    return ["classify-reads", "--paternal_mer", str(d / "hap0.mer"),
            "--maternal_mer", str(d / "hap1.mer"),
            "--filial", f"{d / 'reads1.fq.gz'} {d / 'reads2.fq'}",
            "--workdir", str(wd), "--batch-size", "4096", "--device", "cpu"]


def test_classify_reads_without_jax_matches_goldens(inputs):
    wd = inputs / "wd"
    wd.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", NO_JAX,
                           *classify_reads_argv(inputs, wd)],
                          cwd=inputs, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (wd / "phased.barcodes").read_bytes() == \
        (GOLD / "phased.barcodes.golden").read_bytes()
    for name in ("paternal", "maternal", "homozygous"):
        assert (wd / f"{name}.unique.barcodes").read_bytes() == \
            (GOLD / f"{name}.unique.barcodes.golden").read_bytes()
        n = (GOLD / f"{name}.unique.barcodes.golden").read_bytes().count(
            b"\n")
        assert f"final {name} barcodes : {n}" in proc.stdout
    for name in ("paternal", "maternal", "homozygous", "nobarcode"):
        assert (wd / f"reads2.fq.{name}.fastq").read_bytes() == \
            (GOLD / "quarter" / f"reads2.fq.{name}.fastq").read_bytes()
        assert (wd / f"reads1.fq.{name}.fastq").exists()
    for step in ("9", "10", "11"):
        assert (wd / f"step_{step}_done").exists()


def test_build_markers_without_jax_matches_goldens(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX, "build-markers", "--auto_bounds",
         "--paternal", str(GOLD00 / "paternal.reads.fa.gz"),
         "--maternal", str(GOLD00 / "maternal.reads.fa.gz"),
         "--out-dir", str(tmp_path), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for parent in ("maternal", "paternal"):
        assert (tmp_path / f"{parent}.kmercount.histo").read_bytes() == \
            (GOLD00 / f"{parent}.histo").read_bytes()
        assert (tmp_path / f"{parent}.bounds.txt").read_bytes() == \
            (GOLD00 / f"{parent}.bounds.txt").read_bytes()
        ours = (tmp_path / f"{parent}.unique.filter.mer").read_bytes()
        golden = (GOLD00 / f"{parent}.unique.filter.mer").read_bytes()
        assert sorted(ours.split()) == sorted(golden.split())
        assert f"final {parent} unique kmer is : {golden.count(b'\n')}" \
            in proc.stderr
    assert (tmp_path / "step_00_markers_done").exists()
    assert (tmp_path / "step_00.device_markers_done").exists()


def test_stage00_to_01_chain_matches_e2e_goldens(tmp_path):
    """build-markers then classify-reads through the port's CLI on the
    e2e trio: phased.barcodes and the binned fastqs byte for byte."""
    d00, d01 = tmp_path / "00", tmp_path / "01"
    d00.mkdir()
    d01.mkdir()
    main(["build-markers", "--out-dir", str(d00), "--auto_bounds",
          "--paternal", str(E2E / "paternal.fa.gz"),
          "--maternal", str(E2E / "maternal.fa.gz"),
          "--batch-size", "16384", "--device", "cpu"])
    for parent in ("paternal", "maternal"):
        assert sorted((d00 / f"{parent}.unique.filter.mer").read_bytes()
                      .split()) == \
            sorted((E2E / f"{parent}.unique.filter.mer").read_bytes().split())
    main(["classify-reads",
          "--paternal_mer", str(d00 / "paternal.unique.filter.mer"),
          "--maternal_mer", str(d00 / "maternal.unique.filter.mer"),
          "--filial", str(E2E / "son.r1.fq.gz"),
          "--filial", str(E2E / "son.r2.fq"),
          "--workdir", str(d01), "--batch-size", "4096", "--device", "cpu"])
    assert (d01 / "phased.barcodes").read_bytes() == \
        (E2E / "stage01" / "phased.barcodes").read_bytes()
    for r in (1, 2):
        for name in ("paternal", "maternal", "homozygous", "nobarcode"):
            golden = E2E / "stage01" / f"son.r{r}.fq.{name}.fastq"
            ours = d01 / f"son.r{r}.fq.{name}.fastq"
            if golden.exists():
                assert ours.read_bytes() == golden.read_bytes(), ours.name
            else:
                assert not ours.exists(), ours.name


def test_classify_reads_skips_finished_steps(inputs):
    wd = inputs / "wd"
    wd.mkdir()
    main(classify_reads_argv(inputs, wd))
    phased = (wd / "phased.barcodes").read_bytes()
    assert phased == (GOLD / "phased.barcodes.golden").read_bytes()
    # erase one output of each step: a rerun must redo none of them
    (wd / "phased.barcodes").write_bytes(b"")
    (wd / "paternal.unique.barcodes").unlink()
    (wd / "reads2.fq.paternal.fastq").unlink()
    main(classify_reads_argv(inputs, wd))
    assert (wd / "phased.barcodes").read_bytes() == b""
    assert not (wd / "paternal.unique.barcodes").exists()
    assert not (wd / "reads2.fq.paternal.fastq").exists()


def test_classify_writes_output_file(inputs):
    out = inputs / "phased.out"
    main(["classify", "--hap0", str(inputs / "hap0.mer"), "--hap1",
          str(inputs / "hap1.mer"), "--read",
          str(inputs / "reads1.fq.gz"), "--read", str(inputs / "reads2.fq"),
          "--weight0", "1.04", "--output", str(out), "--device", "cpu"])
    assert out.read_bytes() == (GOLD / "phased.barcodes.golden").read_bytes()


def test_device_cuda_without_a_card_is_an_error(inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        main(["classify", "--hap0", str(inputs / "hap0.mer"), "--hap1",
              str(inputs / "hap1.mer"), "--read", str(inputs / "reads2.fq")])
    assert "no CUDA device" in str(e.value.code)
    assert not (inputs / "hap0.mer.probetable.npz").exists()
    with pytest.raises(SystemExit) as e:
        main(["build-markers", "--paternal", str(inputs / "reads2.fq"),
              "--maternal", str(inputs / "reads2.fq"), "--out-dir",
              str(inputs / "00")])
    assert "no CUDA device" in str(e.value.code)
    assert not (inputs / "00").exists()


@pytest.mark.parametrize("cmd", ["build-markers", "classify",
                                 "classify-reads"])
def test_help(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out
