"""The port's CLI: `python -m hast_tpu_torch build-markers | classify |
classify-reads | prepare-10x | assemble | mkoutput | classify-segments |
run`, the tools (`mark-library`, `classify-hic`, `vcf-*`,
`draw-heatalign`, `get-n`, `check-genes`, `plot-bounds`,
`filter-fastq-by-barcodes`) and `warmup`.

build-markers, classify-reads, mkoutput and run (HAST.sh, 00->01->02->03
with a fake Supernova) run end to end in a subprocess that blocks jax
and hast_tpu before anything is imported, which shows the port imports
neither; their outputs must equal the goldens byte for byte (--device
cpu: the plain twins).  The 00->01 chain also runs in process on the
e2e trio, as tests/test_e2e_trio.py runs it through hast_tpu's.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from hast_tpu_torch.cli import main
from hast_tpu_torch.utils import synthetic as S

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLD = ROOT / "tests" / "golden" / "stage01"
GOLD00 = ROOT / "tests" / "golden" / "stage00"
E2E = ROOT / "tests" / "golden" / "e2e"
GOLD03 = ROOT / "tests" / "golden" / "stage03"
INPUTS = ("hap0.mer", "hap1.mer", "reads1.fq.gz", "reads2.fq")

NO_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["hast_tpu"] = None
from hast_tpu_torch.cli import main
main(sys.argv[1:])
loaded = sorted(m for m, mod in sys.modules.items()
                if mod is not None and m.split(".")[0] in ("jax", "hast_tpu"))
assert not loaded, loaded
"""

def fake_supernova(root: pathlib.Path) -> pathlib.Path:
    """`run`'s stage 02 and 03 need Supernova: a stand-in that hands out
    the e2e golden pseudohap2 assembly (tests/test_e2e_full.py's fake)."""
    return pathlib.Path(S.write_fake_supernova(
        str(root), str(E2E / "assembly"),
        str(ROOT / "tests" / "golden" / "stage02" / "whitelist.txt")))


def run_no_jax(argv: list[str], cwd: pathlib.Path, **env_vars):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **env_vars)
    proc = subprocess.run([sys.executable, "-c", NO_JAX, *argv], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


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
    proc = run_no_jax(classify_reads_argv(inputs, wd), inputs)
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
    proc = run_no_jax(
        ["build-markers", "--auto_bounds",
         "--paternal", str(GOLD00 / "paternal.reads.fa.gz"),
         "--maternal", str(GOLD00 / "maternal.reads.fa.gz"),
         "--out-dir", str(tmp_path), "--device", "cpu"], tmp_path)
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
                                 "classify-reads", "mkoutput",
                                 "classify-segments", "run"])
def test_help(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_mkoutput_without_jax_matches_goldens(tmp_path):
    run_no_jax(["mkoutput", "--assembly_path", str(GOLD03 / "assembly"),
                "--maternal_mer", str(GOLD03 / "maternal.mer"),
                "--paternal_mer", str(GOLD03 / "paternal.mer"),
                "--prefer", "paternal", "--workdir", str(tmp_path),
                "--device", "cpu"], tmp_path)
    for name in ("phasing.out", "output.merge.homo.ids", "output.father.fa",
                 "output.father.idx", "output.supplement.fa"):
        assert (tmp_path / name).read_bytes() == \
            (GOLD03 / name).read_bytes(), name
    assert os.readlink(tmp_path / "output.primary.fa") == "output.father.fa"


def test_mkoutput_prefer_follows_mer_order(tmp_path):
    """Without --prefer the first --*_mer flag picks the primary branch
    (mkoutput_by_fabulous2.0.sh's order rule), whether it is written
    out, as --maternal_mer=m.mer or as a prefix argparse takes
    (--maternal m.mer)."""
    mat, pat = str(GOLD03 / "maternal.mer"), str(GOLD03 / "paternal.mer")
    for i, mers in enumerate((["--maternal_mer", mat, "--paternal_mer", pat],
                              [f"--maternal_mer={mat}", "--paternal_mer",
                               pat],
                              ["--maternal", mat, f"--pat={pat}"])):
        wd = tmp_path / str(i)
        wd.mkdir()
        main(["mkoutput", "--assembly_path", str(GOLD03 / "assembly"), *mers,
              "--workdir", str(wd), "--device", "cpu"])
        assert os.readlink(wd / "output.primary.fa") == "output.mother.fa"
        assert not (wd / "output.father.fa").exists()


def test_merge_results_takes_paths_with_spaces(inputs, capsysbinary):
    """merge-results --input passes each path as given (the JAX CLI's
    list), so a path with a space names one file."""
    shard_dir = inputs / "two shards"
    shard_dir.mkdir()
    lines = (GOLD / "phased.barcodes.golden").read_bytes().splitlines(True)
    for i in (0, 1):
        (shard_dir / f"s {i}").write_bytes(b"".join(lines[i::2]))
    main(["merge-results", "--input", str(shard_dir / "s 0"), "--input",
          str(shard_dir / "s 1"), "--hap0", str(inputs / "hap0.mer"),
          "--hap1", str(inputs / "hap1.mer"), "--weight0", "1.04"])
    assert capsysbinary.readouterr().out == \
        (GOLD / "phased.barcodes.golden").read_bytes()


def test_classify_segments_writes_verdicts(capfd):
    main(["classify-segments", "--hap", str(GOLD03 / "paternal.mer"),
          "--hap", str(GOLD03 / "maternal.mer"),
          "--read", str(GOLD03 / "fastq_mode.fq"), "--format", "fastq",
          "--device", "cpu"])
    assert capfd.readouterr().out == (GOLD03 / "fastq_mode.out").read_text()


@pytest.mark.parametrize("paths", ["absolute", "relative"])
def test_run_without_jax_matches_e2e_goldens(tmp_path, paths):
    """HAST.sh through the port: markers, bins, fake-10X conversion, both
    assemblies (fake Supernova) and both re-phasing runs.  "relative"
    gives --workdir and --supernova relative to the working directory,
    which stage 02 and stage 03 leave for their own."""
    sn = fake_supernova(tmp_path)
    wd = tmp_path / "run"
    wd.mkdir()
    if paths == "relative":
        sn, wd_arg = sn.relative_to(tmp_path), "run"
    else:
        wd_arg = str(wd)
    run_no_jax(["run", "--paternal", str(E2E / "paternal.fa.gz"),
                "--maternal", str(E2E / "maternal.fa.gz"),
                "--read1", str(E2E / "son.r1.fq.gz"),
                "--read2", str(E2E / "son.r2.fq"), "--supernova", str(sn),
                "--workdir", wd_arg, "--device", "cpu"], tmp_path)
    assert (wd / "01.classify_reads" / "phased.barcodes").read_bytes() == \
        (E2E / "stage01" / "phased.barcodes").read_bytes()
    for parent, fa in (("paternal", "father"), ("maternal", "mother")):
        for name in (f"output.{fa}.fa", f"output.{fa}.idx",
                     "output.supplement.fa"):
            assert (wd / f"03.{parent}_output" / name).read_bytes() == \
                (E2E / f"stage03_{parent}" / name).read_bytes(), (parent,
                                                                 name)
        for name in ("barcode_freq.txt", "merge.txt", "output.1.idx",
                     "SampleName_S1_L001_R1_001.fastq.gz"):
            assert (wd / f"02.{parent}_assembly" / name).exists(), name


def test_mkoutput_with_relative_paths(tmp_path, monkeypatch):
    """mkoutput changes into --workdir: relative assembly, mer and work
    directories still name what they named before the change."""
    shutil.copytree(GOLD03, tmp_path / "in")
    (tmp_path / "wd").mkdir()
    monkeypatch.chdir(tmp_path)
    main(["mkoutput", "--assembly_path", "in/assembly",
          "--paternal_mer", "in/paternal.mer",
          "--maternal_mer", "in/maternal.mer", "--prefer", "paternal",
          "--workdir", "wd", "--device", "cpu"])
    for name in ("phasing.out", "output.father.fa", "output.supplement.fa"):
        assert (tmp_path / "wd" / name).read_bytes() == \
            (GOLD03 / name).read_bytes(), name
    assert os.readlink(tmp_path / "wd" / "output.primary.fa") == \
        "output.father.fa"


def test_every_module_imports_without_jax_or_hast_tpu():
    import pkgutil
    import hast_tpu_torch
    names = sorted(m.name for m in pkgutil.walk_packages(
        hast_tpu_torch.__path__, "hast_tpu_torch.")
        if m.name != "hast_tpu_torch.__main__")
    assert "hast_tpu_torch.pipeline.rephase" in names
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['hast_tpu'] = None\n"
            f"for name in {names!r}:\n    __import__(name)\n"
            "bad = sorted(m for m, mod in sys.modules.items() if mod is not "
            "None and m.split('.')[0] in ('jax', 'hast_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_stage03_device_cuda_without_a_card_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["mkoutput", "--assembly_path", str(GOLD03 / "assembly"),
                  "--paternal_mer", str(GOLD03 / "paternal.mer"),
                  "--maternal_mer", str(GOLD03 / "maternal.mer"),
                  "--workdir", str(tmp_path)],
                 ["classify-segments", "--hap", str(GOLD03 / "paternal.mer"),
                  "--hap", str(GOLD03 / "maternal.mer"), "--read",
                  str(GOLD03 / "fastq_mode.fq")],
                 ["run", "--paternal", str(E2E / "paternal.fa.gz"),
                  "--maternal", str(E2E / "maternal.fa.gz"),
                  "--read1", str(E2E / "son.r1.fq.gz"),
                  "--read2", str(E2E / "son.r2.fq"),
                  "--workdir", str(tmp_path / "run")]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert "no CUDA device" in str(e.value.code), argv
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("mesh", ["4x2", "1x1", "auto"])
def test_classify_mesh_without_jax_matches_golden(inputs, mesh):
    """classify --mesh on the CPU (a named device holds every shard)."""
    out = inputs / "phased.out"
    run_no_jax(["classify", "--hap0", str(inputs / "hap0.mer"),
                "--hap1", str(inputs / "hap1.mer"),
                "--read", str(inputs / "reads1.fq.gz"),
                "--read", str(inputs / "reads2.fq"), "--weight0", "1.04",
                "--batch-size", "4096", "--output", str(out), "--mesh", mesh,
                "--device", "cpu"], inputs, OMP_NUM_THREADS="1")
    assert out.read_bytes() == (GOLD / "phased.barcodes.golden").read_bytes()


def test_classify_reads_mesh_without_jax_matches_goldens(inputs):
    wd = inputs / "wd"
    wd.mkdir()
    run_no_jax(classify_reads_argv(inputs, wd) + ["--mesh", "2x2"], inputs,
               OMP_NUM_THREADS="1")
    assert (wd / "phased.barcodes").read_bytes() == \
        (GOLD / "phased.barcodes.golden").read_bytes()
    for name in ("paternal", "maternal", "homozygous"):
        assert (wd / f"{name}.unique.barcodes").read_bytes() == \
            (GOLD / f"{name}.unique.barcodes.golden").read_bytes()


def test_build_markers_mesh_without_jax_matches_goldens(tmp_path):
    # one intra-op thread: the twins' small ops only contend beside other
    # test workers
    proc = run_no_jax(
        ["build-markers", "--auto_bounds", "--mesh", "4",
         "--paternal", str(GOLD00 / "paternal.reads.fa.gz"),
         "--maternal", str(GOLD00 / "maternal.reads.fa.gz"),
         "--out-dir", str(tmp_path), "--device", "cpu"], tmp_path,
        OMP_NUM_THREADS="1")
    for parent in ("maternal", "paternal"):
        assert (tmp_path / f"{parent}.kmercount.histo").read_bytes() == \
            (GOLD00 / f"{parent}.histo").read_bytes()
        assert (tmp_path / f"{parent}.bounds.txt").read_bytes() == \
            (GOLD00 / f"{parent}.bounds.txt").read_bytes()
        assert sorted((tmp_path / f"{parent}.unique.filter.mer")
                      .read_bytes().split()) == sorted(
            (GOLD00 / f"{parent}.unique.filter.mer").read_bytes().split())
    assert "mesh-sharded device count tables" in proc.stderr
    assert (tmp_path / "step_00_markers_done").exists()


@pytest.mark.parametrize("mesh", ["4x2", "2x1x2", "x"])
def test_build_markers_mesh_rejects_tp_and_bad_grids(tmp_path, mesh):
    with pytest.raises(SystemExit) as e:
        main(["build-markers", "--mesh", mesh, "--paternal",
              str(GOLD00 / "paternal.reads.fa.gz"), "--maternal",
              str(GOLD00 / "maternal.reads.fa.gz"), "--out-dir",
              str(tmp_path / "00"), "--device", "cpu"])
    assert "--mesh" in str(e.value.code)
    assert not (tmp_path / "00").exists()


def test_merge_results_without_jax_matches_golden(inputs):
    shards = []
    for i, read in enumerate(("reads1.fq.gz", "reads2.fq")):
        shards.append(inputs / f"shard{i}.out")
        main(["classify", "--hap0", str(inputs / "hap0.mer"), "--hap1",
              str(inputs / "hap1.mer"), "--read", str(inputs / read),
              "--weight0", "1.04", "--output", str(shards[-1]),
              "--device", "cpu"])
    proc = run_no_jax(["merge-results", "--input", str(shards[0]),
                       "--input", str(shards[1]), "--hap0",
                       str(inputs / "hap0.mer"), "--hap1",
                       str(inputs / "hap1.mer"), "--weight0", "1.04"], inputs)
    assert proc.stdout == (GOLD / "phased.barcodes.golden").read_text()


@pytest.mark.parametrize("cmd", ["build-markers", "classify",
                                 "classify-reads"])
def test_mesh_in_help(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 0
    assert "--mesh" in capsys.readouterr().out


TOOL_CMDS = ["mark-library", "classify-hic", "vcf-snp-only", "vcf-snp-info",
             "vcf-phased-snp", "vcf-dipcall-hapsnp", "vcf-merge-hap-snp",
             "vcf-hap-inherit", "vcf-inherit-solid", "vcf-inherit-3aa",
             "vcf-phase-inherit-solid", "vcf-calc-hd", "draw-heatalign",
             "get-n", "check-genes", "plot-bounds",
             "filter-fastq-by-barcodes", "warmup"]


@pytest.mark.parametrize("cmd", TOOL_CMDS)
def test_help_tools(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert f"hast_tpu_torch {cmd}" in out
    assert ("--device" in out) == (cmd == "warmup")


def jax_cli_stdout(argv, monkeypatch) -> bytes:
    """`python -m hast_tpu.cli` in this process (no jit cache), stdout."""
    pytest.importorskip("jax")
    import contextlib
    import io
    from hast_tpu import cli as jax_cli
    monkeypatch.setenv("HAST_TPU_NO_JIT_CACHE", "1")
    buf = io.BytesIO()

    class Out:
        buffer = buf

        def write(self, s):
            buf.write(s.encode())

        def flush(self):
            pass

    with contextlib.redirect_stdout(Out()):
        jax_cli.main(argv)
    return buf.getvalue()


HEAT = ROOT / "tests" / "golden" / "heatalign"
TOOL_RUNS = {
    "vcf-snp-info": ["vcf-snp-info",
                     str(ROOT / "tests" / "golden" / "vcfqc" / "child.vcf")],
    "mark-library": ["mark-library", str(GOLD / "reads2.fq"), "3"],
    "filter-fastq-by-barcodes": ["filter-fastq-by-barcodes",
                                 str(GOLD / "reads2.fq"), "keep.txt"],
    "draw-heatalign": ["draw-heatalign", "1100000",
                       "-i", str(HEAT / "H1.align.txt"),
                       "-i", str(HEAT / "H2.align.txt"),
                       "-g", str(HEAT / "genes.txt"), "--preset", "MHC"],
    "check-genes": ["check-genes", str(HEAT / "H1.align.txt"),
                    str(HEAT / "cg.genes.txt")],
}


@pytest.mark.parametrize("cmd", list(TOOL_RUNS))
def test_tools_without_jax_match_the_jax_cli(cmd, tmp_path, monkeypatch):
    """The tool subcommands with jax and hast_tpu blocked print the JAX
    CLI's bytes; filter-fastq-by-barcodes appends the same log line."""
    keep = (GOLD / "paternal.unique.barcodes.golden").read_bytes()
    (tmp_path / "keep.txt").write_bytes(b"\n".join(keep.split()[:40]) + b"\n")
    ours = subprocess.run(
        [sys.executable, "-c", NO_JAX, *TOOL_RUNS[cmd]], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        timeout=300)
    assert ours.returncode == 0, ours.stderr[-3000:]
    assert ours.stdout
    log = tmp_path / "filter_reads.log"
    ours_log = log.read_bytes() if log.exists() else None
    if log.exists():
        log.unlink()
    monkeypatch.chdir(tmp_path)
    assert ours.stdout == jax_cli_stdout(TOOL_RUNS[cmd], monkeypatch)
    if ours_log is not None:
        assert ours_log == log.read_bytes()


def test_mark_library_rejects_lib_id_0(tmp_path):
    with pytest.raises(SystemExit) as e:
        main(["mark-library", str(GOLD / "reads2.fq"), "0"])
    assert e.value.code == "invalid lib_id : 0"


def test_warmup_on_cpu(capsys):
    main(["warmup", "--device", "cpu", "--markers", "3000", "--reads", "256"])
    out = capsys.readouterr().out
    assert out.startswith("warm: ") and "(kernels: " in out


def test_warmup_cuda_without_a_card_is_an_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        main(["warmup", "--markers", "3000", "--reads", "256"])
    assert "no CUDA device" in str(e.value.code)
    assert "warm:" not in capsys.readouterr().out
