"""The port's host-only tools against hast_tpu's and the goldens.

hast_tpu_torch.tools.{vcfqc,heatalign,hic,mark_library},
pipeline.partition.filter_fastq_by_barcodes and utils.plot_bounds are
jax-free copies: on the same inputs they must give the JAX package's
bytes, and those of the reference programs where tests/golden has them.
The JAX package is imported inside the tests, so that this file imports
where it is absent.
"""

import importlib.util
import io
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest

from hast_tpu_torch.pipeline import partition as P
from hast_tpu_torch.tools import heatalign as HA
from hast_tpu_torch.tools import hic
from hast_tpu_torch.tools import vcfqc as V
from hast_tpu_torch.tools.mark_library import mark_library

GOLD = pathlib.Path(__file__).parent / "golden"
VCF = GOLD / "vcfqc"
HEAT = GOLD / "heatalign"


def _ref(module: str):
    """The JAX package's module of the same name."""
    pytest.importorskip("jax")
    return importlib.import_module(f"hast_tpu.{module}")


def _tools_cases():
    """tests/test_tools.py (its FASTQ, SAM and SAM2), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "tools_cases", pathlib.Path(__file__).parent / "test_tools.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VCF_CASES = [
    ("snponly.out", "get_snp_only", ["child"]),
    ("snpinfo.out", "get_snp_info", ["child"]),
    ("phasedsnp.out", "phased_snp", ["child"]),
    ("dipcall.out", "get_hapsnp_from_dipcall", ["child"]),
    ("mergehap.out", "merge_hap_snp", ["hap1", "hap2"]),
    ("hapinherit.out", "hap_inherit", ["father", "child"]),
    ("inherit3aa.out", "inherit_3aa", ["father", "mother", "child"]),
    ("solidsnp.out", "inherit_solid_snp", ["father", "mother", "child"]),
    ("phasesolid.out", "phase_inherit_solid_snp",
     ["father", "mother", "child"]),
    ("calchd.out.err", "calc_hd", None),
]


@pytest.mark.parametrize("golden,fn,vcfs", VCF_CASES,
                         ids=[c[1] for c in VCF_CASES])
def test_vcfqc_matches_jax_and_goldens(golden, fn, vcfs):
    ref = _ref("tools.vcfqc")
    if vcfs is None:     # CalcHD writes its scores to stderr
        args = [str(VCF / "phasedsnp.out"), str(VCF / "mergehap.out")]
        errs = []
        for mod in (V, ref):
            err = io.StringIO()
            result = getattr(mod, fn)(*args, err)
            errs.append((result, err.getvalue()))
        assert errs[0] == errs[1]
        totals = [x for x in errs[0][1].splitlines()
                  if x.startswith(" total")]
        assert totals and totals == [
            x for x in (VCF / golden).read_text().splitlines()
            if x.startswith(" total")]
        return
    args = [str(VCF / f"{v}.vcf") for v in vcfs]
    outs = []
    for mod in (V, ref):
        out, err = io.StringIO(), io.StringIO()
        getattr(mod, fn)(*args, out, err)
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0] == (VCF / golden).read_text()


@pytest.mark.parametrize("preset", ["KIR", "MHC"])
def test_heatalign_svg_matches_jax_and_golden(preset):
    ref = _ref("tools.heatalign")
    outs = []
    for mod in (HA, ref):
        out = io.StringIO()
        mod.draw_heatalign(1100000, [str(HEAT / "H1.align.txt"),
                                     str(HEAT / "H2.align.txt")],
                           out, gene_file=str(HEAT / "genes.txt"),
                           preset=preset, err=io.StringIO())
        outs.append(out.getvalue())
    golden = (HEAT / f"{preset.lower()}.svg.golden").read_text()
    # queries are named by their align file's path, and the golden holds
    # the directory it was made in
    made = re.search(r">([^<>]*)H1</text>", golden).group(1)
    assert outs[0] == outs[1]
    assert outs[0].replace(f"{HEAT}/", made) == golden


def test_get_n_and_check_genes_match_jax_and_goldens():
    ref = _ref("tools.heatalign")
    for mod in (HA, ref):
        out = io.StringIO()
        with open(HEAT / "n.fa") as f:
            mod.get_n(f, out)
        assert out.getvalue() == (HEAT / "getn.out.golden").read_text()
        out = io.StringIO()
        mod.check_genes(str(HEAT / "H1.align.txt"),
                        str(HEAT / "cg.genes.txt"), out)
        assert out.getvalue() == \
            (HEAT / "checkgenes.out.golden").read_text()


def test_hic_matches_jax(tmp_path):
    ref = _ref("tools.hic")
    cases = _tools_cases()
    (tmp_path / "pat.sam").write_text(cases.SAM)
    (tmp_path / "mat.sam").write_text(cases.SAM2)
    for sam in ("pat.sam", "mat.sam"):
        got = list(hic.get_infos(str(tmp_path / sam)))
        assert got == list(ref.get_infos(str(tmp_path / sam)))
        assert list(hic.get_scores(iter(got))) == \
            list(ref.get_scores(iter(got)))
    outs = {}
    for name, mod in (("ours", hic), ("jax", ref)):
        (tmp_path / name).mkdir()
        mod.classify_hic_reads(str(tmp_path / "pat.sam"),
                               str(tmp_path / "mat.sam"),
                               str(tmp_path / name))
        outs[name] = {f.name: f.read_bytes()
                      for f in sorted((tmp_path / name).iterdir())}
    assert outs["ours"] == outs["jax"]
    assert set(outs["ours"]) == {"paternal.reads", "maternal.reads",
                                 "homo.reads"}


def test_mark_library_matches_awk_and_jax(tmp_path):
    ref = _ref("tools.mark_library")
    fq = tmp_path / "in.fq"
    fq.write_bytes(_tools_cases().FASTQ)
    awk = subprocess.run(
        ["awk", "-F", "#|/", "-v", "lib_id=2",
         '{if(NR%4==1&&NF>1&&$2!="0_0_0"){printf("%s#lib%s_%s/%s\\n",'
         '$1,lib_id,$2,$3);}else print $0; }', str(fq)],
        capture_output=True, check=True).stdout
    ours, theirs = io.BytesIO(), io.BytesIO()
    mark_library(str(fq), 2, ours)
    ref.mark_library(str(fq), 2, theirs)
    assert ours.getvalue() == theirs.getvalue() == awk


def test_filter_fastq_by_barcodes_matches_jax(tmp_path):
    ref = _ref("pipeline.partition")
    reads = GOLD / "stage01" / "reads2.fq"
    barcodes = tmp_path / "keep.txt"
    names = (GOLD / "stage01" / "paternal.unique.barcodes.golden")
    barcodes.write_bytes(b"\n".join(names.read_bytes().splitlines()[:40])
                         + b"\n")
    # a header without a barcode field at the end: the awk `c` flag
    # prints it iff the record before it was kept
    fq = tmp_path / "in.fq"
    first = reads.read_bytes().splitlines(keepends=True)
    fq.write_bytes(b"".join(first) + b"@plainhead\nGGGG\n+\nFFFF\n")
    outs = []
    for name, fn in (("ours", P.filter_fastq_by_barcodes),
                     ("jax", ref.filter_fastq_by_barcodes)):
        out, log = io.BytesIO(), tmp_path / f"{name}.log"
        log.write_bytes(b"earlier line\n")     # the stats line appends
        used = fn(str(fq), str(barcodes), out, log_path=str(log))
        outs.append((used, out.getvalue(), log.read_bytes()))
    assert outs[0] == outs[1]
    used, out, log = outs[0]
    assert 0 < used and out.count(b"\n@") + 1 >= used
    assert log.startswith(b"earlier line\nuse %d from " % used)


@pytest.mark.parametrize("tool", ["mark_library", "filter_fastq_by_barcodes"])
def test_fastq_tools_match_goldens(tool, tmp_path):
    """tests/golden/fastq_tools, the goldens chip_smoke.py holds the CLI
    to: reads2.fq through awk's mark_library line with lib_id 2, and
    through hast_tpu's filter_fastq_by_barcodes with keep40.barcodes (its
    output and its filter_reads.log line)."""
    gold = GOLD / "fastq_tools"
    reads = GOLD / "stage01" / "reads2.fq"
    out = io.BytesIO()
    if tool == "mark_library":
        mark_library(str(reads), 2, out)
        want = (gold / "reads2.lib2.fq.golden").read_bytes()
        assert want == subprocess.run(
            ["awk", "-F", "#|/", "-v", "lib_id=2",
             '{if(NR%4==1&&NF>1&&$2!="0_0_0"){printf("%s#lib%s_%s/%s\\n",'
             '$1,lib_id,$2,$3);}else print $0; }', str(reads)],
            capture_output=True, check=True).stdout
        assert out.getvalue() == want
        return
    ref = _ref("pipeline.partition")
    logs = {}
    for name, fn in (("ours", P.filter_fastq_by_barcodes),
                     ("jax", ref.filter_fastq_by_barcodes)):
        buf = io.BytesIO() if name == "jax" else out
        fn(str(reads), str(gold / "keep40.barcodes"), buf,
           log_path=str(tmp_path / name))
        assert buf.getvalue() == (gold / "reads2.keep40.fq.golden").read_bytes()
        logs[name] = (tmp_path / name).read_bytes()
    assert logs["ours"] == logs["jax"] == \
        (gold / "filter_reads.log.golden").read_bytes()


def _bounds_dir(tmp_path: pathlib.Path) -> pathlib.Path:
    for parent in ("maternal", "paternal"):
        shutil.copy(GOLD / "stage00" / f"{parent}.histo",
                    tmp_path / f"{parent}.kmercount.histo")
        shutil.copy(GOLD / "stage00" / f"{parent}.bounds.txt",
                    tmp_path / f"{parent}.bounds.txt")
    return tmp_path


def test_render_bounds_figure_matches_jax(tmp_path):
    """The same panels, curves and vlines (labels, styles, colours and
    positions) as hast_tpu's figure, tests/test_stage00_parity.py's
    semantics (draw_bounds.py:50-76)."""
    pytest.importorskip("matplotlib")
    ref = _ref("utils.plot_bounds")
    from hast_tpu_torch.utils.plot_bounds import render_bounds_figure
    d = _bounds_dir(tmp_path)
    figs = [render_bounds_figure(str(d)), ref.render_bounds_figure(str(d))]

    def describe(fig):
        return [(ax.get_title(), ax.get_xlim(), ax.get_xlabel(),
                 ax.get_ylabel(),
                 [(ln.get_label(), ln.get_linestyle(), ln.get_color(),
                   np.asarray(ln.get_xdata()).tolist(),
                   np.asarray(ln.get_ydata()).tolist())
                  for ln in ax.get_lines()]) for ax in fig.axes]

    ours, theirs = describe(figs[0]), describe(figs[1])
    assert ours == theirs
    assert [a[0] for a in ours] == ["maternal kmer-depth count",
                                    "paternal kmer-depth count"]
    assert all(len(a[4]) == 5 for a in ours)


def test_plot_bounds_without_matplotlib_is_skipped(tmp_path, monkeypatch,
                                                   capsys):
    from hast_tpu_torch.cli import main
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    main(["plot-bounds", "--workdir", str(_bounds_dir(tmp_path))])
    assert capsys.readouterr().out == "matplotlib unavailable; skipped\n"
    assert not (tmp_path / "test.png").exists()
