"""The PyTorch port's command line (hast_tpu/cli.py's pipeline commands).

  build-markers     00.build_unshare_kmers: parental count tables, histos,
                    bounds and unique.filter.mer files behind the
                    step_00_markers checkpoint
  classify          the reference `classify` binary (phased.barcodes)
  classify-reads    classify_stlfr_reads.sh: classify, barcode splits and
                    fastq quartering behind step_9/10/11 checkpoints
  merge-results     01 mergeResult (fixed semantics: equals a single run)
  prepare-10x       02 barcode_freq + merge_barcodes + fake_10x (host only)
  assemble          02 supernova wrapper (external binary required; host)
  mkoutput          03 mkoutput_by_fabulous2.0 (Split->classify->merge->GenSq)
  classify-segments 03 `classify` fasta binary
  run               HAST.sh end-to-end orchestrator
  mark-library      tools/mark_library.sh
  classify-hic      tools/classify_hic_reads.sh
  vcf-*             the ten self_vcftools programs
  draw-heatalign, get-n, check-genes   tools/draw_heatalign
  plot-bounds       draw_bounds.py (needs matplotlib; skipped without it)
  filter-fastq-by-barcodes   filter_fq_by_barcodes.awk
  warmup            build the kernels and libhastio, then run the stage-01
                    and stage-00 kernels once on synthetic inputs

Each takes the JAX package's flags.  The subcommands that run kernels
take --device (default cuda); a CUDA device that is not there is an
error, and the run never moves to the CPU on its own.  merge-results,
prepare-10x, assemble and the tools run no device work and take no
--device.

--mesh DPxTP (build-markers: DP or DPx1; or auto) runs build-markers,
classify and classify-reads on a dp×tp mesh of --device's devices:
``--device cuda`` gives shard i the card cuda:i, and a grid that needs
more cards than there are is an error; a named device (cpu, cuda:N)
holds every shard.  classify under HAST_NUM_PROCESSES > 1 (with
HAST_PROCESS_ID and HAST_COORDINATOR=host:port) classifies this
process's share of the files, reduces over the processes with
torch.distributed (gloo), and process 0 writes.

Usage: python -m hast_tpu_torch <subcommand> --help
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def _split_paths(values):
    """Flatten quoted whitespace-separated file lists (HAST.sh:23-37)."""
    out = []
    for v in values or []:
        out.extend(v.split())
    return out


def _option_order(parser: argparse.ArgumentParser, argv) -> dict:
    """Each long option of parser -> the index of the first argv token
    that argparse reads as it (exact, --opt=value or a unique prefix),
    or len(argv) when none does."""
    opts = [s for act in parser._actions for s in act.option_strings
            if s.startswith("--")]
    order = dict.fromkeys(opts, len(argv))
    for i, tok in enumerate(argv):
        if tok == "--":
            break
        if not tok.startswith("--"):
            continue
        name = tok.split("=", 1)[0]
        hits = [name] if name in order else [o for o in opts
                                             if o.startswith(name)]
        if len(hits) == 1:
            order[hits[0]] = min(order[hits[0]], i)
    return order


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"ERROR: --device {name}: no CUDA device is available "
                 "(pass --device cpu to run the plain PyTorch twins)")
    if dev.type == "cuda" and dev.index is not None and \
            dev.index >= torch.cuda.device_count():
        sys.exit(f"ERROR: --device {name}: only "
                 f"{torch.cuda.device_count()} CUDA devices are visible")
    return dev


def _mesh_devices(device: torch.device, n: int | None = None) -> list:
    """n devices for a mesh's shards (all there are when n is None):
    ``cuda`` means cuda:0 ... cuda:n-1, a named device holds every shard."""
    from hast_tpu_torch.parallel import mesh as PM
    if device.type == "cuda" and device.index is None:
        cards = PM.visible_devices()
        if n is not None and n > len(cards):
            sys.exit(f"ERROR: the mesh needs {n} cards, {len(cards)} are "
                     "visible (a named --device, e.g. cuda:0, holds every "
                     "shard)")
        return cards[:n] if n is not None else cards
    return [device] * (n or 1)


def _grid(spec: str, n_devices: int, auto_tp=lambda n: 1) -> tuple[int, int]:
    """(dp, tp) of --mesh DPxTP, DP or auto (n_devices, tp = auto_tp(n))."""
    if spec == "auto":
        tp = auto_tp(n_devices)
        return n_devices // tp, tp
    parts = spec.lower().split("x")
    try:
        if len(parts) > 2:
            raise ValueError(spec)
        dp = int(parts[0])
        tp = int(parts[1]) if len(parts) > 1 and parts[1] else 1
    except ValueError:
        sys.exit(f"ERROR: --mesh takes DPxTP, DP or auto (got {spec})")
    if dp < 1 or tp < 1:
        sys.exit(f"ERROR: --mesh {spec}: dp and tp must be positive")
    return dp, tp


def _mesh(spec: str, device: torch.device, auto_tp=lambda n: 1):
    from hast_tpu_torch.parallel import mesh as PM
    dp, tp = _grid(spec, len(_mesh_devices(device)), auto_tp)
    return PM.make_mesh(dp * tp, tp=tp,
                        devices=_mesh_devices(device, dp * tp))


def _add_mesh(p, what: str) -> None:
    p.add_argument("--mesh", default=None, metavar="DPxTP|auto",
                   help=f"{what} on a dp×tp mesh of --device's devices "
                        "(cuda: cuda:0 ... cuda:n-1, one shard each; a named "
                        "device holds every shard; auto: every card)")


def _add_device(p, what: str) -> None:
    p.add_argument("--device", default="cuda",
                   help=f"torch device of {what} and the kernels (default "
                        "cuda; cpu runs the plain twins)")


def _adaptor_kw(a) -> dict:
    kw = {}
    if a.adaptor_f is not None:
        kw["adaptor_f"] = a.adaptor_f
    if a.adaptor_r is not None:
        kw["adaptor_r"] = a.adaptor_r
    return kw


def _common(p) -> None:
    p.add_argument("--adaptor_f", default=None)
    p.add_argument("--adaptor_r", default=None)
    p.add_argument("--batch-size", type=int, default=1 << 15)
    p.add_argument("--thread", type=int, default=None,
                   help="accepted for reference compatibility (unused)")
    _add_device(p, "the marker table")


def _add_build_markers(sub):
    p = sub.add_parser("build-markers", help="stage 00: unique marker mers")
    p.add_argument("--paternal", action="append", required=True)
    p.add_argument("--maternal", action="append", required=True)
    p.add_argument("--mer", type=int, default=21)
    p.add_argument("--auto_bounds", action="store_true")
    p.add_argument("--m-lower", type=int, default=9)
    p.add_argument("--m-upper", type=int, default=33)
    p.add_argument("--p-lower", type=int, default=9)
    p.add_argument("--p-upper", type=int, default=33)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--batch-size", type=int, default=1 << 14)
    p.add_argument("--count-parts", type=int, default=None,
                   help="split the k-mer key space into N ranges counted "
                        "in N passes (bounded device memory for inputs "
                        "whose distinct set exceeds it); default "
                        "HAST_COUNT_PARTS, else 1")
    p.add_argument("--engine", choices=("auto", "device", "host"),
                   default=None,
                   help="device (and auto): count tables stay on the "
                        "device, only final markers fetched (one "
                        "all-or-nothing checkpoint); host: per-substep "
                        ".counts.npz snapshots and finer resume; default "
                        "HAST_STAGE00_ENGINE, else auto")
    p.add_argument("--thread", type=int, default=None,
                   help="accepted for reference compatibility (unused)")
    p.add_argument("--memory", type=int, default=None,
                   help="accepted for reference compatibility (unused)")
    p.add_argument("--mesh", default=None, metavar="DP|DPx1|auto",
                   help="count tables hash-range-sharded over a mesh of DP "
                        "of --device's devices (cuda: cuda:0 ... "
                        "cuda:DP-1; a named device holds every shard; "
                        "auto: every card)")
    _add_device(p, "the count tables")

    def run(a):
        from hast_tpu_torch.utils.checkpoint import step
        from hast_tpu_torch.pipeline import markers as M
        # reference sanity bounds (build_unshared_kmers.sh:145-152)
        if a.mer < 11 or a.mer > 31:
            sys.exit("ERROR : arguments invalid ... exit!!! (11 <= mer <= 31)")
        if not (1 <= a.m_lower and a.m_upper <= 100000000
                and 1 <= a.p_lower and a.p_upper <= 100000000):
            sys.exit("ERROR : arguments invalid ... exit!!! ")
        device = _device(a.device)
        mesh = _mesh(a.mesh, device) if a.mesh else None
        if mesh is not None and mesh.tp != 1:   # stage 00 has no tp axis
            sys.exit("ERROR: build-markers --mesh shards count tables over "
                     f"DP only; use '{mesh.dp}' or '{mesh.dp}x1' (got "
                     f"{a.mesh})")
        with step("00_markers", a.out_dir) as todo:
            if todo and mesh is not None:
                from hast_tpu_torch.parallel import distributed as D
                D.build_unshared_markers_mesh(
                    mesh, _split_paths(a.paternal), _split_paths(a.maternal),
                    a.out_dir, k=a.mer, auto_bounds=a.auto_bounds,
                    p_lower=a.p_lower, p_upper=a.p_upper,
                    m_lower=a.m_lower, m_upper=a.m_upper,
                    batch_size=a.batch_size)
            elif todo:
                M.build_unshared_markers(
                    _split_paths(a.paternal), _split_paths(a.maternal),
                    a.out_dir, k=a.mer, auto_bounds=a.auto_bounds,
                    p_lower=a.p_lower, p_upper=a.p_upper,
                    m_lower=a.m_lower, m_upper=a.m_upper,
                    batch_size=a.batch_size, n_parts=a.count_parts,
                    engine=a.engine, device=device)
    p.set_defaults(func=run)


def _add_classify(sub):
    p = sub.add_parser("classify", help="stage 01: classify stLFR reads")
    p.add_argument("--hap0", required=True)
    p.add_argument("--hap1", required=True)
    p.add_argument("--read", action="append", required=True)
    p.add_argument("--weight0", type=float, default=1.0)
    p.add_argument("--weight1", type=float, default=1.0)
    p.add_argument("--output", default="-")
    _add_mesh(p, "classify (table over tp, reads over dp)")
    _common(p)

    def run(a):
        from hast_tpu_torch.pipeline import classify as C
        device = _device(a.device)
        reads = _split_paths(a.read)
        if int(os.environ.get("HAST_NUM_PROCESSES", "1")) > 1:
            _classify_multiprocess(a, device, reads)
            return
        out = sys.stdout.buffer if a.output == "-" else open(a.output, "wb")
        try:
            if a.mesh:
                from hast_tpu_torch.parallel import mesh as PM
                table = C.load_marker_table(a.hap0, a.hap1)
                C.erase_adaptors(table, **_adaptor_kw(a))
                mesh = _mesh(a.mesh, device, lambda n: PM.choose_tp(
                    table.data.numel() * 4, n))
                tally = C.classify_fastqs_mesh(mesh, table, reads,
                                               batch_size=a.batch_size)
                C.write_phased_barcodes(tally, table, out, a.weight0,
                                        a.weight1)
            else:
                C.run_classify(a.hap0, a.hap1, reads, out, w0=a.weight0,
                               w1=a.weight1, batch_size=a.batch_size,
                               device=device, **_adaptor_kw(a))
        finally:
            if out is not sys.stdout.buffer:
                out.close()
    p.set_defaults(func=run)


def _classify_multiprocess(a, device, reads) -> None:
    """classify under HAST_NUM_PROCESSES > 1: this process's share of the
    files on its device (tp = 1) or a tp-sharded mesh (--mesh DPxTP), a
    reduce over the processes, and process 0 writes."""
    from hast_tpu_torch.parallel import distributed as D
    from hast_tpu_torch.pipeline import classify as C
    D.initialize()
    table = C.load_marker_table(a.hap0, a.hap1)
    C.erase_adaptors(table, **_adaptor_kw(a))
    tp = 1
    if a.mesh and a.mesh != "auto":
        tp = _grid(a.mesh, 1)[1]
    devices = None
    if tp > 1:   # every card of `cuda`, else tp shards on the named device
        every_card = device.type == "cuda" and device.index is None
        devices = _mesh_devices(device, None if every_card else tp)
    tally = D.classify_fastqs_multihost(table, reads,
                                        batch_size=a.batch_size, tp=tp,
                                        device=device, devices=devices)
    if D.process_index() == 0:
        out = sys.stdout.buffer if a.output == "-" else open(a.output, "wb")
        try:
            C.write_phased_barcodes(tally, table, out, a.weight0, a.weight1)
        finally:
            if out is not sys.stdout.buffer:
                out.close()


def _add_classify_reads(sub):
    p = sub.add_parser("classify-reads",
                       help="stage 01 driver: classify + split + quartering")
    p.add_argument("--paternal_mer", required=True)
    p.add_argument("--maternal_mer", required=True)
    p.add_argument("--filial", action="append", required=True)
    p.add_argument("--workdir", default=".")
    p.add_argument("--format", choices=("fasta", "fastq"), default="fastq",
                   help="accepted for reference compatibility")
    _add_mesh(p, "classify (reads over dp, table over tp; auto: tp = 1)")
    _common(p)

    def run(a):
        from hast_tpu_torch.utils.checkpoint import step
        from hast_tpu_torch.pipeline import classify as C
        from hast_tpu_torch.pipeline import partition as P
        device = _device(a.device)
        mesh = _mesh(a.mesh, device) if a.mesh else None
        wd = a.workdir
        filial = _split_paths(a.filial)
        phased = os.path.join(wd, "phased.barcodes")
        with step("9", wd) as todo:
            if todo:
                # driver parity: weight0=1.04 (classify_stlfr_reads.sh:148)
                with open(phased, "wb") as out:
                    C.run_classify(a.paternal_mer, a.maternal_mer, filial,
                                   out, w0=1.04, batch_size=a.batch_size,
                                   device=device, mesh=mesh,
                                   **_adaptor_kw(a))
        with step("10", wd) as todo:
            if todo:
                paths = P.split_barcodes(phased, out_prefix=wd + os.sep)
                for hap, name in (("0", "paternal"), ("1", "maternal"),
                                  ("-1", "homozygous")):
                    with open(paths[hap], "rb") as f:
                        print(f"final {name} barcodes : "
                              f"{sum(1 for _ in f)}")
        with step("11", wd) as todo:
            if todo:
                cwd = os.getcwd()
                os.chdir(wd)
                try:
                    for x in filial:
                        x = x if os.path.isabs(x) else os.path.join(cwd, x)
                        P.quarter_fastq(x, "paternal.unique.barcodes",
                                        "maternal.unique.barcodes",
                                        "homozygous.unique.barcodes")
                finally:
                    os.chdir(cwd)
    p.set_defaults(func=run)


def _add_merge_results(sub):
    p = sub.add_parser("merge-results",
                       help="merge sharded phased.barcodes (fixed semantics)")
    p.add_argument("--input", action="append", required=True)
    p.add_argument("--size0", type=int, help="hap0 marker set size")
    p.add_argument("--size1", type=int, help="hap1 marker set size")
    p.add_argument("--hap0", help="recompute sizes from mer files")
    p.add_argument("--hap1")
    p.add_argument("--weight0", type=float, default=1.0)
    p.add_argument("--weight1", type=float, default=1.0)

    def run(a):
        from hast_tpu_torch.parallel import merge as PMerge
        size0, size1 = a.size0, a.size1
        if size0 is None or size1 is None:
            if not (a.hap0 and a.hap1):
                sys.exit("need --size0/--size1 or --hap0/--hap1")
            from hast_tpu_torch.pipeline import classify as C
            table = C.load_marker_table(a.hap0, a.hap1)
            C.erase_adaptors(table)
            size0, size1 = table.set_sizes
        PMerge.merge_phased_files(a.input, sys.stdout.buffer,
                                  size0, size1, a.weight0, a.weight1)
    p.set_defaults(func=run)


def _add_prepare_10x(sub):
    p = sub.add_parser("prepare-10x", help="stage 02: fake-10X conversion")
    p.add_argument("--read1", action="append", required=True)
    p.add_argument("--read2", action="append", required=True)
    p.add_argument("--whitelist", required=True)
    p.add_argument("--min_rp", type=int, default=1)
    p.add_argument("--out-dir", default=".")

    def run(a):
        from hast_tpu_torch.pipeline import tenx as T
        total, used = T.prepare_10x(a.read1, a.read2, a.whitelist,
                                    a.out_dir, a.min_rp)
        print(f"Total {total} pairs and used {used} pairs")
    p.set_defaults(func=run)


def _add_assemble(sub):
    p = sub.add_parser("assemble", help="stage 02: run external Supernova")
    p.add_argument("--supernova", required=True)
    p.add_argument("--read1", action="append", required=True)
    p.add_argument("--read2", action="append", required=True)
    p.add_argument("--prefix", default="output")
    p.add_argument("--thread", type=int, default=30)
    p.add_argument("--memory", type=int, default=800)
    p.add_argument("--min_rp", type=int, default=1)
    p.add_argument("--out-dir", default=".")

    def run(a):
        import glob
        from hast_tpu_torch.pipeline import tenx as T
        wl = glob.glob(os.path.join(
            a.supernova, "supernova-cs", "*", "tenkit", "lib", "python",
            "tenkit", "barcodes", "4M-with-alts-february-2016.txt"))
        if not wl:
            sys.exit(f"{a.supernova} is not a valid supernova path")
        T.prepare_10x(a.read1, a.read2, wl[0], a.out_dir, a.min_rp)
        T.assemble(a.supernova, a.out_dir, a.prefix, a.thread, a.memory)
    p.set_defaults(func=run)


def _add_mkoutput(sub):
    p = sub.add_parser("mkoutput", help="stage 03: re-phase pseudohap2")
    p.add_argument("--assembly_path", required=True)
    p.add_argument("--paternal_mer", required=True)
    p.add_argument("--maternal_mer", required=True)
    p.add_argument("--prefix", default="output")
    p.add_argument("--thread", type=int, default=None,
                   help="accepted for reference compatibility (unused)")
    p.add_argument("--prefer", choices=("paternal", "maternal"),
                   help="default: whichever mer flag came first "
                        "(reference order rule)")
    p.add_argument("--workdir", default=".")
    _add_device(p, "the segment table")

    def run(a):
        from hast_tpu_torch.pipeline import rephase as R
        prefer = a.prefer
        if prefer is None:
            # reference rule: the first --*_mer on the command line wins
            order = _option_order(p, a.argv)
            prefer = ("paternal" if order["--paternal_mer"]
                      <= order["--maternal_mer"] else "maternal")
        timings = {}
        R.mkoutput(a.assembly_path, a.prefix, a.paternal_mer,
                   a.maternal_mer, prefer, a.workdir,
                   device=_device(a.device), timings=timings)
        print("[hast_tpu_torch] mkoutput steps: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in timings.items()), file=sys.stderr)
    p.set_defaults(func=run)


def _add_classify_segments(sub):
    p = sub.add_parser("classify-segments",
                       help="stage 03: per-sequence haplotype verdicts")
    p.add_argument("--hap", action="append", required=True)
    p.add_argument("--read", action="append", required=True)
    p.add_argument("--format", choices=("fasta", "fastq"), default="fasta")
    p.add_argument("--thread", type=int, default=None,
                   help="accepted for reference compatibility (unused)")
    _add_device(p, "the segment table")

    def run(a):
        from hast_tpu_torch.pipeline import rephase as R
        R.classify_segments(a.hap, a.read, _StdoutText(), a.format,
                            device=_device(a.device))
    p.set_defaults(func=run)


def _add_run(sub):
    p = sub.add_parser("run", help="end-to-end HAST pipeline (HAST.sh)")
    p.add_argument("--paternal", action="append", required=True)
    p.add_argument("--maternal", action="append", required=True)
    p.add_argument("--read1", action="append", required=True)
    p.add_argument("--read2", action="append", required=True)
    p.add_argument("--supernova", help="optional; stops after stage 01 "
                                       "bins if absent")
    p.add_argument("--thread", type=int, default=8)
    p.add_argument("--memory", type=int, default=800)
    p.add_argument("--workdir", default=".")
    _add_device(p, "stages 00, 01 and 03")

    def run(a):
        from hast_tpu_torch.models.trio import TrioBinningPipeline
        TrioBinningPipeline(
            paternal=_split_paths(a.paternal),
            maternal=_split_paths(a.maternal),
            read1=_split_paths(a.read1), read2=_split_paths(a.read2),
            supernova=a.supernova, threads=a.thread, memory_gb=a.memory,
            workdir=a.workdir, device=str(_device(a.device))).run()
    p.set_defaults(func=run)


class _StdoutText:
    """Text writer over sys.stdout.buffer (bytes as written, no newline
    translation) that never closes it."""

    def write(self, s: str) -> None:
        sys.stdout.buffer.write(s.encode())

    def flush(self) -> None:
        sys.stdout.buffer.flush()


def _add_mark_library(sub):
    p = sub.add_parser("mark-library",
                       help="prefix barcodes with libN_ (tools/mark_library)")
    p.add_argument("input")
    p.add_argument("lib_id", type=int)

    def run(a):
        from hast_tpu_torch.tools.mark_library import mark_library
        if a.lib_id < 1:
            sys.exit(f"invalid lib_id : {a.lib_id}")
        mark_library(a.input, a.lib_id, sys.stdout.buffer)
    p.set_defaults(func=run)


def _add_classify_hic(sub):
    p = sub.add_parser("classify-hic",
                       help="trio-bin Hi-C reads from two SAMs")
    p.add_argument("pat_sam")
    p.add_argument("mat_sam")
    p.add_argument("--out-dir", default=".")

    def run(a):
        from hast_tpu_torch.tools.hic import classify_hic_reads
        classify_hic_reads(a.pat_sam, a.mat_sam, a.out_dir)
    p.set_defaults(func=run)


_VCF_PROGRAMS = (
    ("vcf-snp-only", ["vcf"], "GetSNPOnly: echo SNP lines", "get_snp_only"),
    ("vcf-snp-info", ["vcf"], "GetSNPInfo: CHROM POS ALT1 ALT2",
     "get_snp_info"),
    ("vcf-phased-snp", ["vcf"], "PhasedSNP: phased het SNPs + PS blocks",
     "phased_snp"),
    ("vcf-dipcall-hapsnp", ["vcf"], "GetHapSNP_fromDipcall",
     "get_hapsnp_from_dipcall"),
    ("vcf-merge-hap-snp", ["hap1_vcf", "hap2_vcf"],
     "MergeHapSNP: pair SNPs across hap VCFs (chr1-22)", "merge_hap_snp"),
    ("vcf-hap-inherit", ["parent_vcf", "child_vcf"],
     "HapInherit: inheritance typing vs one parent", "hap_inherit"),
    ("vcf-inherit-solid", ["p1_vcf", "p2_vcf", "f1_vcf"],
     "InheritSolidSNP: trio-consistent solid SNPs", "inherit_solid_snp"),
    ("vcf-inherit-3aa", ["p1_vcf", "p2_vcf", "f1_vcf"],
     "Inherit3Aa: both-parents-both-alleles SNPs", "inherit_3aa"),
    ("vcf-phase-inherit-solid", ["p1_vcf", "p2_vcf", "f1_vcf"],
     "PhaseInheritSolidSNP (stats only, as shipped)",
     "phase_inherit_solid_snp"),
)


def _add_vcfqc(sub):
    """All ten self_vcftools programs as vcf-* subcommands; stdout goes
    through the shim, stderr is the process's at the call."""
    for name, args, help_, fn_name in _VCF_PROGRAMS:
        p = sub.add_parser(name, help=help_)
        for arg in args:
            p.add_argument(arg)

        def run(a, args=args, fn_name=fn_name):
            from hast_tpu_torch.tools import vcfqc as V
            getattr(V, fn_name)(*[getattr(a, arg) for arg in args],
                                _StdoutText(), sys.stderr)
        p.set_defaults(func=run)

    p = sub.add_parser("vcf-calc-hd",
                       help="CalcHD: Hamming + switch error rate")
    p.add_argument("true_phased_blocks")
    p.add_argument("merged_snps")

    def run_hd(a):
        from hast_tpu_torch.tools import vcfqc as V
        V.calc_hd(a.true_phased_blocks, a.merged_snps, sys.stderr)
    p.set_defaults(func=run_hd)


def _add_heatalign(sub):
    p = sub.add_parser("draw-heatalign",
                       help="KIR/MHC alignment heat SVG to stdout")
    p.add_argument("ref_len", type=int)
    p.add_argument("-i", dest="aligns", action="append", required=True,
                   help="xxx.align.txt (repeatable)")
    p.add_argument("-g", dest="genes", default=None)
    p.add_argument("--preset", choices=("KIR", "MHC"), default="KIR")

    def run(a):
        from hast_tpu_torch.tools.heatalign import draw_heatalign
        draw_heatalign(a.ref_len, a.aligns, _StdoutText(), gene_file=a.genes,
                       preset=a.preset, err=sys.stderr)
    p.set_defaults(func=run)

    p2 = sub.add_parser("get-n", help="report N runs in fasta (stdin)")

    def run_n(a):
        from hast_tpu_torch.tools.heatalign import get_n
        get_n(sys.stdin, _StdoutText())
    p2.set_defaults(func=run_n)

    p3 = sub.add_parser("check-genes",
                        help="per-gene alignment coverage fraction")
    p3.add_argument("align_txt")
    p3.add_argument("genes_txt")

    def run_g(a):
        from hast_tpu_torch.tools.heatalign import check_genes
        check_genes(a.align_txt, a.genes_txt, _StdoutText())
    p3.set_defaults(func=run_g)


def _add_plot_bounds(sub):
    p = sub.add_parser("plot-bounds",
                       help="k-mer depth histogram plot (draw_bounds.py)")
    p.add_argument("--workdir", default=".")
    p.add_argument("--out", default="test.png")

    def run(a):
        from hast_tpu_torch.utils.plot_bounds import plot_bounds
        path = plot_bounds(a.workdir, a.out)
        print(path if path else "matplotlib unavailable; skipped")
    p.set_defaults(func=run)


def _add_filter_barcodes(sub):
    p = sub.add_parser("filter-fastq-by-barcodes",
                       help="keep records whose barcode is listed "
                            "(filter_fq_by_barcodes.awk)")
    p.add_argument("fastq")
    p.add_argument("barcode_list")

    def run(a):
        from hast_tpu_torch.pipeline.partition import filter_fastq_by_barcodes
        filter_fastq_by_barcodes(a.fastq, a.barcode_list, sys.stdout.buffer)
    p.set_defaults(func=run)


def _add_warmup(sub):
    p = sub.add_parser(
        "warmup",
        help="build the CUDA kernels and libhastio if they are absent, then "
             "run the stage-01 and stage-00 kernels once (the JAX package's "
             "compile-cache warmup)")
    p.add_argument("--hap0", help="real marker file (the deployment "
                                  "table's exact shape)")
    p.add_argument("--hap1")
    p.add_argument("--markers", type=int, default=2_000_000,
                   help="synthetic marker count per hap when no real "
                        "files are given (sizes the probe table)")
    p.add_argument("--read-len", type=int, default=100,
                   help="typical read length")
    p.add_argument("--reads", type=int, default=1 << 17,
                   help="synthetic reads to stream (the steady-state and "
                        "tail batches)")
    p.add_argument("--mer", type=int, default=21)
    _add_device(p, "the tables")

    def run(a):
        import tempfile
        import time

        import numpy as np

        from hast_tpu_torch.io import native as N
        from hast_tpu_torch.ops import _build
        from hast_tpu_torch.ops import encode as E
        from hast_tpu_torch.ops import hashtable as H
        from hast_tpu_torch.ops import kmer_count as KC
        from hast_tpu_torch.pipeline import classify as C
        from hast_tpu_torch.pipeline.markers import count_files_device

        device = _device(a.device)
        t0 = time.perf_counter()
        kernels = "none, --device cpu runs the twins"
        if device.type == "cuda":
            _build.load_library()
            kernels = _build.library_path()
        N.get_lib()
        k = a.mer
        rng = np.random.default_rng(0)
        if a.hap0 and a.hap1:
            table = C.load_marker_table(a.hap0, a.hap1)
        else:
            seqs = rng.integers(0, 4, size=(2 * a.markers, k),
                                dtype=np.int32)
            hi, lo = E.canonical_kmers_np(seqs, k)
            pay = np.repeat(np.array([1, 2], np.uint32), a.markers)
            table = H.build_table(hi[:, 0], lo[:, 0], pay, k,
                                  set_sizes=(a.markers, a.markers))
        C.erase_adaptors(table)
        table = table.to(device)
        letters = np.frombuffer(b"ACGT", np.uint8)
        with tempfile.TemporaryDirectory() as td:
            fq = os.path.join(td, "warm.fq")
            n, L = a.reads, a.read_len
            arr = letters[rng.integers(0, 4, (n, L))]
            with open(fq, "wb", buffering=1 << 22) as f:
                qual = b"F" * L
                for i in range(n):
                    f.write(b"@w%d#%d_%d_%d/1\n%s\n+\n%s\n" % (
                        i, 1 + i % 97, 2, 3, arr[i].tobytes(), qual))
            # stage 01: K3 each batch, K11 at the fetch (97 barcodes never
            # grow the tally, so K10 does not run, as JAX's _grow_acc does
            # not); stage 00: K4-K6 and K12 in the count, K7, K8
            C.classify_fastqs(table, [fq])
            t = count_files_device([fq], k, device=device)
            t.histo()
            KC.device_marker_algebra(t, t, 1, 2, 1, 2)
        print(f"warm: {time.perf_counter() - t0:.1f}s (kernels: {kernels})")
    p.set_defaults(func=run)


def main(argv=None) -> None:
    """Run one subcommand."""
    parser = argparse.ArgumentParser(
        prog="hast_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add in (_add_build_markers, _add_classify, _add_classify_reads,
                _add_merge_results, _add_prepare_10x, _add_assemble,
                _add_mkoutput, _add_classify_segments, _add_run,
                _add_mark_library, _add_classify_hic, _add_vcfqc,
                _add_heatalign, _add_plot_bounds, _add_filter_barcodes,
                _add_warmup):
        add(sub)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    args.argv = argv
    args.func(args)


if __name__ == "__main__":
    main()
