#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hast_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It exits non-zero, printing no result, when torch sees no CUDA device or
when the package is not beside it.  ``python3 chip_smoke.py
--across-cards`` on a machine with two or more cards runs only the paths
that cross cards (phase_across_cards) instead.  Phases, each fatal on
failure:

1. toolchain: card, power limit, torch, CUDA, nvcc; the kernels' build.
2. kernels vs their plain PyTorch twins on the card, bit-exact, with
   both times: K1 canonical_windows on 65,536 packed 100-bp reads at
   k = 15, 21, 31, one C call a call, then on utils/synthetic.py
   window_edge_reads at strides 25, 26, 28, 30 and 520 bytes and k = 15,
   17, 21, 31, and at one and two windows a row over 8,193 reads
   (partial last tiles) (its times and its one kernel a call, K4's
   template keeping every key, after phase 3: phase_k1_times); K2 probe
   on a 2M-key quot table (2^20 rows), the same keys in a forced full
   table (2^21 rows) and a 4e7-key quot table
   (2^24 rows, 268 MB, past the 50 MB L2); K3 classify_tally against
   tally_step_ref with N reads, id -1 rows and reads shorter than k; K10
   grow_tally from 2^19 to 2^20 rows (its int4 path back to back and
   with the L2 flushed before each call, and its int32 loop on a tally 12
   bytes into its storage) and K11 pack_tally on 10^6 rows (the main
   path's tally shapes).
3. the stage-00 kernels the same way: K4 count_windows on 65,536 packed
   100-bp reads at k = 15, 21, 31 (masked, clean, key range up to
   2^64 - 1; its device time), then on utils/synthetic.py
   window_edge_reads at strides 25, 26 and 30 and k = 15, 17, 21, 31;
   K5 sort_pairs on the edge cases of
   utils/synthetic.py sort_edge_cases (lengths 1, tile - 1, tile, tile +
   1, all keys equal, all sentinels, sorted, reversed, a sentinel tail
   longer than a tile, three keys drawn many times, one 8-bit field
   varying so that the other passes are skipped) at k = 15, 17, 21, 31
   in one portion and in portions of two tiles, the library's tile and
   digit equal to kmer_count's, with counts below 2^30 and below 100,
   then on 2^26 pairs at k = 21 and 31, counts below 2^30 and below 60
   (a fold's, packed above the keys from the second pass to the last at
   k = 21), beside torch.sort(stable=True) (time_sort_pairs: each
   device operation of a call, every pass's launch recorded); K6
   fold_runs on a 2^26-element duplicate-heavy sorted run (its two
   kernels once a call, nothing else on the card) and K12
   shrink_run on its distinct rows; K7
   count_stats on the 2^26 counts of stats_inputs at high = 10000
   (uniform, synthetic.peaked_counts, all 1, all 5,000) and peaked past
   the shared form's limit (the library's), and the uniform counts at
   high 0, as DeviceCountTable.total bins them, one C call, one zero fill
   and one kernel of the form high names a call, then on
   synthetic.count_stats_edge_cases at high 0, 30, 62, 63 (every bin a
   lane's own up to 62), 10,000 and on both sides of that limit, each
   also as views off a 16-byte boundary (call and device times from
   time_count_stats); K8
   marker_filter on two
   2^25-row runs sharing half their keys, bounds (9, 33) and
   (0, 2^31 - 1) (its two kernels once a call, nothing else on the card;
   the device time of each), then on marker_edge_cases (shared keys at
   the tile edges of the merged order, empty sides, a and b the same
   arrays, runs of unequal length), each call twice.
4. the stage-01 goldens (main, edge, k15, k31; weight0 1.04) classified
   on the card, byte-identical to tests/golden/stage01/*.golden; the
   stage-00 goldens built on the card by engines device, host and device
   with 3 key-range passes (histos and bounds byte-identical, markers
   equal to jellyfish's when sorted); the e2e trio through
   ``build-markers`` and ``classify-reads --device cuda``, phased.barcodes
   and the binned fastqs byte-identical.
5. the stage-01 main path at bench.py's scale: 10^6 markers per
   haplotype at k = 21 and 10^6 100-bp stLFR reads, through
   ``classify-reads --device cuda`` (classify, splits, quartering); K3,
   K10 and K11 must have been launched and no twin called.  A warm
   run_classify under torch.profiler gives K3's device time over its
   launches and the device idle share.  The first 10^5 reads are
   classified on the card and on the CPU twins, and the outputs must be
   equal bytes.
6. the stage-00 main path at bench.py's scale: a 3 Mb trio, 100-bp reads
   at 33x with 0.2 % errors (about 990,000 reads a parent), through
   ``build-markers --auto_bounds --device cuda``; K4-K8 and K12 must each
   have been launched and no twin called.  The first 2x10^5 reads of each
   parent go through the card and the CPU twins, and the outputs must be
   equal bytes.  Then where the time goes: the native reader alone, and
   a torch.profiler run of the device engine (device time by kernel,
   device idle share; every K5 kernel launched recorded), and the share
   of the fold sorts whose counts K5 packed above the keys.
7. device-resident state at scale: two parents of 6x10^8 windows each,
   drawn on the card from key pools of 1.6x10^8 that overlap by a
   quarter, fed to the DeviceCounter in 2^25-key chunks; finalize,
   histogram and marker algebra through the kernels and again through
   the twins on the card must agree; fold counts, peak device memory,
   times, K8's share of the marker algebra, K5's share of the
   paternal count's device time (torch.profiler, every K5 kernel
   launched recorded) and the share of the fold sorts whose counts K5
   packed are printed.
8. K9 segment_votes against its twin on the card, bit-exact, with both
   times: 4,096 random records of 0-20 kb (2 % soft-masked, 1 % N, a few
   IUPAC bytes, planted table keys) plus records of k - 1, k, 4096 + k - 1,
   50,000 (bad bytes on every tile edge), 1024 + k - 1 (all lowercase),
   4097 + k - 1 and 2k + 11 bytes (one good window), on phase 2's
   2^20-row quot table, the same keys in the forced full table and the
   2^24-row quot table; on the last, the device time back to back and
   with the L2 flushed before each call.
9. the stage-03 goldens on the card: ``mkoutput --device cuda`` on
   tests/golden/stage03 (the 13 files and the primary link),
   ``classify-segments --format fastq``, and ``run --device cuda`` (HAST.sh
   00->01->02->03 with a stand-in Supernova) on tests/golden/e2e, every
   kernel of the chain launched and no twin called.
10. the stage-03 main path at scale: a seeded pseudohap2 assembly of
   2,000 scaffolds with 10^8 phased bases a branch and 10^7 markers per
   haplotype at k = 21 (a 2^24-row segment table, past the L2), through
   ``rephase.mkoutput(device="cuda")`` (what ``mkoutput --device cuda``
   runs); K9 must have been launched and its twin never called.  Time
   by step, the first 2x10^6 bases of phb.12.fa classified on the card and on the CPU twins (equal bytes), and a
   torch.profiler run of the classify step (K9's device time, device
   idle share).
11. K13-K15 against their twins on the card, bit-exact, with both times:
   K13 vote_reads on 65,536 packed 100-bp reads and on the same reads as
   ASCII with 1 % random non-ACGT bytes, on phase 2's three tables, plus
   __graft_entry__'s 256 x 128 batch; the table split in 2 and in 4, the
   shards' votes summed equal to the whole table's; K14 route_batch on a
   16,384-read batch at dp = 4 and 8, slack 2, every shard in one launch
   with the receive layout written in place, against route_batch_ref,
   route_kmers (the one-shard form) on shard 0, and both forms on 64
   identical reads of one key (drop counts equal the twins'); in turns,
   dp one-shard calls plus the receivers' cat beside the batch call, on
   card tensors and from the host arrays; K15 tally_votes of 65,536 reads
   into 10^5 barcodes, ids -1 and past the end included, random and in
   stLFR's barcode runs of 20-60 reads, into a fresh tally and with out=
   over two calls (call and device times; index_add_'s beside them).
   Then K3 and K13, which share csrc/reads.cuh, on
   utils/synthetic.py read_tile_edge_batches (READ_EDGE_STRIDES: 1 to
   16,384 bytes; k = 15, 17, 21, 31; both table formats; tp shards 2 and
   4), the library's tile geometry against synthetic's, one C call a
   wrapper call and one kernel a call in the short and the long form;
   their device times on the three tables (random and barcode-sorted ids
   for K3, packed and ASCII for K13; the 2^24-row table also with 256 MB
   written before each call) and in the long form on 8,192 reads of
   len_cap 8,192.
   Then the launch path: K10 against F.pad and K12 against narrow(0, 0,
   m).clone(), in turns (kernel, library, library, kernel; 200 calls
   each; the kernels line takes K10's and K12's call and library times
   from these turns).
12. sharded_classify_step on meshes of cuda:0 at dp x tp = 4x1 and 2x2,
   both slot formats, equal to K3's tally of the same reads.
13. the mesh classify main path: phase 5's workload through
   run_classify(mesh=make_mesh(4, devices=[cuda:0] * 4)) and a 2x2
   mesh, phased.barcodes byte-identical to phase 5's; K13 launched, no
   twin called; the call's time under a CPU profiler session and its
   host fold's share (its ``classify.host_fold`` spans).  With two
   or more cards, the 4x1 mesh again over distinct cards.
14. the mesh stage-00 main path: phase 6's trio through
   build_unshared_markers_mesh on a 4-shard mesh of cuda:0, histos,
   bounds and markers byte-identical to phase 6's; K14, K5, K6, K7, K8
   and K12 launched, K14 once a batch, no twin called; then a skewed
   batch through count_files_mesh_device, retried with more slack.
15. the stage-01 goldens through the CLI's mesh and multi-process paths
   on the card: ``classify --mesh 1x1``, ``classify-reads --mesh auto``,
   two processes of ``python -m hast_tpu_torch classify`` under
   HAST_NUM_PROCESSES=2 on the same card, and ``merge-results`` of two
   shard outputs.
16. K16 broadcast_probe, the port's entry point, on the canonical windows
   of 65,536 100-bp reads (5.2x10^6 queries, a key of each panel planted
   in each read) against two full tables: the stLFR adaptor panel (the
   21-mers of both adaptors) and a 10^4-marker targeted panel (32,768
   slots); launched twice, no twin.  Then bit-exact against its twin (all
   queries on the adaptor panel, the first 2^18 on the target panel),
   payloads equal to K2 probe's on the same keys and tables (K2 timed
   beside it), and the JAX padding's edge cases: lengths that are a
   multiple of neither chunk 2048 nor 512, duplicate keys with two
   payloads (the larger wins), the pad key (0x3FFFFFFF, 0xFFFFFFFF).
17. the remaining entry points: ``warmup --device cuda`` at its default
   shapes in this process (K3, K10, K11, K4-K8 and K12 launched, no twin;
   its wall time), then the tools through the CLI on the committed
   goldens: the nine ``vcf-*`` outputs and ``vcf-calc-hd``'s totals,
   ``draw-heatalign`` KIR and MHC, ``get-n``, ``check-genes``
   byte-identical; ``mark-library`` and ``filter-fastq-by-barcodes`` on
   reads2.fq equal to the awk programs' rules; ``plot-bounds``.

Before the last line it prints one JSON line of kernel results (with each
kernel's bound: the larger of the bytes it must move at the H100's
3.35 TB/s and the int32 operations it must do at the card's 16.7 T/s;
the log names both counts) and the ``nvidia-smi`` name and power limit;
the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None          # the port runs without jax
sys.modules["hast_tpu"] = None     # and imports nothing of the JAX package

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(ROOT, "tests", "golden", "stage01")
GOLD00 = os.path.join(ROOT, "tests", "golden", "stage00")
E2E = os.path.join(ROOT, "tests", "golden", "e2e")
GOLD03 = os.path.join(ROOT, "tests", "golden", "stage03")
N_MARKERS = 1_000_000
N_READS = 1_000_000
N_CPU_READS = 100_000
K = 21
GENOME_LEN = 3_000_000        # bench.py's stage-00 trio
COVERAGE = 33.0
N_CPU_PARENT_READS = 200_000
SCALE_WINDOWS = 600_000_000   # per parent
SCALE_POOL = 160_000_000
SCALE_CHUNK = 1 << 25
STAGE00_KERNELS = ("count_windows", "sort_pairs", "fold_runs",
                   "shrink_run", "count_stats", "marker_filter")
SEG_RECORDS = 4096            # K9 check: random records of 0-20 kb
SEG_SCAFFOLDS = 2000          # stage-03 scale phase
SEG_PHASED_BASES = 100_000_000   # per branch
SEG_MARKERS = 10_000_000      # per haplotype
SEG_HEAD_BASES = 2_000_000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
# H100 SXM int32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper
# white paper); the 67 T/s float32 rate counts an FMA as two operations
INT_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations the work needs, counted from the kernels' arithmetic
# with 64-bit words as two 32-bit halves, where the data allow the least:
# a window rolled one base a step (code 2, forward word 4, reverse
# complement 5, 64-bit min 4, run of good bases 3)
WINDOW_OPS = 18
# one two-bucket probe: quot = Feistel split 5 + 4 rounds of 11 + bucket
# and quotient 4 + alternate bucket 12 + 8 slot tests of 8 + the maxima 7;
# full = two hashes of 9 and 11, masks 2, 4 slot tests of 6, maxima 4
PROBE_OPS = {"quot": 136, "full": 50}
VOTE_OPS = 4          # payload bits into the two vote sums
READ_OPS = 10         # K3 per read: id and N tests, unknown flag, 3 adds
COUNT_RANGE_OPS = 4   # K4: the key-range test and the sentinel select
SORT_PASS_OPS = 8     # K5 per key and pass: digit, count, rank, place
FOLD_OPS = 8          # K6 per key: neighbour compare, flag, scan, sum
STATS_OPS = 4         # K7 per count: clamp, bin, total
# K1's kernel: K4's template with every key kept, and its first form's own
# (time_canonical_windows may time an earlier tree)
K1_KERNELS = ("count_windows_kernel<false, false, true>",
              "canonical_windows_kernel")
MERGE_OPS = 12        # K8 per row, as a merge of two sorted runs
GROW_OPS = 1          # K10 per element of the new tally: copy or zero
PACK_OPS = 8          # K11 per entry: two masks, two shifts, two tests, sums
# K14 per window on top of the window itself: the ACGT test of the new
# byte 2, the hash 9, the route (multiply-high) and clamp 3, the slot 2
ROUTE_OPS = 16
# K16 per (query, slot) pair: the JAX kernel's formulation does five (the
# key mask, two compares, the select of the payload, the running maximum),
# but the mask and the payload shift belong to the slot, done once a tile,
# and the select folds into a maximum predicated on the compares: two
# compares and a maximum a pair are what the work needs
BROADCAST_OPS = 3
N_VOTE_READS = 65536          # K13 check: 100-bp reads
N_PANEL_READS = 65536         # K16: 100-bp reads, 5.2x10^6 windows
TARGET_PANEL = 10_000         # K16: targeted-region markers at k = 21
CROSSOVER_SLOTS = (16, 32, 64, 128, 256)   # K16 vs K2: raw panels
N_TALLY_BARCODES = 100_000    # K15 check
MESH_BATCH = 1 << 14          # the mesh stage-00 batch (FQ.DEFAULT_BATCH)
FOLD_KERNELS = ("fold_tiles_kernel", "fold_tail_kernel")   # K6's two
# K3's and K13's kernels; each call runs one of them, in the short form
# (<false>, a tile of whole reads) or the long (<true>, eight reads a
# block)
READ_VOTE_KERNELS = {"classify_tally": "classify_tally_kernel",
                     "vote_reads": "vote_reads_kernel"}
FLUSH_BYTES = 1 << 28         # written before a call to empty the 50 MB L2
LEAD_KERNEL = "spin_kernel"   # torch.cuda._sleep's, which starts a session
LEAD_KERNELS = 16             # of them a profiler session starts with
MARKER_KERNELS = ("marker_tiles_kernel", "marker_tail_kernel")   # K8's two
STAGE03_FILES = (
    "output.phb.1.fa", "output.phb.2.fa", "output.homo.fa", "phasing.out",
    "output.phb.12.father.idx", "output.phb.12.mother.idx",
    "output.phb.12.ambiguous.idx", "output.merge.father.ids",
    "output.merge.mother.ids", "output.merge.homo.ids", "output.father.fa",
    "output.father.idx", "output.supplement.fa")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn over reps launches, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_once(fn):
    """fn's result and the device milliseconds of that one call (for a
    twin too slow to repeat)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _profiled(fn):
    """key_averages() of a torch.profiler session (CUDA activity) around
    fn() and a synchronize, without LEAD_KERNELS' records.  The profiler
    drops the first few kernel records of a session, more of them as a
    run goes on (none or one in a fresh process, three after phase 2 on
    an H100), so a session starts with LEAD_KERNELS one-cycle spins,
    waited for; where none of theirs is left, fn's first records may be
    gone too, and the session is taken again with four times the spins.
    The callers profile again while a session shows too few records."""
    import torch
    lead = LEAD_KERNELS
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(LEAD_KERNEL in e.key for e in events):
            break
        lead *= 4
    return [e for e in events if LEAD_KERNEL not in e.key]


def device_ms(fn, reps: int, kernel) -> float:
    """Mean device time of the kernels whose name holds `kernel` (or one
    of a tuple of names) over reps calls of fn, from torch.profiler: the
    kernels alone, apart from the wrapper's host time that cuda_ms also
    sees when it is the longer."""
    import torch
    fn()
    torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel

    def calls():
        for _ in range(reps):
            fn()

    for _ in range(3):
        seen = [e for e in _profiled(calls)
                if any(name in e.key for name in names)]
        # each matched kernel runs at least once a call: fewer records
        # mean the profiler dropped some, so the sum would read short
        if seen and all(e.count >= reps for e in seen):
            break
        log(f"device_ms: the profiler recorded {[e.count for e in seen]} "
            f"launches of {names} in {reps} calls; profiling again")
    return sum(_device_us(e) for e in seen) / reps / 1e3


def bound(name: str, n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of n_bytes (each input read once, each output written once; probing
    kernels add the two 16-byte table rows a probed window touches) over
    the HBM rate and n_ops int32 operations over the int32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    log(f"bound of {name}: {n_bytes:.6g} bytes ({t_bytes:.4f} ms), "
        f"{n_ops:.6g} int32 operations ({t_ops:.4f} ms)")
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def random_keys(rng, n: int, k: int):
    """n distinct random 2k-bit keys as (int64 words, hi, lo uint32)."""
    import numpy as np
    words = np.unique(rng.integers(0, 1 << (2 * k), n + n // 64 + 16,
                                   dtype=np.int64))
    rng.shuffle(words)
    words = words[:n]
    return (words, (words >> 32).astype(np.uint32),
            (words & 0xFFFFFFFF).astype(np.uint32))


def phase_toolchain() -> None:
    import torch
    from hast_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"nvcc: {nvcc.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernel build + load: {time.perf_counter() - t0:.3f} s "
        f"({_build.library_path()})")


def stats_inputs(past=None) -> dict:
    """{name: (counts, high)}: 2^26 int32 counts on the card at high
    10,000, uniform in [0, 60) with every 997th in [0, 40,000), a count
    table's shape (utils/synthetic.py peaked_counts), all 1 and all 5,000;
    and the peaked counts at high `past`, by default the first past the
    library's shared form (the global form)."""
    import torch
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.utils import synthetic as S

    dev = torch.device("cuda")
    n = 1 << 26
    if past is None:
        past = _build.count_stats_shared_high() + 1
    g = torch.Generator(device=dev)
    g.manual_seed(2034)
    uniform = torch.randint(0, 60, (n,), device=dev, generator=g,
                            dtype=torch.int32)
    uniform[::997] = torch.randint(0, 40000, (uniform[::997].numel(),),
                                   device=dev, generator=g,
                                   dtype=torch.int32)
    return {
        "uniform": (uniform, 10000),
        "peaked": (torch.from_numpy(S.peaked_counts(2034, n, 10000)).to(dev),
                   10000),
        "all 1": (torch.ones(n, dtype=torch.int32, device=dev), 10000),
        "all 5000": (torch.full((n,), 5000, dtype=torch.int32, device=dev),
                     10000),
        f"peaked, high {past}": (torch.from_numpy(
            S.peaked_counts(2035, n, past)).to(dev), past)}


def _call_and_device(fn, kernel) -> dict:
    return dict(ms=cuda_ms(fn, 20), device_ms=device_ms(fn, 20, kernel))


def time_count_stats(inputs=None) -> dict:
    """Call and device times (ms) of K7 on each of stats_inputs().  Calls
    only the wrapper, whose contract earlier trees share, so that a script
    can time another tree's package with it."""
    from hast_tpu_torch.ops import kmer_count as KC

    out = {}
    for name, (counts, high) in (inputs or stats_inputs()).items():
        out[name] = _call_and_device(lambda: KC.count_stats(counts, high),
                                     "count_stats_kernel")
        log(f"K7 count_stats {name}: call {out[name]['ms']:.4f} ms, device "
            f"{out[name]['device_ms']:.4f} ms")
    return out


def sort_inputs(k: int, high: int, n: int = 1 << 26, seed: int = 2025):
    """n K5 pairs on the card: keys uniform below 2^(2k), 10 % of them the
    sentinel, counts uniform below high."""
    import torch
    from hast_tpu_torch.ops import kmer_count as KC

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    keys = torch.randint(0, 1 << (2 * k), (n,), device=dev, generator=g)
    keys[torch.rand(n, device=dev, generator=g) < 0.1] = KC.SENT
    pay = torch.randint(0, high, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    return keys, pay


def _kernel_name(key: str) -> str:
    """A profiler record's name without namespace, template and
    arguments."""
    name = re.sub(r"\(.*$", "", key.replace("(anonymous namespace)::", ""))
    return name.split("::")[-1].split("<")[0]


def time_sort_pairs(keys, pay, k: int, reps: int = 3) -> dict:
    """K5 on (keys, pay): the call (CUDA events over 10 calls), each
    device operation of a call (kernels and zero fills: launches and ms a
    call, from _profiled over reps calls, taken again while the pass
    kernel shows fewer records than its passes in reps calls) and
    torch.sort(stable=True) of the keys.  Calls only the wrapper and
    KC.sort_passes, so that a script can time another tree's package
    with it (given that tree's pass count as KC.sort_passes)."""
    import torch
    from hast_tpu_torch.ops import kmer_count as KC

    def calls():
        for _ in range(reps):
            KC.sort_pairs(keys, pay, k)

    ms = cuda_ms(lambda: KC.sort_pairs(keys, pay, k), 10)
    passes = KC.sort_passes(k)
    for _ in range(3):
        ops = {}
        for e in _profiled(calls):
            if _device_us(e):
                name = _kernel_name(e.key)
                n, us = ops.get(name, (0, 0.0))
                ops[name] = (n + e.count, us + _device_us(e))
        if ops.get("onesweep_pass_kernel", (0,))[0] >= reps * passes:
            break
        log(f"K5: the profiler recorded {ops} in {reps} calls of "
            f"{passes} passes; profiling again")
    ops = {name: dict(launches=n / reps, ms=us / reps / 1e3)
           for name, (n, us) in ops.items()}
    return dict(ms=ms, device_ms=sum(o["ms"] for o in ops.values()),
                ops=ops, library_ms=cuda_ms(
                    lambda: torch.sort(keys, stable=True), 10))


def _k5_packs(payload, k: int) -> bool:
    """Whether K5 moves these counts packed above the keys' 2k + 1 bits
    from its second pass (sort.cu's test: 16 free bits or more, and the
    OR of the counts below 2^(63 - 2k) where fewer than 32 are free)."""
    free = 63 - 2 * k
    if free < 16:
        return False
    if free >= 32:
        return True
    lo, hi = (int(x) for x in payload.aminmax())
    return lo >= 0 and hi >> free == 0


@contextlib.contextmanager
def k5_calls(packing: bool = False):
    """K5's calls within the block, through the wrapper's module global:
    yields a tally of its 'calls' and the 'kernels' they launch (a
    histogram, a plan and one pass kernel a pass and portion), and with
    packing, the 'sorts' with counts (a fold's) and how many of them
    'packed' (_k5_packs, read on the host: a sync a call)."""
    import threading
    from hast_tpu_torch.ops import kmer_count as KC

    real = KC.sort_pairs
    lock = threading.Lock()
    tally = dict(calls=0, kernels=0, sorts=0, packed=0)

    def counted(keys, payload, k, *args, **kwargs):
        n = keys.numel()
        packs = (packing and payload is not None and n > 0
                 and keys.is_cuda and _k5_packs(payload, k))
        with lock:
            if n and keys.is_cuda:
                tally["calls"] += 1
                tally["kernels"] += 2 + KC.sort_passes(k) * -(
                    -n // KC._SORT_PORTION)
                if packing and payload is not None:
                    tally["sorts"] += 1
                    tally["packed"] += packs
        return real(keys, payload, k, *args, **kwargs)

    KC.sort_pairs = counted
    try:
        yield tally
    finally:
        KC.sort_pairs = real


def _profiled_k5(fn):
    """_profiled(fn) and k5_calls' tally of that session, taken again (up
    to three times) while the profiler shows fewer of K5's kernels than
    fn's K5 calls launched: a session that drops records reads short."""
    for _ in range(3):
        with k5_calls() as tally:
            events = _profiled(fn)
        tally["recorded"] = sum(e.count for e in events
                                if "onesweep_" in e.key)
        if tally["recorded"] >= tally["kernels"]:
            break
        log(f"K5: the profiler recorded {tally['recorded']} of "
            f"{tally['kernels']} kernels; profiling again")
    return events, tally


def k1_input():
    """65,536 random packed reads of 112 bases, lengths 100, on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2033)
    packed = torch.from_numpy(rng.integers(0, 256, (65536, 28),
                                           np.uint8)).to("cuda")
    return packed, torch.full((65536,), 100, dtype=torch.int32,
                              device="cuda")


def time_canonical_windows() -> dict:
    """Call and device times (ms) of K1 on 65,536 packed reads of 112
    bases (lengths 100), at k = 15, 21 and 31.  Calls only the wrapper, as
    time_count_stats does."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import encode as E

    packed, lengths = k1_input()
    out = {}
    for k in (15, 21, 31):
        out[f"k={k}"] = t = _call_and_device(
            lambda: E.canonical_windows(packed, lengths, k), K1_KERNELS)
        log(f"K1 canonical_windows k={k}: call {t['ms']:.4f} ms, device "
            f"{t['device_ms']:.4f} ms")
    return out


def phase_k1_times() -> dict:
    """K1's call and device times (time_canonical_windows) and the one
    kernel of one call at k = 15, 21 and 31; the k = 21 times.  Not in
    phase 2: runs whose first profiler sessions came before phase 2's
    tables were built lost kernels' records in sessions after them (K6's
    and K8's one-call checks failed), and runs whose first came after
    them lost none."""
    from hast_tpu_torch.ops import encode as E

    times = time_canonical_windows()
    packed, lengths = k1_input()
    for k in (15, 21, 31):
        name = _one_kernel(lambda: E.canonical_windows(packed, lengths, k),
                           f"K1 canonical_windows k={k}", K1_KERNELS[0])
        log(f"K1 canonical_windows k={k}: one call's device work: {name}")
    return times[f"k={K}"]


def phase_kernels() -> dict:
    """Each kernel against its twin on the same card tensors."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.ops import hashtable as H
    from hast_tpu_torch.pipeline import classify as C
    from hast_tpu_torch.utils import synthetic as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    res = {}

    # K1: 65,536 packed reads of stride 112 bases, lengths 100 but for a
    # few shorter than k and a few empty
    n, lp = 65536, 28
    packed = torch.from_numpy(rng.integers(0, 256, (n, lp), np.uint8)).to(dev)
    lens = np.full(n, 100, np.int32)
    lens[rng.integers(0, n, 512)] = rng.integers(0, 31, 512)
    lengths = torch.from_numpy(lens).to(dev)
    err = 0.0
    for k in (15, 21, 31):
        keys, valid = _launched("canonical_windows", lambda: (
            E.canonical_windows(packed, lengths, k)))
        rkeys, rvalid = E.canonical_windows_ref(packed, lengths, k)
        torch.cuda.synchronize()
        if not (torch.equal(keys, rkeys) and torch.equal(valid, rvalid)):
            fail(f"K1 canonical_windows != twin at k={k}")
        err = max(err, max_abs_err(keys, rkeys))
        plain = cuda_ms(lambda: E.canonical_windows_ref(packed, lengths, k),
                        3)
        log(f"K1 canonical_windows k={k} {n} reads x {keys.shape[1]} "
            f"windows: twin {plain:.4f} ms, bit-exact")
        if k == K:
            # packed reads and lengths in, 8-byte keys and a valid byte
            # out; the times come from phase_k1_times
            res["canonical_windows"] = dict(
                max_abs_err=err, plain_ms=plain, library_ms=None,
                **bound("K1", n * lp + 4 * n + 9 * keys.numel(),
                        WINDOW_OPS * keys.numel()))
    # the tile edges: window_edge_reads packed at the edge strides (tiles
    # that begin and end inside a read, a partial last tile), and one and
    # two windows a row over 8,193 reads (the last tile one window, two)
    cases = [(k, lp, 203) for k in (15, 17, 21, 31)
             for lp in (25, 26, 28, 30, 520)]
    cases += [(16, 4, 8193), (15, 4, 8193), (31, 8, 8193)]
    for k, lp, rows in cases:
        seqs, elens = S.window_edge_reads(k + lp, k, lp, n=rows)
        ep = torch.from_numpy(E.pack_codes_np(seqs)).to(dev)
        el = torch.from_numpy(elens).to(dev)
        keys, valid = E.canonical_windows(ep, el, k)
        rkeys, rvalid = E.canonical_windows_ref(ep, el, k)
        if not (torch.equal(keys, rkeys) and torch.equal(valid, rvalid)):
            fail(f"K1 canonical_windows != twin on window_edge_reads at "
                 f"k={k}, stride {lp} bytes, {rows} reads")
        err = max(err, max_abs_err(keys, rkeys))
    log(f"K1 canonical_windows: {len(cases)} edge batches bit-exact")
    res["canonical_windows"]["max_abs_err"] = err

    # K2 on the bench-scale key count, quot and forced full
    tables, words, pay, bwords = vote_tables(rng)
    absent = random_keys(np.random.default_rng(99), 1 << 21, K)[0]
    absent = absent[~np.isin(absent, words)]
    q_np = np.concatenate([words[rng.integers(0, words.size, 1 << 21)],
                           absent])
    expect = np.concatenate([pay[_index_of(words, q_np[:1 << 21])],
                             np.zeros(absent.size, np.uint32)])
    queries = torch.from_numpy(q_np).to(dev)
    err = 0.0
    for fmt in ("quot", "full"):
        table = tables[fmt]
        got = H.probe(table, queries)
        ref = H.probe_ref(table, queries)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"K2 probe != twin on the {fmt} table")
        if not np.array_equal(got.cpu().numpy(), expect.astype(np.int32)):
            fail(f"K2 probe payloads differ from the inserted ones ({fmt})")
        err = max(err, max_abs_err(got, ref))
        ms = cuda_ms(lambda: H.probe(table, queries), 20)
        plain = cuda_ms(lambda: H.probe_ref(table, queries), 3)
        log(f"K2 probe {fmt} table {table.n_buckets} rows, "
            f"{queries.numel()} keys: kernel {ms:.4f} ms, twin "
            f"{plain:.4f} ms, bit-exact")
        if fmt == "quot":
            # 8-byte key in, 4-byte payload out, two 16-byte rows a key
            res["probe"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                **bound("K2", queries.numel() * (8 + 4 + 32),
                                        PROBE_OPS[fmt] * queries.numel()))

    # K2 and K3 past the L2
    big = tables["big"]
    bq = torch.from_numpy(np.concatenate(
        [bwords[rng.integers(0, bwords.size, 1 << 22)],
         random_keys(rng, 1 << 22, K)[0]])).to(dev)
    got, ref = H.probe(big, bq), H.probe_ref(big, bq)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        fail("K2 probe != twin on the 2^24-row table")
    if int((got[:1 << 22] == 0).sum()):
        fail("K2 probe missed inserted keys of the 2^24-row table")
    err = max(err, max_abs_err(got, ref))
    ms = cuda_ms(lambda: H.probe(big, bq), 20)
    plain = cuda_ms(lambda: H.probe_ref(big, bq), 3)
    log(f"K2 probe quot table {big.n_buckets} rows, {bq.numel()} keys: "
        f"kernel {ms:.4f} ms, twin {plain:.4f} ms, bit-exact")
    res["probe"]["max_abs_err"] = err

    # K3: reads with planted table keys, N reads, id -1 rows, a shared
    # id space and reads shorter than k
    err = 0.0
    for name, table, key_words in (("2^24-row", big, bwords),
                                   ("bench-scale 2^20-row", tables["quot"],
                                    words)):
        b = 32768
        batch = _planted_batch(rng, key_words, b, K)
        acc = torch.zeros((4096, 3), dtype=torch.int32, device=dev)
        acc_ref = acc.clone()
        C.tally_step(table, acc, *batch)
        C.tally_step_ref(table, acc_ref, *batch)
        torch.cuda.synchronize()
        if not torch.equal(acc, acc_ref):
            fail(f"K3 classify_tally != twin on the {name} table")
        if int(acc[:, :2].sum()) == 0:
            fail(f"K3 found no marker hits on the {name} table")
        err = max(err, max_abs_err(acc, acc_ref))
        ms = cuda_ms(lambda: C.tally_step(table, acc, *batch), 20)
        plain = cuda_ms(lambda: C.tally_step_ref(table, acc_ref, *batch), 3)
        log(f"K3 classify_tally {name} table, {b}-read batch: kernel "
            f"{ms:.4f} ms, twin {plain:.4f} ms, bit-exact")
    # the last batch (bench-scale table): reads, lengths, ids, N flags and
    # the tally read and written, two rows per probed window
    packed, lengths, ids, has_n = batch
    probed = ((lengths.long() - K + 1).clamp(0, 4 * packed.shape[1] - K + 1)
              * ((ids >= 0) & (ids < acc.shape[0]) & (has_n == 0))).sum()
    res["classify_tally"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
        **bound("K3", packed.numel() + 9 * b + 2 * acc.numel() * 4
                + 32 * int(probed),
                (WINDOW_OPS + PROBE_OPS[tables["quot"].fmt] + VOTE_OPS)
                * int(probed) + READ_OPS * b))
    del bq
    res.update(_tally_kernels(rng))
    return res, tables, words, bwords


def _tally_kernels(rng) -> dict:
    """K10 and K11 at the main path's tally shapes: 2^19 rows grown to
    2^20 (the native path doubles from 2^16 as 10^6 barcode ids arrive),
    and the image of 10^6 barcodes' rows, some entries past 8 bits."""
    import numpy as np
    import torch
    from hast_tpu_torch.pipeline import classify as C
    dev = torch.device("cuda")
    res = {}
    acc = torch.from_numpy(rng.integers(0, 200, (1 << 19, 3)).astype(
        np.int32)).to(dev)
    acc[::997] = 300
    max_id = acc.shape[0]
    err = _check_same("K10 grow_tally", [C.grow_tally(acc, max_id)],
                      [C.grow_tally_ref(acc, max_id)])
    ms = cuda_ms(lambda: C.grow_tally(acc, max_id), 20)
    plain = cuda_ms(lambda: C.grow_tally_ref(acc, max_id), 5)
    lib = cuda_ms(lambda: torch.nn.functional.pad(acc, (0, 0, 0, max_id)),
                  20)
    dev_ms = device_ms(lambda: C.grow_tally(acc, max_id), 20,
                       "grow_tally_kernel")
    # the int32 loop on the same rows: a tally 12 bytes into its storage
    off = torch.empty(acc.numel() + 3, dtype=torch.int32, device=dev)
    off[3:] = acc.reshape(-1)
    unaligned = off[3:].view(-1, 3)
    err = max(err, _check_same("K10 grow_tally (int32 loop)",
                               [C.grow_tally(unaligned, max_id)],
                               [C.grow_tally_ref(unaligned, max_id)]))
    loop_ms = device_ms(lambda: C.grow_tally(unaligned, max_id), 20,
                        "grow_tally_kernel")
    # back to back, the 6.3 MB tally and its 12.6 MB copy stay in the 50
    # MB L2, and the HBM bound does not hold; with 256 MB written before
    # each call the kernel reads and writes HBM, as the bound counts
    flush = torch.empty(1 << 28, dtype=torch.uint8, device=dev)
    cold_ms = device_ms(lambda: (flush.zero_(), C.grow_tally(acc, max_id)),
                        20, "grow_tally_kernel")
    del flush
    log(f"K10 grow_tally {acc.shape[0]} -> {2 * acc.shape[0]} rows: kernel "
        f"{ms:.4f} ms ({dev_ms:.4f} ms of it on the device back to back, "
        f"{cold_ms:.4f} ms with the L2 flushed before each call; the int32 "
        f"loop on an unaligned tally {loop_ms:.4f} ms back to back), twin "
        f"{plain:.4f} ms, torch.nn.functional.pad {lib:.4f} ms, bit-exact")
    del off, unaligned
    k10 = bound("K10", 4 * acc.numel() + 8 * acc.numel(),
                GROW_OPS * 2 * acc.numel())
    log(f"K10 grow_tally with the L2 flushed: "
        f"{k10['bound_ms'] / cold_ms:.2f} of its bound on the device")
    res["grow_tally"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             library_ms=lib, device_ms_l2_flushed=cold_ms,
                             **k10)
    rows = C.grow_tally(acc, max_id)[:1_000_000]
    err = _check_same("K11 pack_tally", C.pack_tally(rows),
                      C.pack_tally_ref(rows))
    if C.pack_tally(rows)[2].tolist() != [int(((rows >> 8) != 0).sum()), 0]:
        fail("K11 pack_tally: wrong counts of entries past 8 and 16 bits")
    ms = cuda_ms(lambda: C.pack_tally(rows), 20)
    plain = cuda_ms(lambda: C.pack_tally_ref(rows), 5)
    dev_ms = device_ms(lambda: C.pack_tally(rows), 20, "pack_tally_kernel")
    log(f"K11 pack_tally {rows.shape[0]} rows: kernel {ms:.4f} ms "
        f"({dev_ms:.4f} ms of it on the device), twin "
        f"{plain:.4f} ms, bit-exact")
    res["pack_tally"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
        **bound("K11", 4 * rows.numel() + 3 * rows.numel() + 16,
                PACK_OPS * rows.numel()))
    return res


def _hash_keys(idx):
    """A bijection of [0, 2^42) (odd multiplier mod 2^42): distinct
    indices below 2^29 give distinct 21-mer keys, spread over the space."""
    return (idx * 0x2545F491) & ((1 << 42) - 1)


def _check_same(name: str, got, want) -> float:
    import torch
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail(f"{name} != its twin")
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def phase_kernels00() -> dict:
    """K4-K8 against their twins on the same card tensors."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.ops import kmer_count as KC
    from hast_tpu_torch.utils import synthetic as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(2025)
    g = torch.Generator(device=dev)
    g.manual_seed(2025)
    res = {}

    # K4: 65,536 reads of stride 112 bases, 100 bp but for a few short or
    # empty ones, 1 % N bases
    n, L = 65536, 112
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, L))]
    seqs[rng.random((n, L)) < 0.01] = ord("N")
    lens = np.full(n, 100, np.int32)
    lens[rng.integers(0, n, 512)] = rng.integers(0, 31, 512)
    seqs[np.arange(L)[None, :] >= lens[:, None]] = 0
    packed, good, lengths = (torch.from_numpy(x).to(dev) for x in (
        E.pack_codes_np(seqs), KC.pack_good_np(seqs), lens))
    err = 0.0
    for k in (15, 21, 31):
        for variant, mask, key_range in (
                ("masked", good, None), ("clean", None, None),
                ("range", good, (1 << (2 * k - 2), (1 << 64) - 1))):
            fn = lambda: KC.count_windows(packed, lengths, k, mask,  # noqa
                                          key_range)
            ref = lambda: KC.count_windows_ref(packed, lengths, k,  # noqa
                                               mask, key_range)
            got = fn()
            err = max(err, _check_same(f"K4 count_windows k={k} {variant}",
                                       [got], [ref()]))
            real = int((got != KC.SENT).sum())
            if not 0 < real < got.numel():
                fail(f"K4 count_windows k={k} {variant}: {real} of "
                     f"{got.numel()} windows real")
            ms, plain = cuda_ms(fn, 20), cuda_ms(ref, 3)
            dev_ms = device_ms(fn, 20, "count_windows_kernel")
            log(f"K4 count_windows k={k} {variant}: {n} reads x "
                f"{got.numel() // n} windows ({real} real): kernel "
                f"{ms:.4f} ms ({dev_ms:.4f} ms of it on the device), twin "
                f"{plain:.4f} ms, bit-exact")
            if k == K and variant == "masked":
                # packed reads, the ACGT bitmask and lengths in, keys out
                res["count_windows"] = dict(
                    ms=ms, plain_ms=plain, library_ms=None, device_ms=dev_ms,
                    **bound("K4", packed.numel() + good.numel() + 4 * n
                            + 8 * got.numel(),
                            (WINDOW_OPS + COUNT_RANGE_OPS) * got.numel()))
    # the rolled windows' edges: strides that are not a multiple of 4,
    # reads of length 0, k - 1, k and the stride, N at a window's ends
    cases = 0
    for k in (15, 17, 21, 31):
        for lp in (25, 26, 30):
            seqs, lens = S.window_edge_reads(k + lp, k, lp, n=2000)
            packed, lengths = (torch.from_numpy(x).to(dev) for x in (
                E.pack_codes_np(seqs), lens))
            masks = (None,) if lp % 2 else (None, torch.from_numpy(
                KC.pack_good_np(seqs)).to(dev))
            for mask in masks:
                for key_range in (None, (1 << 63, (1 << 64) - 1),
                                  (1 << (2 * k - 2), (1 << 64) - 1)):
                    err = max(err, _check_same(
                        f"K4 count_windows k={k} stride {lp} edges",
                        [KC.count_windows(packed, lengths, k, mask,
                                          key_range)],
                        [KC.count_windows_ref(packed, lengths, k, mask,
                                              key_range)]))
                    cases += 1
    log(f"K4 count_windows: {cases} edge batches (strides 25, 26, 30; "
        "lengths 0, k - 1, k, 4 x stride; N at window ends; k = 15, 17, 21, "
        "31; ranges from 2^63) bit-exact")
    res["count_windows"]["max_abs_err"] = err

    # K5: the inputs a one-sweep sort gets wrong (lengths around a tile,
    # one hot digit, all sentinels, sorted and reversed runs, a sentinel
    # tail, three keys drawn many times, one digit varying so that the
    # other passes are skipped) at k = 15, 17, 21, 31, with and without
    # payload, in one portion and in portions of two tiles; then 2^26
    # random keys, 10 % sentinels
    if _build.sort_geometry() != (KC.SORT_TILE, KC.SORT_DIGIT_BITS):
        fail(f"K5: the library's tile and digit {_build.sort_geometry()} "
             f"!= kmer_count's {(KC.SORT_TILE, KC.SORT_DIGIT_BITS)}")
    err = 0.0
    cases = 0
    for k in (15, 17, 21, 31):
        for portion, high in itertools.product(
                (KC._SORT_PORTION, 2 * KC.SORT_TILE), (1 << 30, 100)):
            saved, KC._SORT_PORTION = KC._SORT_PORTION, portion
            try:
                for name, keys_np in S.sort_edge_cases(
                        k, k, KC.SORT_TILE, KC.SORT_DIGIT_BITS):
                    keys = torch.from_numpy(keys_np).to(dev)
                    pay = torch.randint(0, high, keys.shape, device=dev,
                                        generator=g, dtype=torch.int32)
                    what = (f"K5 sort_pairs k={k} {name} portion {portion} "
                            f"counts < {high}")
                    err = max(err, _check_same(
                        what, KC.sort_pairs(keys, pay, k),
                        KC.sort_pairs_ref(keys, pay, k)))
                    err = max(err, _check_same(
                        what + " no payload",
                        KC.sort_pairs(keys, None, k)[:1],
                        KC.sort_pairs_ref(keys, None, k)[:1]))
                    cases += 1
            finally:
                KC._SORT_PORTION = saved
    log(f"K5 sort_pairs: {cases} edge cases (n = 1, tile - 1, tile, tile + "
        "1; all equal, all sentinels, sorted, reversed, a sentinel tail, "
        "three keys, one digit varying; k = 15, 17, 21, 31; one portion "
        "and portions of two tiles; counts below 2^30 and below 100) "
        "bit-exact")
    # counts below 2^30 (the pairs move as keys and payloads in every
    # pass) and below 60, as a stage-00 fold's (packed into one word from
    # the second pass to the last at k = 21)
    n = 1 << 26
    for k, high in itertools.product((21, 31), (1 << 30, 60)):
        keys, pay = sort_inputs(k, high, n)
        what = f"K5 sort_pairs k={k} counts < {high}"
        err = max(err, _check_same(what, KC.sort_pairs(keys, pay, k),
                                   KC.sort_pairs_ref(keys, pay, k)))
        t = time_sort_pairs(keys, pay, k)
        plain = cuda_ms(lambda: KC.sort_pairs_ref(keys, pay, k), 3)
        passes = KC.sort_passes(k)
        log(f"{what}: {n} pairs, {passes} passes: kernel {t['ms']:.4f} ms, "
            f"twin {plain:.4f} ms, torch.sort(stable=True) of the keys "
            f"{t['library_ms']:.4f} ms, bit-exact; on the device "
            f"{t['device_ms']:.4f} ms a call (bytes bound "
            f"{24 * n / HBM_BYTES_PER_S * 1e3:.4f} a pass): " + ", ".join(
                f"{name} {o['launches']:g} x {o['ms'] / o['launches']:.4f}"
                for name, o in t["ops"].items()))
        if k == K and high == 1 << 30:
            # 8-byte keys and 4-byte payloads read once and written once
            res["sort_pairs"] = dict(
                ms=t["ms"], device_ms=t["device_ms"], plain_ms=plain,
                library_ms=t["library_ms"],
                **bound("K5", 24 * n, SORT_PASS_OPS * n * passes))
        elif k == K:
            res["sort_pairs"].update(ms_small_counts=t["ms"],
                                     device_ms_small_counts=t["device_ms"])
    res["sort_pairs"]["max_abs_err"] = err
    del keys, pay

    # K6: a sorted 2^26-element run of 2^22 distinct keys, sentinel tail
    keys = _hash_keys(torch.randint(0, 1 << 22, (n,), device=dev,
                                    generator=g))
    keys[-(n // 20):] = KC.SENT
    keys = torch.sort(keys).values
    counts = torch.randint(1, 50, (n,), device=dev, generator=g,
                           dtype=torch.int32)
    got = KC.fold_runs(keys, counts)
    err = _check_same("K6 fold_runs", got, KC.fold_runs_ref(keys, counts))
    ms = cuda_ms(lambda: KC.fold_runs(keys, counts), 10)
    plain = cuda_ms(lambda: KC.fold_runs_ref(keys, counts), 3)
    dev_ms = [device_ms(lambda: KC.fold_runs(keys, counts), 10, name)
              for name in FOLD_KERNELS]
    kernels = _kernels_of_one_call(lambda: KC.fold_runs(keys, counts), 2)
    if sorted(kernels.values()) != [1, 1] or \
            not all(any(f in name for f in FOLD_KERNELS) for name in kernels):
        fail(f"K6 fold_runs: one call ran {kernels} on the card, not its "
             "two kernels once each")
    log(f"K6 fold_runs: {n} sorted keys, {int(got[2])} distinct: kernel "
        f"{ms:.4f} ms ({sum(dev_ms):.4f} ms of it on the device: the "
        f"look-back pass {dev_ms[0]:.4f}, the tail {dev_ms[1]:.4f}; one "
        f"call's device work: {kernels}), twin {plain:.4f} ms, bit-exact")
    # keys and counts read once, every output slot written once (the
    # contract's full-size output, kmer_count.py:337-341), n_unique
    res["fold_runs"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            library_ms=None, device_ms=sum(dev_ms),
                            **bound("K6", 24 * n + 8, FOLD_OPS * n))
    # K12 on the fold's distinct rows, as DeviceCounter._fold runs it
    m = int(got[2])
    err = _check_same("K12 shrink_run", KC.shrink_run(got[0], got[1], m),
                      KC.shrink_run_ref(got[0], got[1], m))
    ms = cuda_ms(lambda: KC.shrink_run(got[0], got[1], m), 20)
    plain = cuda_ms(lambda: KC.shrink_run_ref(got[0], got[1], m), 5)
    dev_ms = device_ms(lambda: KC.shrink_run(got[0], got[1], m), 20,
                       "shrink_run_kernel")
    # the library's copy: narrow(...).clone() of the keys and the counts
    # (JAX's _shrink slices hi, lo and counts; the port's key is one word)
    lib = cuda_ms(lambda: (got[0].narrow(0, 0, m).clone(),
                           got[1].narrow(0, 0, m).clone()), 20)
    log(f"K12 shrink_run: {m} of {n} rows: kernel {ms:.4f} ms "
        f"({dev_ms:.4f} ms of it on the device), twin "
        f"{plain:.4f} ms, narrow().clone() of both arrays {lib:.4f} ms, "
        "bit-exact")
    res["shrink_run"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             library_ms=lib, **bound("K12", 24 * m, 0))
    del keys, counts, got

    # K7: stats_inputs' 2^26 counts, each against the twin, one C call,
    # and one zero fill and one kernel of the form its high names a call;
    # the uniform counts also at high 0, as DeviceCountTable.total bins
    # them (every bin a lane's own)
    limit = _build.count_stats_shared_high()
    inputs = stats_inputs(limit + 1)
    err = 0.0
    checks = dict(inputs, **{"uniform, high 0": (inputs["uniform"][0], 0)})
    for name, (counts, high) in checks.items():
        fn = lambda: KC.count_stats(counts, high)  # noqa: E731
        err = max(err, _check_same(f"K7 count_stats {name}",
                                   _launched("count_stats", fn),
                                   KC.count_stats_ref(counts, high)))
        form = "count_stats_kernel<%s>" % (
            "true" if high <= limit else "false")
        kernels = _kernels_of_one_call(fn, 2)
        if sorted(kernels.values()) != [1, 1] or not (
                any(form in key for key in kernels)
                and any("FillFunctor" in key or "Memset" in key
                        for key in kernels)):
            fail(f"K7 count_stats {name}: one call ran {kernels} on the "
                 f"card, not one zero fill and one {form}")
        log(f"K7 count_stats {name}: one call's device work: {kernels}")
    # the edge cases at high 0 and 30 (every bin a lane's own), on both
    # sides of the last such high (62, 63), at 10,000 and on both sides of
    # the shared form's limit, each also as views that start off a 16-byte
    # boundary
    cases = 0
    for high in (0, 30, 62, 63, 10000, limit, limit + 1):
        for case, counts in S.count_stats_edge_cases(
                high, high, n=(1 << 22) + 3).items():
            counts = torch.from_numpy(counts).to(dev)
            for view in (counts, counts[1:], counts[2:], counts[3:]):
                err = max(err, _check_same(
                    f"K7 count_stats {case}, high {high}, {view.numel()} "
                    "counts", KC.count_stats(view, high),
                    KC.count_stats_ref(view, high)))
                cases += 1
    log(f"K7 count_stats: {cases} edge calls bit-exact")
    times = time_count_stats(inputs)
    counts, high = inputs["uniform"]
    plain = cuda_ms(lambda: KC.count_stats_ref(counts, high), 3)
    clamped = counts.clamp(0, high + 1)
    lib = cuda_ms(lambda: torch.bincount(clamped, minlength=high + 2), 20)
    for name, t in times.items():
        # the counts read once; the bins and the total written once
        b = bound(f"K7 {name}", 4 * n + 8 * (inputs[name][1] + 3),
                  STATS_OPS * n)
        log(f"K7 count_stats {name}: {n} counts, high {inputs[name][1]}: "
            f"{b['bound_ms'] / t['device_ms']:.2f} of its bound on the "
            "device")
    log(f"K7 count_stats uniform: twin {plain:.4f} ms, torch.bincount of "
        f"the clamped counts {lib:.4f} ms")
    res["count_stats"] = dict(
        max_abs_err=err, plain_ms=plain, library_ms=lib, **times["uniform"],
        **bound("K7", 4 * n + 8 * (high + 3), STATS_OPS * n))
    del inputs, checks, counts, clamped

    # K8: two 2^25-row runs sharing half their keys, 2^16 pads each
    rows, pads = 1 << 25, 1 << 16
    args = []
    for start in (0, rows // 2):
        keys = torch.sort(_hash_keys(torch.arange(
            start, start + rows - pads, device=dev))).values
        keys = torch.cat([keys, torch.full((pads,), KC.SENT, device=dev)])
        counts = torch.randint(1, 60, (rows,), device=dev, generator=g,
                               dtype=torch.int32)
        counts[-pads:] = 0
        args += [keys, counts, rows - pads]
    err = 0.0
    for bounds in ((9, 33, 9, 33), (0, 2**31 - 1, 0, 2**31 - 1)):
        fn = lambda: KC.marker_filter(*args, bounds)  # noqa: E731
        got = fn()
        err = max(err, _check_same(f"K8 marker_filter {bounds}", got,
                                   KC.marker_filter_ref(*args, bounds)))
        ms = cuda_ms(fn, 10)
        plain = cuda_ms(lambda: KC.marker_filter_ref(*args, bounds), 3)
        dev_ms = [device_ms(fn, 10, name) for name in MARKER_KERNELS]
        log(f"K8 marker_filter: 2 x {rows} rows, bounds {bounds}, kept "
            f"{int(got[1])} + {int(got[3])}: kernel {ms:.4f} ms "
            f"({sum(dev_ms):.4f} ms of it on the device: the look-back pass "
            f"{dev_ms[0]:.4f}, the tail {dev_ms[1]:.4f}), twin {plain:.4f} "
            "ms, bit-exact")
        if bounds[0] == 9:
            # two runs of 8-byte keys and 4-byte counts in, and out every
            # slot of the two full-size key outputs (_compact_kernel keeps
            # the input's size, kmer_count.py:602-608) and the two counts
            res["marker_filter"] = dict(
                ms=ms, plain_ms=plain, library_ms=None,
                device_ms=sum(dev_ms),
                **bound("K8", 2 * rows * 12 + 2 * rows * 8 + 16,
                        MERGE_OPS * 2 * rows))
    kernels = _kernels_of_one_call(fn, 2)
    if sorted(kernels.values()) != [1, 1] or not all(
            any(m in name for m in MARKER_KERNELS) for name in kernels):
        fail(f"K8 marker_filter: one call ran {kernels} on the card, not "
             "its two kernels once each")
    log(f"K8 marker_filter: one call's device work: {kernels}")
    del args, got
    # the merge-path tiles' edges, a few tiles a case: shared keys at,
    # across and after each tile edge, empty sides, all or no key shared,
    # a and b the same arrays, unequal lengths; each call twice
    cases = 0
    for name, a, b in S.marker_edge_cases(2025, KC.MARKER_TILE):
        ta = [torch.from_numpy(a[0]).to(dev), torch.from_numpy(a[1]).to(dev),
              a[2]]
        tb = ta if b is a else [torch.from_numpy(b[0]).to(dev),
                                torch.from_numpy(b[1]).to(dev), b[2]]
        for bounds in ((1, 11, 2, 9), (0, 2**31 - 1, 0, 2**31 - 1)):
            want = KC.marker_filter_ref(*ta, *tb, bounds)
            for _ in range(2):
                err = max(err, _check_same(f"K8 marker_filter {name}",
                                           KC.marker_filter(*ta, *tb, bounds),
                                           want))
                cases += 1
    log(f"K8 marker_filter: {cases} edge calls bit-exact")
    res["marker_filter"]["max_abs_err"] = err
    return res


def _index_of(words, q):
    import numpy as np
    order = np.argsort(words)
    return order[np.searchsorted(words, q, sorter=order)]


def _planted_batch(rng, key_words, b: int, k: int):
    """(packed, lengths, ids, has_n) card tensors of b reads of 100 bp."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import encode as E
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (b, 112))]
    kmers = E.words_to_bytes(key_words[rng.integers(0, key_words.size, b)],
                             k)
    pos = rng.integers(0, 100 - k + 1, b)
    seqs[np.arange(b)[:, None], pos[:, None] + np.arange(k)] = kmers
    lengths = np.full(b, 100, np.int32)
    lengths[rng.integers(0, b, 256)] = rng.integers(0, k, 256)
    ids = rng.integers(0, 4096, b).astype(np.int32)
    ids[rng.integers(0, b, 256)] = -1
    has_n = (rng.random(b) < 0.02).astype(np.uint8)
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(x).to(dev) for x in
                 (E.pack_codes_np(seqs), lengths, ids, has_n))


def phase_goldens(tmp: str) -> None:
    import io
    from hast_tpu_torch.pipeline import classify as C
    cases = (("main", "hap0.mer", "hap1.mer", ["reads1.fq.gz", "reads2.fq"],
              "phased.barcodes.golden"),
             ("edge", "edge.hap0.mer", "edge.hap1.mer", ["edge.fq"],
              "edge.phased.golden"),
             ("k15", "k15.hap0.mer", "k15.hap1.mer", ["k15.fq"],
              "k15.phased.golden"),
             ("k31", "k31.hap0.mer", "k31.hap1.mer", ["k31.fq"],
              "k31.phased.golden"))
    gdir = os.path.join(tmp, "golden")
    os.makedirs(gdir)
    for name, h0, h1, reads, golden in cases:
        for f in (h0, h1, *reads):
            shutil.copy(os.path.join(GOLD, f), gdir)
        for engine in ("native", "python"):
            out = io.BytesIO()
            C.run_classify(os.path.join(gdir, h0), os.path.join(gdir, h1),
                           [os.path.join(gdir, r) for r in reads], out,
                           w0=1.04, batch_size=4096, device="cuda",
                           engine=engine)
            with open(os.path.join(GOLD, golden), "rb") as f:
                if out.getvalue() != f.read():
                    fail(f"golden {name} ({engine} reader) differs on cuda")
        log(f"golden {name}: byte-identical on cuda (native and python "
            "readers)")


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _sorted_lines(path: str) -> list:
    with open(path, "rb") as f:
        return sorted(f.read().split())


def phase_goldens00(tmp: str) -> None:
    """Stage 00 goldens on the card, then the e2e 00->01 chain."""
    from hast_tpu_torch import cli
    from hast_tpu_torch.pipeline import markers as M
    pat = [os.path.join(GOLD00, "paternal.reads.fa.gz")]
    mat = [os.path.join(GOLD00, "maternal.reads.fa.gz")]
    for engine, parts in (("device", None), ("host", None), ("device", 3)):
        out = os.path.join(tmp, f"stage00_{engine}_{parts}")
        os.makedirs(out)
        with open(os.devnull, "w") as devnull:
            paths = M.build_unshared_markers(
                pat, mat, out, auto_bounds=True, batch_size=16384,
                engine=engine, n_parts=parts, device="cuda", log=devnull)
        for parent in ("maternal", "paternal"):
            for ours, golden in ((f"{parent}.kmercount.histo",
                                  f"{parent}.histo"),
                                 (f"{parent}.bounds.txt",
                                  f"{parent}.bounds.txt")):
                if not _same_bytes(os.path.join(out, ours),
                                   os.path.join(GOLD00, golden)):
                    fail(f"stage-00 {ours} differs on cuda ({engine}, "
                         f"parts {parts})")
            if _sorted_lines(paths[parent]) != _sorted_lines(os.path.join(
                    GOLD00, f"{parent}.unique.filter.mer")):
                fail(f"stage-00 {parent} markers differ on cuda ({engine},"
                     f" parts {parts})")
        log(f"golden stage00 ({engine} engine, parts {parts}): histo and "
            "bounds byte-identical, markers equal to jellyfish's on cuda")

    d00, d01 = os.path.join(tmp, "e2e00"), os.path.join(tmp, "e2e01")
    os.makedirs(d00)
    os.makedirs(d01)
    cli.main(["build-markers", "--out-dir", d00, "--auto_bounds",
              "--paternal", os.path.join(E2E, "paternal.fa.gz"),
              "--maternal", os.path.join(E2E, "maternal.fa.gz"),
              "--batch-size", "16384", "--device", "cuda"])
    mer = os.path.join(d00, "{}.unique.filter.mer")
    cli.main(["classify-reads",
              "--paternal_mer", mer.format("paternal"),
              "--maternal_mer", mer.format("maternal"),
              "--filial", os.path.join(E2E, "son.r1.fq.gz"),
              "--filial", os.path.join(E2E, "son.r2.fq"),
              "--workdir", d01, "--batch-size", "4096", "--device", "cuda"])
    if not _same_bytes(os.path.join(d01, "phased.barcodes"),
                       os.path.join(E2E, "stage01", "phased.barcodes")):
        fail("e2e 00->01 chain: phased.barcodes differs on cuda")
    for r in (1, 2):
        for name in ("paternal", "maternal", "homozygous", "nobarcode"):
            f = f"son.r{r}.fq.{name}.fastq"
            golden = os.path.join(E2E, "stage01", f)
            ours = os.path.join(d01, f)
            if os.path.exists(golden) != os.path.exists(ours) or (
                    os.path.exists(golden) and not _same_bytes(ours,
                                                               golden)):
                fail(f"e2e 00->01 chain: {f} differs on cuda")
    log("golden e2e: build-markers + classify-reads --device cuda, "
        "phased.barcodes and binned fastqs byte-identical")


def phase_main_path(tmp: str) -> dict:
    import io
    import itertools

    import torch
    from hast_tpu_torch import cli
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.pipeline import classify as C
    from hast_tpu_torch.utils import synthetic as S

    d = os.path.join(tmp, "bench")
    wd = os.path.join(d, "01.classify")
    os.makedirs(wd)
    hap0 = os.path.join(d, "paternal.mer")
    hap1 = os.path.join(d, "maternal.mer")
    reads = os.path.join(d, "son.fq")
    t0 = time.perf_counter()
    m0, m1 = S.make_marker_files(7, N_MARKERS, K, hap0, hap1)
    S.make_stlfr_fastq(8, reads, m0, m1, N_READS)
    log(f"inputs: {N_MARKERS} markers/hap (k={K}), {N_READS} 100-bp reads, "
        f"generated in {time.perf_counter() - t0:.2f} s")

    _build.LAUNCHES.clear()
    _build.TWIN_CALLS.clear()
    t0 = time.perf_counter()
    cli.main(["classify-reads", "--paternal_mer", hap0, "--maternal_mer",
              hap1, "--filial", reads, "--workdir", wd, "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    twins = dict(_build.TWIN_CALLS)
    log(f"classify-reads --device cuda: {wall:.3f} s end to end "
        f"({N_READS / wall:.0f} reads/s, marker text parse and table build "
        f"included); launches {launches}; twin calls {twins}")
    for name in ("classify_tally", "grow_tally", "pack_tally"):
        if launches.get(name, 0) <= 0:
            fail(f"the main path launched no {name} kernel")
    if any(twins.values()):
        fail(f"the main path called twins: {twins}")
    phased = os.path.join(wd, "phased.barcodes")
    with open(phased, "rb") as f:
        rows = [line.split(b"\t") for line in f]
    haps = {h: sum(1 for r in rows if r[1] == h) for h in (b"0", b"1", b"-1")}
    if not (haps[b"0"] and haps[b"1"] and haps[b"-1"]):
        fail(f"phased.barcodes lacks a class: {haps}")
    for name in ("paternal", "maternal", "homozygous", "nobarcode"):
        if not os.path.exists(os.path.join(wd, f"son.fq.{name}.fastq")):
            fail(f"quartering wrote no son.fq.{name}.fastq")
    log(f"phased.barcodes: {len(rows)} barcodes, paternal {haps[b'0']}, "
        f"maternal {haps[b'1']}, homozygous/unknown {haps[b'-1']}")

    # warm repeat (snapshot present), run_classify's three steps timed
    t0 = time.perf_counter()
    table = C.load_marker_table(hap0, hap1)
    C.erase_adaptors(table)
    table = table.to("cuda")
    t1 = time.perf_counter()
    tally = C.classify_fastqs(table, [reads], 1 << 15)
    t2 = time.perf_counter()
    C.write_phased_barcodes(tally, table, io.BytesIO(), 1.04)
    timings = dict(load_markers=t1 - t0, classify=t2 - t1,
                   decide_write=time.perf_counter() - t2)
    del table, tally
    log("run_classify warm (snapshot): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in timings.items())
        + f"; classify phase {N_READS / timings['classify']:.0f} reads/s")
    # the same warm run under torch.profiler: K3's device time over its
    # launches, and the device's idle share
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        C.run_classify(hap0, hap1, [reads], io.BytesIO(), w0=1.04,
                       batch_size=1 << 15, device="cuda")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if _device_us(e)]
    k3 = [e for e in events if READ_VOTE_KERNELS["classify_tally"] in e.key]
    k3_ms = sum(_device_us(e) for e in k3) / 1e3
    busy = sum(_device_us(e) for e in events) / 1e6
    log(f"run_classify warm under torch.profiler: wall {prof_wall:.3f} s, "
        f"K3 {k3_ms:.4f} ms of device time over "
        f"{sum(e.count for e in k3)} launches, device busy {busy:.4f} s, "
        f"idle share {1 - busy / prof_wall:.4f}")

    # the first 10^5 reads on the card and on the CPU twins
    small = os.path.join(d, "son.100k.fq")
    with open(reads, "rb") as f, open(small, "wb") as w:
        w.writelines(itertools.islice(f, 4 * N_CPU_READS))
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(d, f"phased.100k.{dev}")
        t0 = time.perf_counter()
        cli.main(["classify", "--hap0", hap0, "--hap1", hap1, "--read",
                  small, "--weight0", "1.04", "--output", outs[dev],
                  "--device", dev])
        log(f"classify {N_CPU_READS} reads --device {dev}: "
            f"{time.perf_counter() - t0:.3f} s")
    with open(outs["cuda"], "rb") as a, open(outs["cpu"], "rb") as b:
        if a.read() != b.read():
            fail("first 10^5 reads: cuda and cpu phased.barcodes differ")
    log(f"first {N_CPU_READS} reads: cuda and cpu phased.barcodes equal")
    return dict(launches=launches, wall=wall, timings=timings,
                k3_device_ms=k3_ms)


def phase_markers_main(tmp: str) -> dict:
    """build-markers --device cuda on bench.py's stage-00 trio."""
    import itertools
    from hast_tpu_torch import cli
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.utils import synthetic as S

    d = os.path.join(tmp, "stage00")
    os.makedirs(d)
    t0 = time.perf_counter()
    reads = {"paternal": os.path.join(d, "pat_parent.fa"),
             "maternal": os.path.join(d, "mat_parent.fa")}
    genomes = S.make_trio_genomes(77, GENOME_LEN, het_rate=0.001)
    for seed, g, parent in zip((1, 2), genomes, ("paternal", "maternal")):
        S.make_parent_reads_vectorized(seed, g, reads[parent], COVERAGE, 100,
                                       0.002)
    n_reads = {p: os.path.getsize(f) // 104 for p, f in reads.items()}
    log(f"inputs: {GENOME_LEN} bp trio, {COVERAGE}x 100-bp reads "
        f"({n_reads['paternal']} + {n_reads['maternal']} reads), generated "
        f"in {time.perf_counter() - t0:.2f} s")

    out = os.path.join(d, "00")
    os.makedirs(out)
    _build.LAUNCHES.clear()
    _build.TWIN_CALLS.clear()
    t0 = time.perf_counter()
    cli.main(["build-markers", "--paternal", reads["paternal"],
              "--maternal", reads["maternal"], "--out-dir", out,
              "--auto_bounds", "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    twins = dict(_build.TWIN_CALLS)
    windows = sum(n_reads.values()) * (100 - K + 1)
    log(f"build-markers --device cuda: {wall:.3f} s end to end "
        f"({windows / wall:.0f} windows/s); launches {launches}; twin calls "
        f"{twins}")
    for name in STAGE00_KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"the stage-00 main path launched no {name} kernel")
    if any(twins.values()):
        fail(f"the stage-00 main path called twins: {twins}")
    for parent in ("paternal", "maternal"):
        with open(os.path.join(out, f"{parent}.bounds.txt")) as f:
            b = dict(line.strip().split("=") for line in f)
        n = len(_sorted_lines(os.path.join(out,
                                           f"{parent}.unique.filter.mer")))
        if not (1 <= int(b["LOWER_INDEX"]) < int(b["UPPER_INDEX"])
                and n > 0):
            fail(f"stage-00 {parent}: bounds {b}, {n} markers")
        log(f"{parent}: {n} markers, bounds {b}")

    # the first 2x10^5 reads of each parent on the card and on the CPU
    small = {}
    for parent, f in reads.items():
        small[parent] = os.path.join(d, f"{parent}.head.fa")
        with open(f, "rb") as src, open(small[parent], "wb") as w:
            w.writelines(itertools.islice(src, 2 * N_CPU_PARENT_READS))
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(d, f"head_{dev}")
        os.makedirs(outs[dev])
        t0 = time.perf_counter()
        cli.main(["build-markers", "--paternal", small["paternal"],
                  "--maternal", small["maternal"], "--out-dir", outs[dev],
                  "--auto_bounds", "--device", dev])
        log(f"build-markers {N_CPU_PARENT_READS} reads/parent --device "
            f"{dev}: {time.perf_counter() - t0:.3f} s")
    for f in sorted(os.listdir(outs["cpu"])):
        if f.startswith("step_"):
            continue
        if not _same_bytes(os.path.join(outs["cuda"], f),
                           os.path.join(outs["cpu"], f)):
            fail(f"first {N_CPU_PARENT_READS} reads: {f} differs between "
                 "cuda and cpu")
    log(f"first {N_CPU_PARENT_READS} reads/parent: cuda and cpu write "
        "equal bytes")
    return dict(launches=launches, wall=wall, reads=reads)


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return us if us is not None else event.self_cuda_time_total


def _kernels_of_one_call(fn, want: int) -> dict:
    """{name: count} of the device work (kernels, memsets, copies) of one
    call of fn, after a warm-up call, from torch.profiler; profiled again
    (up to three times) while it shows fewer than `want` launches, since
    the profiler now and then drops a record."""
    fn()
    for _ in range(3):
        seen = {e.key: e.count for e in _profiled(fn) if _device_us(e)}
        if sum(seen.values()) >= want:
            break
        log(f"the profiler recorded {seen} for one call; profiling again")
    return seen


def phase_stage00_breakdown(tmp: str, reads: dict) -> None:
    """Where stage 00's time goes: the reader alone, then the device
    engine under torch.profiler (device time by kernel, idle share)."""
    import torch
    from hast_tpu_torch.ops import kmer_count as KC
    from hast_tpu_torch.pipeline import markers as M

    t0 = time.perf_counter()
    n_batches = 0
    for f in reads.values():
        reader = KC.open_count_reader(f, 1 << 14)
        if reader is None:
            fail(f"the native counting reader cannot open {f}")
        try:
            for b in reader:
                KC.batch_is_clean(b.good, b.lengths)
                n_batches += 1
        finally:
            reader.close()
    log(f"stage-00 native reader alone (parse, pack, mask, clean test), "
        f"both parents: {time.perf_counter() - t0:.3f} s, {n_batches} "
        "batches")

    groups = (("K4 count_windows", ("count_windows_kernel",)),
              ("K5 sort_pairs", ("onesweep_",)),
              ("K6 fold_runs", FOLD_KERNELS),
              ("K7 count_stats", ("count_stats_kernel",)),
              ("K8 marker_filter", MARKER_KERNELS),
              ("copies and memsets (K5's status words)",
               ("Memcpy", "Memset")))
    walls = []

    def build():
        out = os.path.join(tmp, f"stage00_profiled{len(walls)}")
        os.makedirs(out)
        t0 = time.perf_counter()
        with open(os.devnull, "w") as devnull:
            M.build_unshared_markers([reads["paternal"]],
                                     [reads["maternal"]], out,
                                     auto_bounds=True, device="cuda",
                                     log=devnull)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    events, k5 = _profiled_k5(build)
    wall = walls[-1]
    sums = {name: 0.0 for name, _ in groups}
    sums["other (torch glue)"] = 0.0
    for e in events:
        us = _device_us(e)
        if not us:
            continue
        name = next((g for g, keys in groups
                     if any(x in e.key for x in keys)), "other (torch glue)")
        sums[name] += us
    busy = sum(sums.values()) / 1e6
    idle = f"{1 - busy / wall:.4f}" if busy else "not measured"
    with k5_calls(packing=True) as packed:
        build()
    log(f"stage-00 device engine under torch.profiler: wall {wall:.3f} s, "
        f"device busy {busy:.4f} s, idle share {idle}; "
        "device s by kernel: " + ", ".join(
            f"{k} {v / 1e6:.4f}" for k, v in sums.items()) +
        f"; K5: {k5['calls']} calls, {k5['recorded']} of their "
        f"{k5['kernels']} kernels recorded; {packed['packed']} of "
        f"{packed['sorts']} fold sorts packed their counts")


def _segment_records(rng, k: int, key_sets):
    """K9's check input: SEG_RECORDS random records of 0-20 kb plus ones of
    k - 1, k, 4096 + k - 1 (one tile to the byte), 50,000, 1024 + k - 1
    and 4097 + k - 1 bytes, a table key planted every 200 bytes (from each
    key set in turn), then 2 % of bytes soft-masked, 1 % N and 0.1 %
    IUPAC codes; then bad bytes on the first byte of every 1,024-window
    and 4,096-window tile of the 50,000-byte record and on the last byte
    of each tile's last window, one record all lowercase (the one of 1024
    + k - 1 bytes) and one with a single good window (the last).  Returns
    (data, starts) numpy arrays; the seven records after the random ones
    come in the order above."""
    import numpy as np
    from hast_tpu_torch.ops import encode as E
    lengths = np.concatenate([rng.integers(0, 20_001, SEG_RECORDS),
                              [k - 1, k, 4096 + k - 1, 50_000, 1024 + k - 1,
                               4097 + k - 1, 2 * k + 11]])
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    total = int(starts[-1])
    data = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, total)]
    pos = rng.integers(0, total - k, total // 200)
    rec = np.searchsorted(starts, pos, side="right") - 1
    pos = pos[pos + k <= starts[rec + 1]]
    keys = np.concatenate([ks[rng.integers(0, ks.size, pos.size // 2 + 1)]
                           for ks in key_sets])[:pos.size]
    data[pos[:, None] + np.arange(k)] = E.words_to_bytes(keys, k)
    u = rng.random(total)
    data = np.where(u < 0.02, data | 0x20, data)
    data = np.where((u >= 0.02) & (u < 0.03), ord("N"), data)
    iupac = np.frombuffer(b"RYKMSWBDHV", np.uint8)
    data = np.where((u >= 0.03) & (u < 0.031),
                    iupac[rng.integers(0, iupac.size, total)], data)
    r = SEG_RECORDS + 3                      # the 50,000-byte record
    for tile in (1024, 4096):
        for t in range(starts[r], starts[r + 1], tile):
            for pos in (t, t + tile + k - 2):
                if pos < starts[r + 1]:
                    data[pos] = b"aNRy"[pos % 4]
    data[starts[r + 1]:starts[r + 2]] |= 0x20
    data[starts[-2]:starts[-1]] = ord("N")
    data[starts[-2] + k:starts[-2] + 2 * k] = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, k)]
    return data.astype(np.uint8), starts


def _valid_windows(data, starts, k: int) -> int:
    """Windows of k uppercase A/C/G/T bytes inside their record."""
    import torch
    lut = torch.zeros(256, dtype=torch.bool, device=data.device)
    lut[list(b"ACGT")] = True
    good = torch.zeros(data.numel() + 1, dtype=torch.int64,
                       device=data.device)
    good[1:] = torch.cumsum(lut[data.long()].long(), 0)
    g = torch.arange(data.numel() - k + 1, device=data.device)
    rec = torch.searchsorted(starts, g, right=True) - 1
    return int((((good[g + k] - good[g]) == k)
                & (g + k <= starts[rec + 1])).sum())


def phase_kernels03(tables: dict, words, bwords) -> dict:
    """K9 segment_votes against its twin on the same card tensors, on
    phase 2's tables: 2^20-row quot, 2^21-row full, 2^24-row quot."""
    import numpy as np
    import torch
    from hast_tpu_torch.pipeline import rephase as R

    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    data_np, starts_np = _segment_records(rng, K, (words, bwords))
    data = torch.from_numpy(data_np).to(dev)
    starts = torch.from_numpy(starts_np).to(dev)
    n_rec = starts.numel() - 1
    n_valid = _valid_windows(data, starts, K)
    err = 0.0
    for name, table in (("quot", tables["quot"]), ("full", tables["full"]),
                        ("quot 2^24-row", tables["big"])):
        got = torch.zeros((n_rec, 2), dtype=torch.int64, device=dev)
        want = got.clone()
        R.segment_votes(table, data, starts, got)
        R.segment_votes_ref(table, data, starts, want)
        err = max(err, _check_same(f"K9 segment_votes ({name})", [got],
                                   [want]))
        edges = got[SEG_RECORDS:].tolist()   # k - 1, ..., one good window
        if int(got.sum()) == 0 or sum(edges[0]) or sum(edges[4]) or \
                sum(edges[6]) > 2:
            fail(f"K9 segment_votes ({name}): {int(got.sum())} votes, "
                 f"{edges} for the records of k - 1 bytes, ..., all "
                 "lowercase, one good window")
        out = torch.zeros_like(got)
        call = lambda: R.segment_votes(table, data, starts, out)  # noqa
        ms = cuda_ms(call, 10)
        dev_ms = device_ms(call, 10, "segment_votes_kernel")
        plain = cuda_ms(lambda: R.segment_votes_ref(table, data, starts,
                                                    out), 1)
        log(f"K9 segment_votes {name} table {table.n_buckets} rows, "
            f"{n_rec} records, {data.numel()} bytes, {n_valid} valid "
            f"windows, {int(got.sum())} votes: kernel {ms:.4f} ms "
            f"({dev_ms:.4f} ms on the device back to back), twin "
            f"{plain:.4f} ms, bit-exact")
    # back to back, most of the 41 MB of record bytes stay in the 50 MB
    # L2; with 256 MB written before each call they come from HBM, as the
    # bound counts them
    flush = torch.empty(1 << 28, dtype=torch.uint8, device=dev)
    cold_ms = device_ms(lambda: (flush.zero_(), call()), 10,
                        "segment_votes_kernel")
    del flush
    log(f"K9 segment_votes on the 2^24-row table with the L2 flushed before "
        f"each call: {cold_ms:.4f} ms on the device")
    # the last, HBM-resident table: bytes and starts in, votes read and
    # written, two rows per valid window
    windows = int((starts[1:] - starts[:-1] - K + 1).clamp(min=0).sum())
    k9 = bound("K9", data.numel() + 8 * (n_rec + 1) + 32 * n_rec
               + 32 * n_valid, WINDOW_OPS * windows
               + (PROBE_OPS[tables["big"].fmt] + VOTE_OPS) * n_valid)
    log(f"K9 segment_votes on the 2^24-row table: {k9['bound_ms'] / dev_ms:.2f}"
        f" of its bound back to back, {k9['bound_ms'] / cold_ms:.2f} with "
        "the L2 flushed")
    return {"segment_votes": dict(
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
        device_ms=dev_ms, device_ms_l2_flushed=cold_ms, **k9)}


def phase_goldens03(tmp: str) -> None:
    """Stage-03 goldens and the whole HAST.sh run on the card."""
    import contextlib
    import io
    from hast_tpu_torch import cli
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.utils import synthetic as S
    pat = os.path.join(GOLD03, "paternal.mer")
    mat = os.path.join(GOLD03, "maternal.mer")
    d = os.path.join(tmp, "stage03")
    os.makedirs(d)
    cli.main(["mkoutput", "--assembly_path", os.path.join(GOLD03, "assembly"),
              "--paternal_mer", pat, "--maternal_mer", mat, "--prefer",
              "paternal", "--workdir", d, "--device", "cuda"])
    for f in STAGE03_FILES:
        if not _same_bytes(os.path.join(d, f), os.path.join(GOLD03, f)):
            fail(f"stage-03 golden {f} differs on cuda")
    if os.readlink(os.path.join(d, "output.primary.fa")) != \
            "output.father.fa":
        fail("stage-03: output.primary.fa does not link output.father.fa")
    buf = io.BytesIO()
    text = io.TextIOWrapper(buf)
    with contextlib.redirect_stdout(text):
        cli.main(["classify-segments", "--hap", pat, "--hap", mat, "--read",
                  os.path.join(GOLD03, "fastq_mode.fq"), "--format",
                  "fastq", "--device", "cuda"])
        text.flush()
    with open(os.path.join(GOLD03, "fastq_mode.out"), "rb") as f:
        if buf.getvalue() != f.read():
            fail("classify-segments --format fastq differs on cuda")
    log(f"golden stage03: mkoutput --device cuda, the {len(STAGE03_FILES)} "
        "files byte-identical and the primary link; classify-segments "
        "--format fastq byte-identical")

    sn = S.write_fake_supernova(
        tmp, os.path.join(E2E, "assembly"),
        os.path.join(ROOT, "tests", "golden", "stage02", "whitelist.txt"))
    run = os.path.join(tmp, "run")
    os.makedirs(run)
    _build.LAUNCHES.clear()
    _build.TWIN_CALLS.clear()
    t0 = time.perf_counter()
    cli.main(["run", "--paternal", os.path.join(E2E, "paternal.fa.gz"),
              "--maternal", os.path.join(E2E, "maternal.fa.gz"),
              "--read1", os.path.join(E2E, "son.r1.fq.gz"),
              "--read2", os.path.join(E2E, "son.r2.fq"), "--supernova", sn,
              "--workdir", run, "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches, twins = dict(_build.LAUNCHES), dict(_build.TWIN_CALLS)
    if not _same_bytes(os.path.join(run, "01.classify_reads",
                                    "phased.barcodes"),
                       os.path.join(E2E, "stage01", "phased.barcodes")):
        fail("run --device cuda: phased.barcodes differs")
    for parent, fa in (("paternal", "father"), ("maternal", "mother")):
        for f in (f"output.{fa}.fa", f"output.{fa}.idx",
                  "output.supplement.fa"):
            if not _same_bytes(os.path.join(run, f"03.{parent}_output", f),
                               os.path.join(E2E, f"stage03_{parent}", f)):
                fail(f"run --device cuda: {parent} {f} differs")
    # the golden run's few barcodes never grow the tally (no K10)
    for name in ("classify_tally", "pack_tally", *STAGE00_KERNELS,
                 "segment_votes"):
        if launches.get(name, 0) <= 0:
            fail(f"run --device cuda launched no {name} kernel")
    if any(twins.values()):
        fail(f"run --device cuda called twins: {twins}")
    log(f"golden e2e: run --device cuda (00->01->02->03, stand-in "
        f"Supernova) in {wall:.3f} s: both final fastas, idx and "
        f"supplements and phased.barcodes byte-identical; launches "
        f"{launches}; twin calls {twins}")


def phase_stage03_main(tmp: str) -> dict:
    """mkoutput on the card on a seeded pseudohap2 assembly at scale."""
    import io
    import torch
    from hast_tpu_torch.io import fastq as FQ
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.pipeline import rephase as R
    from hast_tpu_torch.utils import synthetic as S

    d = os.path.join(tmp, "scale03")
    asm, wd = os.path.join(d, "assembly"), os.path.join(d, "03")
    os.makedirs(asm)
    os.makedirs(wd)
    mers = [os.path.join(d, "paternal.mer"), os.path.join(d, "maternal.mer")]
    t0 = time.perf_counter()
    made = S.make_pseudohap2_assembly(3, asm, *mers, n_scaffolds=SEG_SCAFFOLDS,
                                      phased_bases=SEG_PHASED_BASES,
                                      n_markers=SEG_MARKERS, k=K)
    log(f"stage-03 inputs: {made}, generated in "
        f"{time.perf_counter() - t0:.2f} s")

    _build.LAUNCHES.clear()
    _build.TWIN_CALLS.clear()
    steps = {}
    t0 = time.perf_counter()
    R.mkoutput(asm, "output", *mers, "paternal", wd, device="cuda",
               timings=steps)
    wall = time.perf_counter() - t0
    launches, twins = dict(_build.LAUNCHES), dict(_build.TWIN_CALLS)
    log(f"mkoutput on cuda: {wall:.3f} s end to end; by step: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
        + f"; launches {launches}; twin calls {twins}")
    if launches.get("segment_votes", 0) <= 0:
        fail("the stage-03 main path launched no segment_votes kernel")
    if any(twins.values()):
        fail(f"the stage-03 main path called twins: {twins}")
    with open(os.path.join(wd, "phasing.out")) as f:
        verdicts = [line.split("\t")[1] for line in f]
    classes = {v: verdicts.count(v)
               for v in ("haplotype0", "haplotype1", "ambiguous")}
    with open(os.path.join(wd, "output.merge.homo.ids")) as f:
        homo = sum(1 for _ in f)
    if not all(classes.values()) or not homo or \
            os.path.getsize(os.path.join(wd, "output.father.fa")) == 0:
        fail(f"stage-03 scale: verdicts {classes}, {homo} final homo pairs")
    log(f"stage-03 scale: {len(verdicts)} segments, verdicts {classes}, "
        f"{homo} pairs left homozygous (supplement)")

    # the first SEG_HEAD_BASES of phb.12.fa on the card and on the CPU
    phb = os.path.join(wd, "output.phb.12.fa")
    head = os.path.join(d, "head.fa")
    n = 0
    with open(head, "wb") as f:
        for name, seq in FQ.fasta_records(phb):
            f.write(b">" + name + b"\n" + R.wrap_seq(seq, 60))
            n += len(seq)
            if n >= SEG_HEAD_BASES:
                break
    table = R._build_segment_table(mers, "cuda")
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = io.StringIO()
        t0 = time.perf_counter()
        R.write_verdicts(table.to(dev), head, outs[dev])
        log(f"first {n} bases of phb.12.fa classified on {dev}: "
            f"{time.perf_counter() - t0:.3f} s")
    if outs["cuda"].getvalue() != outs["cpu"].getvalue():
        fail("stage-03 head: cuda and cpu verdicts differ")
    log(f"first {n} bases of phb.12.fa: cuda and cpu verdicts equal")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        R.write_verdicts(table, phb, io.StringIO())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k9 = busy = 0.0
    for e in prof.key_averages():
        us = _device_us(e)
        if us:
            busy += us / 1e6
            if "segment_votes_kernel" in e.key:
                k9 += us / 1e6
    idle = f"{1 - busy / wall:.4f}" if busy else "not measured"
    log(f"stage-03 classify step under torch.profiler ({table.n_buckets}-row "
        f"{table.fmt} table): wall {wall:.3f} s, K9 device {k9:.4f} s, "
        f"device busy {busy:.4f} s, idle share {idle}")
    return launches


def phase_scale() -> None:
    """Two parents of 6x10^8 windows each through the DeviceCounter, the
    histogram and the marker algebra: kernels, then twins, on the card."""
    import contextlib
    import torch
    from hast_tpu_torch.ops import kmer_count as KC

    dev = torch.device("cuda")
    starts = {"paternal": 0, "maternal": SCALE_POOL * 3 // 4}

    @contextlib.contextmanager
    def twins_on_card():
        saved = {n: getattr(KC, n) for n in STAGE00_KERNELS}
        for n in STAGE00_KERNELS:
            setattr(KC, n, getattr(KC, f"{n}_ref"))
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(KC, n, fn)

    def count(parent: str, seed: int):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        dc = KC.DeviceCounter(K, dev)
        lo = starts[parent]
        for s in range(0, SCALE_WINDOWS, SCALE_CHUNK):
            idx = torch.randint(lo, lo + SCALE_POOL,
                                (min(SCALE_CHUNK, SCALE_WINDOWS - s),),
                                device=dev, generator=g)
            dc.add_sorted_chunk(_hash_keys(idx))
        return dc.finalize_device(), dc.n_folds

    results = {}
    for mode in ("kernels", "twins"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = {}
        with twins_on_card() if mode == "twins" else contextlib.nullcontext():
            t0 = time.perf_counter()
            pat, folds_p = count("paternal", 1)
            mat, folds_m = count("maternal", 2)
            torch.cuda.synchronize()
            times["count"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            hists = (pat.histo(), mat.histo())
            times["histo"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            markers = KC.device_marker_algebra(pat, mat, 2, 8, 2, 8)
            times["marker_algebra"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        if mode == "kernels":
            # the marker algebra is K8 plus the fetch of the kept words
            k8 = cuda_ms(lambda: KC.marker_filter(
                pat.keys, pat.counts, pat.n_valid, mat.keys, mat.counts,
                mat.n_valid, (2, 8, 2, 8)), 3)
            log(f"scale: K8 marker_filter alone on {pat.n_valid} + "
                f"{mat.n_valid} rows: {k8:.4f} ms")
            # K5's share of the count's device time: the paternal count
            # again, under torch.profiler
            again = [None]

            def paternal():
                again[0] = None
                again[0] = count("paternal", 1)[0]

            events, k5 = _profiled_k5(paternal)
            busy = k5_us = 0.0
            for e in events:
                us = _device_us(e)
                busy += us
                if "onesweep_" in e.key:
                    k5_us += us
            if not torch.equal(again[0].keys, pat.keys):
                fail("scale: the profiled paternal count differs")
            del again
            with k5_calls(packing=True) as packed:
                count("paternal", 1)
                count("maternal", 2)
            log(f"scale: the paternal count's device time {busy / 1e6:.4f} "
                f"s, K5 sort_pairs {k5_us / 1e6:.4f} s of it "
                f"({k5_us / busy:.4f})" if busy else
                "scale: K5's share of the count: not measured (the "
                "profiler saw no device time)")
            log(f"scale: K5 {k5['calls']} calls in the paternal count, "
                f"{k5['recorded']} of their {k5['kernels']} kernels "
                f"recorded; {packed['packed']} of {packed['sorts']} fold "
                "sorts of both parents packed their counts")
        results[mode] = (pat, mat, hists, markers)
        log(f"scale ({mode}): 2 x {SCALE_WINDOWS} windows in "
            f"{SCALE_CHUNK}-key chunks; distinct {pat.n_distinct} + "
            f"{mat.n_distinct}, folds {folds_p} + {folds_m}; markers "
            f"{markers[0].size} + {markers[1].size}; peak device memory "
            f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB "
            "before; " + ", ".join(f"{k} {v:.3f} s"
                                   for k, v in times.items()))
    (kp, km, kh, kw), (tp, tm, th, tw) = results["kernels"], results["twins"]
    for a, b in ((kp, tp), (km, tm)):
        if a.n_valid != b.n_valid or not (torch.equal(a.keys, b.keys)
                                          and torch.equal(a.counts,
                                                          b.counts)):
            fail("scale: the kernels' and the twins' tables differ")
    import numpy as np
    if not all(np.array_equal(a, b) for a, b in zip(kh + kw, th + tw)):
        fail("scale: histograms or markers differ between kernels and twins")
    if not (1.4e8 < kp.n_distinct < 1.6e8 and kw[0].size and kw[1].size):
        fail(f"scale: {kp.n_distinct} distinct, markers {kw[0].size} + "
             f"{kw[1].size}")
    log("scale: tables, histograms and markers equal between kernels and "
        "twins")


def _vote_reads_input(rng, key_sets, n: int, L: int = 112):
    """n ACGT reads of stride L, lengths 100 but for some shorter than k
    and some empty, one key of each set planted in each read."""
    import numpy as np
    from hast_tpu_torch.ops import encode as E
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, L))]
    for s, ks in enumerate(key_sets):
        pos = rng.integers(s * 50, s * 50 + 50 - K, n)
        kmers = E.words_to_bytes(ks[rng.integers(0, ks.size, n)], K)
        seqs[np.arange(n)[:, None], pos[:, None] + np.arange(K)] = kmers
    lens = np.full(n, 100, np.int32)
    lens[rng.integers(0, n, 512)] = rng.integers(0, K, 512)
    return seqs, lens


def vote_tables(rng) -> tuple:
    """The probed tables at the main paths' sizes: 2x10^6 random 21-mers
    as a quot table (2^20 rows, 16.8 MB, in the 50 MB L2) and a forced
    full one (2^21 rows), 4x10^7 as a quot table of 2^24 rows (268 MB,
    past the L2; the few duplicate draws merge in the build).  Returns
    ({"quot", "full", "big"}: table on the card, the 2x10^6 keys, their
    payloads, the 4x10^7 keys)."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import hashtable as H
    dev = torch.device("cuda")
    words, hi, lo = random_keys(rng, 2_000_000, K)
    pay = rng.integers(1, 4, words.size).astype(np.uint32)
    bwords = rng.integers(0, 1 << (2 * K), 40_000_000, dtype=np.int64)
    bpay = rng.integers(1, 4, bwords.size).astype(np.uint32)
    tables = {}
    for name, args, fmt in (("quot", (hi, lo, pay), "quot"),
                            ("full", (hi, lo, pay), "full"),
                            ("big", ((bwords >> 32).astype(np.uint32),
                                     (bwords & 0xFFFFFFFF).astype(np.uint32),
                                     bpay), "auto")):
        t0 = time.perf_counter()
        tables[name] = t = H.build_table(*args, K, load=0.7, fmt=fmt).to(dev)
        log(f"{name} table: {t.fmt}, {t.n_buckets} rows, "
            f"{t.data.numel() * 4 / 1e6:.1f} MB, built in "
            f"{time.perf_counter() - t0:.2f} s")
    return tables, words, pay, bwords


def time_read_votes(tables: dict, words, bwords) -> dict:
    """Call and device times (ms) of K3 and K13 at the main paths' shapes:
    K3 on 32,768 reads (_planted_batch's random ids, and barcode-sorted
    ids), K13 on 65,536 packed and ASCII reads (_vote_reads_input), on the
    2^20-row quot, 2^21-row full and 2^24-row quot tables, the last also
    with FLUSH_BYTES written before each call; and both in the long form
    (K13 packed) on the 2^20-row table: 8,192 reads of a batch the native
    paths redo at len_cap 8,192, 100 bp but for 1 % of 1,000-8,192 bases.
    Calls only the wrappers, whose contracts earlier trees share, so that
    a script can time another tree's package with it."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.pipeline import classify as C
    from hast_tpu_torch.utils import synthetic as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(2031)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    seqs, lens = _vote_reads_input(rng, (words, bwords), N_VOTE_READS)
    odd = np.frombuffer(b"acgtNRUnKMSWBDHV", np.uint8)
    ascii_np = np.where(rng.random(seqs.shape) < 0.01,
                        odd[rng.integers(0, odd.size, seqs.shape)], seqs)
    forms = {"packed": (True, torch.from_numpy(E.pack_codes_np(seqs)).to(dev)),
             "ascii": (False, torch.from_numpy(ascii_np).to(dev))}
    lengths = torch.from_numpy(lens).to(dev)
    acc = torch.zeros((4096, 3), dtype=torch.int32, device=dev)
    out = {}

    def both(key, fn, kernel):
        ms = cuda_ms(fn, 20)
        dev_ms = device_ms(fn, 20, kernel)
        cold = None
        if key[1] == "big":
            cold = device_ms(lambda: (flush.zero_(), fn()), 20, kernel)
        out["/".join(key)] = dict(ms=ms, device_ms=dev_ms,
                                  device_ms_l2_flushed=cold)
        log(f"{'K3' if key[0] == 'classify_tally' else 'K13'} {key[0]} "
            f"{key[1]} table, {key[2]}: call {ms:.4f} ms, device "
            f"{dev_ms:.4f} ms" + (f", {cold:.4f} ms with the L2 flushed "
                                  "before each call" if cold else ""))

    for name in ("quot", "full", "big"):
        table = tables[name]
        batch = _planted_batch(rng, bwords if name == "big" else words,
                               32768, K)
        runs = torch.from_numpy(S.barcode_sorted_ids(
            2031, 32768, acc.shape[0])).to(dev)
        for ids_name, ids in (("random ids", batch[2]),
                              ("barcode-sorted ids", runs)):
            args = (batch[0], batch[1], ids, batch[3])
            both(("classify_tally", name, ids_name),
                 lambda: C.tally_step(table, acc, *args),
                 READ_VOTE_KERNELS["classify_tally"])
        for form, (packed, reads) in forms.items():
            both(("vote_reads", name, form),
                 lambda: C.vote_reads(table, reads, lengths, packed),
                 READ_VOTE_KERNELS["vote_reads"])

    table = tables["quot"]
    args = len_cap_batch(words, acc.shape[0])
    both(("classify_tally", "quot", "len_cap 8192"),
         lambda: C.tally_step(table, acc, *args),
         READ_VOTE_KERNELS["classify_tally"])
    both(("vote_reads", "quot", "len_cap 8192"),
         lambda: C.vote_reads(table, args[0], args[1], True),
         READ_VOTE_KERNELS["vote_reads"])
    return out


def len_cap_batch(words, cap: int) -> list:
    """(packed, lengths, ids, has_n) on the card: 8,192 reads of a batch
    the native paths redo at len_cap 8,192 (2,048-byte rows, the long
    form), 100 bp but for 1 % of 1,000-8,192 bases, each with a key of
    words at base 10, in barcode runs of ids below cap."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.utils import synthetic as S

    rng = np.random.default_rng(2032)
    n, lp = 8192, 2048
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 4 * lp))]
    lens = np.full(n, 100, np.int32)
    longer = rng.random(n) < 0.01
    lens[longer] = rng.integers(1000, 4 * lp + 1, int(longer.sum()))
    seqs[:, 10:10 + K] = E.words_to_bytes(words[rng.integers(
        0, words.size, n)], K)
    log(f"len_cap batch: {n} reads of len_cap {4 * lp}, "
        f"{int(longer.sum())} past 1,000 bases")
    return [torch.from_numpy(x).to("cuda") for x in (
        E.pack_codes_np(seqs), lens, S.barcode_sorted_ids(2032, n, cap),
        (rng.random(n) < 0.02).astype(np.uint8))]


def _one_kernel(fn, what: str, form: str) -> str:
    """The name of the one kernel one call of fn runs; fails unless it is
    the only device work of the call and its name holds `form`."""
    kernels = _kernels_of_one_call(fn, 1)
    if list(kernels.values()) != [1] or form not in next(iter(kernels)):
        fail(f"{what}: one call ran {kernels} on the card, not one "
             f"{form} kernel")
    return next(iter(kernels))


def _launched(name: str, fn):
    """fn's result; fails unless fn called the C entry `name` once."""
    from hast_tpu_torch.ops import _build
    before = _build.LAUNCHES[name]
    got = fn()
    if _build.LAUNCHES[name] != before + 1:
        fail(f"{name}: {_build.LAUNCHES[name] - before} C calls in one "
             "wrapper call")
    return got


def phase_read_votes(tables: dict, words, bwords) -> dict:
    """K3 and K13, which share csrc/reads.cuh: bit-exact against their
    twins on utils/synthetic.py read_tile_edge_batches (k = 15, 17, 21 in
    both table formats and 31 in the full one, every stride of
    READ_EDGE_STRIDES there, the long-row form included; K3 into a tally
    that already holds counts, random and barcode-sorted ids; K13 packed
    and ASCII on the whole table and its 2- and 4-way shards, the shards'
    votes summing to the whole table's), after checking that the
    library's tile geometry is synthetic's; one C call a wrapper call and
    one kernel a call, of the form the stride names; then the device
    times of time_read_votes, and both in the long form against their
    twins on len_cap_batch."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.ops import hashtable as H
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.pipeline import classify as C
    from hast_tpu_torch.utils import synthetic as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(2030)
    if _build.read_tile_geometry() != S.READ_TILE_GEOMETRY:
        fail(f"csrc/reads.cuh's tiles {_build.read_tile_geometry()} are not "
             f"utils/synthetic.py's {S.READ_TILE_GEOMETRY}: the edge batches "
             "miss the tile edges")
    err = {"classify_tally": 0.0, "vote_reads": 0.0}
    calls = 0
    for k in (15, 17, 21, 31):
        for fmt in ("quot", "full") if k < 31 else ("full",):
            kw, hi, lo = random_keys(rng, 5000, k)
            table = H.build_table(hi, lo, rng.integers(1, 4, kw.size).astype(
                np.uint32), k, load=0.7, fmt=fmt).to(dev)
            for lp in S.READ_EDGE_STRIDES:
                batches = S.read_tile_edge_batches(k * lp, k, lp, kw)
                seqs, lens = batches[0][1], batches[0][2]
                lengths = torch.from_numpy(lens).to(dev)
                packed = torch.from_numpy(E.pack_codes_np(seqs)).to(dev)
                for name, _, _, ids, has_n in batches:
                    args = (packed, lengths, torch.from_numpy(ids).to(dev),
                            torch.from_numpy(has_n).to(dev))
                    acc = torch.from_numpy(rng.integers(
                        0, 50, (512, 3)).astype(np.int32)).to(dev)
                    want = C.tally_step_ref(table, acc.clone(), *args)
                    got = _launched("classify_tally", lambda: C.tally_step(
                        table, acc, *args))
                    err["classify_tally"] = max(err["classify_tally"],
                                                _check_same(
                        f"K3 classify_tally k={k} {fmt} lp={lp} {name}",
                        [got], [want]))
                    calls += 1
                forms = ((True, packed),
                         (False, torch.from_numpy(seqs).to(dev)))
                for is_packed, reads in forms:
                    whole = _launched("vote_reads", lambda: C.vote_reads(
                        table, reads, lengths, is_packed))
                    err["vote_reads"] = max(err["vote_reads"], _check_same(
                        f"K13 vote_reads k={k} {fmt} lp={lp} packed="
                        f"{is_packed}", [whole], [C.vote_reads_ref(
                            table, reads, lengths, is_packed)]))
                    calls += 1
                    for tp in (2, 4):
                        rows = table.n_buckets // tp
                        total = torch.zeros_like(whole, dtype=torch.int64)
                        for j in range(tp):
                            part = H.KmerTable(
                                table.data[j * rows:(j + 1) * rows],
                                table.n_buckets, table.max_probe, k, 0, (),
                                table.fmt)
                            got = _launched("vote_reads", lambda: C.vote_reads(
                                part, reads, lengths, is_packed, j * rows))
                            err["vote_reads"] = max(err["vote_reads"],
                                                    _check_same(
                                f"K13 vote_reads k={k} {fmt} lp={lp} shard "
                                f"{j}/{tp}", [got], [C.vote_reads_ref(
                                    part, reads, lengths, is_packed,
                                    j * rows)]))
                            total += got.long() & 0xFFFF
                            calls += 1
                        if not torch.equal(total, whole.long() & 0xFFFF):
                            fail(f"K13 vote_reads k={k} {fmt} lp={lp}: the "
                                 f"{tp} shards' votes do not sum to the "
                                 "whole table's")
    log(f"K3 and K13 on read_tile_edge_batches: {calls} calls bit-exact "
        f"(strides {S.READ_EDGE_STRIDES} bytes, k = 15, 17, 21, 31)")

    # one kernel a call, of the form the stride names
    table = tables["quot"]
    for lp, form in ((28, "false"), (2048, "true")):
        seqs, lens = _vote_reads_input(rng, (words,), 256, 4 * lp)
        packed = torch.from_numpy(E.pack_codes_np(seqs)).to(dev)
        lengths = torch.from_numpy(lens).to(dev)
        ids = torch.zeros(256, dtype=torch.int32, device=dev)
        has_n = torch.zeros(256, dtype=torch.uint8, device=dev)
        acc = torch.zeros((4, 3), dtype=torch.int32, device=dev)
        names = [_one_kernel(lambda: C.tally_step(table, acc, packed, lengths,
                                                  ids, has_n),
                             f"K3 classify_tally lp={lp}",
                             f"classify_tally_kernel<{form}>")]
        for ascii_form, reads in (("false", packed),
                                  ("true", torch.from_numpy(seqs).to(dev))):
            names.append(_one_kernel(
                lambda: C.vote_reads(table, reads, lengths,
                                     ascii_form == "false"),
                f"K13 vote_reads lp={lp}",
                f"vote_reads_kernel<{ascii_form}, {form}"))
        log(f"stride {lp} bytes: one kernel a call: {names}")

    times = time_read_votes(tables, words, bwords)
    acc = torch.zeros((4096, 3), dtype=torch.int32, device=dev)
    args = len_cap_batch(words, acc.shape[0])
    want = C.tally_step_ref(table, acc.clone(), *args)
    err["classify_tally"] = max(err["classify_tally"], _check_same(
        "K3 classify_tally long form, len_cap 8192",
        [C.tally_step(table, acc, *args)], [want]))
    err["vote_reads"] = max(err["vote_reads"], _check_same(
        "K13 vote_reads long form, len_cap 8192",
        [C.vote_reads(table, args[0], args[1], True)],
        [C.vote_reads_ref(table, args[0], args[1], True)]))
    return {
        "classify_tally": dict(
            max_abs_err=err["classify_tally"],
            device_ms=times["classify_tally/quot/random ids"]["device_ms"],
            device_ms_sorted_ids=times[
                "classify_tally/quot/barcode-sorted ids"]["device_ms"],
            device_ms_full=times[
                "classify_tally/full/random ids"]["device_ms"],
            device_ms_2_24=times[
                "classify_tally/big/random ids"]["device_ms"],
            device_ms_2_24_l2_flushed=times[
                "classify_tally/big/random ids"]["device_ms_l2_flushed"],
            device_ms_long_form=times[
                "classify_tally/quot/len_cap 8192"]["device_ms"]),
        "vote_reads": dict(
            max_abs_err=err["vote_reads"],
            device_ms=times["vote_reads/quot/packed"]["device_ms"],
            device_ms_ascii=times["vote_reads/quot/ascii"]["device_ms"],
            device_ms_full=times["vote_reads/full/packed"]["device_ms"],
            device_ms_2_24=times["vote_reads/big/packed"]["device_ms"],
            device_ms_2_24_l2_flushed=times[
                "vote_reads/big/packed"]["device_ms_l2_flushed"],
            device_ms_long_form=times[
                "vote_reads/quot/len_cap 8192"]["device_ms"])}


def phase_kernels_mesh(tables: dict, words, bwords) -> dict:
    """K13-K15 against their twins on the same card tensors."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.ops import hashtable as H
    from hast_tpu_torch.ops import kmer_count as KC
    from hast_tpu_torch.parallel import mesh as PM
    from hast_tpu_torch.pipeline import classify as C
    from hast_tpu_torch.utils import synthetic as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(2027)
    res = {}
    seqs, lens = _vote_reads_input(rng, (words, bwords), N_VOTE_READS)
    # the same reads as ASCII with 1 % random non-ACGT bytes (K13 codes
    # any byte; validity comes from the length alone)
    odd = np.frombuffer(b"acgtNRUnKMSWBDHV", np.uint8)
    ascii_np = np.where(rng.random(seqs.shape) < 0.01,
                        odd[rng.integers(0, odd.size, seqs.shape)], seqs)
    forms = {"packed": (True, torch.from_numpy(E.pack_codes_np(seqs)).to(dev)),
             "ascii": (False, torch.from_numpy(ascii_np).to(dev))}
    lengths = torch.from_numpy(lens).to(dev)
    probed = int((lengths.long() - K + 1).clamp(0, 100 - K + 1).sum())
    err, times = 0.0, {}
    for name in ("quot", "full", "big"):
        table = tables[name]
        for form, (packed, reads) in forms.items():
            got = C.vote_reads(table, reads, lengths, packed)
            want = C.vote_reads_ref(table, reads, lengths, packed)
            err = max(err, _check_same(f"K13 vote_reads {form} ({name})",
                                       [got], [want]))
            if int((got.long() & 0xFFFF).sum()) == 0:
                fail(f"K13 vote_reads {form} ({name}): no votes")
            ms = cuda_ms(lambda: C.vote_reads(table, reads, lengths,
                                              packed), 20)
            plain = cuda_ms(lambda: C.vote_reads_ref(table, reads, lengths,
                                                     packed), 3)
            times[(name, form)] = (ms, plain)
            log(f"K13 vote_reads {form} {name} table {table.n_buckets} rows, "
                f"{N_VOTE_READS} reads, {probed} windows: kernel {ms:.4f} ms,"
                f" twin {plain:.4f} ms, bit-exact")
    # __graft_entry__'s example batch: 256 reads of 128 ASCII bytes, 100 bp
    graft = torch.from_numpy(ascii_np[:256, :112].repeat(2, axis=1)[:, :128]
                             .copy()).to(dev)
    glens = torch.full((256,), 100, dtype=torch.int32, device=dev)
    err = max(err, _check_same(
        "K13 vote_reads on the 256 x 128 batch",
        [C.vote_reads(tables["quot"], graft, glens, False)],
        [C.vote_reads_ref(tables["quot"], graft, glens, False)]))
    # the table split in 2 and in 4: the shards' votes sum to the whole's
    for name in ("quot", "full"):
        table = tables[name]
        for tp in (2, 4):
            rows = table.n_buckets // tp
            for form, (packed, reads) in forms.items():
                whole = C.vote_reads(table, reads, lengths, packed)
                parts = []
                for j in range(tp):
                    part = H.KmerTable(table.data[j * rows:(j + 1) * rows],
                                       table.n_buckets, table.max_probe, K,
                                       0, (), table.fmt)
                    got = C.vote_reads(part, reads, lengths, packed,
                                       row_lo=j * rows)
                    err = max(err, _check_same(
                        f"K13 vote_reads {form} shard {j}/{tp} ({name})",
                        [got], [C.vote_reads_ref(part, reads, lengths,
                                                 packed, row_lo=j * rows)]))
                    parts.append(got.long() & 0xFFFF)
                if not torch.equal(sum(parts), whole.long() & 0xFFFF):
                    fail(f"K13 vote_reads {form}: the {tp} shards' votes do "
                         f"not sum to the whole table's ({name})")
    log("K13 vote_reads: the 256 x 128 batch and the 2- and 4-way table "
        "splits bit-exact; the shards' votes sum to the whole table's")
    ms, plain = times[("quot", "packed")]
    # packed reads and lengths in, two uint16 votes out, two rows a window
    res["vote_reads"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
        **bound("K13", forms["packed"][1].numel() + 4 * N_VOTE_READS
                + 4 * N_VOTE_READS + 32 * probed,
                (WINDOW_OPS + PROBE_OPS[tables["quot"].fmt] + VOTE_OPS)
                * probed))

    # K14 on a 16,384-read batch of 100-bp reads (stride 128, as the
    # python reader pads them), 1 % N and 2 % soft-masked: the batch form
    # (every source shard in one launch, the receive layout written in
    # place) against route_batch_ref; the one-shard form on
    # shard 0 against route_kmers_ref; then, in turns, dp one-shard calls
    # plus the receivers' cat (what sharded_count_chunk did before) and
    # the batch call, on card tensors and from the host arrays
    err = 0.0
    for dp in (4, 8):
        rows = MESH_BATCH // dp
        seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(
            0, 4, (MESH_BATCH, 128))]
        u = rng.random(seqs.shape)
        seqs = np.where(u < 0.01, ord("N"), np.where(u < 0.03, seqs | 0x20,
                                                     seqs)).astype(np.uint8)
        lens = np.full(MESH_BATCH, 100, np.int32)
        seqs[:, 100:] = 0
        seqs_t = torch.from_numpy(seqs).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        cap = rows * (128 - K + 1) // dp * 2
        got, dropped = PM.route_kmers(seqs_t[:rows], lens_t[:rows], K, dp,
                                      cap)
        want, want_dropped = PM.route_kmers_ref(seqs_t[:rows], lens_t[:rows],
                                                K, dp, cap)
        torch.cuda.synchronize()
        if int(dropped) != int(want_dropped) or int(dropped):
            fail(f"K14 route_kmers dp={dp}: dropped {int(dropped)}, twin "
                 f"{int(want_dropped)}")
        err = max(err, _check_same(f"K14 route_kmers dp={dp}",
                                   [got.sort(dim=1).values], [want]))
        want, want_dropped = PM.route_batch_ref(seqs_t, lens_t, K, dp, cap,
                                                dp)
        got, dropped = PM.route_batch(seqs_t, lens_t, K, dp, cap, dp)
        torch.cuda.synchronize()
        if dropped.tolist() != want_dropped.tolist() or int(dropped.sum()):
            fail(f"K14 route_batch dp={dp}: dropped {dropped.tolist()}, "
                 f"twin {want_dropped.tolist()}")
        err = max(err, _check_same(
            f"K14 route_batch dp={dp}",
            [got.reshape(dp, dp, cap).sort(dim=2).values.reshape(dp, -1)],
            [want]))
        # the route kernel, the pads' tail pass and the counters' memset
        dev_ms = device_ms(
            lambda: PM.route_batch(seqs_t, lens_t, K, dp, cap, dp), 20,
            ("route_", "Memset"))
        keys = int((want != KC.SENT).sum())
        shard = [(seqs_t[i * rows:(i + 1) * rows],
                  lens_t[i * rows:(i + 1) * rows]) for i in range(dp)]

        def one_shard_calls():
            bufs = [PM.route_kmers(s, n, K, dp, cap)[0] for s, n in shard]
            return [torch.cat([buf[d] for buf in bufs]) for d in range(dp)]

        def host_one_shard_calls():
            bufs = [PM.route_kmers(torch.from_numpy(seqs[i * rows:(i + 1)
                                                         * rows]).to(dev),
                                   torch.from_numpy(lens[i * rows:(i + 1)
                                                         * rows]).to(dev),
                                   K, dp, cap)[0] for i in range(dp)]
            return [torch.cat([buf[d] for buf in bufs]) for d in range(dp)]

        def host_batch_call():
            every = list(range(dp))
            return PM.route_batch(
                PM._rows_on(torch.from_numpy(seqs), every, rows, dev),
                PM._rows_on(torch.from_numpy(lens), every, rows, dev), K, dp,
                cap, dp)

        calls = {"batch": lambda: PM.route_batch(seqs_t, lens_t, K, dp, cap,
                                                 dp),
                 "one-shard": one_shard_calls,
                 "host batch": host_batch_call,
                 "host one-shard": host_one_shard_calls}
        times = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                times[name].append(cuda_ms(calls[name], 20))
        ms = {name: float(np.mean(t)) for name, t in times.items()}
        old_dev = device_ms(one_shard_calls, 20,
                            ("route_", "Memset", "CatArray"))
        plain = cuda_ms(lambda: PM.route_batch_ref(seqs_t, lens_t, K, dp,
                                                   cap, dp), 3)
        log(f"K14 route_kmers dp={dp}: {MESH_BATCH} reads, {keys} keys into "
            f"{dp} x {dp * cap}: batch call {ms['batch']:.4f} ms on card "
            f"tensors ({dev_ms:.4f} ms on the device), "
            f"{dp} one-shard calls + the receivers' cat "
            f"{ms['one-shard']:.4f} ms ({old_dev:.4f} ms on the device); "
            f"from the host arrays: pinned copy + batch call "
            f"{ms['host batch']:.4f} ms, {dp} sliced copies + one-shard "
            f"calls + cat {ms['host one-shard']:.4f} ms (each mean of two "
            f"rounds in turns: {times}); twin {plain:.4f} ms; segments "
            "equal once sorted, no drop; the one-shard form on shard 0 "
            "equal too")
        if dp == 4:
            # the batch's reads and lengths in, the receive layout out
            res["route_kmers"] = dict(
                ms=ms["batch"], plain_ms=plain, library_ms=None,
                **bound("K14", seqs.size + 4 * MESH_BATCH + 8 * dp * dp * cap,
                        (WINDOW_OPS + ROUTE_OPS) * MESH_BATCH * (128 - K + 1)))
    # 64 identical reads of one key: every key routes to one shard
    skew = torch.full((64, 128), ord("A"), dtype=torch.uint8, device=dev)
    skew_lens = torch.full((64,), 128, dtype=torch.int32, device=dev)
    cap = 8 * (128 - K + 1) // 8 * 2
    got, dropped = PM.route_kmers(skew[:8], skew_lens[:8], K, 8, cap)
    want, want_dropped = PM.route_kmers_ref(skew[:8], skew_lens[:8], K, 8,
                                            cap)
    if int(dropped) != int(want_dropped) or not int(dropped):
        fail(f"K14 route_kmers skewed batch: dropped {int(dropped)}, twin "
             f"{int(want_dropped)}")
    got, lost = PM.route_batch(skew, skew_lens, K, 8, cap, 8)
    want, want_lost = PM.route_batch_ref(skew, skew_lens, K, 8, cap, 8)
    if lost.tolist() != want_lost.tolist() or not int(lost.sum()):
        fail(f"K14 route_batch skewed batch: dropped {lost.tolist()}, twin "
             f"{want_lost.tolist()}")
    log(f"K14 route_kmers: 64 identical reads of one key, dp 8, slack 2: "
        f"{int(dropped)} keys dropped by one shard, {lost.tolist()} by the "
        "batch's shards, as the twins")
    res["route_kmers"]["max_abs_err"] = err

    # K15: 65,536 reads' votes into 10^5 barcodes, ids -1 and past the
    # end: random ids, then stLFR's barcode runs of 20-60 reads
    n, nb = N_VOTE_READS, N_TALLY_BARCODES
    votes = torch.from_numpy(rng.integers(0, 50, (n, 2)).astype(
        np.int32)).to(dev)
    has_n = torch.from_numpy(rng.random(n) < 0.02).to(dev)
    ids_np = rng.integers(0, nb, n).astype(np.int32)
    ids_np[rng.integers(0, n, 256)] = -1
    ids_np[rng.integers(0, n, 256)] = nb + 7
    err = 0.0
    for order, ids_np in (("random", ids_np),
                          ("barcode-sorted",
                           S.barcode_sorted_ids(2027, n, nb))):
        ids = torch.from_numpy(ids_np).to(dev)
        want = C.tally_votes_ref(votes, has_n, ids, nb)
        err = max(err, _check_same(f"K15 tally_votes {order}",
                                   [C.tally_votes(votes, has_n, ids, nb)],
                                   [want]))
        # out=: two halves added into one tally over two calls
        acc = torch.zeros((nb, 3), dtype=torch.int32, device=dev)
        for s in (slice(0, n // 2), slice(n // 2, n)):
            C.tally_votes(votes[s], has_n[s], ids[s], nb, out=acc)
        err = max(err, _check_same(f"K15 tally_votes {order} out=", [acc],
                                   [want]))
        ms = cuda_ms(lambda: C.tally_votes(votes, has_n, ids, nb), 20)
        out_ms = cuda_ms(lambda: C.tally_votes(votes, has_n, ids, nb,
                                               out=acc), 20)
        dev_ms = device_ms(lambda: C.tally_votes(votes, has_n, ids, nb,
                                                 out=acc), 20,
                           "tally_votes_kernel")
        plain = cuda_ms(lambda: C.tally_votes_ref(votes, has_n, ids, nb), 5)
        keep = (ids >= 0) & (ids < nb)
        v0 = torch.where(has_n, 0, votes[:, 0])
        v1 = torch.where(has_n, 0, votes[:, 1])
        upd = torch.stack([v0, v1, ((v0 == 0) & (v1 == 0) | has_n).int()],
                          -1)[keep].int()
        ids64 = ids[keep].long()
        lib = cuda_ms(lambda: acc.index_add_(0, ids64, upd), 20)
        lib_dev = device_ms(lambda: acc.index_add_(0, ids64, upd), 20,
                            "index")
        # the leaders' atomics: one a (warp, barcode) group and column
        groups = int(torch.unique(
            ids64 + (torch.nonzero(keep).reshape(-1) // 32)
            * (nb + 1)).numel())
        log(f"K15 tally_votes {order} ids, {n} reads into {nb} barcodes "
            f"({int(keep.sum())} kept reads in {groups} (warp, barcode) "
            "groups): call "
            f"{ms:.4f} ms with a fresh tally, {out_ms:.4f} ms into a given "
            f"one ({dev_ms:.4f} ms of it on the device), twin {plain:.4f} "
            f"ms, index_add_ of the prepared rows {lib:.4f} ms "
            f"({lib_dev:.4f} ms on the device), bit-exact")
        if order == "random":
            # the main path (sharded_classify_step) adds into a given tally
            res["tally_votes"] = dict(ms=out_ms, plain_ms=plain,
                                      library_ms=lib,
                                      **bound("K15", 13 * n + 12 * nb,
                                              READ_OPS * n))
    res["tally_votes"]["max_abs_err"] = err
    return res


def phase_launch_path() -> dict:
    """K10 and K12 against their library calls, in turns (kernel,
    library, library, kernel; 200 calls each) at phase 2's and 3's
    shapes.  Returns the kernels line's call and library times of K10 and
    K12 from the turns (steadier than phases 2 and 3's 20 calls)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from hast_tpu_torch.ops import kmer_count as KC
    from hast_tpu_torch.pipeline import classify as C

    dev = torch.device("cuda")
    rng = np.random.default_rng(2031)
    acc = torch.from_numpy(rng.integers(0, 200, (1 << 19, 3)).astype(
        np.int32)).to(dev)
    grow = acc.shape[0]
    m = 1 << 22
    keys = torch.full((2 * m,), KC.SENT, device=dev)
    keys[:m] = torch.sort(_hash_keys(torch.arange(m, device=dev))).values
    counts = torch.ones(2 * m, dtype=torch.int32, device=dev)
    pairs = {
        "grow_tally": ("K10 grow_tally vs F.pad",
                       lambda: C.grow_tally(acc, grow),
                       lambda: F.pad(acc, (0, 0, 0, grow))),
        "shrink_run": ("K12 shrink_run vs narrow().clone()",
                       lambda: KC.shrink_run(keys, counts, m),
                       lambda: (keys.narrow(0, 0, m).clone(),
                                counts.narrow(0, 0, m).clone()))}
    res = {}
    for key, (name, kernel, library) in pairs.items():
        times = {"kernel": [], "library": []}
        for mode in ("kernel", "library", "library", "kernel"):
            times[mode].append(cuda_ms(kernel if mode == "kernel"
                                       else library, 200))
        res[key] = dict(ms=float(np.mean(times["kernel"])),
                        library_ms=float(np.mean(times["library"])))
        log(f"launch path: {name}: {np.mean(times['kernel']):.4f} ms "
            f"against {np.mean(times['library']):.4f} ms a call (in turns: "
            f"{times['kernel'][0]:.4f}, {times['library'][0]:.4f}, "
            f"{times['library'][1]:.4f}, {times['kernel'][1]:.4f})")
    return res


def phase_classify_step(tables: dict, words) -> int:
    """sharded_classify_step on meshes of cuda:0 against K3's tally of the
    same reads; returns K15's launches in the steps."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.parallel import mesh as PM
    from hast_tpu_torch.pipeline import classify as C

    dev = torch.device("cuda")
    rng = np.random.default_rng(2028)
    b, nb = 32768, 4096
    seqs, lens = _vote_reads_input(rng, (words,), b)
    ids = rng.integers(0, nb, b).astype(np.int32)
    ids[rng.integers(0, b, 256)] = -1
    has_n = rng.random(b) < 0.02
    k3_args = [torch.from_numpy(x).to(dev) for x in
               (E.pack_codes_np(seqs), lens, ids, has_n)]
    launches = 0
    for name in ("quot", "full"):
        table = tables[name]
        for dp, tp in ((4, 1), (2, 2)):
            mesh = PM.make_mesh(dp * tp, tp=tp, devices=[dev] * (dp * tp))
            shards = PM.shard_table(mesh, table)
            _build.LAUNCHES.clear()
            _build.TWIN_CALLS.clear()
            got = PM.sharded_classify_step(mesh, shards, seqs, lens, ids,
                                           has_n, K, table.max_probe,
                                           table.n_buckets, nb, table.fmt)
            torch.cuda.synchronize()
            counts, twins = dict(_build.LAUNCHES), dict(_build.TWIN_CALLS)
            launches += counts.get("tally_votes", 0)
            if counts.get("vote_reads", 0) != dp * tp or \
                    counts.get("tally_votes", 0) != dp or any(twins.values()):
                fail(f"sharded_classify_step {dp}x{tp}: launches {counts}, "
                     f"twins {twins}")
            want = C.tally_step(table, torch.zeros((nb, 3), dtype=torch.int32,
                                                   device=dev), *k3_args)
            if not torch.equal(got, want) or int(want[:, :2].sum()) == 0:
                fail(f"sharded_classify_step {dp}x{tp} ({name}) differs from "
                     "K3's tally")
            log(f"sharded_classify_step {dp}x{tp} on cuda:0 ({name} table, "
                f"{b} reads): equal to K3's tally; launches {counts}")
    return launches


def _int32_bits(words):
    """The low 32 bits of int64 words as int32 tensors of the same bits."""
    import torch
    return (((words & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _panel_queries(rng, panels):
    """The canonical windows of N_PANEL_READS random 100-bp reads with one
    key of each panel planted in each read (panel s in bases [50 s,
    50 s + 50)): int64 words and (hi, lo) int32 card tensors."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import encode as E
    n = N_PANEL_READS
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 112))]
    for s, ks in enumerate(panels):
        pos = rng.integers(s * 50, s * 50 + 50 - K, n)
        kmers = E.words_to_bytes(ks[rng.integers(0, ks.size, n)], K)
        seqs[np.arange(n)[:, None], pos[:, None] + np.arange(K)] = kmers
    dev = torch.device("cuda")
    packed = torch.from_numpy(E.pack_codes_np(seqs)).to(dev)
    lengths = torch.full((n,), 100, dtype=torch.int32, device=dev)
    keys, valid = E.canonical_windows(packed, lengths, K)
    words = keys[valid].contiguous()
    return words, _int32_bits(words >> 32).contiguous(), \
        _int32_bits(words).contiguous()


def phase_broadcast() -> tuple[dict, int]:
    """K16 broadcast_probe: the port's entry point on two panels (the main
    path, counted), then against its twin, bit-exact, against K2's
    payloads on the same keys, and on the edge cases of the JAX padding;
    last, K16 and K2 on small raw panels, for their crossover."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.ops import broadcast_probe as BP
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.ops import hashtable as H
    from hast_tpu_torch.pipeline import classify as C

    dev = torch.device("cuda")
    rng = np.random.default_rng(2029)
    # the stLFR adaptor panel: the 21-mers of both adaptors (F payload 1,
    # R payload 2, a key of both ORs to 3)
    his, los, pays = [], [], []
    for bit, adaptor in ((1, C.ADAPTOR_F), (2, C.ADAPTOR_R)):
        codes = E.encode_np(np.frombuffer(adaptor.encode(), np.uint8))
        hi, lo = E.canonical_kmers_np(codes[None, :], K)
        his.append(hi[0])
        los.append(lo[0])
        pays.append(np.full(hi.shape[1], bit, np.uint32))
    a_hi, a_lo = np.concatenate(his), np.concatenate(los)
    a_words = (a_hi.astype(np.int64) << 32) | a_lo.astype(np.int64)
    # a targeted-region panel: 10^4 distinct canonical markers, payloads 1-3
    hi, lo = E.canonical_kmers_np(rng.integers(
        0, 4, (TARGET_PANEL + TARGET_PANEL // 64, K), dtype=np.int32), K)
    t_words = np.unique((hi[:, 0].astype(np.int64) << 32) | lo[:, 0])
    t_words = rng.permutation(t_words)[:TARGET_PANEL]
    t_hi = (t_words >> 32).astype(np.uint32)
    t_lo = (t_words & 0xFFFFFFFF).astype(np.uint32)
    panels = {
        "adaptor": H.build_table(a_hi, a_lo, np.concatenate(pays), K,
                                 fmt="full").to(dev),
        "target": H.build_table(t_hi, t_lo, rng.integers(
            1, 4, t_words.size).astype(np.uint32), K, fmt="full").to(dev)}
    words, q_hi, q_lo = _panel_queries(rng, (np.unique(a_words), t_words))
    arrays = {name: BP.table_key_arrays(t) for name, t in panels.items()}

    _build.LAUNCHES.clear()
    _build.TWIN_CALLS.clear()
    outs = {name: BP.broadcast_probe(thi, tlo, q_hi, q_lo)
            for name, (thi, tlo) in arrays.items()}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    twins = dict(_build.TWIN_CALLS)
    if launches.get("broadcast_probe", 0) != len(panels) or any(
            twins.values()):
        fail(f"broadcast_probe main path: launches {launches}, twins "
             f"{twins}")
    slots = {name: a[0].numel() for name, a in arrays.items()}
    log(f"broadcast_probe main path: {words.numel()} canonical windows of "
        f"{N_PANEL_READS} reads against the adaptor ({slots['adaptor']} "
        f"slots) and target ({slots['target']} slots) panels; launches "
        f"{launches}, twin calls {twins}")

    err, res = 0.0, {}
    for name, (thi, tlo) in arrays.items():
        got = outs[name]
        # the twin once over every query: its time and the check
        want, plain = cuda_ms_once(lambda: BP.broadcast_probe_ref(
            thi, tlo, q_hi, q_lo))
        err = max(err, _check_same(
            f"K16 broadcast_probe ({name} panel, {words.numel()} queries)",
            [got], [want]))
        k2 = H.probe(panels[name], words)
        torch.cuda.synchronize()
        if not torch.equal(got, k2):
            fail(f"K16 broadcast_probe != K2 probe payloads ({name} panel)")
        if int((got > 0).sum()) < N_PANEL_READS:
            fail(f"K16 broadcast_probe found fewer hits than planted keys "
                 f"({name} panel)")
        ms = cuda_ms(lambda: BP.broadcast_probe(thi, tlo, q_hi, q_lo), 10)
        k2_ms = cuda_ms(lambda: H.probe(panels[name], words), 20)
        log(f"K16 broadcast_probe {name} panel ({thi.numel()} slots), "
            f"{words.numel()} queries: kernel {ms:.4f} ms, twin {plain:.4f} "
            f"ms (one call, every query), K2 probe of the same keys on the "
            f"same table {k2_ms:.4f} ms; bit-exact, payloads equal to K2's, "
            f"{int((got > 0).sum())} hits")
        # tables and queries read once, payloads written once; every
        # (query, slot) pair compared
        res[name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                         **bound(f"K16 {name}", 8 * thi.numel()
                                 + 12 * words.numel(),
                                 BROADCAST_OPS * words.numel() * thi.numel()))

    # the crossover with K2: raw panels of the first s target keys (no
    # EMPTY slot) against K2 on the smallest full table that holds them
    t_pay = rng.integers(1, 4, t_words.size).astype(np.uint32)
    for s in CROSSOVER_SLOTS:
        s_hi = torch.from_numpy((t_hi[:s] | (t_pay[:s] << 30)).view(
            np.int32)).to(dev)
        s_lo = torch.from_numpy(t_lo[:s].view(np.int32)).to(dev)
        table = H.build_table(t_hi[:s], t_lo[:s], t_pay[:s], K,
                              fmt="full").to(dev)
        got = BP.broadcast_probe(s_hi, s_lo, q_hi, q_lo)
        if not torch.equal(got, H.probe(table, words)):
            fail(f"K16 broadcast_probe != K2 probe payloads ({s} keys)")
        ms = cuda_ms(lambda: BP.broadcast_probe(s_hi, s_lo, q_hi, q_lo), 20)
        k2_ms = cuda_ms(lambda: H.probe(table, words), 20)
        log(f"K16 vs K2, {words.numel()} queries: {s} raw slots "
            f"{ms:.4f} ms; K2 on the {s} keys' full table "
            f"({BP.table_key_arrays(table)[0].numel()} slots) {k2_ms:.4f} "
            f"ms; payloads equal")

    # the JAX padding: a length that is a multiple of neither chunk, the pad
    # key (0x3FFFFFFF, 0xFFFFFFFF) at the end of the queries
    thi, tlo = arrays["target"]
    eq_hi = torch.cat([q_hi[:1 << 16], torch.tensor(
        [0x3FFFFFFF], dtype=torch.int32, device=dev)])
    eq_lo = torch.cat([q_lo[:1 << 16], torch.tensor(
        [-1], dtype=torch.int32, device=dev)])
    for chunk in (2048, 512):
        n = 30001
        got = BP.broadcast_probe(thi[:n], tlo[:n], eq_hi, eq_lo, chunk)
        err = max(err, _check_same(
            f"K16 broadcast_probe n={n} chunk={chunk}", [got],
            [BP.broadcast_probe_ref(thi[:n], tlo[:n], eq_hi, eq_lo, chunk)]))
        if int(got[-1]) != 3:
            fail(f"K16 broadcast_probe: the pad key got {int(got[-1])} at "
                 f"n={n}, chunk={chunk}")
    # duplicate keys with two payloads: the larger, not the OR
    p1, p2 = rng.integers(0, 4, (2, TARGET_PANEL)).astype(np.uint32)
    order = rng.permutation(2 * TARGET_PANEL)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
            dev)
    d_hi = card(np.concatenate([t_hi | (p1 << 30), t_hi | (p2 << 30)])[order])
    d_lo = card(np.concatenate([t_lo, t_lo])[order])
    k_hi, k_lo = card(t_hi), card(t_lo)
    got = BP.broadcast_probe(d_hi, d_lo, k_hi, k_lo)
    err = max(err, _check_same("K16 broadcast_probe duplicate keys", [got], [
        BP.broadcast_probe_ref(d_hi, d_lo, k_hi, k_lo)]))
    if not torch.equal(got, card(np.maximum(p1, p2))):
        fail("K16 broadcast_probe: duplicate keys do not take the larger "
             "payload")
    # no pad and no EMPTY slot: the pad key gets 0; the full table's own
    # EMPTY slots give it 3
    pad_q = (eq_hi[-1:], eq_lo[-1:])
    got = [BP.broadcast_probe(d_hi[:1024].contiguous(),
                              d_lo[:1024].contiguous(), *pad_q, chunk=1024),
           BP.broadcast_probe(thi, tlo, *pad_q)]
    if [int(g) for g in got] != [0, 3]:
        fail(f"K16 broadcast_probe: the pad key got {got} (want 0 with no "
             "EMPTY slot, 3 on the full table)")
    log("K16 broadcast_probe: ragged lengths at chunk 2048 and 512, "
        "duplicate keys (the larger payload) and the pad key bit-exact")
    row = res["target"]
    row["max_abs_err"] = err
    return row, launches["broadcast_probe"]


def _host_fold_seconds(call) -> tuple:
    """call() under a CPU-side torch.profiler session: its wall seconds
    and the seconds of its ``classify.host_fold`` spans."""
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        call()
        wall = time.perf_counter() - t0
    fold = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.name == "classify.host_fold") / 1e6
    return wall, fold


def phase_mesh_classify(tmp: str) -> int:
    """Phase 5's workload through run_classify on meshes of cuda:0 (and of
    distinct cards when there are two or more); returns K13's launches
    of the 4x1 run."""
    import io
    import torch
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.parallel import mesh as PM
    from hast_tpu_torch.pipeline import classify as C

    d = os.path.join(tmp, "bench")
    hap0, hap1 = os.path.join(d, "paternal.mer"), os.path.join(d, "maternal.mer")
    reads = [os.path.join(d, "son.fq")]
    with open(os.path.join(d, "01.classify", "phased.barcodes"), "rb") as f:
        single = f.read()
    cuda0 = torch.device("cuda", 0)
    meshes = [("4x1 on cuda:0", PM.make_mesh(4, devices=[cuda0] * 4)),
              ("2x2 on cuda:0", PM.make_mesh(4, tp=2, devices=[cuda0] * 4))]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = [torch.device("cuda", i % n_cards) for i in range(4)]
        meshes.append((f"4x1 on {n_cards} cards", PM.make_mesh(
            4, devices=cards)))
    else:
        log("one card: every mesh shard ran on cuda:0 (the launch guard "
            "of ops/_build.py launch is not exercised across cards)")
    k13 = None
    with open(os.devnull, "w") as devnull:
        for name, mesh in meshes:
            _build.LAUNCHES.clear()
            _build.TWIN_CALLS.clear()
            out = io.BytesIO()
            with contextlib.redirect_stderr(devnull):
                wall, fold = _host_fold_seconds(
                    lambda: C.run_classify(hap0, hap1, reads, out, w0=1.04,
                                           batch_size=1 << 15, mesh=mesh))
            counts, twins = dict(_build.LAUNCHES), dict(_build.TWIN_CALLS)
            if k13 is None:
                k13 = counts.get("vote_reads", 0)
            if out.getvalue() != single:
                fail(f"mesh classify {name}: phased.barcodes differs from "
                     "the single-device output")
            if counts.get("vote_reads", 0) <= 0 or any(twins.values()):
                fail(f"mesh classify {name}: launches {counts}, twins "
                     f"{twins}")
            log(f"mesh classify {name}: {N_READS} reads, phased.barcodes "
                f"byte-identical to the single-device run; run_classify "
                f"{wall:.3f} s under a CPU profiler session, host fold "
                f"{fold:.3f} s ({fold / wall:.4f} of it); launches {counts}")
    return k13


def phase_mesh_markers(tmp: str, reads: dict) -> int:
    """Phase 6's trio through build_unshared_markers_mesh on 4 shards of
    cuda:0, then a skewed batch through count_files_mesh_device; returns
    K14's launches of the trio run."""
    import io
    import numpy as np
    import torch
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.parallel import distributed as D
    from hast_tpu_torch.parallel import mesh as PM
    from hast_tpu_torch.pipeline import markers as M

    d = os.path.join(tmp, "stage00")
    single, out = os.path.join(d, "00"), os.path.join(d, "00mesh")
    os.makedirs(out)
    mesh = PM.make_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    batches = [0]
    count_chunk = PM.sharded_count_chunk

    def counted(*args, **kwargs):
        batches[0] += 1
        return count_chunk(*args, **kwargs)

    _build.LAUNCHES.clear()
    _build.TWIN_CALLS.clear()
    PM.sharded_count_chunk = counted
    try:
        t0 = time.perf_counter()
        with open(os.devnull, "w") as devnull:
            D.build_unshared_markers_mesh(mesh, [reads["paternal"]],
                                          [reads["maternal"]], out,
                                          auto_bounds=True,
                                          batch_size=MESH_BATCH, log=devnull)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        PM.sharded_count_chunk = count_chunk
    counts, twins = dict(_build.LAUNCHES), dict(_build.TWIN_CALLS)
    for name in ("route_kmers", *STAGE00_KERNELS):
        if name != "count_windows" and counts.get(name, 0) <= 0:
            fail(f"mesh build-markers launched no {name} kernel: {counts}")
    if counts["route_kmers"] != batches[0]:
        fail(f"mesh build-markers: {counts['route_kmers']} K14 launches for "
             f"{batches[0]} batches (one a batch)")
    if any(twins.values()):
        fail(f"mesh build-markers called twins: {twins}")
    for parent in ("paternal", "maternal"):
        for f in (f"{parent}.kmercount.histo", f"{parent}.bounds.txt",
                  f"{parent}.unique.filter.mer"):
            if not _same_bytes(os.path.join(out, f), os.path.join(single, f)):
                fail(f"mesh build-markers: {f} differs from the device "
                     "engine's")
    log(f"mesh build-markers (4 shards on cuda:0, {MESH_BATCH}-read "
        f"batches): {wall:.3f} s; histos, bounds and markers byte-identical "
        f"to phase 6's; {batches[0]} batches, one K14 launch each; "
        f"launches {counts}")

    skew = os.path.join(d, "skew.fa")
    with open(skew, "wb") as f:
        f.write(b"".join(b">r%d\n%s\n" % (i, b"A" * 128) for i in range(64)))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        t = D.count_files_mesh_device(PM.make_mesh(
            8, devices=[torch.device("cuda", 0)] * 8), [skew], K,
            batch_size=64)
    want = M.count_files([skew], K, batch_size=64, device="cuda")
    host = t.fetch()
    if "retrying batch with slack=8" not in err.getvalue() or not (
            np.array_equal(host.words, want.words)
            and np.array_equal(host.counts, want.counts)):
        fail(f"mesh count of a skewed batch: {err.getvalue()!r}, "
             f"{host.counts} vs {want.counts}")
    log("mesh count of 64 identical reads of one key: all_to_all overflow, "
        "retried at slack 4 and 8, table equal to the single-device count")
    return counts.get("route_kmers", 0)


def phase_mesh_goldens(tmp: str) -> None:
    """The stage-01 golden through the CLI's mesh, multi-process and merge
    paths on the card."""
    import socket
    from hast_tpu_torch import cli
    d = os.path.join(tmp, "golden_mesh")
    os.makedirs(d)
    for f in ("hap0.mer", "hap1.mer", "reads1.fq.gz", "reads2.fq"):
        shutil.copy(os.path.join(GOLD, f), d)
    hap = ["--hap0", os.path.join(d, "hap0.mer"),
           "--hap1", os.path.join(d, "hap1.mer")]
    reads = [os.path.join(d, "reads1.fq.gz"), os.path.join(d, "reads2.fq")]
    with open(os.path.join(GOLD, "phased.barcodes.golden"), "rb") as f:
        golden = f.read()

    def same(path: str, what: str) -> None:
        with open(path, "rb") as f:
            if f.read() != golden:
                fail(f"{what} differs from phased.barcodes.golden")

    out = os.path.join(d, "mesh11.out")
    cli.main(["classify", *hap, "--read", reads[0], "--read", reads[1],
              "--weight0", "1.04", "--output", out, "--mesh", "1x1",
              "--device", "cuda"])
    same(out, "classify --mesh 1x1 --device cuda")
    wd = os.path.join(d, "wd")
    os.makedirs(wd)
    cli.main(["classify-reads", "--paternal_mer", hap[1], "--maternal_mer",
              hap[3], "--filial", f"{reads[0]} {reads[1]}", "--workdir", wd,
              "--mesh", "auto", "--device", "cuda"])
    same(os.path.join(wd, "phased.barcodes"),
         "classify-reads --mesh auto --device cuda")

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = os.path.join(d, "two.out")
    argv = [sys.executable, "-m", "hast_tpu_torch", "classify", *hap,
            "--read", reads[0], "--read", reads[1], "--weight0", "1.04",
            "--output", out, "--device", "cuda"]
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, HAST_NUM_PROCESSES="2",
                   HAST_PROCESS_ID=str(rank),
                   HAST_COORDINATOR=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            fail(f"two-process classify: a process exited {p.returncode}:\n"
                 f"{text.decode(errors='replace')[-3000:]}")
    same(out, "two-process classify on one card (HAST_NUM_PROCESSES=2)")
    wall = time.perf_counter() - t0

    shards = []
    for i, r in enumerate(reads):
        shards.append(os.path.join(d, f"shard{i}.out"))
        cli.main(["classify", *hap, "--read", r, "--weight0", "1.04",
                  "--output", shards[-1], "--device", "cuda"])
    merged = subprocess.run(
        [sys.executable, "-m", "hast_tpu_torch", "merge-results", "--input",
         shards[0], "--input", shards[1], *hap, "--weight0", "1.04"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, timeout=300)
    if merged.returncode != 0 or merged.stdout != golden:
        fail(f"merge-results of two shard outputs differs from the golden: "
             f"{merged.stderr.decode(errors='replace')[-2000:]}")
    log(f"golden mesh: classify --mesh 1x1, classify-reads --mesh auto, "
        f"two processes of classify on one card ({wall:.3f} s) and "
        "merge-results of two shards: byte-identical on cuda")


def _cli_bytes(argv, stdin_path: str | None = None) -> tuple[bytes, str]:
    """One CLI subcommand in this process: its stdout bytes (the CLI
    writes through sys.stdout.buffer) and its stderr text."""
    import io
    from hast_tpu_torch import cli
    out = io.TextIOWrapper(io.BytesIO(), newline="", write_through=True)
    err = io.StringIO()
    with open(stdin_path or os.devnull) as stdin, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        saved, sys.stdin = sys.stdin, stdin
        try:
            cli.main(argv)
        finally:
            sys.stdin = saved
    return out.buffer.getvalue(), err.getvalue()


def phase_entry_points(tmp: str) -> None:
    """warmup --device cuda at its default shapes, in this process, so the
    launch counters show its kernels; then each tool subcommand against its
    committed golden, byte for byte (tier-1 holds the same tools to the
    JAX package and the reference programs)."""
    from hast_tpu_torch import cli
    from hast_tpu_torch.ops import _build

    _build.LAUNCHES.clear()
    _build.TWIN_CALLS.clear()
    t0 = time.perf_counter()
    cli.main(["warmup", "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches, twins = dict(_build.LAUNCHES), dict(_build.TWIN_CALLS)
    log(f"warmup --device cuda (2x2,000,000 synthetic markers, 131,072 "
        f"reads): {wall:.3f} s wall; launches {launches}; twin calls {twins}")
    # 97 barcodes never grow the tally: K10 is not warmup's (phase 5's)
    for name in ("classify_tally", "pack_tally", *STAGE00_KERNELS):
        if launches.get(name, 0) <= 0:
            fail(f"warmup launched no {name} kernel")
    if any(twins.values()):
        fail(f"warmup called twins: {twins}")

    g = os.path.join(ROOT, "tests", "golden")
    vcf, ha, fq = (os.path.join(g, "vcfqc"), os.path.join(g, "heatalign"),
                   os.path.join(g, "fastq_tools"))
    v = {n: os.path.join(vcf, f"{n}.vcf")
         for n in ("child", "father", "mother", "hap1", "hap2")}
    trio = [v["father"], v["mother"], v["child"]]
    aligns = ["-i", os.path.join(ha, "H1.align.txt"),
              "-i", os.path.join(ha, "H2.align.txt"),
              "-g", os.path.join(ha, "genes.txt")]
    reads = os.path.join(GOLD, "reads2.fq")
    keep = os.path.join(fq, "keep40.barcodes")
    cases = [(["vcf-snp-only", v["child"]], "vcfqc/snponly.out"),
             (["vcf-snp-info", v["child"]], "vcfqc/snpinfo.out"),
             (["vcf-phased-snp", v["child"]], "vcfqc/phasedsnp.out"),
             (["vcf-dipcall-hapsnp", v["child"]], "vcfqc/dipcall.out"),
             (["vcf-merge-hap-snp", v["hap1"], v["hap2"]],
              "vcfqc/mergehap.out"),
             (["vcf-hap-inherit", v["father"], v["child"]],
              "vcfqc/hapinherit.out"),
             (["vcf-inherit-3aa", *trio], "vcfqc/inherit3aa.out"),
             (["vcf-inherit-solid", *trio], "vcfqc/solidsnp.out"),
             (["vcf-phase-inherit-solid", *trio], "vcfqc/phasesolid.out"),
             (["draw-heatalign", "1100000", *aligns, "--preset", "KIR"],
              "heatalign/kir.svg.golden"),
             (["draw-heatalign", "1100000", *aligns, "--preset", "MHC"],
              "heatalign/mhc.svg.golden"),
             (["get-n"], "heatalign/getn.out.golden"),
             (["check-genes", os.path.join(ha, "H1.align.txt"),
               os.path.join(ha, "cg.genes.txt")],
              "heatalign/checkgenes.out.golden"),
             (["mark-library", reads, "2"],
              "fastq_tools/reads2.lib2.fq.golden"),
             (["filter-fastq-by-barcodes", reads, keep],
              "fastq_tools/reads2.keep40.fq.golden")]
    cwd = os.getcwd()
    os.chdir(tmp)       # filter_reads.log appends to the working directory
    try:
        for argv, golden in cases:
            got = _cli_bytes(argv, os.path.join(ha, "n.fa")
                             if argv[0] == "get-n" else None)[0]
            with open(os.path.join(g, golden), "rb") as f:
                want = f.read()
            if golden.endswith(".svg.golden"):
                # a query is named by its align file's path, and the golden
                # holds the directory it was made in
                made = re.search(rb">([^<>]*)H1</text>", want).group(1)
                got = got.replace(ha.encode() + b"/", made)
            if got != want:
                fail(f"{argv[0]}: stdout differs from {golden}")
        with open("filter_reads.log", "rb") as f, open(os.path.join(
                fq, "filter_reads.log.golden"), "rb") as g_log:
            if f.read() != g_log.read():
                fail("filter-fastq-by-barcodes: filter_reads.log differs "
                     "from its golden")
    finally:
        os.chdir(cwd)
    err = _cli_bytes(["vcf-calc-hd", os.path.join(vcf, "phasedsnp.out"),
                      os.path.join(vcf, "mergehap.out")])[1]
    with open(os.path.join(vcf, "calchd.out.err")) as f:
        want = [x for x in f.read().splitlines() if x.startswith(" total")]
    if [x for x in err.splitlines() if x.startswith(" total")] != want:
        fail("vcf-calc-hd: its ' total' lines differ from calchd.out.err")

    bounds = os.path.join(tmp, "bounds")
    os.makedirs(bounds)
    for parent in ("maternal", "paternal"):
        shutil.copy(os.path.join(GOLD00, f"{parent}.histo"),
                    os.path.join(bounds, f"{parent}.kmercount.histo"))
        shutil.copy(os.path.join(GOLD00, f"{parent}.bounds.txt"), bounds)
    said = _cli_bytes(["plot-bounds", "--workdir", bounds])[0].decode()
    log(f"tools through the CLI: {len(cases)} outputs and vcf-calc-hd's "
        f"totals byte-identical to their goldens; plot-bounds: "
        f"{said.strip()}")


def phase_across_cards(tmp: str) -> None:
    """The paths that cross cards, on every visible card (two or more):
    the stage-01 golden with --device cuda:N for each N and on a mesh of
    all of them; the stage-00 goldens on a mesh of all of them; phase 5's
    workload on cuda:0 alone and on the meshes (dp = cards, and 2 x
    cards/2 when even), equal bytes; phase 6's trio through the device
    engine on cuda:0 and a mesh of every card, equal files."""
    import io
    import torch
    from hast_tpu_torch import cli
    from hast_tpu_torch.ops import _build
    from hast_tpu_torch.parallel import mesh as PM
    from hast_tpu_torch.pipeline import classify as C
    from hast_tpu_torch.pipeline import markers as M
    from hast_tpu_torch.utils import synthetic as S

    n = torch.cuda.device_count()
    if n < 2:
        fail(f"--across-cards needs two or more cards, {n} visible")
    d = os.path.join(tmp, "golden")
    os.makedirs(d)
    for f in ("hap0.mer", "hap1.mer", "reads1.fq.gz", "reads2.fq"):
        shutil.copy(os.path.join(GOLD, f), d)
    hap = ["--hap0", os.path.join(d, "hap0.mer"),
           "--hap1", os.path.join(d, "hap1.mer")]
    reads = ["--read", os.path.join(d, "reads1.fq.gz"),
             "--read", os.path.join(d, "reads2.fq"), "--weight0", "1.04"]
    for device, mesh in [(f"cuda:{i}", []) for i in range(n)] + [
            ("cuda", ["--mesh", f"{n}x1"])]:
        out = os.path.join(d, f"phased.{device}.{len(mesh)}")
        cli.main(["classify", *hap, *reads, "--output", out, "--device",
                  device, *mesh])
        if not _same_bytes(out, os.path.join(GOLD,
                                             "phased.barcodes.golden")):
            fail(f"classify --device {device} {mesh} differs from the "
                 "golden")
    out00 = os.path.join(tmp, "00")
    os.makedirs(out00)
    cli.main(["build-markers", "--auto_bounds", "--mesh", str(n),
              "--paternal", os.path.join(GOLD00, "paternal.reads.fa.gz"),
              "--maternal", os.path.join(GOLD00, "maternal.reads.fa.gz"),
              "--out-dir", out00, "--device", "cuda"])
    for parent in ("maternal", "paternal"):
        if not (_same_bytes(os.path.join(out00, f"{parent}.kmercount.histo"),
                            os.path.join(GOLD00, f"{parent}.histo"))
                and _sorted_lines(os.path.join(
                    out00, f"{parent}.unique.filter.mer")) == _sorted_lines(
                    os.path.join(GOLD00, f"{parent}.unique.filter.mer"))):
            fail(f"build-markers --mesh {n} --device cuda: {parent} differs")
    log(f"across {n} cards: classify --device cuda:0 ... cuda:{n - 1} and "
        f"--mesh {n}x1, build-markers --mesh {n}: goldens byte-identical")

    b = os.path.join(tmp, "bench")
    os.makedirs(b)
    h0, h1 = os.path.join(b, "paternal.mer"), os.path.join(b, "maternal.mer")
    son = os.path.join(b, "son.fq")
    m0, m1 = S.make_marker_files(7, N_MARKERS, K, h0, h1)
    S.make_stlfr_fastq(8, son, m0, m1, N_READS)
    cards = [torch.device("cuda", i) for i in range(n)]
    runs = [("cuda:0 alone", None), (f"{n}x1 mesh", PM.make_mesh(
        devices=cards))]
    if n % 2 == 0 and n >= 4:
        runs.append((f"{n // 2}x2 mesh", PM.make_mesh(tp=2, devices=cards)))
    want = None
    with open(os.devnull, "w") as devnull:
        for name, mesh in runs * 2:       # the second round is warm
            _build.LAUNCHES.clear()
            out = io.BytesIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(devnull):
                C.run_classify(h0, h1, [son], out, w0=1.04,
                               batch_size=1 << 15, device="cuda:0",
                               mesh=mesh)
            wall = time.perf_counter() - t0
            want = want or out.getvalue()
            if out.getvalue() != want:
                fail(f"classify on the {name} differs from cuda:0 alone")
            log(f"across {n} cards: classify of {N_READS} reads on the "
                f"{name}: run_classify {wall:.3f} s; launches "
                f"{dict(_build.LAUNCHES)}")

    t = os.path.join(tmp, "trio")
    os.makedirs(t)
    parents = {p: os.path.join(t, f"{p}.fa") for p in ("paternal",
                                                       "maternal")}
    genomes = S.make_trio_genomes(77, GENOME_LEN, het_rate=0.001)
    for seed, g, p in zip((1, 2), genomes, parents):
        S.make_parent_reads_vectorized(seed, g, parents[p], COVERAGE, 100,
                                       0.002)
    outs = {}
    for name, mesh in (("device engine on cuda:0", None),
                       (f"mesh of {n} cards", PM.make_mesh(devices=cards))):
        outs[name] = os.path.join(t, f"out{len(outs)}")
        os.makedirs(outs[name])
        t0 = time.perf_counter()
        with open(os.devnull, "w") as devnull:
            if mesh is None:
                M.build_unshared_markers([parents["paternal"]],
                                         [parents["maternal"]], outs[name],
                                         auto_bounds=True, device="cuda:0",
                                         log=devnull)
            else:
                from hast_tpu_torch.parallel import distributed as D
                D.build_unshared_markers_mesh(
                    mesh, [parents["paternal"]], [parents["maternal"]],
                    outs[name], auto_bounds=True, batch_size=MESH_BATCH,
                    log=devnull)
        log(f"across {n} cards: build-markers of the {GENOME_LEN} bp trio "
            f"by the {name}: {time.perf_counter() - t0:.3f} s")
    first, second = outs.values()
    for f in sorted(os.listdir(second)):
        if not _same_bytes(os.path.join(first, f), os.path.join(second, f)):
            fail(f"build-markers across {n} cards: {f} differs from cuda:0's")
    log(f"across {n} cards: the trio's histos, bounds and markers equal")


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "hast_tpu_torch")):
        fail(f"the hast_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, ROOT)

    across = sys.argv[1:] == ["--across-cards"]
    if sys.argv[1:] and not across:
        fail(f"unknown arguments {sys.argv[1:]} (only --across-cards)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    phase_toolchain()
    if across:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            phase_across_cards(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    kernels, tables, words, bwords = phase_kernels()
    kernels.update(phase_kernels00())
    kernels["canonical_windows"].update(phase_k1_times())
    kernels.update(phase_kernels03(tables, words, bwords))
    kernels.update(phase_kernels_mesh(tables, words, bwords))
    for name, extra in phase_read_votes(tables, words, bwords).items():
        extra["max_abs_err"] = max(extra["max_abs_err"],
                                   kernels[name]["max_abs_err"])
        kernels[name].update(extra)
    for name, turns in phase_launch_path().items():
        kernels[name].update(turns)
    mesh_launches = {"tally_votes": phase_classify_step(tables, words)}
    del tables, words, bwords
    kernels["broadcast_probe"], mesh_launches["broadcast_probe"] = \
        phase_broadcast()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_goldens(tmp)
        phase_goldens00(tmp)
        phase_goldens03(tmp)
        main_path = phase_main_path(tmp)
        launches = main_path["launches"]
        kernels["classify_tally"]["main_path_device_ms"] = \
            main_path["k3_device_ms"]
        mesh_launches["vote_reads"] = phase_mesh_classify(tmp)
        markers = phase_markers_main(tmp)
        launches.update(markers["launches"])
        phase_stage00_breakdown(tmp, markers["reads"])
        mesh_launches["route_kmers"] = phase_mesh_markers(tmp,
                                                          markers["reads"])
        phase_mesh_goldens(tmp)
        launches.update(phase_stage03_main(tmp))
        launches.update(mesh_launches)
        phase_entry_points(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_scale()

    csrc = "hast_tpu_torch/ops/csrc/"
    sources = {"canonical_windows": ("count.cu",
                                     "hast_tpu/ops/encode.py:53"),
               "probe": ("probe.cu", "hast_tpu/ops/hashtable.py:444"),
               "classify_tally": ("classify.cu",
                                  "hast_tpu/pipeline/classify.py:217"),
               "grow_tally": ("tally.cu",
                              "hast_tpu/pipeline/classify.py:262"),
               "pack_tally": ("tally.cu",
                              "hast_tpu/pipeline/classify.py:267"),
               "count_windows": ("count.cu",
                                 "hast_tpu/ops/kmer_count.py:58"),
               "sort_pairs": ("sort.cu", "hast_tpu/ops/kmer_count.py:333"),
               "fold_runs": ("fold.cu", "hast_tpu/ops/kmer_count.py:333"),
               "shrink_run": ("shrink.cu",
                              "hast_tpu/ops/kmer_count.py:361"),
               "count_stats": ("stats.cu", "hast_tpu/ops/kmer_count.py:535"),
               "marker_filter": ("markers.cu",
                                 "hast_tpu/ops/kmer_count.py:560"),
               "segment_votes": ("segment.cu",
                                 "hast_tpu/pipeline/rephase.py:276"),
               "vote_reads": ("vote.cu", "hast_tpu/pipeline/classify.py:313"),
               "route_kmers": ("route.cu", "hast_tpu/parallel/mesh.py:455"),
               "tally_votes": ("tally.cu", "hast_tpu/parallel/mesh.py:117"),
               "broadcast_probe": ("broadcast.cu",
                                   "docs/experimental/probe_pallas.py:62")}
    rows = [dict(name=name, route="cuda", source=csrc + src, replaces=rep,
                 launches=launches.get(name, 0), **kernels[name])
            for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
