#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hast_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It exits non-zero, printing no result, when torch sees no CUDA device or
when the package is not beside it.  Phases, each fatal on failure:

1. toolchain: card, power limit, torch, CUDA, nvcc; the kernels' build.
2. kernels vs their plain PyTorch twins on the card, bit-exact, with
   both times: K1 canonical_windows on 65,536 packed 100-bp reads at
   k = 15, 21, 31; K2 probe on a 2M-key quot table (2^20 rows), the same
   keys in a forced full table (2^21 rows) and a 4e7-key quot table
   (2^24 rows, 268 MB, past the 50 MB L2); K3 classify_tally against
   tally_step_ref with N reads, id -1 rows and reads shorter than k.
3. the stage-00 kernels the same way: K4 count_windows on 65,536 packed
   100-bp reads at k = 15, 21, 31 (masked, clean, key range up to
   2^64 - 1); K5 sort_pairs on 2^26 pairs at k = 21 and 31; K6
   fold_runs on a 2^26-element duplicate-heavy sorted run; K7
   count_stats on 2^26 counts, high = 10000; K8 marker_filter on two
   2^25-row runs sharing half their keys, bounds (9, 33) and
   (0, 2^31 - 1).
4. the stage-01 goldens (main, edge, k15, k31; weight0 1.04) classified
   on the card, byte-identical to tests/golden/stage01/*.golden; the
   stage-00 goldens built on the card by engines device, host and device
   with 3 key-range passes (histos and bounds byte-identical, markers
   equal to jellyfish's when sorted); the e2e trio through
   ``build-markers`` and ``classify-reads --device cuda``, phased.barcodes
   and the binned fastqs byte-identical.
5. the stage-01 main path at bench.py's scale: 10^6 markers per
   haplotype at k = 21 and 10^6 100-bp stLFR reads, through
   ``classify-reads --device cuda`` (classify, splits, quartering); K3
   must have been launched and tally_step_ref never called.  The first
   10^5 reads are classified on the card and on the CPU twins, and the
   outputs must be equal bytes.
6. the stage-00 main path at bench.py's scale: a 3 Mb trio, 100-bp reads
   at 33x with 0.2 % errors (about 990,000 reads a parent), through
   ``build-markers --auto_bounds --device cuda``; K4-K8 must each have
   been launched and no twin called.  The first 2x10^5 reads of each
   parent go through the card and the CPU twins, and the outputs must be
   equal bytes.  Then where the time goes: the native reader alone, and
   a torch.profiler run of the device engine (device time by kernel,
   device idle share).
7. device-resident state at scale: two parents of 6x10^8 windows each,
   drawn on the card from key pools of 1.6x10^8 that overlap by a
   quarter, fed to the DeviceCounter in 2^25-key chunks; finalize,
   histogram and marker algebra through the kernels and again through
   the twins on the card must agree; fold counts, peak device memory,
   times and K8's share of the marker algebra are printed.

Before the last line it prints one JSON line of kernel results and the
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None          # the port must run without jax

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(ROOT, "tests", "golden", "stage01")
GOLD00 = os.path.join(ROOT, "tests", "golden", "stage00")
E2E = os.path.join(ROOT, "tests", "golden", "e2e")
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
                   "count_stats", "marker_filter")


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


def phase_kernels() -> dict:
    """Each kernel against its twin on the same card tensors."""
    import numpy as np
    import torch
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.ops import hashtable as H
    from hast_tpu_torch.pipeline import classify as C

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
        keys, valid = E.canonical_windows(packed, lengths, k)
        rkeys, rvalid = E.canonical_windows_ref(packed, lengths, k)
        torch.cuda.synchronize()
        if not (torch.equal(keys, rkeys) and torch.equal(valid, rvalid)):
            fail(f"K1 canonical_windows != twin at k={k}")
        err = max(err, max_abs_err(keys, rkeys))
        ms = cuda_ms(lambda: E.canonical_windows(packed, lengths, k), 20)
        plain = cuda_ms(lambda: E.canonical_windows_ref(packed, lengths, k),
                        3)
        log(f"K1 canonical_windows k={k} {n} reads x {keys.shape[1]} "
            f"windows: kernel {ms:.4f} ms, twin {plain:.4f} ms, bit-exact")
        if k == K:
            res["canonical_windows"] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=plain)
    res["canonical_windows"]["max_abs_err"] = err

    # K2 on the bench-scale key count, quot and forced full
    words, hi, lo = random_keys(rng, 2_000_000, K)
    pay = rng.integers(1, 4, words.size).astype(np.uint32)
    absent = random_keys(np.random.default_rng(99), 1 << 21, K)[0]
    absent = absent[~np.isin(absent, words)]
    q_np = np.concatenate([words[rng.integers(0, words.size, 1 << 21)],
                           absent])
    expect = np.concatenate([pay[_index_of(words, q_np[:1 << 21])],
                             np.zeros(absent.size, np.uint32)])
    queries = torch.from_numpy(q_np).to(dev)
    err = 0.0
    tables = {}
    for fmt in ("quot", "full"):
        t0 = time.perf_counter()
        table = H.build_table(hi, lo, pay, K, load=0.7, fmt=fmt).to(dev)
        build_s = time.perf_counter() - t0
        tables[fmt] = table
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
        log(f"K2 probe {fmt} table {table.n_buckets} rows "
            f"({table.data.numel() * 4 / 1e6:.1f} MB, built in {build_s:.2f}"
            f" s), {queries.numel()} keys: kernel {ms:.4f} ms, twin "
            f"{plain:.4f} ms, bit-exact")
        if fmt == "quot":
            res["probe"] = dict(ms=ms, plain_ms=plain)

    # K2 and K3 past the L2: 4e7 random keys -> 2^24 quot rows (the few
    # duplicate draws merge in the build)
    t0 = time.perf_counter()
    bwords = rng.integers(0, 1 << (2 * K), 40_000_000, dtype=np.int64)
    bpay = rng.integers(1, 4, bwords.size).astype(np.uint32)
    t1 = time.perf_counter()
    big = H.build_table((bwords >> 32).astype(np.uint32),
                        (bwords & 0xFFFFFFFF).astype(np.uint32), bpay, K,
                        load=0.7).to(dev)
    log(f"4e7-key table: {big.fmt}, {big.n_buckets} rows, "
        f"{big.data.numel() * 4 / 1e6:.1f} MB; keys drawn in "
        f"{t1 - t0:.2f} s, table built in {time.perf_counter() - t1:.2f} s")
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
    res["classify_tally"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    del big, bq
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
    from hast_tpu_torch.ops import encode as E
    from hast_tpu_torch.ops import kmer_count as KC

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
            log(f"K4 count_windows k={k} {variant}: {n} reads x "
                f"{got.numel() // n} windows ({real} real): kernel "
                f"{ms:.4f} ms, twin {plain:.4f} ms, bit-exact")
            if k == K and variant == "masked":
                res["count_windows"] = dict(ms=ms, plain_ms=plain)
    res["count_windows"]["max_abs_err"] = err

    # K5: 2^26 random keys, 10 % sentinels, int32 payload
    n = 1 << 26
    err = 0.0
    for k in (21, 31):
        keys = torch.randint(0, 1 << (2 * k), (n,), device=dev, generator=g)
        keys[torch.rand(n, device=dev, generator=g) < 0.1] = KC.SENT
        pay = torch.randint(0, 1 << 30, (n,), device=dev, generator=g,
                            dtype=torch.int32)
        err = max(err, _check_same(f"K5 sort_pairs k={k}",
                                   KC.sort_pairs(keys, pay, k),
                                   KC.sort_pairs_ref(keys, pay, k)))
        ms = cuda_ms(lambda: KC.sort_pairs(keys, pay, k), 5)
        plain = cuda_ms(lambda: KC.sort_pairs_ref(keys, pay, k), 3)
        log(f"K5 sort_pairs k={k}: {n} pairs, {-(-(2 * k + 1) // 8)} "
            f"passes: kernel {ms:.4f} ms, twin {plain:.4f} ms, bit-exact")
        if k == K:
            res["sort_pairs"] = dict(ms=ms, plain_ms=plain)
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
    log(f"K6 fold_runs: {n} sorted keys, {int(got[2])} distinct: kernel "
        f"{ms:.4f} ms, twin {plain:.4f} ms, bit-exact")
    res["fold_runs"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    del keys, counts, got

    # K7: 2^26 counts, mostly low, some above high, pads of 0
    counts = torch.randint(0, 60, (n,), device=dev, generator=g,
                           dtype=torch.int32)
    counts[::997] = torch.randint(0, 40000, (counts[::997].numel(),),
                                  device=dev, generator=g,
                                  dtype=torch.int32)
    err = _check_same("K7 count_stats", KC.count_stats(counts, 10000),
                      KC.count_stats_ref(counts, 10000))
    ms = cuda_ms(lambda: KC.count_stats(counts, 10000), 20)
    plain = cuda_ms(lambda: KC.count_stats_ref(counts, 10000), 3)
    log(f"K7 count_stats: {n} counts, high 10000: kernel {ms:.4f} ms, twin "
        f"{plain:.4f} ms, bit-exact")
    res["count_stats"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    del counts

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
        got = KC.marker_filter(*args, bounds)
        err = max(err, _check_same(f"K8 marker_filter {bounds}", got,
                                   KC.marker_filter_ref(*args, bounds)))
        ms = cuda_ms(lambda: KC.marker_filter(*args, bounds), 10)
        plain = cuda_ms(lambda: KC.marker_filter_ref(*args, bounds), 3)
        log(f"K8 marker_filter: 2 x {rows} rows, bounds {bounds}, kept "
            f"{int(got[1])} + {int(got[3])}: kernel {ms:.4f} ms, twin "
            f"{plain:.4f} ms, bit-exact")
        if bounds[0] == 9:
            res["marker_filter"] = dict(ms=ms, plain_ms=plain)
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
    if launches.get("classify_tally", 0) <= 0:
        fail("the main path launched no classify_tally kernel")
    if twins.get("tally_step_ref", 0):
        fail("the main path called tally_step_ref")
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

    # warm repeat (snapshot present) for the per-phase breakdown
    timings = {}
    C.run_classify(hap0, hap1, [reads], io.BytesIO(), w0=1.04,
                   batch_size=1 << 15, device="cuda", timings=timings)
    log("run_classify warm (snapshot): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in timings.items())
        + f"; classify phase {N_READS / timings['classify']:.0f} reads/s")

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
    return dict(launches=launches, wall=wall, timings=timings)


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
              ("K5 sort_pairs", ("radix_", "HistVal")),
              ("K6 fold_runs", ("StartFlag", "fill_kernel",
                                "n_unique_kernel")),
              ("K7 count_stats", ("count_stats_kernel",)),
              ("K8 marker_filter", ("keep_kernel", "KeepVal")),
              ("scan tiles (K5, K6, K8)", ("scan_tiles_kernel",)),
              ("copies", ("Memcpy", "Memset")))
    out = os.path.join(tmp, "stage00_profiled")
    os.makedirs(out)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with open(os.devnull, "w") as devnull:
            M.build_unshared_markers([reads["paternal"]],
                                     [reads["maternal"]], out,
                                     auto_bounds=True, device="cuda",
                                     log=devnull)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sums = {name: 0.0 for name, _ in groups}
    sums["other (torch glue)"] = 0.0
    for e in prof.key_averages():
        us = _device_us(e)
        if not us:
            continue
        name = next((g for g, keys in groups
                     if any(x in e.key for x in keys)), "other (torch glue)")
        sums[name] += us
    busy = sum(sums.values()) / 1e6
    idle = f"{1 - busy / wall:.4f}" if busy else "not measured"
    log(f"stage-00 device engine under torch.profiler: wall {wall:.3f} s, "
        f"device busy {busy:.4f} s, idle share {idle}; "
        "device s by kernel: " + ", ".join(
            f"{k} {v / 1e6:.4f}" for k, v in sums.items()))


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
        if mode == "kernels":
            # the marker algebra is K8 plus the fetch of the kept words
            k8 = cuda_ms(lambda: KC.marker_filter(
                pat.keys, pat.counts, pat.n_valid, mat.keys, mat.counts,
                mat.n_valid, (2, 8, 2, 8)), 3)
            log(f"scale: K8 marker_filter alone on {pat.n_valid} + "
                f"{mat.n_valid} rows: {k8:.4f} ms")
        peak = torch.cuda.max_memory_allocated() - base
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    phase_toolchain()
    kernels = phase_kernels()
    kernels.update(phase_kernels00())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_goldens(tmp)
        phase_goldens00(tmp)
        launches = phase_main_path(tmp)["launches"]
        markers = phase_markers_main(tmp)
        launches.update(markers["launches"])
        phase_stage00_breakdown(tmp, markers["reads"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_scale()

    csrc = "hast_tpu_torch/ops/csrc/"
    sources = {"canonical_windows": ("kmer.cu", "hast_tpu/ops/encode.py:53"),
               "probe": ("probe.cu", "hast_tpu/ops/hashtable.py:444"),
               "classify_tally": ("classify.cu",
                                  "hast_tpu/pipeline/classify.py:217"),
               "count_windows": ("count.cu",
                                 "hast_tpu/ops/kmer_count.py:58"),
               "sort_pairs": ("sort.cu", "hast_tpu/ops/kmer_count.py:333"),
               "fold_runs": ("fold.cu", "hast_tpu/ops/kmer_count.py:333"),
               "count_stats": ("stats.cu", "hast_tpu/ops/kmer_count.py:535"),
               "marker_filter": ("markers.cu",
                                 "hast_tpu/ops/kmer_count.py:560")}
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
