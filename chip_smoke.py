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
3. the stage-01 goldens (main, edge, k15, k31; weight0 1.04) classified
   on the card, byte-identical to tests/golden/stage01/*.golden.
4. the main path at bench.py's scale: 10^6 markers per haplotype at
   k = 21 and 10^6 100-bp stLFR reads, through ``classify-reads --device
   cuda`` (classify, splits, quartering); K3 must have been launched and
   tally_step_ref never called.  The first 10^5 reads are classified on
   the card and on the CPU twins, and the outputs must be equal bytes.

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
N_MARKERS = 1_000_000
N_READS = 1_000_000
N_CPU_READS = 100_000
K = 21


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
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_goldens(tmp)
        main_path = phase_main_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    sources = {"canonical_windows": ("hast_tpu_torch/ops/csrc/kmer.cu",
                                     "hast_tpu/ops/encode.py:53"),
               "probe": ("hast_tpu_torch/ops/csrc/probe.cu",
                         "hast_tpu/ops/hashtable.py:444"),
               "classify_tally": ("hast_tpu_torch/ops/csrc/classify.cu",
                                  "hast_tpu/pipeline/classify.py:217")}
    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=main_path["launches"].get(name, 0),
                 **kernels[name]) for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
