"""The port's tracer (hast_tpu_torch/utils/profiling.py): spans that
record only under a torch.profiler session, and the host counters, on
the stage-01 and stage-00 goldens and on a small marker table."""

import gzip
import io
import json
import os
import pathlib
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hast_tpu_torch.io import fastq as FQ
from hast_tpu_torch.ops import hashtable as H
from hast_tpu_torch.ops import kmer_count as KC
from hast_tpu_torch.pipeline import classify as C
from hast_tpu_torch.pipeline import markers as M
from hast_tpu_torch.utils import profiling as P

GOLD = pathlib.Path(__file__).parent / "golden"
READS01 = [GOLD / "stage01" / "reads1.fq.gz", GOLD / "stage01" / "reads2.fq"]
PARENTS00 = {p: GOLD / "stage00" / f"{p}.reads.fa.gz"
             for p in ("paternal", "maternal")}
CPU = [torch.profiler.ProfilerActivity.CPU]


def _refuse(*args, **kwargs):
    raise AssertionError("called with no profiler running")


def _spans(prof, path) -> list:
    """(name, start, end) of the exported trace's annotations, in µs."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _records(path) -> int:
    if str(path).endswith((".fa", ".fa.gz")):
        return sum(1 for _ in FQ.fasta_records(str(path)))
    return sum(1 for _ in FQ.fastq_records(str(path)))


def test_span_enters_no_annotation_and_reads_no_clock_when_off(
        monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(time, "perf_counter", _refuse)
    monkeypatch.setattr(time, "perf_counter_ns", _refuse)
    with P.span("a"):
        with P.span("b"):
            pass


def test_span_and_phase_are_annotations_under_a_session(tmp_path):
    timer = P.PhaseTimer(log=None)
    with torch.profiler.profile(activities=CPU) as prof:
        with P.span("outer"):
            with timer.phase("inner"):
                torch.ones(4).sum()
    got = {n: (s, e) for n, s, e in _spans(prof, tmp_path / "t.json")}
    assert set(got) == {"outer", "inner"}
    assert got["outer"][0] <= got["inner"][0] <= got["inner"][1] \
        <= got["outer"][1]
    assert timer.phases["inner"] > 0
    # the session is over: spans are off again
    assert P.span("after") is P.span("again")


@pytest.mark.parametrize("width", [1, 2])
def test_native_classify_spans_and_counters(tmp_path, monkeypatch, width):
    """Native classify of the stage-01 goldens under a CPU profiler
    session, with up to width files' readers open at once: a reader wait
    a batch handed over, and one more a file for the call that finds its
    end; no batch's staging inside a wait; one fetch a file; every read
    counted once; all of them inside the one classify.files span of the
    call, and the batches taken while both files' readers were open
    counted as overlapped."""
    for f in ("hap0.mer", "hap1.mer"):     # the snapshot goes beside them
        shutil.copy(GOLD / "stage01" / f, tmp_path / f)
    table = C.load_marker_table(str(tmp_path / "hap0.mer"),
                                str(tmp_path / "hap1.mer"))
    C.erase_adaptors(table)
    monkeypatch.setattr(C, "_reader_width", lambda n: min(n, width))
    before = dict(P.COUNTERS)
    with torch.profiler.profile(activities=CPU) as prof:
        tally = C.classify_fastqs(table, [str(p) for p in READS01],
                                  batch_size=512, engine="native")
        out = _write(tally, table)
    assert out == (GOLD / "stage01" / "phased.barcodes.golden").read_bytes()
    grew = {k: P.COUNTERS[k] - before.get(k, 0)
            for k in ("io.reads", "io.batches", "io.reader_opens",
                      "classify.overlapped_batches")}
    assert grew["io.reads"] == sum(_records(p) for p in READS01)
    assert grew["io.reader_opens"] == len(READS01)
    batches = [-(-_records(p) // 512) for p in READS01]
    assert grew["io.batches"] == sum(batches)
    if width == 1:
        assert grew["classify.overlapped_batches"] == 0
    else:
        assert grew["classify.overlapped_batches"] >= 2 * min(batches) - 1
    spans = _spans(prof, tmp_path / "trace.json")
    names = [n for n, _, _ in spans]
    waits = [(s, e) for n, s, e in spans if n == "io.read_wait"]
    stages = [(s, e) for n, s, e in spans if n == "classify.stage"]
    assert len(waits) == grew["io.batches"] + len(READS01)
    assert len(stages) == grew["io.batches"]
    assert not [1 for a, b in stages for s, e in waits if s < b and a < e]
    assert names.count("classify.files") == 1
    assert names.count("classify.fetch_tally") == len(READS01)
    for name in ("classify.sort_barcodes", "classify.decide_format",
                 "classify.write"):
        assert names.count(name) == 1, name
    files = [(s, e) for n, s, e in spans if n == "classify.files"]
    inner = [(s, e) for n, s, e in spans
             if n in ("io.read_wait", "classify.stage",
                      "classify.fetch_tally")]
    assert all(any(a <= s and e <= b for a, b in files) for s, e in inner)


def _write(tally, table) -> bytes:
    out = io.BytesIO()
    C.write_phased_barcodes(tally, table, out, w0=1.04)
    return out.getvalue()


def _as_fastq(src: pathlib.Path, dst: pathlib.Path) -> str:
    with open(dst, "wb") as f:
        for head, seq in FQ.fasta_records(str(src)):
            f.write(b"@%s\n%s\n+\n%s\n" % (head, seq, b"I" * len(seq)))
    return str(dst)


def test_partitioned_markers_read_each_parent_once_a_pass(tmp_path,
                                                          monkeypatch):
    """build-markers in two key-range passes on the stage-00 goldens as
    fastq: each parent's file is read once a job, into its spill, both
    parents' readers open at once, and every pass of both sweeps and the
    boundary sample read the spills; every span of the stage-00 path is
    in the trace, and the outputs are the goldens."""
    monkeypatch.setattr(C, "_reader_width", lambda n: min(n, 2))
    fq = {p: _as_fastq(src, tmp_path / f"{p}.fq")
          for p, src in PARENTS00.items()}
    reads = {p: _records(fq[p]) for p in fq}
    before = dict(P.COUNTERS)
    out = tmp_path / "out"
    out.mkdir()
    with torch.profiler.profile(activities=CPU) as prof:
        M.build_unshared_markers(
            [fq["paternal"]], [fq["maternal"]], str(out), auto_bounds=True,
            n_parts=2, engine="device", device="cpu", log=io.StringIO())
    n_parts = 2
    grew = {k: P.COUNTERS[k] - before.get(k, 0)
            for k in ("io.reads", "io.reader_opens", "io.spill_reads",
                      "io.spill_bytes", "markers.overlapped_batches")}
    assert grew["io.reads"] == reads["paternal"] + reads["maternal"]
    assert grew["io.reader_opens"] == 2
    assert "markers.overlapped_batches" in P.COUNTERS
    assert grew["markers.overlapped_batches"] > 0
    # the sample: every 32nd of the first 512 maternal batches
    bs = FQ.DEFAULT_BATCH
    sampled = sum(min(bs, reads["maternal"] - i)
                  for i in range(0, reads["maternal"], 32 * bs))
    assert grew["io.spill_reads"] == \
        2 * n_parts * (reads["paternal"] + reads["maternal"]) + sampled
    assert grew["io.spill_bytes"] > 0
    assert not list(out.glob("*.spill"))
    names = {n for n, _, _ in _spans(prof, tmp_path / "trace.json")}
    assert {"io.read_wait", "markers.sample_boundaries",
            "markers.spill_write", "markers.spill_read",
            "markers.count_pass", "markers.histo", "markers.dump_words",
            "markers.algebra", "kmer_count.stage", "kmer_count.fold",
            "histo_sweep", "bounds", "marker_sweep"} <= names
    for p in PARENTS00:
        for name, gold in ((f"{p}.kmercount.histo", f"{p}.histo"),
                           (f"{p}.bounds.txt", f"{p}.bounds.txt")):
            assert (out / name).read_bytes() == \
                (GOLD / "stage00" / gold).read_bytes(), name
        assert sorted((out / f"{p}.unique.filter.mer").read_bytes()
                      .split()) == sorted(
            (GOLD / "stage00" / f"{p}.unique.filter.mer").read_bytes()
            .split())


def test_file_merge_opens_once_a_pass_and_counts_each_parent_s_files(
        tmp_path):
    """build-markers in two key-range passes, the paternal goldens as a
    paired library (R1 and R2 the two halves of its reads, fastq.gz) and
    the maternal as one fastq: markers.file_merge opens once in each
    pass of both sweeps, inside it, and markers.merged_runs grows by the
    parent's file count a pass; the outputs are the goldens."""
    records = list(FQ.fasta_records(str(PARENTS00["paternal"])))
    half = len(records) // 2
    paternal = []
    for mate, part in ((1, records[:half]), (2, records[half:])):
        path = tmp_path / f"paternal_{mate}.fq.gz"
        path.write_bytes(gzip.compress(b"".join(
            b"@%s\n%s\n+\n%s\n" % (head, seq, b"I" * len(seq))
            for head, seq in part)))
        paternal.append(str(path))
    maternal = [_as_fastq(PARENTS00["maternal"], tmp_path / "ma.fq")]
    out = tmp_path / "out"
    out.mkdir()
    before = P.COUNTERS["markers.merged_runs"]
    n_parts = 2
    with torch.profiler.profile(activities=CPU) as prof:
        M.build_unshared_markers(
            paternal, maternal, str(out), auto_bounds=True, n_parts=n_parts,
            engine="device", device="cpu", log=io.StringIO())
    spans = _spans(prof, tmp_path / "trace.json")
    passes = [(s, e) for n, s, e in spans if n == "markers.count_pass"]
    merges = [(s, e) for n, s, e in spans if n == "markers.file_merge"]
    assert len(passes) == len(merges) == 2 * n_parts * 2
    assert all(a <= s and e <= b for (a, b), (s, e) in zip(passes, merges))
    assert P.COUNTERS["markers.merged_runs"] - before == \
        2 * n_parts * (len(paternal) + len(maternal))
    for p in PARENTS00:
        assert (out / f"{p}.kmercount.histo").read_bytes() == \
            (GOLD / "stage00" / f"{p}.histo").read_bytes(), p


@pytest.mark.parametrize("width", [1, 2])
def test_open_readers_a_turn_read_the_width(tmp_path, width):
    """Two parents' spills written in turn, each parent one fastq of the
    same 45,000 reads: markers.turns counts the batches taken, and
    markers.open_readers over it reads 2.0 with both parents' readers
    open at once, 1.0 one at a time."""
    fq = _as_fastq(PARENTS00["maternal"], tmp_path / "ma.fq")
    shutil.copy(fq, tmp_path / "pa.fq")
    names = ("markers.turns", "markers.open_readers")
    before = {n: P.COUNTERS[n] for n in names}
    spills = KC.PackedSpill.write_in_turn(
        [(str(tmp_path / "pa.spill"), [str(tmp_path / "pa.fq")]),
         (str(tmp_path / "ma.spill"), [fq])], 21, 4096, width=width)
    for s in spills:
        s.remove()
    grew = {n: P.COUNTERS[n] - before[n] for n in names}
    assert grew["markers.turns"] == 2 * -(-_records(fq) // 4096)
    assert grew["markers.open_readers"] / grew["markers.turns"] == width


def test_python_reader_counts_nothing():
    """The counters are the native readers': the python fasta reader,
    which takes files the native reader refuses, counts no reads."""
    before = P.COUNTERS["io.reads"]
    got = sum(b.n for b in FQ.sequence_batches(
        str(PARENTS00["paternal"]), 21, 4096))
    assert got == _records(PARENTS00["paternal"])
    assert P.COUNTERS["io.reads"] == before



def test_counts_from_many_threads_are_all_kept():
    """Two parents count on two threads: no add is lost, with more
    threads than cores and a thread switch every microsecond."""
    threads, adds = 4 * (os.cpu_count() or 1), 2000
    before = P.COUNTERS["test.adds"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            P.count("test.adds", 3) for _ in range(adds)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert P.COUNTERS["test.adds"] - before == 3 * adds * threads


def _small_table_keys():
    """300 keys, 40 of them twice (in both sets): 260 distinct."""
    rng = np.random.default_rng(5)
    words = np.unique(rng.integers(0, 4 ** 21, 300, dtype=np.int64))[:260]
    keys = np.concatenate([words, words[:40]])
    pay = np.concatenate([np.ones(260, np.uint32), np.full(40, 2, np.uint32)])
    return (keys >> 32).astype(np.uint32), \
        (keys & 0xFFFFFFFF).astype(np.uint32), pay


_TABLE_COUNTERS = ("table.keys", "table.rows", "table.upload_bytes")


def test_table_build_and_upload_spans_under_a_session(tmp_path):
    """build_table opens table.build with table.dedup and table.place
    inside it; KmerTable.to opens table.upload."""
    hi, lo, pay = _small_table_keys()
    with torch.profiler.profile(activities=CPU) as prof:
        table = H.build_table(hi, lo, pay, 21, load=0.7)
        table.to("meta")
    spans = {n: (s, e) for n, s, e in _spans(prof, tmp_path / "t.json")}
    assert {"table.build", "table.dedup", "table.place",
            "table.upload"} <= set(spans)
    b0, b1 = spans["table.build"]
    for child in ("table.dedup", "table.place"):
        assert b0 <= spans[child][0] <= spans[child][1] <= b1
    assert spans["table.dedup"][1] <= spans["table.place"][0]
    assert spans["table.upload"][0] >= b1


def test_table_counters_count_keys_rows_and_bytes_moved():
    """table.keys grows by the distinct keys, table.rows by the buckets,
    table.upload_bytes by the rows' bytes when they move and not when
    they are on the device already."""
    hi, lo, pay = _small_table_keys()
    before = {k: P.COUNTERS[k] for k in _TABLE_COUNTERS}
    table = H.build_table(hi, lo, pay, 21, load=0.7)
    assert table.n_keys == 260
    assert H.table_shape(260, 21, 0.7) == (table.fmt, table.n_buckets)
    table.to("cpu")
    moved = table.to("meta")
    assert moved.data.device.type == "meta"
    grew = {k: P.COUNTERS[k] - before[k] for k in _TABLE_COUNTERS}
    assert grew == {"table.keys": 260, "table.rows": table.n_buckets,
                    "table.upload_bytes": 16 * table.n_buckets}


def test_table_spans_record_nothing_outside_a_session(monkeypatch):
    """With no session running, the table's spans enter no annotation
    and read no clock; the counters count all the same."""
    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(time, "perf_counter", _refuse)
    hi, lo, pay = _small_table_keys()
    before = P.COUNTERS["table.keys"]
    H.build_table(hi, lo, pay, 21, load=0.7).to("meta")
    assert P.COUNTERS["table.keys"] - before == 260
