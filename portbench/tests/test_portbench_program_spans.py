"""The program's spans read with innermost attribution, and the readers
built on them."""

import os
import time
import types

import pytest
import torch

from portbench import harness
from portbench import program_spans as PS
from portbench import trace as T
from portbench.tests import tiny

NEW = ("classify.read_wait_share", "markers.read_wait_share",
       "markers.reads_per_input_read", "markers.sample_ms")

# a job's benchmark span with two of the program's spans inside it
NESTED = [(0.0, 100.0, "outer"), (2.0, 30.0, "io.read_wait"),
          (30.0, 32.0, "classify.stage")]


def test_a_gap_goes_to_the_innermost_span_open():
    summary = {"window_us": (-5.0, 100.0), "device": [("k", 31.0, 69.0)],
               "spans": NESTED}
    assert PS.idle_by_span(summary) == pytest.approx({
        T.BETWEEN: 5e-6, "outer": 2e-6, "io.read_wait": 28e-6,
        "classify.stage": 1e-6})


def test_the_flat_split_puts_the_same_gap_under_the_outer_span():
    """trace._split takes spans as flat: what the innermost reading puts
    under io.read_wait, it puts under the benchmark's span."""
    spans = sorted(NESTED)
    got = list(T._split(-5.0, 31.0, spans, [s for s, _, _ in spans]))
    assert got == [(T.BETWEEN, 5.0), ("outer", 31.0)]


def test_pieces_cover_each_instant_once_and_clip_a_child_to_its_parent():
    spans = [(0.0, 10.0, "a"), (1.0, 4.0, "b"), (2.0, 3.0, "c"),
             (4.0, 4.0, "empty"), (6.0, 10.5, "late"), (12.0, 13.0, "d")]
    assert PS.pieces(spans) == [
        (0.0, 1.0, "a"), (1.0, 2.0, "b"), (2.0, 3.0, "c"), (3.0, 4.0, "b"),
        (4.0, 6.0, "a"), (6.0, 10.0, "late"), (12.0, 13.0, "d")]


def test_idle_time_by_innermost_span():
    summary = {"window_us": (0.0, 100.0),
               "device": [("k", 10.0, 5.0), ("k", 12.0, 8.0),
                          ("copy", 50.0, 10.0)],
               "spans": NESTED}
    got = PS.idle_by_span(summary)
    assert got == pytest.approx({"outer": 60e-6, "io.read_wait": 18e-6,
                                 "classify.stage": 2e-6})
    assert sum(got.values()) == pytest.approx(80e-6)


def _run(spans, bench_spans):
    """A traced run's view as the readers see it."""
    return types.SimpleNamespace(
        summary={"spans": spans, "window_s": 1.0, "window_us": (0.0, 1e6),
                 "device": []},
        spans=bench_spans, store={}, jobs=2,
        inputs={"paternal": ("p.fq", torch.zeros((10, 100))),
                "maternal": ("m.fq", torch.zeros((10, 100)))})


@pytest.mark.parametrize("name", NEW)
def test_a_reader_reads_nothing_without_a_program_span(name):
    mod = harness._load(os.path.join(harness.BENCH_DIR, "metrics",
                                     f"{name}.py"), "m_" + name)
    run = _run([(0.0, 5e5, "markers.build"), (5e5, 9e5, "markers.build")],
               [("markers.build", 0.0, 0.5), ("markers.build", 0.5, 0.9)])
    run.store[getattr(mod, "KEY", "-")] = (None, [170, 170])
    assert mod.read(run) is None


def test_the_readers_read_the_program_spans():
    spans = [(0.0, 5e5, "markers.build"),
             (1e4, 2e4, "markers.sample_boundaries"),
             (2e4, 3e4, "io.read_wait"), (3e4, 3.5e4, "io.read_wait"),
             (6e5, 7e5, "markers.build"),
             (6e5 + 1, 6e5 + 3e4 + 1, "markers.sample_boundaries")]
    run = _run(spans, [("markers.build", 0.0, 0.5)])
    run.store["markers.reads_per_input_read"] = (None, [170, 170])
    read = {n: harness._load(os.path.join(harness.BENCH_DIR, "metrics",
                                          f"{n}.py"), "r_" + n).read
            for n in NEW}
    assert read["markers.read_wait_share"](run) == pytest.approx(0.015)
    assert read["classify.read_wait_share"](run) == pytest.approx(0.015)
    assert read["markers.sample_ms"](run) == pytest.approx(20.0)
    assert read["markers.reads_per_input_read"](run) == 8.5


@pytest.mark.parametrize("workload", ["classify-hbm-gz", "markers-parts4"])
def test_a_traced_cpu_run_reads_every_new_metric(tmp_path, monkeypatch,
                                                 workload):
    """A traced run of a tiny cell on the CPU (the session's CUDA calls
    stubbed): each new metric of the cell reads a value, the passes'
    re-reads at 1.0 (each parent read once a job into a spill, the
    passes and the sample reading the spills), and the program's spans
    hold the most of the window."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a, **k: None)
    c = tiny.cell(tmp_path, workload)
    seen = {}
    first = c.per_layer[0][1]
    real = first.read

    def read(run):
        seen["run"] = run
        return real(run)

    monkeypatch.setattr(first, "read", read)
    work = tmp_path / "work"
    work.mkdir()
    r = harness.run_cell(c, 3000000001, 1.0, True, "cpu", str(work),
                         time.perf_counter())
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    mine = [n for n in NEW if n in {e["name"] for e, _ in c.per_layer}]
    assert mine and all(n in m for n in mine)
    for n in mine:
        if n.endswith("read_wait_share"):
            assert 0 < m[n] < 1
    if workload == "markers-parts4":
        assert m["markers.reads_per_input_read"] == 1.0
        assert m["markers.sample_ms"] > 0
    run = seen["run"]
    assert PS.program_spans(run)
    # the window's time outside every span is small
    cut = PS.pieces(run.summary["spans"])
    covered = sum(e - s for s, e, _ in cut)
    t0, t1 = run.summary["window_us"]
    assert covered > 0.9 * (t1 - t0)
