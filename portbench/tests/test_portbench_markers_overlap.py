"""markers.reader_overlap_share on a tiny traced CPU run of
markers-parts4: a share in (0, 1] where the program keeps both parents'
counting readers open at once, and nothing, with no error, from a
program that counts no overlapped batch."""

import collections
import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

NAME = "markers.reader_overlap_share"


def _traced(tmp_path, seed):
    c = tiny.cell(tmp_path, "markers-parts4")
    assert NAME in [m["name"] for m, _ in c.per_layer]
    work = tmp_path / "work"
    work.mkdir()
    r = harness.run_cell(c, seed, 0.5, True, "cpu", str(work),
                         time.perf_counter())
    assert r["correct"]
    return {k: v["value"] for k, v in r["metrics"].items()}


@pytest.fixture
def traced(monkeypatch):
    """A traced run with the session's CUDA calls stubbed."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a, **k: None)
    return _traced


def test_the_share_of_batches_taken_with_both_parents_open(traced, tmp_path,
                                                           monkeypatch):
    from hast_tpu_torch.pipeline import classify as C
    monkeypatch.setattr(C, "_reader_width", lambda n: n)
    m = traced(tmp_path, 3000000037)
    assert 0.0 < m[NAME] <= 1.0
    assert m["markers.reads_per_input_read"] == 1.0
    assert m["markers.read_wait_share"] > 0


def test_one_parent_at_a_time_reads_nothing(traced, tmp_path, monkeypatch):
    """One parent's reader open at a time, on a fresh set of counters:
    the counter never appears, and the metric is left out of the line."""
    from hast_tpu_torch.pipeline import classify as C
    from hast_tpu_torch.utils import profiling as P
    monkeypatch.setattr(C, "_reader_width", lambda n: min(n, 1))
    monkeypatch.setattr(P, "COUNTERS", collections.Counter())
    m = traced(tmp_path, 2**31 + 91)
    assert NAME not in m
    assert P.COUNTERS["io.batches"] > 0
