"""The human-scale classify cell, classify-human-gz: its job at a tiny
size on the CPU, its reference, its table's size by the program's own
rule, and its written bytes."""

import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.gen import stlfr
from portbench.jobs import classify as J
from portbench.tests import tiny
from portbench.tests.test_portbench_harness import _wchar

CELL = "classify-human-gz"


@pytest.fixture
def small(monkeypatch):
    """tiny.cell for the human job: classify's small sizes, near ties
    off."""
    monkeypatch.setitem(tiny.SMALL, "classify_human", tiny.SMALL["classify"])

    def cell(tmp, config=None, traffic=None):
        return tiny.cell(tmp, CELL, config=config,
                         traffic={**tiny.SMALL_TRAFFIC, **(traffic or {})})
    return cell


def test_the_tiny_cell_runs_correct(small, tmp_path):
    r = tiny.run(small(tmp_path), str(tmp_path))
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["phased_rows_wrong"]["value"] == 0


def test_a_traced_tiny_run_reads_the_table_metrics(small, tmp_path,
                                                   monkeypatch):
    """A traced run on the CPU (the session's CUDA calls stubbed): the
    build and upload seconds of set-up, and the classify readers the
    cell shares with classify-hbm-gz."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a, **k: None)
    c = small(tmp_path)
    names = [m["name"] for m, _ in c.per_layer]
    assert {"classify.table_build_s", "classify.table_upload_s",
            "classify.k3_roofline", "classify.read_wait_share",
            "classify.decide_write_ms", "classify.device_idle_share",
            "classify.reader_overlap_share"} == set(names)
    work = tmp_path / "work"
    work.mkdir()
    r = harness.run_cell(c, 3000000001, 0.5, True, "cpu", str(work),
                         time.perf_counter())
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["classify.table_build_s"] > 0
    assert m["classify.table_upload_s"] >= 0
    assert 0 < m["classify.read_wait_share"] < 1


def test_the_device_reference_gives_classify_references_bytes(small,
                                                              tmp_path):
    """classify.py's reference (a host sort of each set with the adaptor
    keys, then the erase) and the human job's (the erase alone, on the
    sets as drawn), on the same inputs; and the two controls alike."""
    c = small(tmp_path)
    run = harness.Run(c, 20261017, 0.0, "cpu", str(tmp_path))
    run.inputs = c.job.make_inputs(run)
    assert c.job.reference(run, run.inputs) == J.reference(run, run.inputs)
    assert c.job.control(run, run.inputs) == J.control(run, run.inputs)


def test_the_control_fails_at_a_size_where_float32_loses_a_unit(small,
                                                                 tmp_path):
    """Sets of 2^24 and 2^24 + 1 markers (float32 cannot tell them apart,
    the cell's 2e8 and 2e8 + 1 alike) and near-tie barcodes."""
    c = small(tmp_path, config={"markers_per_haplotype": 1 << 24,
                                "read_pairs": 3000},
              traffic={"near_tie_barcodes": 20})
    r = control.readings(c, 7, "cpu", str(tmp_path))
    assert r["phased_rows_wrong"][0] > 0


def test_near_ties_exist_at_the_cells_set_sizes():
    """The generator finds near-tie counts at 2e8 and 2e8 + 1 markers, so
    the control can fail at the cell's own size."""
    cfg = harness.resolve(harness.load_spec(), CELL).config
    n0 = cfg["markers_per_haplotype"]
    ties = stlfr.near_tie_counts(n0, n0 + cfg["hap1_extra_markers"],
                                 cfg["weight0"], cfg["weight1"])
    assert ties


def test_the_cells_keys_make_a_2_28_row_quot_table():
    """By build_table's own rule (hashtable.table_shape), without building
    it: 2 x 2e8 + 1 markers and the adaptor k-mers at the loader's load
    factor are a quot table of 2^28 rows, 4,294,967,296 bytes, filled
    0.37."""
    from hast_tpu_torch.ops import hashtable as H
    from hast_tpu_torch.pipeline import classify as C
    cfg = harness.resolve(harness.load_spec(), CELL).config
    adapt = stlfr.adaptor_keys((cfg["adaptor_f"], cfg["adaptor_r"]),
                               cfg["k"])
    n = 2 * cfg["markers_per_haplotype"] + cfg["hap1_extra_markers"] \
        + adapt.size
    fmt, n_buckets = H.table_shape(n, cfg["k"], C.LOAD)
    assert (fmt, n_buckets) == ("quot", 1 << 28)
    assert n_buckets * 16 == 4294967296
    assert round(n / (H.QUOT_BUCKET * n_buckets), 2) == 0.37


def test_a_run_writes_no_more_than_its_reckoned_bytes(small, tmp_path):
    if not os.path.exists("/proc/self/io"):
        pytest.skip("no /proc/self/io to count writes")
    c = small(tmp_path)
    before = _wchar()
    r = tiny.run(c, str(tmp_path))
    written = _wchar() - before
    assert r["correct"]
    assert written <= c.job.reckon_bytes(c.config, c.traffic,
                                         r["attempted"] + 1)


def test_a_full_size_run_reckons_a_few_gib_at_most():
    spec = harness.load_spec()
    c = harness.resolve(spec, CELL)
    jobs = 2 * spec["run_seconds"]
    assert c.job.reckon_bytes(c.config, c.traffic, jobs) < 3 << 30


def test_the_config_is_hg002_classify_but_for_the_markers():
    """hg002-classify's keys and values but markers_per_haplotype, the job
    and the texts that name them; read_pairs the one cut."""
    root = harness.ROOT
    with open(os.path.join(root, "portbench/configs/hg002-classify.json")) \
            as f:
        base = json.load(f)
    cfg = harness.resolve(harness.load_spec(), CELL).config
    texts = {"name", "job", "deployment", "source", "reduced", "layout",
             "table", "markers_basis", "left_out"}
    assert {k: v for k, v in cfg.items() if k not in texts
            and k != "markers_per_haplotype"} == \
        {k: v for k, v in base.items() if k not in texts
         and k != "markers_per_haplotype"}
    assert cfg["markers_per_haplotype"] == 200000000
    assert list(cfg["reduced"]) == ["read_pairs"]
    entry = {c["name"]: c for c in harness.load_spec()["configs"]}[
        "hg002-classify-human"]
    assert entry["reduced"] == ["read_pairs"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3100001711, 3100001712, 3100001713])
def test_control_fails_on_the_card_at_the_cells_size(seed, tmp_path):
    """getHap in float32 at 2e8 and 2e8 + 1 markers: the comparison
    fails it, on the card at the cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = harness.resolve(harness.load_spec(), CELL)
    r = control.readings(c, seed, "cuda", str(tmp_path))
    print(CELL, seed, r)
    assert r["phased_rows_wrong"][0] > 0
