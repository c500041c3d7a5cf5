"""The harness: no JAX, everything found by name, bounded writes."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

ROOT = harness.ROOT

_GUARD = r"""
import json, sys, tempfile
sys.path.insert(0, sys.argv[1])
from portbench import harness, run
from portbench.tests import tiny
with tempfile.TemporaryDirectory() as tmp:
    for w in ("classify-hbm-gz", "markers-parts4"):
        r = tiny.run(tiny.cell(tmp + "/" + w, w), tmp + "/" + w)
        assert r["correct"], r
print(json.dumps(run.loaded_blocked()))
"""


def test_nothing_the_harness_runs_loads_jax_or_the_jax_package():
    """A run of two cells, in a process where JAX could load: afterwards no
    module of top-level name jax, jaxlib, flax or hast_tpu is loaded."""
    out = subprocess.run([sys.executable, "-c", _GUARD, ROOT],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_blocked_names_compare_whole_top_level_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "hast_tpu_torch_lookalike",
                        sys.modules["json"])
    assert "hast_tpu_torch_lookalike" not in run.loaded_blocked()
    monkeypatch.setitem(sys.modules, "hast_tpu.ops", sys.modules["json"])
    assert run.loaded_blocked() == ["hast_tpu.ops"]


def test_run_exits_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "classify-hbm-gz", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    if out.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert out.stdout == ""


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    spec = harness.load_spec()
    spec["configs"].append({"name": "tiny-new", "source": "a test",
                            "file": "portbench/configs/tiny-new.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-new.cell", "config": "tiny-new",
                              "traffic": "tiny-mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "tiny.jobs_seen", "unit": "jobs",
                              "better": "higher", "source": "program_span",
                              "layer": "test", "moves":
                              "classify_reads_per_s",
                              "workloads": ["tiny-new.cell"]})
    spec["end_to_end"][0]["workloads"].append("tiny-new.cell")
    bench = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True)
    cfg = json.loads((pathlib_root() / "portbench" / "configs" /
                      "hg002-classify.json").read_text())
    cfg.update(tiny.SMALL["classify"], read_pairs=3000)
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    tr = json.loads((pathlib_root() / "portbench" / "traffic" /
                     "stlfr-fq.json").read_text())
    tr.update(near_tie_barcodes=0, pairs_per_barcode_mean=5)
    (bench / "traffic" / "tiny-mix.json").write_text(json.dumps(tr))
    shutil.copytree(pathlib_root() / "portbench" / "jobs", bench / "jobs")
    (bench / "metrics" / "tiny.jobs_seen.py").write_text(
        "def read(run):\n    return run.jobs\n")
    cell = harness.resolve(spec, "tiny-new.cell", root=str(tmp_path),
                           bench_dir=str(bench))
    assert cell.config["read_pairs"] == 3000
    assert cell.traffic["pairs_per_barcode_mean"] == 5
    names = [m["name"] for m, _ in cell.per_layer]
    # the cell's own metric; the others list their cells
    assert names == ["tiny.jobs_seen"]
    r = tiny.run(cell, str(tmp_path))
    assert r["correct"] and r["attempted"] >= 1
    assert cell.per_layer[-1][1].read(_Seen(r["attempted"])) == r["attempted"]


class _Seen:
    def __init__(self, jobs):
        self.jobs = jobs


def pathlib_root():
    import pathlib
    return pathlib.Path(ROOT)


def _wchar() -> int:
    with open("/proc/self/io") as f:
        return int(next(x for x in f if x.startswith("wchar")).split()[1])


@pytest.mark.parametrize("workload", ["classify-hbm-gz", "markers-parts4"])
def test_a_run_writes_no_more_than_its_reckoned_bytes(tmp_path, workload):
    if not os.path.exists("/proc/self/io"):
        pytest.skip("no /proc/self/io to count writes")
    c = tiny.cell(tmp_path, workload)
    before = _wchar()
    r = tiny.run(c, str(tmp_path))
    written = _wchar() - before
    assert r["correct"]
    assert written <= c.job.reckon_bytes(c.config, c.traffic,
                                         r["attempted"] + 1)


@pytest.mark.parametrize("workload", ["classify-hbm-gz", "markers-parts4"])
def test_a_full_size_run_reckons_a_few_gib_at_most(workload):
    spec = harness.load_spec()
    c = harness.resolve(spec, workload)
    # a run of run_seconds holds at most a job every 0.5 s
    jobs = 2 * spec["run_seconds"]
    assert c.job.reckon_bytes(c.config, c.traffic, jobs) < 3 << 30
