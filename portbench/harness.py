"""The benchmark's driver: a cell of BENCHMARK.json, found by name, run
once.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file the harness finds by its name, so that a later change
adds a cell by adding files and entries:

* ``configs/<config>.json`` (the path BENCHMARK.json gives): the
  deployment's sizes; its ``job`` names the job module;
* ``traffic/<traffic>.json``: the traffic mix's parameters, read by the
  generator its job uses;
* ``jobs/<job>.py``: how inputs are made, the program set up, one whole
  job run, and its outputs judged against the plain reference
  (``reference/``).  It gives ``REQUIRED_LAUNCHES``, ``make_inputs``,
  ``setup``, ``job``, ``work``, ``release``, ``reference``, ``control``,
  ``compare`` and ``reckon_bytes``, and may give ``warm``;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``
  (None when it finds nothing to read), with optional ``arm(run)``
  before the traced window and ``measure(run)`` after it.

A run: set-up (inputs from the seed, the program's state, one whole job
to warm every shape), then whole jobs back to back until ``seconds``
have passed, then the comparison with the reference.  ``--trace 1``
runs the same window under torch.profiler and reports the per-layer
metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import sys
import time

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    job: object
    end_to_end: list
    per_layer: list          # (entry, module)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(spec: dict, workload: str, root: str = ROOT,
            bench_dir: str = BENCH_DIR) -> Cell:
    """The cell named workload, with its files found by name: the
    configuration where spec's entry says, under root; the traffic mix,
    job and metric readers under bench_dir."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    job = _load(os.path.join(bench_dir, "jobs", f"{config['job']}.py"),
                f"portbench_job_{config['job']}")
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = []
    for m in spec["per_layer"]:
        if m["moves"] in reported and _applies(m, workload):
            per_layer.append((m, _load(
                os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
                "portbench_metric_" + m["name"].replace(".", "_"))))
    return Cell(workload, w["chips"], config, traffic, job, e2e, per_layer)


class Run:
    """What a job and a metric reader see of one run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, device: str,
                 workdir: str):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.device = torch.device(device)
        self.workdir = workdir
        self.spans: list = []          # (name, start, end), host clock
        self.store: dict = {}          # the metric readers' own data
        self.summary = None            # the traced window (trace.summarize)
        self.launches = collections.Counter()   # the window's launches
        self.jobs = 0
        self.job_seconds: list = []
        self.inputs = None
        self.state = None
        self._annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        """A span around a call into the program; spans do not nest."""
        t0 = time.perf_counter()
        if self._annotate:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def span_seconds(self, name: str) -> list:
        return [e - s for n, s, e in self.spans if n == name]


@contextlib.contextmanager
def quiet():
    """The program's progress lines go nowhere while it runs."""
    with contextlib.redirect_stderr(io.StringIO()):
        yield


def _sync(run: Run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def _counts():
    from hast_tpu_torch.ops import _build
    return collections.Counter(_build.LAUNCHES), sum(
        _build.TWIN_CALLS.values())


def _window(run: Run, job, outputs: list, invalid: list) -> tuple:
    """Whole jobs until run.seconds have passed; (start, end, work)."""
    work = collections.Counter()
    t0 = time.perf_counter()
    while True:
        before, twins = _counts()
        t_job = time.perf_counter()
        with quiet():
            outputs.append(job.job(run, run.state, run.jobs))
        _sync(run)
        run.job_seconds.append(time.perf_counter() - t_job)
        after, twins_after = _counts()
        run.launches += after - before
        if run.device.type == "cuda" and (
                twins_after != twins or any(
                    after[k] == before[k] for k in job.REQUIRED_LAUNCHES)):
            invalid.append(run.jobs)
        work.update(job.work(run, run.state))
        run.jobs += 1
        t1 = time.perf_counter()
        if t1 - t0 >= run.seconds:
            return t0, t1, work


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, workdir: str, t_start: float) -> dict:
    """One run of the cell; the result line's fields and the checks."""
    job = cell.job
    run = Run(cell, seed, seconds, device, workdir)
    cuda = run.device.type == "cuda"
    marks = [time.perf_counter()]
    run.inputs = job.make_inputs(run)
    if cuda:
        # the inputs are the benchmark's: the peak from here on is the
        # program's own
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)
    marks.append(time.perf_counter())
    with quiet():
        run.state = job.setup(run, run.inputs)
        _sync(run)
        marks.append(time.perf_counter())
        # warm every shape: the job module's own warm-up, else a job
        getattr(job, "warm", lambda r, s: job.job(r, s, -1))(run, run.state)
    _sync(run)
    # the inputs just written reach the disk now: no writeback of them
    # runs in the window
    os.sync()
    marks.append(time.perf_counter())
    print("portbench: set-up s: start %.3f, inputs %.3f, program %.3f, "
          "warm-up job %.3f" % (marks[0] - t_start, *(
              b - a for a, b in zip(marks, marks[1:]))), file=sys.stderr)
    run.spans.clear()
    peak_setup = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    outputs, invalid = [], []
    if trace:
        from portbench import trace as T
        for _, mod in cell.per_layer:
            if hasattr(mod, "arm"):
                mod.arm(run)
        session = T.Session(os.path.join(workdir, "trace.json"))
        run._annotate = True
        with session:
            with torch.profiler.record_function(T.WINDOW):
                t0, t1, work = _window(run, job, outputs, invalid)
        run._annotate = False
        run.summary = session.summary
    else:
        t0, t1, work = _window(run, job, outputs, invalid)
    peak_window = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    metrics = {}
    if trace:
        for entry, mod in cell.per_layer:
            if hasattr(mod, "measure"):
                mod.measure(run)
            value = mod.read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        for m in cell.end_to_end:
            name = m["name"]
            if name == "setup_s":
                value = t0 - t_start
            elif name == "device_peak_gib":
                value = peak_window / GIB
            elif name in work:
                value = work[name] / (t1 - t0)
            else:
                raise KeyError(f"cell {cell.name} reports {name}, which "
                               f"its job does not measure")
            metrics[name] = {"value": value, "unit": m["unit"]}
    # the program's state goes before the reference runs
    job.release(run, run.state)
    run.state = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    expected = job.reference(run, run.inputs)
    checks, failed = job.compare(run, expected, outputs)
    js = sorted(run.job_seconds)
    print("portbench: %d jobs in %.3f s (a job %.3f, %.3f, %.3f s: least, "
          "median, most); reference and comparison %.3f s"
          % (run.jobs, t1 - t0, js[0], js[len(js) // 2], js[-1],
             time.perf_counter() - t_ref), file=sys.stderr)
    if cuda:
        checks.append(("jobs_invalid", len(invalid), 0))
        failed = len(set(failed) | set(invalid))
    else:
        failed = len(failed)
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": run.jobs, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(run.device)
                   if cuda else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": max(peak_setup, peak_window)}}
    if trace:
        result["device"]["busy_s"] = run.summary["busy_s"]
        result["device"]["window_s"] = run.summary["window_s"]
        result["breakdown"] = run.summary["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result
