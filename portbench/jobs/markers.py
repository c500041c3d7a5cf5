"""Stage 00 (``build-markers --auto_bounds``, device engine): one job is
``build_unshared_markers`` over both parents' fastq files into a fresh
directory, with the traffic's ``count_parts`` key-range passes.

The reference (``reference/markers.py``) counts the generated reads
itself; the comparison counts the lines of each job's six files
(``.unique.filter.mer``, ``.kmercount.histo``, ``.bounds.txt`` of both
parents) that differ from its lines, and the gap between each parent's
distinct and total k-mers as the job's log states them and as the
reference counts them: the total is what a narrower count gets wrong.
"""

from __future__ import annotations

import io
import os
import re

import numpy as np

from portbench.gen import parents as P
from portbench.jobs import lines_wrong
from portbench.reference import markers as R

# K4 count_windows, K5 sort_pairs, K6 fold_runs, K7 count_stats, K8
# marker_filter
REQUIRED_LAUNCHES = ("count_windows", "sort_pairs", "fold_runs",
                     "count_stats", "marker_filter")
FILES = tuple(f"{p}.{x}" for p in P.PARENTS for x in (
    "unique.filter.mer", "kmercount.histo", "bounds.txt"))
_TOTALS = re.compile(rb"^\s*(paternal|maternal): (\d+) distinct / (\d+) "
                     rb"total", re.M)


def make_inputs(run) -> dict:
    return P.make_parents(run.cfg, run.seed, run.workdir)


def setup(run, inputs) -> dict:
    return {"paths": {p: inputs[p][0] for p in P.PARENTS}}


def job(run, state, i: int, n_parts: int | None = None):
    from hast_tpu_torch.pipeline import markers as M
    cfg = run.cfg
    out = os.path.join(run.workdir, f"job{i}")
    os.makedirs(out)
    log = io.StringIO()
    with run.span("markers.build"):
        M.build_unshared_markers(
            [state["paths"]["paternal"]], [state["paths"]["maternal"]], out,
            k=cfg["k"], auto_bounds=True, batch_size=cfg["batch_size"],
            log=log, n_parts=n_parts or run.traffic["count_parts"],
            engine="device", device=run.device)
    return out, log.getvalue()


def warm(run, state) -> None:
    """A one-pass job: every kernel and both files warm, in a twentieth
    of a --count-parts 4 job's time."""
    job(run, state, -1, n_parts=1)


def windows(run) -> int:
    L, k = run.cfg["read_len"], run.cfg["k"]
    return sum(r.shape[0] for _, r in run.inputs.values()) * (L - k + 1)


def work(run, state) -> dict:
    return {"markers_windows_per_s": windows(run)}


def release(run, state) -> None:
    state.clear()


def _parents(run, inputs) -> dict:
    return {p: (r, np.full(r.shape[0], r.shape[1], np.int64))
            for p, (_, r) in inputs.items()}


def reference(run, inputs, count_bits=None) -> dict:
    return R.build(_parents(run, inputs), run.cfg["k"], run.device,
                   count_bits=count_bits)


def control(run, inputs) -> dict:
    """The reference with each count held in the 21 bits that ride above
    a 2k + 1-bit key in one 64-bit word at k = 21 (63 - 2k)."""
    return reference(run, inputs, count_bits=63 - 2 * run.cfg["k"])


def compare(run, expected: dict, outputs: list) -> tuple[list, list]:
    """outputs: (directory, log) a job, or a reference-shaped dict."""
    worst = {"mer_lines_wrong": 0, "histo_lines_wrong": 0,
             "bounds_lines_wrong": 0, "distinct_gap": 0, "total_gap": 0}
    failed = []
    for i, out in enumerate(outputs):
        if isinstance(out, dict):
            files, totals = out, out["totals"]
        else:
            files = {}
            for name in FILES:
                path = os.path.join(out[0], name)
                files[name] = open(path, "rb").read() \
                    if os.path.exists(path) else b""
            totals = {m[0].decode(): (int(m[1]), int(m[2]))
                      for m in _TOTALS.findall(out[1].encode())}
        got = {"mer_lines_wrong": 0, "histo_lines_wrong": 0,
               "bounds_lines_wrong": 0, "distinct_gap": 0, "total_gap": 0}
        for name in FILES:
            key = {"mer": "mer_lines_wrong", "histo": "histo_lines_wrong",
                   "txt": "bounds_lines_wrong"}[name.rsplit(".", 1)[1]]
            got[key] += lines_wrong(files[name], expected[name])
        for p in P.PARENTS:
            d, t = totals.get(p, (0, 0))
            got["distinct_gap"] += abs(d - expected["totals"][p][0])
            got["total_gap"] += abs(t - expected["totals"][p][1])
        if any(got.values()):
            failed.append(i)
        for key, v in got.items():
            worst[key] = max(worst[key], v)
    return [(k, v, 0) for k, v in worst.items()], failed


def reckon_bytes(cfg: dict, traffic: dict, jobs: int) -> int:
    """Bytes a run writes at most: both parents' fastq, each job's files
    (at most one marker line a read) and the trace."""
    reads = int(cfg["genome_length"] * cfg["coverage"] / cfg["read_len"])
    record = 2 * cfg["read_len"] + 16
    per_job = 2 * reads * (cfg["k"] + 1) // 8 + (1 << 20)
    return 2 * reads * record + (jobs + 1) * per_job + (256 << 20)
