"""Stage 00 on paired libraries (``build-markers --auto_bounds``, device
engine): one job is ``build_unshared_markers`` over both files, R1 and
R2, of each parent's gzipped paired-end library into a fresh directory,
with the traffic's ``count_parts`` key-range passes.

The plain reference (``reference/markers.py``) counts the union of a
parent's two files' reads, which is what the program must give; the
comparison, the control and the launches a job must make are those of
``jobs/markers.py``.
"""

from __future__ import annotations

import io
import os

from portbench.gen import parents_pe as PE
from portbench.jobs.markers import (FILES, REQUIRED_LAUNCHES, compare,  # noqa: F401
                                    control, reference, release, work)


def make_inputs(run) -> dict:
    return PE.make_parents(run.cfg, run.seed, run.workdir)


def setup(run, inputs) -> dict:
    return {"paths": {p: list(inputs[p][0]) for p in PE.PARENTS}}


def job(run, state, i: int, n_parts: int | None = None):
    from hast_tpu_torch.pipeline import markers as M
    cfg = run.cfg
    out = os.path.join(run.workdir, f"job{i}")
    os.makedirs(out)
    log = io.StringIO()
    with run.span("markers.build"):
        M.build_unshared_markers(
            state["paths"]["paternal"], state["paths"]["maternal"], out,
            k=cfg["k"], auto_bounds=True, batch_size=cfg["batch_size"],
            log=log, n_parts=n_parts or run.traffic["count_parts"],
            engine="device", device=run.device)
    return out, log.getvalue()


def warm(run, state) -> None:
    """A one-pass job: every kernel and all four files warm."""
    job(run, state, -1, n_parts=1)


def reckon_bytes(cfg: dict, traffic: dict, jobs: int) -> int:
    """Bytes a run writes at most: both parents' gzipped files (no
    larger than the fastq they hold), each job's files (at most one
    marker line a read) and the trace."""
    reads = int(cfg["genome_length"] * cfg["coverage"] / cfg["read_len"])
    record = 2 * cfg["read_len"] + 18
    per_job = 2 * reads * (cfg["k"] + 1) // 8 + (1 << 20)
    return 2 * reads * record + (jobs + 1) * per_job + (256 << 20)
