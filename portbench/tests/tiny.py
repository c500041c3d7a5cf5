"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
program's plain PyTorch twins stand in for its kernels there."""

from __future__ import annotations

import json
import os
import shutil

from portbench import harness

SMALL = {
    "classify": {"markers_per_haplotype": 20000, "read_pairs": 6000,
                 "batch_size": 1024},
    "markers": {"genome_length": 30000, "satellite_length": 3000},
}
SMALL_TRAFFIC = {"near_tie_barcodes": 0}


def cell(tmp, workload: str, config=None, traffic=None, spec=None):
    """The workload's cell with its configuration and traffic written to
    tmp at SMALL sizes (and the given overrides)."""
    spec = spec or harness.load_spec()
    w = {x["name"]: x for x in spec["workloads"]}[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    cfg.update(SMALL[cfg["job"]], **(config or {}))
    path = os.path.join(tmp, entry["file"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f)
    bench = os.path.join(tmp, "portbench")
    with open(os.path.join(harness.BENCH_DIR, "traffic",
                           f"{w['traffic']}.json")) as f:
        tr = json.load(f)
    if cfg["job"] == "classify":
        tr.update(SMALL_TRAFFIC)
    tr.update(traffic or {})
    os.makedirs(os.path.join(bench, "traffic"), exist_ok=True)
    with open(os.path.join(bench, "traffic", f"{w['traffic']}.json"),
              "w") as f:
        json.dump(tr, f)
    for d in ("jobs", "metrics"):
        if not os.path.isdir(os.path.join(bench, d)):
            shutil.copytree(os.path.join(harness.BENCH_DIR, d),
                            os.path.join(bench, d))
    return harness.resolve(spec, workload, root=str(tmp), bench_dir=bench)


def run(c, tmp, seed: int = 20261017, seconds: float = 0.5) -> dict:
    work = os.path.join(tmp, "work")
    os.makedirs(work, exist_ok=True)
    return harness.run_cell(c, seed, seconds, False, "cpu", work, 0.0)
