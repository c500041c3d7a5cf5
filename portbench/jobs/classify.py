"""Stage 01 classify (``classify-reads`` step 9) on a resident marker
table: one job is ``classify_fastqs`` over the library's R1 and R2 files
into a fresh tally, then ``write_phased_barcodes`` to a file.

Set-up builds the table as ``load_marker_table`` does after its text
parse (``build_table`` of both sets with the adaptor k-mers in them, at
the loader's load factor), erases the adaptors and moves the table to
the card.  The reference (``reference/classify.py``) starts from the
same key sets and the generated reads, and the comparison counts the
rows of each job's ``phased.barcodes`` that differ from its rows.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.gen import stlfr
from portbench.jobs import lines_wrong
from portbench.reference import classify as R

REQUIRED_LAUNCHES = ("classify_tally",)     # K3


def make_inputs(run) -> dict:
    sets = stlfr.marker_sets(run.cfg, run.seed, run.device)
    lib = stlfr.make_library(run.cfg, run.traffic, run.seed, sets,
                             run.workdir)
    # the sets wait on the host: the window holds only the program's state
    lib["sets"] = {h: sets[h].cpu() for h in ("hap0", "hap1")}
    lib["adaptor"] = sets["adaptor"]
    return lib


def _with_adaptors(keys: torch.Tensor, adaptor: np.ndarray) -> np.ndarray:
    return np.concatenate([keys.numpy(), adaptor])


def setup(run, inputs) -> dict:
    from hast_tpu_torch.ops import hashtable as H
    from hast_tpu_torch.pipeline import classify as C
    cfg = run.cfg
    files = [_with_adaptors(inputs["sets"][h], inputs["adaptor"])
             for h in ("hap0", "hap1")]
    keys = np.concatenate(files)
    table = H.build_table(
        (keys >> 32).astype(np.uint32), (keys & 0xFFFFFFFF).astype(np.uint32),
        np.concatenate([np.full(files[0].size, 1, np.uint32),
                        np.full(files[1].size, 2, np.uint32)]),
        cfg["k"], load=C.LOAD, set_sizes=tuple(f.size for f in files))
    C.erase_adaptors(table, cfg["adaptor_f"], cfg["adaptor_r"])
    return {"table": table.to(run.device), "paths": inputs["paths"]}


def job(run, state, i: int) -> str:
    from hast_tpu_torch.pipeline import classify as C
    cfg = run.cfg
    out = os.path.join(run.workdir, f"phased.barcodes.{i}")
    with run.span("classify.stream"):
        tally = C.classify_fastqs(state["table"], state["paths"],
                                  batch_size=cfg["batch_size"],
                                  engine="native")
    with run.span("classify.decide_write"):
        with open(out, "wb") as f:
            C.write_phased_barcodes(tally, state["table"], f,
                                    cfg["weight0"], cfg["weight1"])
    return out


def work(run, state) -> dict:
    return {"classify_reads_per_s": run.inputs["reads"].shape[0]}


def release(run, state) -> None:
    state.clear()


def reference(run, inputs, dtype=np.float64) -> bytes:
    """The phased.barcodes bytes the job must write; dtype float32 gives
    the control."""
    cfg = run.cfg
    s0, s1 = (R.erase(torch.from_numpy(np.sort(_with_adaptors(
        inputs["sets"][h], inputs["adaptor"]))).to(run.device),
        inputs["adaptor"]) for h in ("hap0", "hap1"))
    reads = inputs["reads"]
    lengths = np.full(reads.shape[0], reads.shape[1], np.int64)
    v0, v1, _ = R.votes(reads, lengths, cfg["k"], s0, s1)
    return R.phased_bytes(inputs["names"], inputs["bc"], v0, v1, s0.numel(),
                          s1.numel(), cfg["weight0"], cfg["weight1"], dtype)


def control(run, inputs) -> bytes:
    """The reference with its one floating step, getHap, in float32."""
    return reference(run, inputs, np.float32)


def compare(run, expected: bytes, outputs: list) -> tuple[list, list]:
    """Rows of each job's phased.barcodes unlike the reference's."""
    worst, failed = 0, []
    for i, out in enumerate(outputs):
        if isinstance(out, bytes):
            got = out
        else:
            with open(out, "rb") as f:
                got = f.read()
        wrong = lines_wrong(got, expected)
        if wrong:
            failed.append(i)
        worst = max(worst, wrong)
    return [("phased_rows_wrong", worst, 0)], failed


def reckon_bytes(cfg: dict, traffic: dict, jobs: int) -> int:
    """Bytes a run writes at most: the two fastq files (plain size, the
    gzip files are smaller), each job's phased.barcodes (a row of at most
    40 bytes a barcode; barcodes hold pairs_per_barcode_mean pairs on
    average, and a few are near ties) and the trace."""
    pairs = cfg["read_pairs"]
    record = 2 * cfg["read_len"] + 36
    rows = 2 * pairs // traffic["pairs_per_barcode_mean"] \
        + traffic["near_tie_barcodes"] + 64
    return 2 * pairs * record + (jobs + 1) * 40 * rows + (256 << 20)
