"""Stage 01 classify at HAST's human operating point: the job of
``classify.py`` (``make_inputs``, ``classify_fastqs`` and
``write_phased_barcodes``, the same comparison, work and written bytes)
on a table of 2 x 2e8 markers, 2^28 rows resident on the card.

What changes with the size is around the job:

* set-up builds the table as ``load_marker_table`` does after its text
  parse, from key arrays written in place, and keeps the host seconds of
  ``build_table`` and of ``KmerTable.to`` in ``run.store``
  (``table_build_s``, ``table_upload_s``), which the harness keeps past
  set-up;
* the reference erases the adaptor keys from the sorted sets on the
  device: the same sets as ``classify.py``'s host sort of each set with
  the adaptor keys, without sorting 2e8 keys a set on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# classify.py's inputs, job, comparison, work and bytes, found here by
# the harness
from portbench.jobs.classify import (  # noqa: F401
    REQUIRED_LAUNCHES, compare, job, make_inputs, reckon_bytes, release,
    work)
from portbench.reference import classify as R


def _table_keys(inputs) -> tuple:
    """(hi, lo, payload, set sizes) of both sets with the adaptor k-mers
    in each, in classify.py's order (hap0, adaptors, hap1, adaptors),
    written into arrays of the whole size."""
    adapt = inputs["adaptor"]
    sets = [inputs["sets"][h].numpy() for h in ("hap0", "hap1")]
    sizes = tuple(s.size + adapt.size for s in sets)
    hi, lo, pay = (np.empty(sum(sizes), np.uint32) for _ in range(3))
    at = 0
    for h, s in enumerate(sets):
        pay[at:at + sizes[h]] = h + 1
        for part in (s, adapt):
            hi[at:at + part.size] = part >> 32
            lo[at:at + part.size] = part & 0xFFFFFFFF
            at += part.size
    return hi, lo, pay, sizes


def setup(run, inputs) -> dict:
    from hast_tpu_torch.ops import hashtable as H
    from hast_tpu_torch.pipeline import classify as C
    cfg = run.cfg
    hi, lo, pay, sizes = _table_keys(inputs)
    t0 = time.perf_counter()
    table = H.build_table(hi, lo, pay, cfg["k"], load=C.LOAD,
                          set_sizes=sizes)
    run.store["table_build_s"] = time.perf_counter() - t0
    del hi, lo, pay
    C.erase_adaptors(table, cfg["adaptor_f"], cfg["adaptor_r"])
    t0 = time.perf_counter()
    table = table.to(run.device)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.store["table_upload_s"] = time.perf_counter() - t0
    return {"table": table, "paths": inputs["paths"]}


def reference(run, inputs, dtype=np.float64) -> bytes:
    """The phased.barcodes bytes the job must write; dtype float32 gives
    the control."""
    cfg = run.cfg
    s0, s1 = (R.erase(inputs["sets"][h].to(run.device), inputs["adaptor"])
              for h in ("hap0", "hap1"))
    reads = inputs["reads"]
    lengths = np.full(reads.shape[0], reads.shape[1], np.int64)
    v0, v1, _ = R.votes(reads, lengths, cfg["k"], s0, s1)
    return R.phased_bytes(inputs["names"], inputs["bc"], v0, v1, s0.numel(),
                          s1.numel(), cfg["weight0"], cfg["weight1"], dtype)


def control(run, inputs) -> bytes:
    """The reference with its one floating step, getHap, in float32."""
    return reference(run, inputs, np.float32)
