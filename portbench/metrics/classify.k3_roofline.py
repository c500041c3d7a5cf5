"""classify.k3_roofline: K3 ``classify_tally`` (``ops/csrc/classify.cu``)
against its bound, in percent: the frozen bound of ``roofline.py`` for
the window's reads (two 16-byte table rows a probed window, the packed
reads and their lengths, ids and N flags, each file's tally of its
barcodes read and written once) over K3's device time in the traced
window.  Nothing is read unless the trace holds a record of every K3
launch the window made."""

import numpy as np

from portbench import roofline

KERNEL = "classify_tally_kernel"


def arm(run) -> None:
    reads = run.inputs["reads"]
    k, L = run.cfg["k"], reads.shape[1]
    clean = int((~(reads == ord("N")).any(axis=1)).sum())
    half = reads.shape[0] // 2
    barcodes = sum(np.unique(run.inputs["names"][run.inputs["bc"][s]]).size
                   for s in (slice(0, half), slice(half, None)))
    run.store["k3_bound_ms_a_job"] = roofline.k3_bound_ms(
        reads.shape[0], reads.shape[0] * (-(-L // 16) * 4), barcodes,
        clean * max(0, L - k + 1))


def read(run):
    recs = [d for n, _, d in run.summary["device"] if KERNEL in n]
    if not recs or len(recs) != run.launches["classify_tally"]:
        return None
    device_ms = sum(recs) / 1e3
    return 100.0 * run.store["k3_bound_ms_a_job"] * run.jobs / device_ms
