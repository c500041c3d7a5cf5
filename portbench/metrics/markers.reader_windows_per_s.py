"""markers.reader_windows_per_s: the stage-00 reader layer alone,
libhastio's ``NativeCountReader`` opened through
``ops/kmer_count.open_count_reader`` as the job's count does (its batch,
the ACGT test of each batch), over both parents' files one after the
other, with no device work: k-mer windows a second.  Measured once after
the traced window."""

import time

import numpy as np


def measure(run) -> None:
    from hast_tpu_torch.ops import kmer_count as KC
    k = run.cfg["k"]
    n = 0
    t0 = time.perf_counter()
    for path, _ in run.inputs.values():
        reader = KC.open_count_reader(path, run.cfg["batch_size"])
        try:
            for b in reader:
                KC.batch_is_clean(b.good, b.lengths)
                n += int(np.maximum(b.lengths[:b.n] - k + 1, 0).sum())
        finally:
            reader.close()
    run.store["markers.reader_windows_per_s"] = n / (time.perf_counter()
                                                     - t0)


def read(run):
    return run.store.get("markers.reader_windows_per_s")
