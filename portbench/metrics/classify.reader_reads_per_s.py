"""classify.reader_reads_per_s: the reader layer alone, libhastio's
``NativeFastqReader`` (``io/native.py``) as the job drives it (packed
rows, the job's batch, the first read-length cap) over the job's R1 and
R2 files, with no device work: reads a second.  Measured once after the
traced window, the files in the page cache as the jobs find them."""

import time


def measure(run) -> None:
    from hast_tpu_torch.io import native as N
    from hast_tpu_torch.pipeline import classify as C
    n = 0
    t0 = time.perf_counter()
    for path in run.inputs["paths"]:
        reader = N.NativeFastqReader(path, run.cfg["batch_size"],
                                     len_cap=C.LEN_CAPS[0], packed=True)
        try:
            for batch in reader:
                n += batch.n
        finally:
            reader.close()
    run.store["classify.reader_reads_per_s"] = n / (time.perf_counter() - t0)


def read(run):
    return run.store.get("classify.reader_reads_per_s")
