"""classify.reader_overlap_share: how much of the classify reader's work
ran with more than one file's reader open: the batches the program took
while another file's libhastio reader of the same ``classify_fastqs``
call was open, ``COUNTERS["classify.overlapped_batches"]`` of
``hast_tpu_torch.utils.profiling``, over the batches its native readers
handed over, ``COUNTERS["io.batches"]``, in the traced window's jobs.
Both counts are taken by a wrapper around the job module's ``job`` for
the traced window, so the batches of what runs after it are not in them.
None when the program counts no overlapped batch at all (it opens one
reader at a time) or the trace holds no program span."""

from portbench import program_spans as PS

KEY = "classify.reader_overlap_share"
NAMES = ("classify.overlapped_batches", "io.batches")


def arm(run) -> None:
    try:
        from hast_tpu_torch.utils.profiling import COUNTERS
    except ImportError:        # a program without counters
        return
    mod = run.cell.job
    real = mod.job
    grew = []

    def counted(*args, **kwargs):
        before = [COUNTERS[n] for n in NAMES]
        try:
            return real(*args, **kwargs)
        finally:
            grew.append([COUNTERS[n] - b for n, b in zip(NAMES, before)])

    mod.job = counted
    run.store[KEY] = (real, grew, COUNTERS)


def measure(run) -> None:
    if KEY in run.store:
        run.cell.job.job = run.store[KEY][0]


def read(run):
    _, grew, counters = run.store.get(KEY, (None, [], {}))
    if NAMES[0] not in counters or not PS.program_spans(run):
        return None
    overlapped, batches = (sum(g[i] for g in grew) for i in (0, 1))
    return overlapped / batches if batches else None
