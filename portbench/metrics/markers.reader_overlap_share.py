"""markers.reader_overlap_share: how much of the stage-00 reader's work
ran with both parents' readers open: the batches the program took while
another parent's libhastio counting reader was open,
``COUNTERS["markers.overlapped_batches"]`` of
``hast_tpu_torch.utils.profiling``, over the batches its native readers
handed over, ``COUNTERS["io.batches"]``, in the traced window's jobs.
Both counts are taken by a wrapper around the job module's ``job`` for
the traced window, so the batches of what runs after it (the reader
alone, for ``markers.reader_windows_per_s``) are not in them.  None when
the program counts no overlapped batch at all (it opens one parent's
reader at a time) or the trace holds no program span."""

from portbench import program_spans as PS

KEY = "markers.reader_overlap_share"
NAMES = ("markers.overlapped_batches", "io.batches")


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
    run.store[KEY] = (real, grew, COUNTERS, counted)


def measure(run) -> None:
    """Unwrap the job, unless a wrapper armed before this one already
    put back the job beneath both."""
    if KEY in run.store:
        real, _, _, counted = run.store[KEY]
        if run.cell.job.job is counted:
            run.cell.job.job = real


def read(run):
    _, grew, counters, _ = run.store.get(KEY, (None, [], {}, None))
    if NAMES[0] not in counters or not PS.program_spans(run):
        return None
    overlapped, batches = (sum(g[i] for g in grew) for i in (0, 1))
    return overlapped / batches if batches else None
