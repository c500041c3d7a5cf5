"""markers.reads_per_input_read: the stage-00 passes' re-reads
(``pipeline/markers.py`` ``_markers_partitioned``: 1.0 where each
parent is read once a job into a spill and the key-range passes and the
boundary sample read the spill): the reads the program's native readers
handed over in the traced window's jobs, ``COUNTERS["io.reads"]`` of
``hast_tpu_torch.utils.profiling``, over the jobs' input reads (both
parents' a job).  The count is taken by a wrapper around the job module's
``job`` for the traced window, so the reads of what runs after it are
not in it.  None when the program has no such counter or the trace no
program span."""

from portbench import program_spans as PS

KEY = "markers.reads_per_input_read"


def arm(run) -> None:
    try:
        from hast_tpu_torch.utils.profiling import COUNTERS
    except ImportError:        # a program without counters
        return
    mod = run.cell.job
    real = mod.job
    grew = []

    def counted(*args, **kwargs):
        before = COUNTERS["io.reads"]
        try:
            return real(*args, **kwargs)
        finally:
            grew.append(COUNTERS["io.reads"] - before)

    mod.job = counted
    run.store[KEY] = (real, grew)


def measure(run) -> None:
    if KEY in run.store:
        run.cell.job.job = run.store[KEY][0]


def read(run):
    grew = run.store.get(KEY, (None, []))[1]
    if not grew or not PS.program_spans(run):
        return None
    inputs = sum(r.shape[0] for _, r in run.inputs.values())
    return sum(grew) / (len(grew) * inputs)
