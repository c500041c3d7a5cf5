"""markers.readers_open_mean: how many input files the stage-00 reader
kept open while it took its batches (``ops/kmer_count.py``
``read_in_turn``, a lane a file, every input file of the job open at
once up to the reader width):
the growth of ``COUNTERS["markers.open_readers"]`` of
``hast_tpu_torch.utils.profiling`` (the files open at each turn that
took a batch) over that of ``COUNTERS["markers.turns"]`` (those turns)
across the traced window's jobs.  Both counts are taken by a wrapper
around the job module's ``job`` for the traced window.  None when the
program has no such counter or the trace no program span."""

from portbench import program_spans as PS

KEY = "markers.readers_open_mean"
NAMES = ("markers.open_readers", "markers.turns")


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
    if NAMES[1] not in counters or not PS.program_spans(run):
        return None
    opened, turns = (sum(g[i] for g in grew) for i in (0, 1))
    return opened / turns if turns else None
