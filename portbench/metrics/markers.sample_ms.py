"""markers.sample_ms: the stage-00 boundary sample
(``ops/kmer_count.py`` ``sample_boundaries``: a strided sample of the
maternal reads' batches, their window keys sorted on the device, the
quantiles of the key-range passes), the mean milliseconds a window job
of the program's ``markers.sample_boundaries`` spans.  None when the
trace holds no such span."""

from portbench import program_spans as PS


def read(run):
    ms = PS.seconds(PS.program_spans(run), "markers.sample_boundaries")
    if not ms or not run.jobs:
        return None
    return 1e3 * sum(ms) / run.jobs
