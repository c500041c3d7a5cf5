"""markers.file_merge_ms: the fold that unions a parent's input files'
runs in a stage-00 key-range pass (``ops/kmer_count.py``
``PackedSpill.count_pass``: ``DeviceCounter.finalize_device`` over the
files' merged runs; with one file a parent, a refold of its one run),
the mean milliseconds a window job of the program's
``markers.file_merge`` spans.  None when the trace holds no such span."""

from portbench import program_spans as PS


def read(run):
    ms = PS.seconds(PS.program_spans(run), "markers.file_merge")
    if not ms or not run.jobs:
        return None
    return 1e3 * sum(ms) / run.jobs
