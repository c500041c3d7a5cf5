"""markers.read_wait_share: the stage-00 reader layer from inside the
job, the share of the traced window the job's thread spent in the
program's ``io.read_wait`` spans (``io/native.py`` ``NativeCountReader``
in the count passes, ``NativeFastqReader`` in the boundary sample):
blocked until libhastio's parse thread handed over the next batch, and
the batch's copy out of its buffer.  None when the trace holds no
program span."""

from portbench import program_spans as PS


def read(run):
    spans = PS.program_spans(run)
    if not spans:
        return None
    return sum(PS.seconds(spans, "io.read_wait")) / run.summary["window_s"]
