"""classify.decide_write_ms: the decision and write layer,
``write_phased_barcodes`` (``pipeline/classify.py``, through
``io/native.py`` ``decide_format_phased``): the mean milliseconds of the
benchmark's span around it, over the traced window's jobs."""


def read(run):
    ms = [s * 1e3 for s in run.span_seconds("classify.decide_write")]
    return sum(ms) / len(ms) if ms else None
