"""classify.table_upload_s: the marker table's copy to the card,
``KmerTable.to`` (``hast_tpu_torch/ops/hashtable.py``), in seconds of
the host clock around the call and a synchronize in the run's set-up
(``jobs/classify_human.py`` keeps it in ``run.store``).  None when the
job keeps no such reading."""


def read(run):
    return run.store.get("table_upload_s")
