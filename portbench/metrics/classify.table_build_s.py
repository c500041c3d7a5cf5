"""classify.table_build_s: the marker table's host build, ``build_table``
(``hast_tpu_torch/ops/hashtable.py``: the sort and merge of both sets'
keys, the 2-choice placement), in seconds of the host clock around the
call in the run's set-up (``jobs/classify_human.py`` keeps it in
``run.store``).  None when the job keeps no such reading."""


def read(run):
    return run.store.get("table_build_s")
