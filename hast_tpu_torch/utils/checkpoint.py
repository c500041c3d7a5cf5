"""Step checkpoint markers (the reference's step_NN_done files; a copy of
hast_tpu/utils/checkpoint.py, so that the port imports nothing of it).

Every reference shell script guards sub-steps with marker files so a rerun
skips completed work (build_unshared_kmers.sh:167-298,
classify_stlfr_reads.sh:146-190).  Same contract here: a step runs iff
its marker is absent; on success the marker records a timestamp.
"""

from __future__ import annotations

import datetime
import os
import sys
from contextlib import contextmanager


def step_done(name: str, workdir: str = ".") -> bool:
    return os.path.exists(os.path.join(workdir, f"step_{name}_done"))


def mark_done(name: str, workdir: str = ".") -> None:
    with open(os.path.join(workdir, f"step_{name}_done"), "a") as f:
        f.write(datetime.datetime.now().ctime() + "\n")


@contextmanager
def step(name: str, workdir: str = ".", log=sys.stderr):
    """Run the body unless already done; mark done on clean exit.

    Usage:
        with step("01", wd) as todo:
            if todo:
                ...work...
    """
    if step_done(name, workdir):
        print(f"skip step_{name} because step_{name}_done file already "
              "exist ...", file=log)
        yield False
    else:
        yield True
        mark_done(name, workdir)
