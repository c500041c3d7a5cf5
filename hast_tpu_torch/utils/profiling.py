"""The port's tracer: spans, host counters, phase timers and fallback
notices (port of hast_tpu/utils/profiling.py).

:func:`span` names a step of the host's work at a layer boundary (the
reader handing over a batch, a batch staged and launched, a fold, a
fetch).  It records only while a ``torch.profiler`` session runs, as a
``record_function`` annotation: the span then lands in that session's
trace on the clock of the device's records, so a gap in the device's
work can be put down to the host step open at the time.  The session
keeps the spans in memory and writes them with its trace.  With no
session running a span costs one flag check: no clock is read and no
annotation entered.  To see the spans, run the CLI (or any caller)
under ``torch.profiler.profile`` and export its chrome trace; there is
no other switch and no other exporter.

:data:`COUNTERS` counts host work at the same boundaries (reads and
batches handed over, readers opened), always on and counted once a
batch or once a call through :func:`count`, which holds a lock: two
threads may count at once.  :class:`PhaseTimer` keeps the wall seconds of a
pipeline's phases for its log, and opens a span of each phase's name.
The reference's only observability is wall-clock timestamps at phase
boundaries (classify.cpp:17-21 logtime).
"""

from __future__ import annotations

import collections
import contextlib
import sys
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# host counts by name ("io.reads", "io.batches", "io.reader_opens"):
# callers read one before and after the work they measure
COUNTERS: collections.Counter = collections.Counter()
# two parents count on two threads in markers.count_files_device_pair
_COUNTERS_LOCK = threading.Lock()

_OFF = contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    """Add n to COUNTERS[name]."""
    with _COUNTERS_LOCK:
        COUNTERS[name] += n


def span(name: str):
    """A context manager naming a step of the host's work: a
    ``record_function(name)`` annotation while a profiler session
    records, else nothing.  name is a fixed string; a span's parent is
    the span enclosing it on the same thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulates named phase durations and item counts."""

    def __init__(self, log=sys.stderr):
        self.log = log
        self.phases: dict[str, float] = {}
        self.items: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield self
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if items:
                self.items[name] = self.items.get(name, 0) + items

    def add_items(self, name: str, n: int) -> None:
        self.items[name] = self.items.get(name, 0) + n

    def report(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, secs in self.phases.items():
            row = {"seconds": round(secs, 3)}
            n = self.items.get(name)
            if n:
                row["items"] = n
                row["items_per_s"] = round(n / secs) if secs > 0 else 0
            out[name] = row
            print(f"[hast_tpu_torch] {name}: {secs:.2f}s"
                  + (f" ({row['items_per_s']:,} items/s)" if n else ""),
                  file=self.log)
        return out


_FALLBACKS_SEEN: set = set()


def notice_fallback(name: str, exc: BaseException | str | None = None
                    ) -> None:
    """One-line stderr notice, once per process per site, when a native
    host fast path is unavailable and its numpy or Python path runs
    instead (same bytes, slower)."""
    if name in _FALLBACKS_SEEN:
        return
    _FALLBACKS_SEEN.add(name)
    why = f": {exc}" if exc else ""
    print(f"[hast_tpu_torch] NOTE: fast path '{name}' unavailable, using "
          f"fallback{why}", file=sys.stderr, flush=True)
