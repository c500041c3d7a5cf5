"""Phase timers and fallback notices (port of hast_tpu/utils/profiling.py).

The reference's only observability is wall-clock timestamps at phase
boundaries (classify.cpp:17-21 logtime); :class:`PhaseTimer` adds
per-phase seconds and items/s.  Device traces come from
``torch.profiler`` around the call (``chip_smoke.py`` does so).
"""

from __future__ import annotations

import contextlib
import sys
import time


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
