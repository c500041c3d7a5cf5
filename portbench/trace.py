"""The traced window: a torch.profiler session and what is read from it.

The session records the CPU side (the benchmark's spans, as
``record_function`` annotations) and the device side (kernels, copies,
fills) on one clock.  It opens with LEAD_SPINS one-cycle spin kernels,
waited for, since torch.profiler drops the first device records of a
session; the readers check the records they use against the program's
launch counters.
"""

from __future__ import annotations

import bisect
import json
import re

import torch

LEAD_SPINS = 64
LEAD_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel
WINDOW = "portbench.window"      # the annotation around the measured jobs
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
BETWEEN = "between_spans"


def kernel_name(name: str) -> str:
    """A record's name without namespace, template and arguments."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    return name.split("::")[-1].split("<")[0].strip() or name


class Session:
    """Profile a block; afterwards ``summary`` holds what the readers
    take (see :func:`summarize`)."""

    def __init__(self, path: str):
        self.path = path
        self.summary = None
        self._prof = None

    def __enter__(self):
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
            with open(self.path) as f:
                self.summary = summarize(json.load(f))
        self._prof = None
        return False


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(trace: dict) -> dict:
    """From a chrome trace: the window (µs), the device records in it,
    busy and window seconds, the spans, whether the lead spins were
    recorded, and the breakdown (top device operations, idle time by the
    span open at the time)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] == WINDOW]
    if not wins:
        raise RuntimeError("the trace holds no window annotation")
    t0 = float(wins[0]["ts"])
    t1 = t0 + float(wins[0]["dur"])
    device = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
              if e.get("cat") in DEVICE_CATS]
    lead = sum(1 for n, _, _ in device if LEAD_KERNEL in n)
    inside = [(n, s, d) for n, s, d in device
              if s >= t0 and s + d <= t1 and LEAD_KERNEL not in n]
    busy = _union([(s, s + d) for _, s, d in inside])
    busy_us = sum(e - s for s, e in busy)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] != WINDOW and t0 <= float(e["ts"]) < t1)
    ops: dict = {}
    for n, _, d in inside:
        key = kernel_name(n)
        ops[key] = ops.get(key, 0.0) + d
    idle = {}
    starts = [s for s, _, _ in spans]
    prev = t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            for name, us in _split(prev, s, spans, starts):
                idle[name] = idle.get(name, 0.0) + us
        prev = max(prev, e)
    top = lambda d: [[k, v / 1e6] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_us": (t0, t1), "device": inside, "lead_records": lead,
            "busy_s": busy_us / 1e6, "window_s": (t1 - t0) / 1e6,
            "spans": spans,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}


def _split(a: float, b: float, spans, starts):
    """[a, b) cut by the spans (start, end, name), which do not nest;
    pieces no span covers go to BETWEEN."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    pos = a
    while pos < b:
        while i < len(spans) and spans[i][1] <= pos:
            i += 1
        if i < len(spans) and spans[i][0] <= pos:
            end = min(b, spans[i][1])
            yield spans[i][2], end - pos
        else:
            end = min(b, spans[i][0]) if i < len(spans) else b
            yield BETWEEN, end - pos
        pos = end
