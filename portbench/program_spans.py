"""The program's own spans in a traced window, read with innermost
attribution: an instant belongs to the innermost span open then.

The program names its host steps with ``hast_tpu_torch.utils.profiling``
``span``, annotations that land in the traced window's trace beside the
benchmark's own spans around each call into the program (``Run.span``);
``trace.summarize`` gives both as ``summary["spans"]``, (start, end,
name) in µs.  The program's spans are those whose names the benchmark
did not open.  All of a job's spans open on the job's one thread, so
they nest, and the innermost span open at an instant is the one opened
last.  A program without spans gives none, and the readers built on
this module then read nothing (None).
"""

from __future__ import annotations

from portbench import trace as T


def program_spans(run) -> list:
    """(start, end, name) of the program's spans in the traced window,
    by start."""
    if not run.summary:
        return []
    bench = {name for name, _, _ in run.spans}
    return [s for s in run.summary["spans"] if s[2] not in bench]


def seconds(spans, name: str) -> list:
    """The durations, in seconds, of the spans called name."""
    return [(e - s) / 1e6 for s, e, n in spans if n == name]


def pieces(spans) -> list:
    """The time line the spans cover, cut into (start, end, name) pieces,
    each under the innermost span open over it; spans nest, and a child
    that outlasts its parent by the trace's rounding ends with it."""
    out, stack, pos = [], [], 0.0

    def close(until):
        nonlocal pos
        while stack and stack[-1][0] <= until:
            end, name = stack.pop()
            if end > pos:
                out.append((pos, end, name))
                pos = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close(s)
        if stack:
            if s > pos:
                out.append((pos, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        pos = s
        stack.append((e, name))
    close(float("inf"))
    return out


def idle_by_span(summary: dict) -> dict:
    """Seconds of the device's idle time in the window under each span,
    the program's and the benchmark's, by innermost attribution
    (trace.BETWEEN where no span is open)."""
    t0, t1 = summary["window_us"]
    busy = T._union([(s, s + d) for _, s, d in summary["device"]])
    # the pieces do not nest: the flat split of trace.py cuts a gap by them
    cut = pieces(summary["spans"])
    starts = [p[0] for p in cut]
    idle: dict = {}
    prev = t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            for name, us in T._split(prev, s, cut, starts):
                idle[name] = idle.get(name, 0.0) + us / 1e6
        prev = max(prev, e)
    return idle
