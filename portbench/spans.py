"""Readings of named host ranges in a traced run (``tracing.Trace``): the
program's own spans and the benchmark's ranges, for the per-layer metrics
that read them.

The port pushes ``capf.*`` ranges (``utils/profiling.span``) inside the
same profiler session as the benchmark's own ranges, so its spans sit on
the device events' clock, and each device event carries the spans open
around its launch. A range missing from the trace (a program span on an
older commit) gives None here, never 0.

Training metrics read a steady window: from the end of the traced
window's first ``capf.train.step`` span to the end of its last device
operation. It leaves out the epoch's start (its first batch and first
step) and its teardown (the loss read, the producer's join). Per step
means over the steps that end inside it: step spans less one.
"""

from __future__ import annotations

from portbench.tracing import union

LIFT = "portbench.lift"
STEP = "capf.train.step"


def spans(trace, name):
    """(start, end) of the driving thread's ranges named ``name``, in
    order."""
    return [(s, e) for s, e, n in trace.host_ranges if n == name]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def intersect(a, b):
    """The intersection of two lists of merged, sorted intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def clip(intervals, start, end):
    return [(max(s, start), min(e, end)) for s, e in intervals
            if e > start and s < end]


def lifts(trace):
    """The number of the benchmark's ranges around ``serve.lift``
    (``portbench.lift``), or None without any."""
    return len(spans(trace, LIFT)) or None


def launched(trace, name):
    """Device operations (kernels, memcpys, memsets) launched inside a
    ``name`` range, hand-written or library."""
    return sum(name in r for _, _, _, r in trace.events)


def steady(trace):
    """(start, end, steps) of the steady window, or None where the trace
    holds fewer than two ``capf.train.step`` spans or no device operation
    after the first one ends."""
    steps = spans(trace, STEP)
    if len(steps) < 2:
        return None
    start = steps[0][1]
    end = min(max((e for _, e, _, _ in trace.events), default=start),
              trace.end)
    if end <= start:
        return None
    return start, end, len(steps) - 1


def idle(trace, start, end):
    """Merged intervals of [start, end] in which no device operation
    runs."""
    out, t = [], start
    for s, e in clip(trace.busy_intervals(), start, end):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return out


def idle_ms_in(trace, name):
    """Device idle ms a step inside the steady window and inside the
    driving thread's ``name`` spans; None without the steady window or
    without such a span."""
    window = steady(trace)
    inside = spans(trace, name)
    if window is None or not inside:
        return None
    start, end, steps = window
    return length(intersect(idle(trace, start, end), union(inside))) \
        / steps / 1e3
