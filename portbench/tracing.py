"""The traced run: host ranges pushed from outside the program, one
``torch.profiler`` window, and the reduction of its trace.

Ranges: ``Ranges`` registers forward hooks on chosen modules of the
program's model (the benchmark's, removed on exit) that push a
``record_function`` range named by a label around each call; the drivers
push their own (``portbench.window``, ``portbench.lift``,
``portbench.wait``). Each kernel, memcpy and memset on the device is joined
to its launch on the host through the trace's correlation ids, and the
launch to the ranges open around it on its thread: a rewritten copy of
what the program's ``tools/trace_budget.py`` does. Kernels the autograd
engine launches sit in its ``autograd::engine::evaluate_function`` ranges;
those of an optimizer step in its ``Optimizer.step`` range.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import tempfile

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
RANGE_CATEGORIES = ("user_annotation", "cpu_op")
WINDOW = "portbench.window"
TOP = 10


@contextlib.contextmanager
def ranges(modules_labels):
    """Push a range ``label`` around every call of each (module, label)."""
    handles = []

    def enter(mod, args, label):
        rf = torch.profiler.record_function(label)
        rf.__enter__()
        mod.__dict__.setdefault("_portbench_ranges", []).append(rf)

    def leave(mod, args, out):
        mod.__dict__["_portbench_ranges"].pop().__exit__(None, None, None)

    try:
        for module, label in modules_labels:
            handles.append(module.register_forward_pre_hook(
                lambda m, a, label=label: enter(m, a, label)))
            handles.append(module.register_forward_hook(leave,
                                                        always_call=True))
        yield
    finally:
        for h in handles:
            h.remove()
        for module, _ in modules_labels:
            module.__dict__.pop("_portbench_ranges", None)


def profile(fn):
    """Run ``fn`` under ``torch.profiler`` (host and device) and return the
    reduced trace (``Trace``). The Chrome trace passes through a file in
    the temporary directory, removed once read."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        print(f"portbench: trace of {os.path.getsize(path) / 2 ** 20:.1f} "
              "MiB read", file=sys.stderr, flush=True)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    return Trace(events["traceEvents"] if isinstance(events, dict)
                 else events)


def _enclosing(ranges_, launches):
    """For each launch (time, key) on one thread, the names of the ranges
    open around it, outermost first: one sweep over both sorted by time."""
    ranges_ = sorted(ranges_, key=lambda r: (r[0], -r[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(launches):
        while i < len(ranges_) and ranges_[i][0] <= t:
            start, end, name = ranges_[i]
            while stack and stack[-1][1] < start:
                stack.pop()
            stack.append((start, end, name))
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = [name for s, e, name in stack if s <= t <= e]
    return out


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device events of the ``portbench.window`` range, each with the host
    ranges around its launch. Times in microseconds."""

    def __init__(self, events):
        launches, ranges_ = {}, collections.defaultdict(list)
        device = []
        window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATEGORIES:
                device.append(e)
            elif cat in LAUNCH_CATEGORIES and "correlation" in e.get(
                    "args", {}):
                launches[e["args"]["correlation"]] = (e["pid"], e["tid"],
                                                      e["ts"])
            elif cat in RANGE_CATEGORIES:
                r = (e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""))
                ranges_[(e["pid"], e["tid"])].append(r)
                if r[2] == WINDOW:
                    window = (r[0], r[1], (e["pid"], e["tid"]))
        if window is None:
            raise RuntimeError("the trace holds no portbench.window range")
        self.start, self.end, self.main = window
        by_thread = collections.defaultdict(list)
        for corr, (pid, tid, ts) in launches.items():
            by_thread[(pid, tid)].append((ts, corr))
        around = {}
        for thread, ls in by_thread.items():
            around.update(_enclosing(ranges_.get(thread, []), ls))
        self.events = []  # (start, end, name, ranges around the launch)
        for e in device:
            s, d = e["ts"], e.get("dur", 0)
            if s + d < self.start or s > self.end:
                continue
            corr = e.get("args", {}).get("correlation")
            self.events.append((s, s + d, e.get("name", ""),
                                around.get(corr, [])))
        self.host_ranges = sorted(ranges_.get(self.main, []))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self):
        return [(max(s, self.start), min(e, self.end)) for s, e in
                union((s, e) for s, e, _, _ in self.events)]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_s(self, where) -> float:
        """Device seconds of the events whose launch ranges satisfy
        ``where(list of range names)``."""
        return sum(e - s for s, e, _, r in self.events if where(r)) / 1e6

    def breakdown(self) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps, each named by the innermost host range open on the
        driving thread when it began."""
        ops = collections.Counter()
        for s, e, name, _ in self.events:
            ops[name[:160]] += (e - s) / 1e6
        busy = self.busy_intervals()
        gaps = [(b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])]
        if busy:
            gaps += [(busy[0][0] - self.start, self.start),
                     (self.end - busy[-1][1], busy[-1][1])]
        gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:TOP]
        return {"device_ops": [[n, v] for n, v in ops.most_common(TOP)],
                "idle_gaps": [[self.host_range_at(t), g / 1e6]
                              for g, t in gaps]}

    def host_range_at(self, t) -> str:
        inner = None
        for s, e, name in self.host_ranges:
            if s > t:
                break
            if e >= t:
                inner = name
        return inner or "host (no range)"
