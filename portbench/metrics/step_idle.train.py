"""step_idle.train: the share of the steady window (from the end of the
first ``capf.train.step`` span to the end of the last device operation)
in which no kernel, memcpy or memset runs on the card, in % (device
trace). ``device_idle.train`` without the epoch's start and teardown.
The traced host's pace sets it: the profiler slows the host's dispatch,
and the idle it leaves swings severalfold from run to run. Compare traced
runs only."""

from portbench import spans


def read(run):
    if run.trace is None or run.kind != "train":
        return None
    window = spans.steady(run.trace)
    if window is None:
        return None
    start, end, _ = window
    return spans.length(spans.idle(run.trace, start, end)) \
        / (end - start) * 100
