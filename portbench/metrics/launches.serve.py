"""launches.serve: kernels, memcpys and memsets a request launched inside
the serving entry (the benchmark's ``portbench.lift`` range around each
``serve.lift`` call), hand-written or library, over those ranges (device
trace). A count: the profiler's host overhead does not move it."""

from portbench import spans


def read(run):
    if run.trace is None or run.kind != "serve":
        return None
    n = spans.lifts(run.trace)
    if n is None:
        return None
    return spans.launched(run.trace, spans.LIFT) / n
