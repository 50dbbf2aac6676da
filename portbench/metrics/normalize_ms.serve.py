"""normalize_ms.serve: device ms a request launched inside the program's
``capf.serve.normalize`` span (``augment.serving_images`` in
``serve.lift``), over the benchmark's ``portbench.lift`` ranges (device
trace)."""

from portbench import spans

NORMALIZE = "capf.serve.normalize"


def read(run):
    if run.trace is None or run.kind != "serve":
        return None
    n = spans.lifts(run.trace)
    if n is None or not spans.spans(run.trace, NORMALIZE):
        return None
    return run.trace.device_s(lambda r: NORMALIZE in r) / n * 1e3
