"""backbone_dispatch_ms.serve: host ms a request inside the benchmark's
``portbench.backbone`` ranges (its forward hooks around the model's
backbone), over its ``portbench.lift`` ranges around ``serve.lift``.
Traced, so it carries the profiler's host overhead and swings with the
traced host's pace: compare traced runs only (host clock)."""

from portbench import spans


def read(run):
    if run.trace is None or run.kind != "serve":
        return None
    n = spans.lifts(run.trace)
    inside = spans.spans(run.trace, "portbench.backbone")
    if n is None or not inside:
        return None
    return spans.length(inside) / n / 1e3
