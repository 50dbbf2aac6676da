"""optimizer_launches.train: kernels, memcpys and memsets launched inside
the program's ``capf.train.optimizer`` span (the NaN guard, the clip and
AdamW's step), over those spans: one a step (device trace). A count: the
profiler's host overhead does not move it."""

from portbench import spans

OPTIMIZER = "capf.train.optimizer"


def read(run):
    if run.trace is None or run.kind != "train":
        return None
    n = len(spans.spans(run.trace, OPTIMIZER))
    if not n:
        return None
    return spans.launched(run.trace, OPTIMIZER) / n
