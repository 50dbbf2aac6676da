"""optimizer_idle_ms.train: device idle ms a step inside the steady window
and inside the program's ``capf.train.optimizer`` spans (the NaN guard,
the clip and AdamW's step; device trace).
The traced host's pace sets it: the profiler slows the host's dispatch,
and the idle it leaves swings severalfold from run to run. Compare traced
runs only, and read a change in the step's launches from
``optimizer_launches.train``."""

from portbench import spans


def read(run):
    if run.trace is None or run.kind != "train":
        return None
    return spans.idle_ms_in(run.trace, "capf.train.optimizer")
