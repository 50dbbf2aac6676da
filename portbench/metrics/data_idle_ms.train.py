"""data_idle_ms.train: device idle ms a step inside the steady window and
inside the program's ``capf.data.wait`` spans (``device_prefetch``'s
consumer taking a batch; device trace).
The traced host's pace sets it: the profiler slows the host's dispatch,
and the idle it leaves swings severalfold from run to run. Compare traced
runs only."""

from portbench import spans


def read(run):
    if run.trace is None or run.kind != "train":
        return None
    return spans.idle_ms_in(run.trace, "capf.data.wait")
