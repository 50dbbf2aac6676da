"""lifter_ms.serve: device ms a request launched inside the lifter (device
trace)."""


def read(run):
    if run.trace is None or run.kind != "serve" or not run.requests:
        return None
    s = run.trace.device_s(lambda r: "portbench.lifter" in r)
    return s / run.requests * 1e3 if s else None
