"""backbone_ms.serve: device ms a request launched inside the serving
entry but outside the lifter: input normalization, the backbone and the
glue between them (device trace)."""


def read(run):
    if run.trace is None or run.kind != "serve" or not run.requests:
        return None
    s = run.trace.device_s(lambda r: "portbench.lift" in r
                           and "portbench.lifter" not in r)
    return s / run.requests * 1e3 if s else None
