"""backbone_ms.train: device ms a step launched inside the frozen backbone
(device trace)."""


def read(run):
    if run.trace is None or run.kind != "train" or not run.steps:
        return None
    s = run.trace.device_s(lambda r: "portbench.backbone" in r)
    return s / run.steps * 1e3 if s else None
