"""lifter_ms.train: device ms a step of the lifter's forward (inside it)
and backward (kernels the autograd engine launches), K1 and K6 included
(device trace)."""


def _lifter(r):
    return "portbench.lifter" in r or any(
        n.startswith("autograd::engine::evaluate_function") for n in r)


def read(run):
    if run.trace is None or run.kind != "train" or not run.steps:
        return None
    s = run.trace.device_s(_lifter)
    return s / run.steps * 1e3 if s else None
