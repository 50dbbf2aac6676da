"""optimizer_ms.train: device ms a step launched inside the optimizer's
step (the ``Optimizer.step`` range of ``torch.optim``; device trace)."""


def read(run):
    if run.trace is None or run.kind != "train" or not run.steps:
        return None
    s = run.trace.device_s(lambda r: any(n.startswith("Optimizer.step")
                                         for n in r))
    return s / run.steps * 1e3 if s else None
