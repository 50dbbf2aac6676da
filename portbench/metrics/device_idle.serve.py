"""device_idle.serve: the share of the traced window in which no kernel,
memcpy or memset runs on the card (the union of device intervals), in %."""


def read(run):
    if run.trace is None or run.kind != "serve":
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100
