"""dispatch_ms.serve: the mean host time of a call of the serving entry
(``serve.lift``), over the traced window's requests (the benchmark's span
around each call; host clock)."""


def read(run):
    if run.kind != "serve" or not run.dispatch_s:
        return None
    return sum(run.dispatch_s) / len(run.dispatch_s) * 1e3
