"""setup_s: seconds from the process's start to the first timed request
or step (host clock)."""


def read(run):
    return run.setup_s
