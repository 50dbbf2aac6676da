"""frames_per_s: frames whose poses reached the host inside the window,
over the window's seconds (host clock)."""


def read(run):
    if run.kind != "serve":
        return None
    return run.items / run.window_s
