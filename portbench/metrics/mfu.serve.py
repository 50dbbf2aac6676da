"""mfu.serve: the traced window's frames/s times the reference's FLOPs a
frame, over the card's dense bf16 peak, in %."""


def read(run):
    if run.trace is None or run.kind != "serve" or not run.items:
        return None
    rate = run.items / run.trace.window_s
    return rate * run.gflops_per_item * 1e9 / run.peak_flops("bfloat16") * 100
