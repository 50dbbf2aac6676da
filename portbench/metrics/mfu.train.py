"""mfu.train: the traced window's samples/s times the reference's FLOPs
of a training sample (the frozen backbone's forward, the lifter's forward
and backward), over the card's fp32 peak, in %."""


def read(run):
    if run.trace is None or run.kind != "train" or not run.items:
        return None
    rate = run.items / run.trace.window_s
    return rate * run.gflops_per_item * 1e9 / run.peak_flops("float32") * 100
