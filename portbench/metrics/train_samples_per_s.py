"""train_samples_per_s: samples of the training steps completed in the
window, over the window's seconds (host clock)."""


def read(run):
    if run.kind != "train":
        return None
    return run.items / run.window_s
