"""Training cells: epochs of the program's ``Trainer`` over a seeded
in-memory dataset, through its ``device_prefetch`` pipeline.

The dataset's rows are cycled into epochs of ``epoch_samples``
(``traffic.Epochs``), thousands of steps as a real epoch runs, so that the
window sees no restart of the input pipeline. Set-up builds the
``Trainer`` and its state (``init_state``), replaces the model's weights by
the benchmark's, and takes the first three optimizer steps through
``Trainer.train_epoch`` itself, on the first three batches of epoch 0
(distinct rows), keeping each step's loss, the optimizer's first moments
after the first step (read by a hook on its step) and the lifter's
parameters after the third. The window runs epoch 1 until ``--seconds``
have passed: the dataset then refuses the next batch, the loop runs the
batches already made and the epoch ends. The rate is over all of the
window's steps and all of its time, up to the last step's end on the card.

After the window the plain reference follows the three steps on the same
rows (logged by the dataset as the pipeline asked for them), with the same
flips and drop-path masks, drawn from a generator seeded as the
configuration's recipe seeds each step (``(seed + 1) * 1000003 + step`` on
the device), and is compared (``check``).
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import threading
import time

import numpy as np
import torch

from portbench import entry, tracing, weights
from portbench.reference.model import AdamW, Model, mpjpe, normalize
from portbench.traffic import Epochs, TrainingSet, WindowClosed

SEED_STRIDE = 1_000_003  # the recipe's step seed: (seed + 1) * this + step
COMPARED_STEPS = 3


def train_seed(seed: int) -> int:
    return seed % (2 ** 31)


def join_pipeline(timeout=30.0) -> None:
    """Wait for the input pipeline's producer threads of finished epochs,
    so that the rows they asked for are all logged."""
    for t in threading.enumerate():
        if t.name == "device_prefetch":
            t.join(timeout)


def run(cell, seed, seconds, trace, device, clock):
    """One run of a training cell (see the module docstring)."""
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    from portbench.harness import note

    cfg, traffic = cell.config, cell.traffic
    note(clock, "program imported")
    pc = entry.program_config(cfg)
    pc = dataclasses.replace(pc, train=dataclasses.replace(
        pc.train, seed=train_seed(seed), batch_size=traffic["batch"]))
    data = TrainingSet(cfg, traffic, seed, device)
    epochs = Epochs(data, traffic["epoch_samples"], pc.train.seed)
    note(clock, "dataset made")
    params = weights.make(cfg, seed, device)
    note(clock, "weights made")
    trainer = Trainer(pc, epochs, epochs, device)
    state = trainer.init_state(train_seed(seed))
    note(clock, "trainer state built")
    entry.load_weights(state.model, params)
    lifter = dict(state.model.lifter.named_parameters())
    start = {n: p.detach().clone() for n, p in lifter.items()}

    b1 = cfg["train"]["betas"][0]
    grad_norms = {}

    def after_step(opt, args, kwargs):
        """The first gradient as the optimizer got it: its first moment
        after one step, over (1 - beta1)."""
        if not grad_norms:
            grad_norms.update(
                {n: float(opt.state[p]["exp_avg"].norm()) / (1 - b1)
                 if "exp_avg" in opt.state.get(p, {}) else 0.0
                 for n, p in lifter.items()})

    hook = state.optimizer.adamw.register_step_post_hook(after_step)
    try:
        losses = trainer.train_epoch(
            state, 0, max_steps=COMPARED_STEPS)["step_losses"]
    finally:
        hook.remove()
    join_pipeline()
    rows = epochs.log[:COMPARED_STEPS]
    grad_norms = grad_norms or {n: 0.0 for n in lifter}
    change_norms = {n: float((p.detach() - start[n]).norm())
                    for n, p in lifter.items()}
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = clock()
    note(clock, "three steps taken")

    epoch, steps, window = 1, 0, None
    if trace:
        modules = [(state.model.backbone, "portbench.backbone"),
                   (state.model.lifter, "portbench.lifter")]

        def window_fn():
            nonlocal steps
            with tracing.ranges(modules), \
                    torch.profiler.record_function(tracing.WINDOW):
                steps = trainer.train_epoch(
                    state, epoch, max_steps=traffic["trace_steps"])["steps"]

        window = tracing.profile(window_fn)
        window_s = window.window_s
    else:
        served = epochs.served
        t0 = time.perf_counter()
        epochs.deadline = t0 + seconds
        try:
            while True:
                trainer.train_epoch(state, epoch)
                epoch += 1
        except WindowClosed:
            pass
        if device != "cpu":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        epochs.deadline = None
        steps = epochs.served - served
    join_pipeline()
    from portbench.drivers.serving import memory_peak_bytes
    memory_peak = memory_peak_bytes(device)
    del trainer, state, lifter, epochs
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    from portbench.harness import Run
    result = Run(kind="train", setup_s=setup_s, window_s=window_s,
                 items=steps * traffic["batch"], steps=steps,
                 attempted=steps + COMPARED_STEPS,
                 memory_peak_bytes=memory_peak, trace=window,
                 batch=traffic["batch"])
    program = {"losses": losses, "grad": grad_norms, "change": change_norms}
    ref = reference_steps(cfg, params, data, rows, train_seed(seed), device)
    result.failed = sum(not np.isfinite(v) for v in losses)
    result.compared = compare(program, ref, cell.workload["limits"])
    result.inputs = {"params": params, "data": data, "rows": rows,
                     "reference": ref}
    return result


def _flip(images, kp3d, kp2d, crop, perm, width):
    crop = crop.clone()
    crop[..., 0] = width - crop[..., 0] - 1.0
    sign = torch.tensor([-1.0, 1.0, 1.0], device=kp3d.device)
    return (images.flip(2), (kp3d * sign)[:, perm], (kp2d * sign[:2])[:, perm],
            crop[:, perm])


def reference_steps(cfg, params, data, rows, seed, device, tf32=False,
                    half_batch=False):
    """The reference's three steps on ``rows``: (losses, first gradient norm
    a leaf, parameter change norm a leaf after the steps). ``tf32`` (the
    lower-precision control) and ``half_batch`` (a fault: the loss over
    the first half of the rows) serve the readings that set the limits."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    tc = cfg["train"]
    model = Model(cfg, params)
    leaves = {n: p.clone().requires_grad_(True)
              for n, p in model.lifter.p.items()}
    model.lifter.p = leaves
    start = {n: p.detach().clone() for n, p in leaves.items()}
    opt = AdamW(leaves, tc["lr"], tc["weight_decay"], tuple(tc["betas"]),
                tc["eps"])
    j = cfg["lifter"]["num_joints"]
    perm = list(range(j))
    for a, b in zip(tc["joints_left"], tc["joints_right"]):
        perm[a], perm[b] = b, a
    root = tc["root_joint"]
    width = cfg["image_shape"][1]
    losses, grads = [], None
    for step, idx in enumerate(rows):
        gen = torch.Generator(device=device)
        gen.manual_seed((seed + 1) * SEED_STRIDE + step)
        images = torch.from_numpy(data.images[idx]).to(device)
        kp3d = torch.from_numpy(data.joints_3d[idx]).to(device)
        kp3d = kp3d - kp3d[:, root:root + 1]
        kp2d = torch.from_numpy(data.joints_2d[idx]).to(device)
        crop = torch.from_numpy(data.joints_2d_crop[idx]).to(device)
        if tc["flip_aug"] and bool(torch.rand((), generator=gen,
                                              device=device) < 0.5):
            images, kp3d, kp2d, crop = _flip(images, kp3d, kp2d, crop, perm,
                                             width)
        with torch.no_grad():
            maps = model.backbone(normalize(images, cfg), "float")
        pred = model.lifter(kp2d, crop, maps, generator=gen)
        keep = pred.shape[0] // 2 if half_batch else pred.shape[0]
        loss = mpjpe(pred[:keep], kp3d[:keep])
        loss.backward()
        losses.append(float(loss.detach()))
        if grads is None:
            grads = {n: float(p.grad.norm()) for n, p in leaves.items()}
        opt.step()
        for p in leaves.values():
            p.grad = None
    change = {n: float((p.detach() - start[n]).norm())
              for n, p in leaves.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"losses": losses, "grad": grads, "change": change}


def leaf_gap(program, ref, names):
    """The widest gap between the program's and the reference's norm of a
    leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    median = statistics.median(ref[n] for n in names)
    return max(abs(program[n] - ref[n]) / max(ref[n], median, 1e-30)
               for n in names)


def readings(program, ref) -> dict:
    """The compared numbers of a training cell: the widest relative gap of
    a step's loss, of a leaf's first gradient and of a leaf's change over
    the steps (leaves whose reference gradient is under a thousandth of
    the median leaf's, which move by round-off alone, left out)."""
    names = sorted(ref["grad"])
    median = statistics.median(ref["grad"][n] for n in names)
    moving = [n for n in names if ref["grad"][n] >= 1e-3 * median]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(program["losses"], ref["losses"])),
        "grad_gap": leaf_gap(program["grad"], ref["grad"], names),
        "change_gap": leaf_gap(program["change"], ref["change"], moving),
    }


def compare(program, ref, limits) -> dict:
    return {k: (v, limits[k]) for k, v in readings(program, ref).items()}
