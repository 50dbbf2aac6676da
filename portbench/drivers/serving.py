"""Serving cells: a closed loop over the program's serving entry.

Set-up builds the configuration's model from the benchmark's weights,
calibrates it (``serve.prepare``) on the pool's calibration frames and
warms the loop's own shapes. The loop then hands ``serve.lift`` requests of
``batch`` distinct frames with their keypoints, copied ``non_blocking``
from a pinned pool of ``pool_requests`` requests, with up to ``in_flight``
requests submitted and not yet read back: each result is copied
``non_blocking`` into a pinned buffer and read after its event. A request
is timed from its submission (its frames handed to the entry) to the host
seeing its poses.

After the window every request's poses are compared with the plain
reference's poses of its pool entry, computed on the same weights and
frames, its calibration worked out again from the same calibration
frames (``check``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import torch

from portbench import entry, tracing, weights
from portbench.reference.model import Model
from portbench.traffic import ServingPool

NUMBER = "pose_gap_int8_units"


class Loop:
    """The closed loop over ``lift(frames, kp2d, crop)``."""

    def __init__(self, lift, pool, in_flight, device, trace=False):
        self.lift, self.pool, self.device = lift, pool, device
        self.in_flight = in_flight
        self.trace = trace
        b, j = pool.kp2d.shape[1:3]
        self.cuda = torch.device(device).type == "cuda"
        self.slots = [torch.empty((b, j, 3), dtype=torch.float32,
                                  pin_memory=self.cuda)
                      for _ in range(in_flight + 1)]
        self.done = []  # (index, pool entry, submit s, done s, frames)
        self.dispatch_s = []
        self.outputs = {}  # index -> (pool entry, poses on the host)

    def _range(self, name):
        return (torch.profiler.record_function(name) if self.trace
                else contextlib.nullcontext())

    def _finish(self, item):
        i, k, t_sub, event, slot = item
        with self._range("portbench.wait"):
            if event is not None:
                event.synchronize()
        t_done = time.perf_counter()
        self.done.append((i, k, t_sub, t_done, slot.shape[0]))
        self.outputs[i] = (k, slot.clone())

    def run(self, seconds=None, count=None):
        """Submit until ``seconds`` have passed (or ``count`` requests are
        submitted), then drain; returns the window's (start, end) on the
        host clock."""
        pending = collections.deque()
        dev = self.device
        i = 0
        t0 = time.perf_counter()
        while (i < count if count is not None
               else time.perf_counter() - t0 < seconds):
            k = i % len(self.pool)
            t_sub = time.perf_counter()
            frames = self.pool.frames[k].to(dev, non_blocking=True)
            kp2d = self.pool.kp2d[k].to(dev, non_blocking=True)
            crop = self.pool.crop[k].to(dev, non_blocking=True)
            with self._range("portbench.lift"):
                out = self.lift(frames, kp2d, crop)
            self.dispatch_s.append(time.perf_counter() - t_sub)
            slot = self.slots[i % len(self.slots)]
            slot.copy_(out, non_blocking=True)
            event = torch.cuda.Event() if self.cuda else None
            if event is not None:
                event.record()
            pending.append((i, k, t_sub, event, slot))
            i += 1
            if len(pending) >= self.in_flight:
                self._finish(pending.popleft())
        while pending:
            self._finish(pending.popleft())
        return t0, t0 + (seconds or 0.0)


def run(cell, seed, seconds, trace, device, clock):
    """One run of a serving cell (see the module docstring): returns the
    harness's ``Run``."""
    from contextaware_poseformer_tpu_torch import serve

    from portbench.harness import note

    cfg, traffic = cell.config, cell.traffic
    note(clock, "program imported")
    pc = entry.program_config(cfg)
    params = weights.make(cfg, seed, device)
    note(clock, "weights made")
    model = entry.serving_model(pc, params, device)
    note(clock, "model built")
    pool = ServingPool(cfg, traffic, seed, device)
    note(clock, "request pool made")
    serve.prepare(model, [pool.calibration])
    note(clock, "calibrated")

    def lift(frames, kp2d, crop):
        return serve.lift(model, frames, kp2d, crop)

    warm = Loop(lift, pool, traffic["in_flight"], device)
    warm.run(count=traffic["warmup_requests"])
    setup_s = clock()
    note(clock, "warmed up")

    loop = Loop(lift, pool, traffic["in_flight"], device, trace)
    window = None
    if trace:
        modules = [(model.backbone, "portbench.backbone"),
                   (model.lifter, "portbench.lifter")]
        modules += [(m, "portbench.int8_conv") for m in
                    model.backbone.modules()
                    if type(m).__name__ == "ConvBN"
                    and getattr(m, "int8", False)]

        def window_fn():
            with tracing.ranges(modules), \
                    torch.profiler.record_function(tracing.WINDOW):
                loop.run(min(seconds, traffic["trace_seconds"]))

        window = tracing.profile(window_fn)
    else:
        _, t1 = loop.run(seconds)
    memory_peak = memory_peak_bytes(device)
    del model, lift, warm
    gc.collect()
    if loop.cuda:
        torch.cuda.empty_cache()

    from portbench.harness import Run
    in_window = [r for r in loop.done if r[3] <= t1] if not trace \
        else loop.done
    result = Run(
        kind="serve", setup_s=setup_s,
        window_s=(window.window_s if trace else seconds),
        items=sum(r[4] for r in in_window),
        latencies_s=[r[3] - r[2] for r in in_window],
        dispatch_s=loop.dispatch_s, requests=len(in_window),
        attempted=len(loop.done), memory_peak_bytes=memory_peak,
        trace=window, batch=traffic["batch"])
    result.failed, result.compared = check(cell, params, pool, loop.outputs,
                                           device)
    result.inputs = {"params": params, "pool": pool}
    return result


def memory_peak_bytes(device) -> int:
    """The most memory the process's allocator has held on the device."""
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_reserved(device)


def reference_poses(cfg, params, pool, device, levels=127, quantized=True):
    """The plain reference's poses of every pool entry (on the host): the
    configuration's graph, an int8 one calibrated on the pool's calibration
    frames, or with ``quantized`` False all in float."""
    ref = Model(cfg, params, levels, quantized)
    if ref.int8:
        ref.calibrate(pool.calibration, cfg["calibration"]["chunk"])
    out = []
    with torch.no_grad():
        for k in range(len(pool)):
            out.append(ref(pool.frames[k].to(device), pool.kp2d[k].to(device),
                           pool.crop[k].to(device)).cpu())
    return out


def frame_gaps(poses, ref):
    """Each frame's distance from ``ref``: the norm over its joints."""
    return (poses - ref).flatten(1).norm(dim=1)


def int8_units(cell, params, pool, device, refs):
    """Each pool entry's unit of distance: the RMS distance of the
    all-float reference's frames from the int8 reference's ``refs``, the
    int8 quantization's own effect on the poses. It scales with how
    strongly the seeded lifter reads its maps, as the program's rounding
    and a lower precision's do, so their ratio holds from seed to seed
    where a distance over the poses' norm swings ninefold."""
    floats = reference_poses(cell.config, params, pool, device,
                             quantized=False)
    return [float(frame_gaps(f, r).square().mean().sqrt())
            for f, r in zip(floats, refs)]


def widest(outputs, refs, unit) -> float:
    """The widest distance of a served frame from the reference's, in the
    unit of its pool entry; ``outputs``: (pool entry, poses) pairs."""
    return max(float(frame_gaps(poses, refs[k]).max()) / unit[k]
               for k, poses in outputs)


def check(cell, params, pool, outputs, device):
    """(failed requests, {number: (value, limit)}) of the served poses
    against the reference: ``pose_gap_int8_units``, the widest distance
    of a served frame from the int8 reference's in ``int8_units``."""
    refs = reference_poses(cell.config, params, pool, device)
    finite = [(k, p) for k, p in outputs.values()
              if bool(torch.isfinite(p).all())]
    unit = int8_units(cell, params, pool, device, refs)
    gap = widest(finite, refs, unit) if finite else float("inf")
    return len(outputs) - len(finite), {
        NUMBER: (gap, cell.workload["limits"][NUMBER])}
