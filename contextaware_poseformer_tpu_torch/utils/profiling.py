"""Profiling and timing utilities.

Port of ``contextaware_poseformer_tpu/utils/profiling.py`` on
``torch.profiler``:

- ``trace(logdir)``: a context manager that profiles CPU and CUDA activity
  and writes a Chrome trace into ``logdir``;
- ``StepWindowProfiler``: profile steps [start, stop) of a loop, one
  ``step()`` call a step, with the JAX package's window semantics;
- ``sustained_timer``: distinct inputs every iteration, each burst ended by
  a host fetch of one output element (which waits for the stream), the
  best burst's seconds an iteration;
- ``span(name)``: a named range (``torch.profiler.record_function``) while
  a profiler records, else a shared no-op context.

The program's spans, each on the thread that calls it, and what reads
each (the benchmark's per-layer metrics, ``portbench/metrics/<metric>.py``):

- ``capf.serve.normalize``: the ``augment.serving_images`` call inside
  ``serve.lift``; ``normalize_ms.serve``, the device time launched inside;
- ``capf.train.step``: each ``steps.train_step`` call of
  ``Trainer.train_epoch``; it bounds the steady window of
  ``step_idle.train`` (the device's idle share after the first step);
- ``capf.train.optimizer``: ``state.optimizer.step`` inside
  ``train_step`` (the NaN guard, the clip and AdamW);
  ``optimizer_launches.train``, the device operations launched inside,
  and ``optimizer_idle_ms.train``, the device's idle time inside;
- ``capf.data.wait``: ``device_prefetch``'s consumer taking a batch (the
  queue's get and the stream hand-over), between steps;
  ``data_idle_ms.train``, the device's idle time inside.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else a shared no-op context: entering ``record_function``
    costs some 10-15 us even with no profiler, the check under 1 us."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def _start() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, logdir: str) -> None:
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU, and CUDA where there is a card) and write a
    Chrome trace ``trace_*.json`` into ``logdir``; yields the
    ``torch.profiler.profile`` (its ``key_averages()`` after the block)."""
    prof = _start()
    try:
        yield prof
    finally:
        _stop(prof, logdir)


class StepWindowProfiler:
    """Profile steps [start, stop) of a loop: call ``step()`` once per
    step."""

    def __init__(self, logdir: str, start: int, stop: int):
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._count = 0
        self._prof = None

    def step(self) -> None:
        if self._count == self.start and self._prof is None:
            self._prof = _start()
        self._count += 1
        if self._count == self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            _stop(self._prof, self.logdir)
            self._prof = None


def sustained_timer(fn: Callable, make_args: Callable[[int], tuple],
                    iters: int = 20, bursts: int = 3) -> dict[str, float]:
    """Peak sustained seconds an iteration of ``fn`` across ``bursts``.

    ``make_args(i)`` must return arguments that differ with ``i``; a burst
    ends with a host fetch of one element of ``fn``'s output (a tensor, or
    nested lists, tuples or dicts whose first leaf is one)."""

    def fetch(out):
        while isinstance(out, (list, tuple, dict)):
            out = next(iter(out.values() if isinstance(out, dict) else out))
        return out.reshape(-1)[0].item()

    fetch(fn(*make_args(0)))
    best = float("inf")
    salt = 0
    for _ in range(bursts):
        t0 = time.perf_counter()
        for _ in range(iters):
            salt += 1
            out = fn(*make_args(salt))
        fetch(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return {"sec_per_iter": best, "iters_per_sec": 1.0 / best}
