"""The readers of named ranges (the program's ``capf.*`` spans and the
benchmark's ``portbench.*`` ranges) on hand-built traces: the steady
window of the training metrics, idle time cut by a span, the launch
counts, the serving metrics per request, and None where a trace holds no
such range (an older program)."""

import pytest

from portbench import harness, spans, tracing

MAIN = 1


def _trace(device=(), ranges=(), window=(0, 1000)):
    """A Chrome trace in microseconds: ``device`` holds (start, end, name,
    launch time, launching thread), ``ranges`` (start, end, name, thread);
    the benchmark's window range on the main thread."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
           "pid": 1, "tid": MAIN, "ts": window[0],
           "dur": window[1] - window[0]}]
    for s, e, name, tid in ranges:
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "pid": 1, "tid": tid, "ts": s, "dur": e - s})
    for i, (s, e, name, at, tid) in enumerate(device):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "pid": 1, "tid": tid, "ts": at, "dur": 0.1,
                   "args": {"correlation": i}})
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                   "ts": s, "dur": e - s, "args": {"correlation": i}})
    return tracing.Trace(ev)


def _run(trace, kind="train"):
    return harness.Run(kind=kind, setup_s=1.0, window_s=trace.window_s,
                       items=0, batch=4, attempted=0, memory_peak_bytes=0,
                       trace=trace, steps=3, requests=2)


def _read(name, trace, kind="train"):
    return harness.reader(name)(_run(trace, kind))


STEPS = [(0, 100, "capf.train.step", MAIN),
         (110, 200, "capf.train.step", MAIN),
         (210, 300, "capf.train.step", MAIN)]


def _training(extra_ranges=(), extra_device=()):
    """Three steps; the card busy over [10, 390] but for gaps [20, 40]
    (inside the first step), [150, 170] and [250, 260]; the window runs
    on to 1000, past the last device operation (the teardown)."""
    device = [(10, 20, "k0", 5, MAIN), (40, 150, "k1", 30, MAIN),
              (170, 250, "k2", 120, MAIN), (260, 390, "k3", 220, MAIN),
              *extra_device]
    return _trace(device, [*STEPS, *extra_ranges])


def test_the_steady_window_leaves_out_the_first_step_and_the_tail():
    t = _training()
    assert spans.steady(t) == (100, 390, 2)
    # idle [150, 170] and [250, 260] of the 290 us from the first step's
    # end to the last operation's; the first step's gap and the 610 us
    # after the last operation are the whole window's only
    assert _read("step_idle.train", t) == pytest.approx(30 / 290 * 100)
    assert _read("device_idle.train", t) == pytest.approx(
        (1000 - 330) / 1000 * 100)


def test_an_idle_gap_half_inside_a_span_counts_half():
    t = _training([(140, 160, "capf.train.optimizer", MAIN),
                   (240, 245, "capf.train.optimizer", MAIN),
                   (255, 258, "capf.data.wait", MAIN),
                   (25, 35, "capf.data.wait", MAIN)])
    # [150, 160] of the gap [150, 170] lies in the optimizer: 10 us over
    # two steps; the wait at [25, 35] is before the steady window
    assert _read("optimizer_idle_ms.train", t) == pytest.approx(5e-3)
    assert _read("data_idle_ms.train", t) == pytest.approx(1.5e-3)


def test_the_optimizers_launches_are_counted_per_step():
    opt = [(140, 160, "capf.train.optimizer", MAIN),
           (240, 250, "capf.train.optimizer", MAIN),
           (50, 60, "capf.train.optimizer", MAIN)]
    # three launches inside the spans (one before the steady window), one
    # just past a span's end
    launches = [(395, 396, "adam", 145, MAIN), (396, 397, "adam", 150, MAIN),
                (397, 398, "where", 55, MAIN), (398, 399, "norm", 251, MAIN)]
    t = _training(opt, launches)
    assert _read("optimizer_launches.train", t) == pytest.approx(1.0)


def test_serving_readers_are_per_request():
    lifts = [(0, 300, "portbench.lift", MAIN),
             (400, 700, "portbench.lift", MAIN)]
    inner = [(10, 50, "capf.serve.normalize", MAIN),
             (60, 160, "portbench.backbone", MAIN),
             (410, 450, "capf.serve.normalize", MAIN),
             (460, 520, "portbench.backbone", MAIN)]
    device = [(20, 40, "normalize", 15, MAIN),
              (420, 460, "normalize", 415, MAIN),
              (100, 200, "conv", 70, MAIN), (500, 600, "conv", 470, MAIN),
              (800, 810, "Memcpy DtoH", 750, MAIN)]  # after both requests
    t = _trace(device, lifts + inner)
    assert _read("normalize_ms.serve", t, "serve") == pytest.approx(30e-3)
    assert _read("backbone_dispatch_ms.serve", t, "serve") == \
        pytest.approx(80e-3)
    assert _read("launches.serve", t, "serve") == 2.0


SERVING = ["normalize_ms.serve", "backbone_dispatch_ms.serve",
           "launches.serve"]
TRAINING = ["step_idle.train", "optimizer_idle_ms.train",
            "data_idle_ms.train", "optimizer_launches.train"]


@pytest.mark.parametrize("name", SERVING + TRAINING)
def test_a_reader_gives_none_without_its_span(name):
    kind = "serve" if name in SERVING else "train"
    t = _trace([(10, 20, "k", 5, MAIN), (30, 40, "k", 25, MAIN)])
    assert _read(name, t, kind) is None
    assert harness.reader(name)(_run(t, "serve" if kind == "train"
                                     else "train")) is None


@pytest.mark.parametrize("name", SERVING + TRAINING)
def test_a_reader_gives_zero_with_nothing_to_count(name):
    if name in SERVING:
        t = _trace([(400, 410, "after", 390, MAIN)],
                   [(0, 300, "portbench.lift", MAIN),
                    (10, 50, "capf.serve.normalize", MAIN),
                    (60, 60, "portbench.backbone", MAIN)])
        assert _read(name, t, "serve") == 0.0
        return
    ranges = {"optimizer_idle_ms.train": [(120, 140, "capf.train.optimizer",
                                           MAIN)],
              "data_idle_ms.train": [(101, 109, "capf.data.wait", MAIN)],
              "optimizer_launches.train": [(120, 140,
                                            "capf.train.optimizer", MAIN)]}
    t = _trace([(0, 400, "k", 1, MAIN)], STEPS + ranges.get(name, []))
    assert _read(name, t) == 0.0
