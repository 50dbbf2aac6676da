"""The port's profiling utilities (``utils/profiling.py``) on the CPU:
``trace`` and ``StepWindowProfiler`` write ``torch.profiler`` traces of
exactly their window, ``sustained_timer`` feeds distinct inputs and ends
each burst with a host fetch, as the JAX package's timer does."""

import json

import pytest
import torch

from contextaware_poseformer_tpu_torch.utils import profiling


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_writes_the_block(tmp_path):
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("inside"):
            torch.ones(8).sum()
    with torch.profiler.record_function("outside"):
        torch.ones(8).sum()
    (path,) = tmp_path.glob("trace_*.json")
    names = _names(path)
    assert "inside" in names and "outside" not in names


@pytest.mark.parametrize("start,stop", [(2, 4), (0, 1)])
def test_step_window_profiler_traces_its_window(tmp_path, start, stop):
    """Steps [start, stop) of six, one ``step()`` call ahead of each step's
    work as the JAX loop calls it; ``close`` after the window is a no-op."""
    prof = profiling.StepWindowProfiler(str(tmp_path), start, stop)
    for i in range(6):
        prof.step()
        with torch.profiler.record_function(f"step_{i}"):
            torch.ones(4).sum()
    prof.close()
    (path,) = tmp_path.glob("trace_*.json")
    names = _names(path)
    # step() at count == start opens the window before step start's work;
    # at count == stop it closes it before step stop's work
    inside = {f"step_{i}" for i in range(start, stop - 1)}
    assert inside <= names
    assert not {f"step_{i}" for i in range(6)
                if i < start or i >= stop} & names


def test_step_window_profiler_close_ends_an_open_window(tmp_path):
    prof = profiling.StepWindowProfiler(str(tmp_path), 1, 100)
    for _ in range(3):
        prof.step()
    prof.close()
    prof.close()
    assert len(list(tmp_path.glob("trace_*.json"))) == 1


def test_sustained_timer_feeds_distinct_inputs_and_fetches():
    seen = []

    def fn(x):
        seen.append(float(x[0]))
        return {"y": (x * 2, "meta")}

    def make_args(i):
        return (torch.full((3,), float(i)),)

    res = profiling.sustained_timer(fn, make_args, iters=5, bursts=2)
    assert seen == [float(i) for i in range(11)]  # warm-up, then 2 x 5
    assert set(res) == {"sec_per_iter", "iters_per_sec"}
    assert res["sec_per_iter"] > 0
    assert res["iters_per_sec"] == pytest.approx(1 / res["sec_per_iter"])


SPANS = {"capf.serve.normalize", "capf.train.step", "capf.train.optimizer",
         "capf.data.wait"}


class _Counted:
    """A stand-in for ``record_function`` that counts its entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counted.entered += 1

    def __exit__(self, *exc):
        return False


def test_span_enters_no_range_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)
    _Counted.entered = 0
    first, second = profiling.span("capf.a"), profiling.span("capf.b")
    with first, second:
        torch.ones(4).sum()
    assert first is second and _Counted.entered == 0


def test_span_is_a_named_range_under_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("capf.probe"):
            torch.ones(8).sum()
    with profiling.span("capf.after"):
        torch.ones(8).sum()
    (path,) = tmp_path.glob("trace_*.json")
    names = _names(path)
    assert "capf.probe" in names and "capf.after" not in names


def _ranges(path):
    """The trace's ``capf.*`` ranges: (start, end, name, thread id)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
            for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("capf.")]


def _inside(inner, outers):
    return any(s <= inner[0] and inner[1] <= e and tid == inner[3]
               for s, e, _, tid in outers)


def test_serving_and_training_emit_the_four_spans(tmp_path):
    """A tiny float CPN request through ``serve.lift`` and a tiny 3-step
    ``Trainer.train_epoch`` under ``trace`` emit exactly the program's four
    spans: one normalization for the request, the optimizer inside each
    step, and the queue wait on the steps' thread between steps."""
    import dataclasses

    from contextaware_poseformer_tpu_torch import serve
    from contextaware_poseformer_tpu_torch.train import train_h36m
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = serve.slice_config("h36m_cpn")
        mc = cfg.model
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            mc, image_shape=(64, 64),
            backbone=dataclasses.replace(mc.backbone,
                                         cpn_layers=(1, 1, 1, 1)),
            lifter=dataclasses.replace(mc.lifter, embed_dim_ratio=32,
                                       depth=1)))
        model = serve.build_serving_model(
            cfg, "cpu", generator=torch.Generator().manual_seed(0))
        args = train_h36m.build_argparser().parse_args(
            ["--tiny", "--synthetic", "--device", "cpu", "--batch-size",
             "2"])
        tcfg = train_h36m.make_config(args)
        train_ds, val_ds = train_h36m.make_datasets(tcfg, args)
        trainer = Trainer(tcfg, train_ds, val_ds, "cpu")
        state = trainer.init_state(0)
        with profiling.trace(str(tmp_path)):
            serve.lift(model, torch.zeros(2, 64, 64, 3, dtype=torch.uint8),
                       torch.zeros(2, 17, 2), torch.full((2, 17, 2), 32.0))
            trainer.train_epoch(state, 0, max_steps=3)
    finally:
        torch.set_num_threads(threads)
    (path,) = tmp_path.glob("trace_*.json")
    ranges = _ranges(path)
    assert {n for _, _, n, _ in ranges} == SPANS

    def named(name):
        return [r for r in ranges if r[2] == name]

    (normalize,) = named("capf.serve.normalize")
    steps_ = sorted(named("capf.train.step"))
    assert len(steps_) == 3 == len(named("capf.train.optimizer"))
    assert all(_inside(r, steps_) for r in named("capf.train.optimizer"))
    assert normalize[1] <= steps_[0][0]
    main = {tid for *_, tid in steps_}
    assert len(main) == 1 and normalize[3] in main
    waits = named("capf.data.wait")
    assert len(waits) == 3 and {r[3] for r in waits} == main
    assert not any(s < w[1] and w[0] < e for w in waits
                   for s, e, _, _ in steps_)
