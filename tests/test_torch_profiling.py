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
