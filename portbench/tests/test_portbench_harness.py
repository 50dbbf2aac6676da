"""The harness on the CPU: discovery by name, the benchmark file's format, the
metric arithmetic, the import check, and that a run without a card fails
instead of reporting."""

import importlib
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import entry, harness, tracing
from portbench.tests.tiny import BENCH, CELLS, ROOT, SERVING, TRAINING
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_discovery_finds_each_cell(name):
    cell = harness.load_cell(ROOT, name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == w["config"]
    assert (ROOT / "portbench" / "drivers"
            / f"{cell.traffic['driver']}.py").exists()
    assert set(cell.workload["limits"]) and cell.workload["config"] == \
        w["config"] and cell.workload["traffic"] == w["traffic"]
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert all(m["moves"] in names for m in cell.per_layer)


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_each_metric_has_a_reader(name):
    assert callable(harness.reader(name))


def test_no_reader_without_a_metric():
    files = {p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert files == {m["name"] for m in METRICS}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configuration_files_state_the_programs_entry(name):
    c = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == name
    pc = entry.program_config(cfg)
    # the file's sizes change nothing in the program's configuration
    e = cfg["entry"]
    assert pc == getattr(importlib.import_module(e["module"]),
                         e["build"])(e["preset"])
    bb, pbb = cfg["backbone"], pc.model.backbone
    assert pbb.kind == bb["kind"]
    if bb["kind"] == "cpn":
        int8 = "stream" if (pbb.quantize == "serve" and pbb.cpn_int8_stream
                            and pbb.cpn_int8_maps) else "none"
    else:
        int8 = ("layer1_wide" if pbb.quantize == "serve"
                and pbb.layer1_impl == "pallas"
                and not pbb.serve_static_amax else "none")
    assert int8 == bb["int8"]
    if int8 != "none":
        assert pbb.calib_quantile == bb["calib_quantile"]
    assert c["reduced"] == cfg["reduced"] == []


def test_benchmark_file_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [m["name"] for m in METRICS] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E and m["workloads"]
        for w in m["workloads"]:
            cell = harness.load_cell(ROOT, w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    for m in METRICS:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def _run(**kw):
    base = dict(kind="serve", setup_s=1.0, window_s=2.0, items=0, batch=4,
                attempted=0, memory_peak_bytes=0)
    base.update(kw)
    return harness.Run(**base)


def test_rates_are_over_the_whole_window():
    read = harness.reader
    assert read("frames_per_s")(_run(items=1000, window_s=2.0)) == 500.0
    train = _run(kind="train", items=2560, window_s=4.0, steps=10)
    assert read("train_samples_per_s")(train) == 640.0
    assert read("frames_per_s")(train) is None


def test_p95_is_over_every_request():
    lat = [i / 1000 for i in range(1, 101)]
    got = harness.reader("request_p95_ms")(_run(latencies_s=lat))
    assert got == pytest.approx(float(np.percentile(lat, 95)) * 1e3)
    assert got == pytest.approx(95.05)


def _trace(events, ranges=()):
    """A Chrome trace of device events (start, dur, name, range) launched
    under host ranges, in a window [0, 100] us."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
           "pid": 1, "tid": 1, "ts": 0, "dur": 100}]
    for i, (s, d, name, rng) in enumerate(events):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "pid": 1, "tid": 1, "ts": s, "dur": 0.1,
                   "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                   "tid": 7, "ts": s, "dur": d,
                   "args": {"correlation": i}})
        if rng:
            ev.append({"ph": "X", "cat": "user_annotation", "name": rng,
                       "pid": 1, "tid": 1, "ts": s - 0.05, "dur": 0.2})
    for s, d, name in ranges:
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "pid": 1, "tid": 1, "ts": s, "dur": d})
    return tracing.Trace(ev)


def test_idle_is_the_complement_of_the_union_of_device_intervals():
    t = _trace([(10, 20, "a", None), (20, 20, "b", None),
                (70, 10, "c", None)])
    assert t.busy_s == pytest.approx(40e-6)
    assert t.window_s == pytest.approx(100e-6)
    run = _run(trace=t)
    assert harness.reader("device_idle.serve")(run) == pytest.approx(60.0)


def test_breakdown_names_ops_and_gaps():
    t = _trace([(10, 20, "a", None), (70, 10, "a", None)],
               ranges=[(25, 50, "portbench.wait")])
    b = t.breakdown()
    assert b["device_ops"] == [["a", pytest.approx(30e-6)]]
    assert b["idle_gaps"][0] == ["portbench.wait", pytest.approx(40e-6)]


def test_layer_times_and_shares():
    t = _trace([(0, 30, "k10", "portbench.int8_conv"),
                (40, 10, "lift", "portbench.lifter")])
    # device events join their launch's ranges; the lift range encloses all
    t.events = [(s, e, n, ["portbench.lift", *r]) for s, e, n, r in t.events]
    run = _run(trace=t, requests=2, items=8, batch=4)
    run.__dict__["int8_least_s"] = 6e-6
    run.__dict__["gflops_per_item"] = 1.0
    read = harness.reader
    assert read("int8_conv_roofline.serve")(run) == pytest.approx(40.0)
    assert read("lifter_ms.serve")(run) == pytest.approx(5e-3)
    assert read("backbone_ms.serve")(run) == pytest.approx(15e-3)
    assert read("mfu.serve")(run) == pytest.approx(
        8 / 100e-6 * 1e9 / 989e12 * 100)


def test_forbidden_modules_compare_whole_top_level_names():
    ok = {"contextaware_poseformer_tpu_torch": 1,
          "contextaware_poseformer_tpu_torch.serve": 1, "jaxtyping": 1,
          "opt_einsum.backends.jax": 1}
    assert harness.forbidden_modules(ok) == []
    bad = dict(ok, **{"jax.numpy": 1, "contextaware_poseformer_tpu.models": 1,
                      "flax": 1, "jaxlib": 1})
    assert harness.forbidden_modules(bad) == [
        "contextaware_poseformer_tpu.models", "flax", "jax.numpy", "jaxlib"]


def test_the_kernel_build_gets_a_temp_dir_it_can_write(tmp_path,
                                                     monkeypatch):
    fallback = tmp_path / "checkout" / "build" / "tmp"
    missing = tmp_path / "given" / "tmp"
    monkeypatch.setenv("TMPDIR", str(missing))
    harness.temp_dir(fallback)
    assert missing.is_dir() and harness.os.environ["TMPDIR"] == str(missing)
    assert not fallback.exists()
    blocked = tmp_path / "a_file"
    blocked.write_text("")
    monkeypatch.setenv("TMPDIR", str(blocked / "tmp"))
    harness.temp_dir(fallback)
    assert fallback.is_dir() and harness.os.environ["TMPDIR"] == str(fallback)
    monkeypatch.delenv("TMPDIR")
    harness.temp_dir(tmp_path / "unused")
    assert "TMPDIR" not in harness.os.environ
    assert not (tmp_path / "unused").exists()


def test_a_forbidden_module_loaded_while_the_line_is_built_stops_it(
        monkeypatch):
    cell = tiny.cell(CELLS[0])
    run = harness.Run(kind="serve", setup_s=1.0, window_s=1.0, items=0,
                      batch=1, attempted=0, memory_peak_bytes=0)
    monkeypatch.setattr(harness, "FORBIDDEN", ("portbench_forbidden_probe",))
    assert harness.finish(cell, run, False, {"platform": "gpu"}) is not None

    def loads_it(run, metrics):
        monkeypatch.setitem(sys.modules, "portbench_forbidden_probe.sub",
                            object())
        return {}

    monkeypatch.setattr(harness, "read_metrics", loads_it)
    assert harness.finish(cell, run, False, {"platform": "gpu"}) is None


SETUP_SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.tests import tiny
from portbench import harness
cell = tiny.cell({name!r})
run = tiny.run(cell)
assert harness.finish(cell, run, False, {{"platform": "cpu"}}) is not None
for m in tiny.BENCH["end_to_end"] + tiny.BENCH["per_layer"]:
    harness.reader(m["name"])(run)
run.gflops_per_item
if run.kind == "serve":
    run.int8_least_s
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


@pytest.mark.parametrize("name", CELLS)
def test_a_cells_setup_path_loads_no_jax(name):
    out = subprocess.run(
        [sys.executable, "-c", SETUP_SCRIPT.format(root=str(ROOT),
                                                   name=name)],
        capture_output=True, text=True, timeout=600, check=True)
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert "contextaware_poseformer_tpu_torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = ("import sys; sys.path.insert(0, '.');"
              "from portbench.tests import tiny;"
              f"tiny.run(tiny.cell({SERVING[0]!r}))")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "contextaware_poseformer_tpu_torch" in out.stderr


@pytest.mark.parametrize("name", SERVING + TRAINING)
def test_a_tiny_run_reports_its_metrics(name):
    cell = tiny.cell(name)
    run = tiny.run(cell, seconds=2.0)
    line = harness.report(cell, run, False, {"platform": "cpu"})
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(line)[-1] == "compared"
    assert set(line["compared"]) == set(cell.workload["limits"])
