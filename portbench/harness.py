"""The benchmark's harness: finds a cell's files by the names in
``BENCHMARK.json``, checks the machine, runs the cell's driver, reads its
metrics and prints the result line.

A cell (``workloads`` entry) names a configuration and a traffic mix:

- ``portbench/configs/<config>.json``: the configuration as it is run;
- ``portbench/traffic/<traffic>.json``: the traffic's parameters and the
  driver that reads them (``portbench/drivers/<driver>.py``);
- ``portbench/workloads/<cell>.json``: the cell's limits of the numbers
  that decide ``correct``;
- ``portbench/metrics/<metric>.py``: one reader a metric, ``read(run)``,
  which returns the metric's value or None where the run has nothing to
  read.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, from a traced window. Either run checks the program's
output against the plain reference once its window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "contextaware_poseformer_tpu")


@dataclasses.dataclass
class Run:
    """What a driver measured, for the metric readers."""

    kind: str
    setup_s: float
    window_s: float
    items: int  # frames (serving) or samples (training) in the window
    batch: int
    attempted: int
    memory_peak_bytes: int
    trace: object = None  # tracing.Trace of a traced run
    latencies_s: list = dataclasses.field(default_factory=list)
    dispatch_s: list = dataclasses.field(default_factory=list)
    requests: int = 0
    steps: int = 0
    failed: int = 0
    compared: dict = dataclasses.field(default_factory=dict)
    cell: object = None
    inputs: dict = dataclasses.field(default_factory=dict)  # for readings

    @functools.cached_property
    def gflops_per_item(self) -> float:
        from portbench import flops
        return flops.gflops_per_item(self.cell.config,
                                     train=self.kind == "train")

    @functools.cached_property
    def int8_least_s(self) -> float:
        """The least time of one request's int8 convolutions."""
        from portbench import flops
        return flops.int8_conv_least_s(self.cell.config, self.batch)

    def peak_flops(self, dtype: str) -> float:
        from portbench.flops import peaks
        return peaks()[f"{dtype}_flops_per_s"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list


def note(clock, what: str) -> None:
    """Print on standard error when a step of set-up ended."""
    print(f"portbench: {what} at {clock():.3f} s", file=sys.stderr,
          flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reported(metrics, cell_name, e2e_names):
    """The metrics of ``metrics`` a cell reports: those listing it, and
    those without a list that move (per-layer) an end-to-end metric the
    cell reports, or (end-to-end) all."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif "moves" not in m or m["moves"] in e2e_names:
            out.append(m)
    return out


def load_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    e2e = reported(bench["end_to_end"], name, ())
    per_layer = reported(bench["per_layer"], name,
                         {m["name"] for m in e2e})
    return Cell(name, w["chips"], config, traffic, workload, e2e, per_layer)


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run: Run, metrics) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    modules = sys.modules if modules is None else modules
    return sorted({n for n in modules if n.split(".", 1)[0] in FORBIDDEN})


def process_start() -> float:
    """This process's start on the ``time.time()`` clock, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return time.time()


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0] if out else "unknown"


def cache_dirs(root: Path) -> None:
    """Fixed build and kernel caches inside the checkout, and a ``TMPDIR``
    that can be written (``temp_dir``)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    temp_dir(build / "tmp")


def temp_dir(fallback: Path) -> None:
    """Make the environment's ``TMPDIR`` usable by the program's kernel
    build: ``nvcc`` writes its intermediate files there and, unlike
    Python's ``tempfile``, stops where the folder is missing. A given
    ``TMPDIR`` that does not exist is made; one that cannot be made or
    written is replaced by ``fallback``, a fixed folder in the checkout."""
    given = os.environ.get("TMPDIR")
    if not given:
        return
    try:
        os.makedirs(given, exist_ok=True)
        if os.access(given, os.W_OK | os.X_OK):
            return
    except OSError:
        pass
    fallback.mkdir(parents=True, exist_ok=True)
    os.environ["TMPDIR"] = str(fallback)


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell: Cell, seed, seconds, trace, device, clock) -> Run:
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    run = driver.run(cell, seed, seconds, trace, device, clock)
    run.cell = cell
    return run


def report(cell: Cell, run: Run, trace: bool, device: dict) -> dict:
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    correct = run.failed == 0 and all(v <= lim for v, lim in
                                      run.compared.values())
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.compared.items()}
    return line


def finish(cell: Cell, run: Run, trace: bool, device: dict):
    """The result line, or None where the process has loaded a module of
    ``FORBIDDEN`` by the time the line is built: in the run, or in the
    metric readers and the counts that ``report`` loads after it."""
    line = report(cell, run, trace, device)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return None
    return line


def main(argv=None) -> int:
    start = process_start()
    args = parse(argv)
    root = HERE.parent
    cache_dirs(root)
    try:
        cell = load_cell(root, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    clock = lambda: time.time() - start  # noqa: E731
    note(clock, "torch imported")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                  clock)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit": power_limit()}
    line = finish(cell, run, bool(args.trace), device)
    if line is None:
        return 3
    shares = [k for k in line["metrics"] if "mfu" in k or "roofline" in k]
    if shares:
        print(f"shares {shares} of the {device['kind']} peaks, power limit "
              f"{device['power_limit']}", file=sys.stderr)
    for k, c in line["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
