"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the benchmark's tests: the same files, with fewer blocks, a 64x64 crop, a
narrower and shallower lifter, a few frames a request."""

import json
import time
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVING = [w for w in CELLS if harness.load_cell(ROOT, w).traffic[
    "driver"] == "serving"]
TRAINING = [w for w in CELLS if w not in SERVING]


def shrink(cfg):
    bb = cfg["backbone"]
    if bb["kind"] == "cpn":
        bb["resnet_layers"] = [1, 1, 1, 1]
    else:
        bb["stage2"].update(blocks=[1, 1])
        bb["stage3"].update(modules=1, blocks=[1, 1, 1])
        bb["stage4"].update(modules=2, blocks=[1, 1, 1, 1])
    cfg["image_shape"] = [64, 64]
    cfg["lifter"].update(embed_dim_ratio=32, depth=2)
    if "calibration" in cfg:
        cfg["calibration"] = {"frames": 16, "chunk": 8}
    return cfg


def cell(name):
    c = harness.load_cell(ROOT, name)
    shrink(c.config)
    c.traffic.update(batch=4, pool_requests=2, warmup_requests=2,
                     trace_seconds=0.3, samples=16, epoch_samples=64,
                     trace_steps=2)
    return c


def run(c, seed=2 ** 31 + 11, seconds=0.3, trace=False):
    """One run of tiny cell ``c`` on the CPU, past the look for a chip."""
    t0 = time.time()
    return harness.execute(c, seed, seconds, trace, "cpu",
                           lambda: time.time() - t0)
