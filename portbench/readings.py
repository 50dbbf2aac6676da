"""The readings that set the limits of ``correct``: the program's numbers
over many seeds (the lower readings), the lower-precision control's and,
for training, a planted fault's (the upper readings).

    python3 portbench/readings.py --workload <name> --seeds 12 \
        [--first 2147483648]

Serving: each seed runs the cell (a one-second window) and reads its
numbers; the control is the reference computed with int4 (levels 7)
where the configuration states int8, put in the program's place and
compared with the int8 reference by the same measure. Training: each seed
runs the cell's set-up steps (no window) and reads its three numbers; the
control is the reference with TF32 on (the configuration states fp32 with
TF32 off), and the fault is the reference with the loss over half of the
batch; a state left unchanged reads 1 by construction (``change_gap``).
Prints one JSON line a seed and a summary. Not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import harness  # noqa: E402


def serving(cell, seed, device, clock):
    from portbench.drivers.serving import (
        NUMBER, int8_units, reference_poses, widest,
    )

    run = harness.execute(cell, seed, 1.0, False, device, clock)
    params, pool = run.inputs["params"], run.inputs["pool"]
    ref = reference_poses(cell.config, params, pool, device)
    control = reference_poses(cell.config, params, pool, device, levels=7)
    unit = int8_units(cell, params, pool, device, ref)
    return {"program": {k: v for k, (v, _) in run.compared.items()},
            "control": {NUMBER: widest(enumerate(control), ref, unit)}}


def training(cell, seed, device, clock):
    from portbench.drivers.training import (
        readings, reference_steps, train_seed,
    )

    run = harness.execute(cell, seed, 0.0, False, device, clock)
    inp = run.inputs
    args = (cell.config, inp["params"], inp["data"], inp["rows"],
            train_seed(seed), device)
    control = reference_steps(*args, tf32=True)
    fault = reference_steps(*args, half_batch=True)
    return {"program": {k: v for k, (v, _) in run.compared.items()},
            "control": readings(control, inp["reference"]),
            "fault_half_batch": readings(fault, inp["reference"])}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=2 ** 31 + 1000)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    cell = harness.load_cell(root, args.workload)
    fn = serving if cell.traffic["driver"] == "serving" else training
    t0 = time.time()
    rows = []
    for seed in range(args.first, args.first + args.seeds):
        row = {"seed": seed, **fn(cell, seed, "cuda:0",
                                   lambda: time.time() - t0)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for kind in rows[0]:
        if kind == "seed":
            continue
        for k in rows[0][kind]:
            vals = [r[kind][k] for r in rows]
            summary[f"{kind}.{k}"] = {"max": max(vals), "min": min(vals)}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
