"""Training-step throughput of the port (sustained, honest timing).

The port's counterpart of the JAX package's ``tools/train_bench.py``: the
whole ``steps.train_step`` (normalization and augmentation, the frozen
backbone's forward, the loss, the lifter's backward, the clip and AdamW,
the NaN guard) of a preset at its image shape, on one device-resident
synthetic batch a batch size, timed by ``utils/profiling.sustained_timer``
(distinct inputs every step; each burst ends by fetching the loss): ms a
step, steps/s, frames/s and the MFU of the step (``tools/model_flops``:
the training step's FLOPs a frame over the peak of the compute dtype)::

  python -m contextaware_poseformer_tpu_torch.tools.train_bench \\
      --preset h36m_cpn --batches 64,128,256 [--eval] \\
      [--compute-dtype bfloat16] [--trace-steps 2:4 --logdir traces]

``--eval`` also times the flip-test eval step (one forward of 2B).
``--trace-steps a:b`` profiles steps [a, b) of a further run
(``utils/profiling.StepWindowProfiler``) under
``tools/trace_budget.annotate`` and prints the trace's budget. ``--tiny``
cuts the preset as ``train_h36m --tiny`` does (a CPU smoke run:
``--tiny --device cpu --batches 2 --iters 2 --bursts 1``).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os

import torch


def _batch(cfg, bs: int, device):
    from contextaware_poseformer_tpu_torch.data import pipeline
    from contextaware_poseformer_tpu_torch.data.synthetic import (
        SyntheticPoseDataset,
    )

    from contextaware_poseformer_tpu_torch.train.steps import Task

    ds = SyntheticPoseDataset(size=bs, image_shape=cfg.model.image_shape,
                              seed=0, root_idx=Task.for_config(cfg).root_idx)
    raw, _ = next(pipeline.batch_iterator(ds, bs, shuffle=False,
                                          num_workers=1))
    return ds, pipeline.to_device(raw, device)


def bench_batch(cfg, bs: int, device, iters: int, bursts: int,
                evaluate: bool, trace_steps=None, logdir: str = "") -> dict:
    """One batch size: its train step (and eval step) timings; with
    ``trace_steps`` (start, stop), the budget of a profiled window."""
    from contextaware_poseformer_tpu_torch.tools import model_flops
    from contextaware_poseformer_tpu_torch.tools import trace_budget
    from contextaware_poseformer_tpu_torch.train import steps
    from contextaware_poseformer_tpu_torch.train.loop import Trainer
    from contextaware_poseformer_tpu_torch.utils.profiling import (
        StepWindowProfiler,
        sustained_timer,
    )

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=bs))
    ds, raw = _batch(cfg, bs, device)
    trainer = Trainer(cfg, ds, ds, device)
    state = trainer.init_state(cfg.train.seed)

    def salted(salt, kp3=True):
        return raw._replace(**({"keypoints_3d": raw.keypoints_3d + salt}
                               if kp3 else
                               {"keypoints_2d": raw.keypoints_2d + salt}))

    def step_once(salt):
        return steps.train_step(state, salted(salt), cfg, trainer.task,
                                cfg.train.seed + 1)["loss"]

    r = sustained_timer(step_once, lambda i: (i * 1e-6,), iters=iters,
                        bursts=bursts)
    flops = model_flops.count(cfg.model, train=True)["gflops_per_frame"]
    out = {"batch": bs, "ms_per_step": r["sec_per_iter"] * 1e3,
           "steps_per_s": r["iters_per_sec"],
           "frames_per_s": bs * r["iters_per_sec"],
           "train_gflops_per_frame": flops,
           "mfu": model_flops.mfu(flops, bs * r["iters_per_sec"],
                                  cfg.model.compute_dtype)}
    if evaluate:
        model = state.model

        def eval_once(salt):
            return steps.eval_step(model, salted(salt * 1e-3, kp3=False),
                                   cfg, trainer.task)[0]

        e = sustained_timer(eval_once, lambda i: (i * 1e-6,), iters=iters,
                            bursts=bursts)
        out.update(eval_ms_per_step=e["sec_per_iter"] * 1e3,
                   eval_frames_per_s=bs * e["iters_per_sec"])
    if trace_steps:
        start, stop = trace_steps
        os.makedirs(logdir, exist_ok=True)
        before = set(glob.glob(os.path.join(logdir, "trace_*.json")))
        # step() ahead of each step's work; the window stays open through
        # step stop - 1 and ``close`` ends it after that step's sync
        prof = StepWindowProfiler(logdir, start, stop + 1)
        with trace_budget.annotate(state.model):
            for i in range(stop):
                prof.step()
                step_once(float(i))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        prof.close()
        path = sorted(set(glob.glob(os.path.join(logdir, "trace_*.json")))
                      - before)[-1]
        out["trace"] = path
        out["budget"] = trace_budget.budget(trace_budget.load_trace(path))
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="h36m_hrnet_32")
    ap.add_argument("--batches", default="64,128,256")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bursts", type=int, default=3)
    ap.add_argument("--eval", action="store_true",
                    help="also time the eval step (flip-test folded into "
                    "the batch axis: one 2B forward)")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="override ModelConfig.compute_dtype (bfloat16: the "
                    "frozen backbone in bf16, the lifter and optimizer fp32)")
    ap.add_argument("--trace-steps", default=None, metavar="START:STOP",
                    help="profile steps [START, STOP) and print the budget")
    ap.add_argument("--logdir", default="traces",
                    help="where --trace-steps writes its trace")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a smoke run)")
    args = ap.parse_args(argv)

    from contextaware_poseformer_tpu_torch import config as cfglib
    from contextaware_poseformer_tpu_torch.tools import trace_budget
    from contextaware_poseformer_tpu_torch.train import train_h36m

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"train_bench: --device {args.device}: no CUDA "
                         "device here")
    cfg = cfglib.preset(args.preset)
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=args.compute_dtype))
    if args.tiny:
        cfg = train_h36m.tiny(cfg)
    trace_steps = (tuple(int(v) for v in args.trace_steps.split(":"))
                   if args.trace_steps else None)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name}); preset {args.preset}"
          f"{' (tiny)' if args.tiny else ''}, {cfg.model.compute_dtype}")
    results = []
    for bs in [int(b) for b in args.batches.split(",")]:
        try:
            r = bench_batch(cfg, bs, device, args.iters, args.bursts,
                            args.eval, trace_steps, args.logdir)
        except torch.OutOfMemoryError as e:  # report OOM per batch size
            print(f"batch {bs}: out of memory: {str(e)[:120]}")
            continue
        print(f"batch {bs}: {r['ms_per_step']:.1f} ms/step, "
              f"{r['steps_per_s']:.2f} steps/s, {r['frames_per_s']:.0f} "
              f"frames/s, MFU {r['mfu'] * 100:.2f}% "
              f"({r['train_gflops_per_frame']:.3f} GFLOP a frame)",
              flush=True)
        if args.eval:
            print(f"batch {bs} EVAL (flip-test 2B fwd): "
                  f"{r['eval_ms_per_step']:.1f} ms/step, "
                  f"{r['eval_frames_per_s']:.0f} frames/s", flush=True)
        if trace_steps:
            print(f"batch {bs}: trace {r['trace']}, steps {trace_steps}:")
            print(trace_budget.report(r["budget"],
                                      trace_steps[1] - trace_steps[0]))
        results.append(r)
    return results


if __name__ == "__main__":
    main()
