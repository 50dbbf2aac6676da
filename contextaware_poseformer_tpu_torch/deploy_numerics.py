"""The deploy-numerics gate: what the int8 deploy stack costs in trained
accuracy.

Port of ``tools/deploy_numerics.py::preset_gate`` and ``_tiny_cfg``
(``:489-612``): a tiny model of the preset's class is trained on the
synthetic geometric-consistency task (``data/synthetic.py``) through the
port's ``steps.train_step``, then P1 is evaluated twice on the same trained
weights: for the fp32 model, and for the deploy stack the port serves for
that configuration (``serve.deploy_graph``: ``config.deploy``, the int8
backbone, the bf16 lifter and its kernels, with an HRNet's layer1 through
K9, which computes ``config.deploy``'s per-conv int8 layer1 bit for bit),
calibrated by ``serve.prepare`` on the first 64 validation frames in chunks
of 16 (``Trainer.ensure_serving_ready``). The HRNet classes keep width-32
stages, so the int8 rule for convs with both channel counts >= 128 engages
(branch 3 has 128 channels, branch 4 256)::

  python -m contextaware_poseformer_tpu_torch.deploy_numerics \\
      --preset h36m_hrnet_32 [--device cpu] [--seed 1]

(on the card unless ``--device`` names another).

The weights come from the port's own initializers and training, not from
the JAX gate's, so its deltas are this gate's own and not a replay of the
JAX package's numbers.

For a CPN the gate also evaluates, on the same trained weights, the deploy
stack with each of its two serving knobs (``KNOBS``: ``cpn_fold_normalize``,
``cpn_int8_topdown``), each on top of the deploy graph as the JAX gate
stacks them (``tools/deploy_numerics.py:321-344``), and prints each P1 with
its delta against fp32 and against the deploy stack.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from contextaware_poseformer_tpu_torch import config as cfglib
from contextaware_poseformer_tpu_torch import serve
from contextaware_poseformer_tpu_torch.data import pipeline
from contextaware_poseformer_tpu_torch.data.synthetic import (
    SyntheticPoseDataset,
)
from contextaware_poseformer_tpu_torch.train import steps, train_h36m
from contextaware_poseformer_tpu_torch.train.loop import Trainer

BATCH = 16
# the CPN's serving knobs the gate evaluates beside the deploy stack: the
# result keys' short name -> the backbone field
KNOBS = {"fold": "cpn_fold_normalize", "topdown": "cpn_int8_topdown"}


def _tiny_cfg(preset_name: str) -> cfglib.Config:
    """Tiny trainable config in the PRESET's deploy-knob class:
    ``train_h36m.tiny`` at width 32 (the int8 rule for convs with both
    channel counts >= 128 engages: branch 3 has 128 channels, branch 4
    256); a CPN keeps its backbone cut to one block a stage
    (``cpn_layers=(1, 1, 1, 1)``, the 4-level /32../4 sampler geometry);
    the 3DHP presets keep ``use_deformable=False``; batch 16."""
    cfg = cfglib.preset(preset_name)
    small = train_h36m.tiny(cfg, width=32)
    if cfg.model.backbone.kind == "cpn":
        small = dataclasses.replace(small, model=dataclasses.replace(
            small.model, backbone=dataclasses.replace(
                cfg.model.backbone, cpn_layers=(1, 1, 1, 1))))
    return dataclasses.replace(
        small, train=dataclasses.replace(small.train, batch_size=BATCH))


def _p1_mm(trainer: Trainer, state: steps.TrainState) -> float:
    """P1 in mm over the validation set, with the flip-test eval step (an
    int8 model is calibrated first)."""
    pred, gt = trainer.predict(state)
    return float(np.linalg.norm(pred - gt, axis=-1).mean() * 1000)


def _deploy_p1(cfg, state, train_ds, val_ds, device, seed):
    """(trainer, state, P1 in mm) of ``cfg``'s deploy model loaded with the
    trained fp32 model's weights (``state``)."""
    deploy = Trainer(cfg, train_ds, val_ds, device)
    deploy_state = deploy.init_state(seed)
    loaded = deploy_state.model.load_state_dict(state.model.state_dict(),
                                                strict=False)
    params = {n for n, _ in deploy_state.model.named_parameters()}
    if loaded.unexpected_keys or params & set(loaded.missing_keys):
        raise AssertionError(f"fp32 -> deploy weights: {loaded}")
    return deploy, deploy_state, _p1_mm(deploy, deploy_state)


def preset_gate(preset_name: str, steps_n: int = 250, device="cuda",
                seed: int = 0, inspect=None) -> dict:
    """fp32 vs the deploy stack on the trained tiny model of
    ``preset_name``'s class, on ``device``; returns the JAX gate's keys
    (P1 in mm, rounded to 4 places) and, for a CPN, each serving knob's
    (``tiny_trained_deploy_<knob>_p1_mm`` and its delta against fp32,
    ``tiny_trained_<knob>_delta_mm``). ``seed`` draws the initial weights and
    the training batches. ``inspect(fp32, deploy)``, if given, runs last
    on the two (trainer, state) pairs."""
    device = torch.device(device)
    cfg = _tiny_cfg(preset_name)
    train_ds = SyntheticPoseDataset(size=128, image_shape=(64, 64), seed=0)
    val_ds = SyntheticPoseDataset(size=64, image_shape=(64, 64), seed=99)
    trainer = Trainer(cfg, train_ds, val_ds, device)
    state = trainer.init_state(seed)
    # the JAX gate's schedule: the learning rate decays every 100 steps
    state.optimizer = steps.make_optimizer(cfg, 100, state.model)
    rng = np.random.RandomState(seed)
    for _ in range(steps_n):
        idx = rng.randint(0, len(train_ds), BATCH)
        raw = pipeline.RawBatch(train_ds._images[idx], train_ds.joints_3d[idx],
                                train_ds.joints_2d[idx],
                                train_ds.joints_2d_crop[idx])
        m = steps.train_step(state, pipeline.to_device(raw, device), cfg,
                             trainer.task, 1)
    print(f"[{preset_name}] trained {steps_n} steps (seed {seed}), "
          f"final loss {float(m['loss']):.4f}", flush=True)
    p1 = _p1_mm(trainer, state)

    dcfg = serve.deploy_graph(cfg)
    deploy, deploy_state, p1d = _deploy_p1(dcfg, state, train_ds, val_ds,
                                           device, seed)
    print(f"[{preset_name}] trained P1: fp32 {p1:.3f} mm | "
          f"full deploy stack {p1d:.3f} mm | delta {p1d - p1:+.3f} mm",
          flush=True)
    row = {
        "preset": preset_name,
        "tiny_trained_fp32_p1_mm": round(p1, 4),
        "tiny_trained_deploy_p1_mm": round(p1d, 4),
        "tiny_trained_delta_mm": round(p1d - p1, 4),
    }
    if cfg.model.backbone.kind == "cpn":
        for short, knob in KNOBS.items():
            kcfg = dataclasses.replace(dcfg, model=dataclasses.replace(
                dcfg.model, backbone=dataclasses.replace(
                    dcfg.model.backbone, **{knob: True})))
            p1k = _deploy_p1(kcfg, state, train_ds, val_ds, device, seed)[2]
            print(f"[{preset_name}] trained P1: deploy {knob} {p1k:.3f} mm "
                  f"| delta vs fp32 {p1k - p1:+.3f} mm | vs deploy "
                  f"{p1k - p1d:+.3f} mm", flush=True)
            row[f"tiny_trained_deploy_{short}_p1_mm"] = round(p1k, 4)
            row[f"tiny_trained_{short}_delta_mm"] = round(p1k - p1, 4)
    if inspect is not None:
        inspect((trainer, state), (deploy, deploy_state))
    return row


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", action="append", choices=cfglib.PRESETS,
                    help="preset whose class is gated (repeatable; default "
                         "every preset)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu for a "
                    "smoke run)")
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--seed", type=int, default=0,
                    help="draws the initial weights and the training batches")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here")
    rows = [preset_gate(name, args.steps, device, args.seed)
            for name in (args.preset or cfglib.PRESETS)]
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
