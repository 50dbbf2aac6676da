"""MPI-INF-3DHP training / evaluation CLI of the port.

The CLI of ``contextaware_poseformer_tpu/train/train_3dhp.py`` (reference:
ContextPose_mpi/run_3dhp.py): GT-2D inputs, the lifter without deformable
blocks, the HRNet backbone, root = joint 14 zeroed in every loss and
metric, batch 160, AdamW wd 0.1, lr x0.97/epoch with x0.5 every 80 epochs,
flip-test evaluation with PCK@150 and AUC per sequence
(``train/metrics.mpi3dhp_evaluate``), an optional ``inference_data.mat``
for the reference's MATLAB pipeline (``--export-mat``, with ``--eval``),
best-P1 checkpoints with true resume. One device, given by ``--device``
(default ``cuda``, never another)::

  python -m contextaware_poseformer_tpu_torch.train.train_3dhp \\
      --preset mpi_3dhp_hrnet_32 --synthetic --device cuda --epochs 1 \\
      --steps-per-epoch 4 --eval-batches 1

``--tiny`` cuts it as ``train_h36m --tiny`` does (CPU smoke run: ``--tiny
--synthetic --device cpu``). ``--distributed`` trains data-parallel under
torchrun as ``train_h36m --distributed`` does, and ``--model-parallel N``
splits the lifter as there.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from contextaware_poseformer_tpu_torch import config as cfglib
from contextaware_poseformer_tpu_torch.parallel import distributed
from contextaware_poseformer_tpu_torch.train import metrics as metrics_lib
from contextaware_poseformer_tpu_torch.train import train_h36m
from contextaware_poseformer_tpu_torch.train.loop import Trainer


class Trainer3dhp(Trainer):
    """3DHP evaluation: P1 over all joints (root 14 zeroed on BOTH sides,
    run_3dhp.py:109,118) and PCK/AUC per sequence."""

    def evaluate(self, state, max_batches: int | None = None):
        """(summary: p1_mm, pck, auc; the ``mpi3dhp_evaluate`` tables).
        Keeps the (gathered) predictions and their sequence indices for
        ``--export-mat`` as ``last_pred`` and ``last_seq_idx``."""
        pred, gt = self.predict_local(state, max_batches)
        seq_idx = np.asarray(self.val_ds.seq_idx[:len(pred)])
        pred, gt, seq_idx = map(self.gather, (pred, gt, seq_idx))
        # the ground truth is root-centred at joint 14 (steps.prepare)
        pred[:, 14] = 0.0  # root zeroed before error (run_3dhp.py:118)
        p1 = float(np.mean(np.linalg.norm(pred - gt, axis=-1)))
        errors = metrics_lib.joint_errors_mm(pred, gt)
        seq_errors = {
            name: errors[seq_idx == i]
            for i, name in enumerate(self.val_ds.seq_names)
            if (seq_idx == i).any()
        }
        tables = metrics_lib.mpi3dhp_evaluate(seq_errors)
        overall = tables.get("All", {})
        self.last_pred, self.last_seq_idx = pred, seq_idx
        return {"p1_mm": p1, "pck": overall.get("pck", 0.0),
                "auc": overall.get("auc", 0.0)}, tables


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Context-Aware PoseFormer (PyTorch) - 3DHP")
    p.add_argument(
        "--preset", default="mpi_3dhp_hrnet_32",
        choices=[n + s for n in ("mpi_3dhp_hrnet_32", "mpi_3dhp_hrnet_48")
                 for s in ("", "_deploy")],
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a "
                   "smoke run)")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--data-root", default="dataset")
    p.add_argument("--train-npz", default=None)
    p.add_argument("--test-npz", default=None)
    p.add_argument("--backbone-ckpt", default=None,
                   help="COCO-pretrained torch backbone checkpoint")
    p.add_argument("--logdir", default="logs/3dhp")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--export-mat", default=None,
                   help="write inference_data.mat for the MATLAB pipeline")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--eval-batches", type=int, default=None)
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks a model group splits the lifter over "
                   "(with --distributed)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel run under torchrun (NCCL on cuda, "
                   "gloo on cpu)")
    return p


def make_config(args) -> cfglib.Config:
    """The H36M CLI's config plumbing; ``--tiny`` keeps the 3DHP lifter
    (no deformable blocks)."""
    cfg = train_h36m.make_config(argparse.Namespace(
        preset=args.preset, config=None, epochs=args.epochs,
        batch_size=args.batch_size, seed=0, data_root=None,
        train_labels=None, val_labels=None, tiny=args.tiny))
    model = cfg.model
    if args.tiny:
        model = dataclasses.replace(model, lifter=dataclasses.replace(
            model.lifter, use_deformable=False))
    return dataclasses.replace(
        cfg, model=model,
        data=dataclasses.replace(cfg.data, dataset="mpi_inf_3dhp"))


def make_datasets(cfg, args):
    if args.synthetic:
        from contextaware_poseformer_tpu_torch.data.synthetic import (
            SyntheticPoseDataset,
        )

        def make(size, seed):
            return SyntheticPoseDataset(
                size=size, image_shape=cfg.model.image_shape, seed=seed,
                root_idx=14, num_seqs=6)

        return (make(max(cfg.train.batch_size * 4, 64), 0),
                make(max(cfg.train.batch_size * 2, 32), 99))
    from contextaware_poseformer_tpu_torch.data import mpi3dhp

    root = args.data_root
    train_ds = mpi3dhp.load_train(
        args.train_npz or os.path.join(root, "data_train_3dhp.npz"),
        os.path.join(root, "mpi_inf_3dhp", "images"),
        frame_store=cfg.data.train_frame_store or None,
    )
    val_ds = mpi3dhp.load_test(
        args.test_npz or os.path.join(root, "data_test_3dhp.npz"),
        os.path.join(root, "mpi_inf_3dhp_test_set", "images"),
        frame_store=cfg.data.val_frame_store or None,
    )
    return train_ds, val_ds


def main(argv=None):
    """Returns (trainer, final state, best P1 in mm or the eval summary)."""
    args = build_argparser().parse_args(argv)
    topo, device = train_h36m.setup(args)
    cfg = make_config(args)
    train_ds, val_ds = train_h36m.shard_datasets(*make_datasets(cfg, args),
                                                 topo, args.model_parallel)

    trainer = Trainer3dhp(cfg, train_ds, val_ds, device, logdir=args.logdir,
                          model_parallel=args.model_parallel)
    print(train_h36m.describe(device, topo, args.model_parallel))
    state = trainer.init_state(cfg.train.seed)
    print("Trainable parameter count:",
          sum(p.numel() for p in state.model.lifter.parameters()),
          *(["(this rank's shard)"] if args.model_parallel > 1 else []))
    if args.backbone_ckpt:
        state = trainer.load_backbone(state, args.backbone_ckpt)
        print(f"Loaded backbone from {args.backbone_ckpt}")

    start_epoch = 0
    if args.resume and trainer.ckpt:
        state, start_epoch = trainer.ckpt.restore(state)
        print(f"Resumed from epoch {start_epoch - 1}")

    if args.eval:
        summary, tables = trainer.evaluate(state,
                                           max_batches=args.eval_batches)
        for seq, row in tables.items():
            line = " ".join(f"{k}={v:.2f}" for k, v in row.items()
                            if not k.startswith(("pck_", "auc_")))
            print(f"{seq}: {line}")
        print(f"p1: {summary['p1_mm']:.2f} pck: {summary['pck']:.2f} "
              f"auc: {summary['auc']:.2f}")
        if args.export_mat and trainer.is_main:
            from contextaware_poseformer_tpu_torch.data.mpi3dhp import (
                export_inference_mat,
            )

            export_inference_mat(args.export_mat, trainer.last_pred,
                                 trainer.last_seq_idx, val_ds.seq_names)
            print(f"wrote {args.export_mat}")
        return trainer, state, summary

    state, best_p1 = trainer.fit(
        state, cfg.train.n_epochs, max_steps_per_epoch=args.steps_per_epoch,
        eval_batches=args.eval_batches, start_epoch=start_epoch,
    )
    print(f"best p1: {best_p1:.2f}")
    return trainer, state, best_p1


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
