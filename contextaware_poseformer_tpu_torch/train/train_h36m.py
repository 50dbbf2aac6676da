"""Human3.6M training / evaluation driver of the port.

The CLI of ``contextaware_poseformer_tpu/train/train_h36m.py:28-250``
(reference recipe: AdamW wd 0.1 over the lifter, per-epoch decay, flip
augmentation, flip-test evaluation, best-P1 checkpoints with true resume),
on one device given by ``--device`` (default ``cuda``; ``cpu`` for a smoke
run), which never falls back to another. Every preset trains (``h36m_hrnet_32``, the default model,
``h36m_hrnet_48`` and ``h36m_cpn``: the frozen fp32 backbone, the lifter
with its deformable blocks); a ``_deploy`` preset evaluates the int8 deploy
graph (``--eval``), calibrated on the first 64 validation frames::

  python -m contextaware_poseformer_tpu_torch.train.train_h36m \\
      --preset h36m_hrnet_32 --synthetic --device cuda --epochs 1 \\
      --steps-per-epoch 4 --eval-batches 1

``--tiny`` cuts the backbone to a width-8 HRNet with one block a stage and
the lifter to embed 32, depth 2, on 64x64 frames (the JAX CLI's tiny
model; a CPU smoke run: ``--tiny --synthetic --device cpu``).
``--backbone-ckpt`` loads a COCO-pretrained reference backbone and
``--model-ckpt`` a trained reference CA_PF checkpoint, both through the
port's copy of ``models/convert.py``. A YAML overlay (``--config``) cuts
any preset, for instance the CPN::

  model: {image_shape: [64, 64], backbone: {cpn_layers: [1, 1, 1, 1]},
          lifter: {embed_dim_ratio: 32, depth: 1}}
  train: {batch_size: 2}

Data-parallel training (the reference's DDP over NCCL) runs one process a
device under torchrun, each on its own contiguous shard of the train and
validation sets with ``--batch-size`` rows a step (the global batch is the
world size times it); evaluation gathers every rank's predictions::

  torchrun --nproc_per_node 8 -m \\
      contextaware_poseformer_tpu_torch.train.train_h36m --distributed \\
      --preset h36m_cpn --synthetic

(``--device cpu`` takes gloo). ``--model-parallel N`` (with
``--distributed``) also splits the lifter's Linears over each group of N
consecutive ranks (``parallel/tensor.py``); the data shards, and the global
batch, are then world size / N of them::

  torchrun --nproc_per_node 4 -m \
      contextaware_poseformer_tpu_torch.train.train_h36m --distributed \
      --model-parallel 2 --preset h36m_cpn --synthetic
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from contextaware_poseformer_tpu_torch import config as cfglib
from contextaware_poseformer_tpu_torch.parallel import distributed, mesh


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Context-Aware PoseFormer (PyTorch) - H36M")
    p.add_argument(
        "--preset", default="h36m_cpn",
        choices=[n + s for n in ("h36m_hrnet_32", "h36m_hrnet_48", "h36m_cpn")
                 for s in ("", "_deploy")],
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a "
                   "smoke run)")
    p.add_argument("--config", default=None, help="YAML overlay path")
    p.add_argument("--eval", action="store_true", help="evaluate only")
    p.add_argument("--data-root", default=None)
    p.add_argument("--train-labels", default=None)
    p.add_argument("--val-labels", default=None)
    p.add_argument("--backbone-ckpt", default=None,
                   help="COCO-pretrained torch backbone checkpoint")
    p.add_argument("--model-ckpt", default=None,
                   help="trained torch CA_PF checkpoint to convert+load")
    p.add_argument("--logdir", default="logs/h36m")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks a model group splits the lifter over "
                   "(with --distributed)")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data smoke mode (no H36M needed)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model (synthetic smoke/testing)")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--eval-batches", type=int, default=None)
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel run under torchrun (NCCL on cuda, "
                   "gloo on cpu)")
    return p


def check_args(args) -> None:
    """Refuse, before any process group is joined, a ``--model-parallel``
    below 1, or above 1 without ``--distributed`` (the ``Trainer``'s
    ``mesh.make_mesh`` refuses what the world or the config cannot split)."""
    try:
        mesh.check_tensor_parallel(args.model_parallel)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.model_parallel > 1 and not args.distributed:
        raise SystemExit(f"--model-parallel {args.model_parallel} splits "
                         "the lifter over that many ranks: run it with "
                         "--distributed under torchrun")


def setup(args) -> tuple[dict, torch.device]:
    """Refuse what cannot run and a CUDA device that is missing; join the
    process group under ``--distributed``; returns the topology and this
    rank's device (``cuda:LOCAL_RANK`` under torchrun)."""
    check_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here")
    topo = (distributed.initialize(args.device) if args.distributed
            else distributed.topology())
    try:
        mesh.check_tensor_parallel(args.model_parallel,
                                   world=topo["process_count"])
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return topo, distributed.local_device(device)


def shard_datasets(train_ds, val_ds, topo, model_parallel: int = 1):
    """Per-data-rank contiguous dataset shards (the reference's per-rank
    label slicing and DistributedSampler, human36m.py:536-552,
    train.py:68-71): ``process_count // model_parallel`` of them, rank
    ``process_index // model_parallel`` (``parallel.make_mesh``'s layout:
    the ranks of a model group hold the same rows). Both train and val
    shard: the evaluation gathers its results. The last data rank takes
    the remainder rows; the ``Trainer`` steps every rank through the fewest
    full batches of any rank."""
    shards = topo["process_count"] // model_parallel
    if shards > 1:
        index = topo["process_index"] // model_parallel
        train_ds.shard(index, shards)
        val_ds.shard(index, shards)
    return train_ds, val_ds


def tiny(cfg: cfglib.Config, width: int = 8) -> cfglib.Config:
    """The tiny model of the JAX CLI's ``--tiny``
    (``train_h36m.py:124-150`` of the JAX package): an HRNet of ``width``
    (8 there; the deploy-numerics gate's is 32) with one block a stage, the
    lifter at embed 32, depth 2, 64x64 frames. Only the structure shrinks;
    the numerics knobs stay, so ``--tiny --preset <x>_deploy`` still runs
    the deploy graph."""
    w = width
    c = (w, 2 * w, 4 * w, 8 * w)
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model,
            backbone=dataclasses.replace(
                cfg.model.backbone, kind="hrnet", width=w,
                stage2=cfglib.HRNetStageConfig(1, 2, (2, 2), c[:2]),
                stage3=cfglib.HRNetStageConfig(1, 3, (2, 2, 2), c[:3]),
                stage4=cfglib.HRNetStageConfig(1, 4, (2, 2, 2, 2), c),
            ),
            lifter=dataclasses.replace(
                cfg.model.lifter, embed_dim_ratio=32, depth=2, levels=4,
            ),
            image_shape=(64, 64),
        ),
    )


def make_config(args) -> cfglib.Config:
    cfg = cfglib.preset_or_deploy(args.preset)
    if args.config:
        cfg = cfglib.load_config(args.config, base=cfg)
    train = {}
    if args.epochs is not None:
        train["n_epochs"] = args.epochs
    if args.batch_size is not None:
        train["batch_size"] = args.batch_size
    if args.seed:
        train["seed"] = args.seed
    data = {k: v for k, v in (("root", args.data_root),
                              ("train_labels_path", args.train_labels),
                              ("val_labels_path", args.val_labels)) if v}
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **train),
        data=dataclasses.replace(cfg.data, **data))
    return tiny(cfg) if args.tiny else cfg


def make_datasets(cfg, args):
    if args.synthetic:
        from contextaware_poseformer_tpu_torch.data.synthetic import (
            SyntheticPoseDataset,
        )

        train_ds = SyntheticPoseDataset(
            size=max(cfg.train.batch_size * 4, 64),
            image_shape=cfg.model.image_shape, seed=cfg.train.seed,
        )
        val_ds = SyntheticPoseDataset(
            size=max(cfg.train.batch_size * 2, 32),
            image_shape=cfg.model.image_shape, seed=cfg.train.seed + 99,
        )
        return train_ds, val_ds
    from contextaware_poseformer_tpu_torch.data.h36m import H36MDataset

    train_ds = H36MDataset.from_pickle(
        cfg.data.train_labels_path, cfg.data.root, cfg.model.image_shape,
        frame_store=cfg.data.train_frame_store or None,
    )
    val_ds = H36MDataset.from_pickle(
        cfg.data.val_labels_path, cfg.data.root, cfg.model.image_shape,
        frame_store=cfg.data.val_frame_store or None,
    )
    return train_ds, val_ds


def main(argv=None):
    """Returns (trainer, final state, best P1 in mm or the eval summary)."""
    args = build_argparser().parse_args(argv)
    topo, device = setup(args)
    cfg = make_config(args)
    train_ds, val_ds = shard_datasets(*make_datasets(cfg, args), topo,
                                      args.model_parallel)

    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, train_ds, val_ds, device, logdir=args.logdir,
                      model_parallel=args.model_parallel)
    print(describe(device, topo, args.model_parallel))
    state = trainer.init_state(cfg.train.seed)
    print("Trainable parameter count:",  # train.py:358-359
          sum(p.numel() for p in state.model.lifter.parameters()),
          *(["(this rank's shard)"] if args.model_parallel > 1 else []))
    if args.backbone_ckpt:
        state = trainer.load_backbone(state, args.backbone_ckpt)
        print(f"Loaded backbone from {args.backbone_ckpt}")
    if args.model_ckpt:
        state = trainer.load_model(state, args.model_ckpt)
        print(f"Loaded full model from {args.model_ckpt}")

    start_epoch = 0
    if args.resume and trainer.ckpt:
        state, start_epoch = trainer.ckpt.restore(state)
        print(f"Resumed from epoch {start_epoch - 1}")

    if args.eval:
        summary, scores = trainer.evaluate(state,
                                           max_batches=args.eval_batches)
        for action, s in scores.items():
            print(f"{action}: p1={s['MPJPE'] * 1000:.2f}, "
                  f"p2={s['P_MPJPE'] * 1000:.2f}, "
                  f"e_vel={s['MPJVE'] * 1000:.2f}")
        print("avg p1:", round(summary["p1_mm"], 1),
              "p2:", round(summary["p2_mm"], 1),
              "MPJVE:", round(summary["mpjve_mm"], 2))
        return trainer, state, summary

    state, best_p1 = trainer.fit(
        state, cfg.train.n_epochs,
        max_steps_per_epoch=args.steps_per_epoch,
        eval_batches=args.eval_batches, start_epoch=start_epoch,
    )
    print(f"best p1: {best_p1:.2f} mm")
    return trainer, state, best_p1


def describe(device, topo, tp: int = 1) -> str:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return (f"device: {device} ({name}) | rank {topo['process_index']} of "
            f"{topo['process_count']}" + (f" | model parallel {tp}"
                                          if tp > 1 else ""))


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
