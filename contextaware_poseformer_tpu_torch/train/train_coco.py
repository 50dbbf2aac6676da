"""CPN COCO 2D-detector training / evaluation driver of the port.

The CLI of ``contextaware_poseformer_tpu/train/train_coco.py`` (the runnable
equivalent of ContextPose/mvn/models/cpn/{train,test}.py), with the same
flags and ``--device`` (default ``cuda``, never another; ``cpu`` for a
smoke run). Recipe per cpn/config.py and train.py: Adam lr 5e-4 with
torch-style L2 weight decay 1e-5 (added to the gradient before the
moments), lr x0.5 after epochs 6, 12, 18, ..., batch 32, 32 epochs; losses
= the 4 zeroed-label global MSEs + the top-8 OHKM refine loss; test = the
optional flip test (one forward of 2B), the two-peak quarter-pixel decode
and OKS AP (``train/coco_eval.py``). Batches reach the device through
``pipeline.device_prefetch``; ``--checkpoint`` holds ``latest.npz`` in the
JAX package's key layout, so a checkpoint moves between the two packages.

  # train on COCO person keypoints:
  python -m contextaware_poseformer_tpu_torch.train.train_coco \\
      --ann annotations/person_keypoints_train2017.json \\
      --image-dir train2017 --checkpoint ckpt_cpn_coco

  # evaluate a checkpoint on person detections:
  python -m contextaware_poseformer_tpu_torch.train.train_coco --eval \\
      --ann annotations/person_keypoints_val2017.json \\
      --dets dets_val2017.json --image-dir val2017 \\
      --checkpoint ckpt_cpn_coco --result result/

  # smoke run without data:
  python -m contextaware_poseformer_tpu_torch.train.train_coco \\
      --synthetic --tiny --device cpu --epochs 1 --steps-per-epoch 2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from contextaware_poseformer_tpu_torch.config import (
    BackboneConfig,
    cpn_backbone,
)
from contextaware_poseformer_tpu_torch.data import coco as coco_data
from contextaware_poseformer_tpu_torch.data import pipeline
from contextaware_poseformer_tpu_torch.models import bridge
from contextaware_poseformer_tpu_torch.models.cpn_coco import (
    CPNCoco,
    init_weights,
)
from contextaware_poseformer_tpu_torch.serve import configure_numerics
from contextaware_poseformer_tpu_torch.train import coco_eval, losses

# cpn/config.py:17-22
LR = 5e-4
LR_GAMMA = 0.5
LR_DEC_EPOCHS = tuple(range(6, 40, 6))
WEIGHT_DECAY = 1e-5
BATCH_SIZE = 32
EPOCHS = 32


class CocoBatch(NamedTuple):
    """A training batch: images (N, H, W, 3) normalized RGB, the four
    target sets stacked (4, N, H/4, W/4, K) (gk15, 11, 9, 7), valid (N,
    K); numpy on the host, tensors on the device
    (``pipeline.to_device``)."""

    image: object
    targets: object
    valid: object


class EvalBatch(NamedTuple):
    """A test batch's images; the rest of the batch stays on the host."""

    image: object


def tiny_backbone() -> BackboneConfig:
    return dataclasses.replace(cpn_backbone(), cpn_layers=(1, 1, 1, 1))


def build_model(backbone: BackboneConfig, device, seed: int = 0) -> CPNCoco:
    model = CPNCoco(backbone, device=device)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def lr_schedule(steps_per_epoch: int):
    """The learning rate of update ``count`` (counted from 0, as optax
    counts): LR times 0.5 for every boundary ``e * steps_per_epoch`` (e in
    6, 12, ...) at or below ``count``, as
    ``optax.piecewise_constant_schedule`` scales (its indicator,
    ``sign(boundary - count)`` clipped at 0, is 0 at the boundary): a new
    rate takes hold at the first update of its epoch."""
    bounds = [e * steps_per_epoch for e in LR_DEC_EPOCHS]

    def fn(count: int) -> float:
        return LR * LR_GAMMA ** sum(b <= count for b in bounds)

    return fn


class Optimizer:
    """``torch.optim.Adam(lr, weight_decay)`` (cpn/train.py:33-35): the L2
    decay is added to the GRADIENT before the Adam moments (unlike AdamW),
    as the JAX package's ``optax.chain(add_decayed_weights, scale_by_adam,
    scale_by_learning_rate)``; betas 0.9/0.999, eps 1e-8. ``count`` is the
    number of updates made; update ``count`` runs at ``lr_schedule``'s
    rate for it."""

    def __init__(self, params, steps_per_epoch: int):
        self.schedule = lr_schedule(steps_per_epoch)
        self.adam = torch.optim.Adam(params, lr=LR, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=WEIGHT_DECAY)
        self.count = 0

    def step(self) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)


def loss_fn(model: CPNCoco, batch: CocoBatch):
    """(loss, global loss, refine loss) of one train-mode forward (which
    updates the BN running statistics)."""
    global_outs, refine_out = model(batch.image)
    g = losses.coco_global_loss(global_outs, batch.targets, batch.valid)
    r = losses.coco_refine_ohkm_loss(refine_out, batch.targets[3],
                                     batch.valid)
    return g + r, g, r


def train_step(model: CPNCoco, opt: Optimizer,
               batch: CocoBatch) -> dict[str, torch.Tensor]:
    """One update on a device batch; {"loss", "global", "refine"} as
    device scalars."""
    model.train()
    opt.zero_grad()
    loss, g, r = loss_fn(model, batch)
    loss.backward()
    opt.step()
    return {"loss": loss.detach(), "global": g.detach(),
            "refine": r.detach()}


def flip_index() -> list[int]:
    idx = list(range(coco_data.NUM_JOINTS))
    for a, b in coco_data.SYMMETRY:
        idx[a], idx[b] = b, a
    return idx


@torch.no_grad()
def eval_step(model: CPNCoco, image: torch.Tensor,
              flip: bool) -> torch.Tensor:
    """Refine heatmaps (N, Ho, Wo, K), optionally averaged with the
    mirrored input's (cpn/test.py:44-70); the flip pass rides the batch
    axis: ONE forward of 2B."""
    model.eval()
    if not flip:
        return model(image)[1]
    n = image.shape[0]
    _, refine = model(torch.cat([image, torch.flip(image, dims=[2])]))
    mirrored = torch.flip(refine[n:], dims=[2])[..., flip_index()]
    return (refine[:n] + mirrored) / 2.0


def _synthetic_batches(rng, steps, batch, img_hw=(64, 64)):
    """The JAX package's synthetic batches, draw for draw (numpy)."""
    h, w = img_hw
    oh, ow = h // 4, w // 4
    for _ in range(steps):
        yield {
            "image": rng.randn(batch, h, w, 3).astype(np.float32),
            "targets": tuple(
                rng.rand(batch, oh, ow, coco_data.NUM_JOINTS).astype(
                    np.float32) * 255.0
                for _ in range(4)
            ),
            "valid": rng.randint(0, 3, (batch, coco_data.NUM_JOINTS)).astype(
                np.float32),
        }


def host_batch(batch: dict) -> CocoBatch:
    """A numpy training batch (``CocoKeypointDataset.batches``,
    ``_synthetic_batches``) with its targets stacked."""
    return CocoBatch(batch["image"], np.stack(batch["targets"]),
                     batch["valid"])


def staged(batches, device, passenger=lambda b: None):
    """``device_prefetch`` over numpy batches: yields (device batch, the
    batch's ``passenger``, host data that stays on the host); close it
    (``with``) to stop the producer."""
    host_iter = ((host_batch(b) if "targets" in b else EvalBatch(b["image"]),
                  passenger(b)) for b in batches)
    return contextlib.closing(pipeline.device_prefetch(
        host_iter, functools.partial(pipeline.to_device, device=device)))


def _flatten(tree, path=()):
    """(path, leaf) of a nested dict, in ``jax.tree_util``'s sorted order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flatten(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _leaves(tree):
    """(the JAX package's ``_save`` key, the dict holding the leaf, its
    name) of every leaf of a ``cpn_coco_to_jax`` tree: ``p`` or ``s``
    (params, batch_stats), then the path as ``jax.tree_util`` prints it."""
    for tag, sub in (("p", tree["params"]), ("s", tree["batch_stats"])):
        for path, _ in _flatten(sub):
            node = sub
            for k in path[:-1]:
                node = node[k]
            yield tag + "/".join(f"[{k!r}]" for k in path), node, path[-1]


def _save(directory: str, epoch: int, model: CPNCoco) -> None:
    """``latest.npz`` with the JAX package's keys (``train_coco.py:166-173``),
    so that its ``_restore`` reads it."""
    os.makedirs(directory, exist_ok=True)
    tree = bridge.cpn_coco_to_jax(model)
    np.savez(os.path.join(directory, "latest.npz"), epoch=epoch,
             **{key: node[name] for key, node, name in _leaves(tree)})


def _restore(directory: str, model: CPNCoco) -> int:
    """Load ``latest.npz`` (written by either package) into ``model`` in
    place; returns its epoch."""
    data = np.load(os.path.join(directory, "latest.npz"))
    tree = bridge.cpn_coco_to_jax(model)
    for key, node, name in _leaves(tree):
        node[name] = data[key]
    model.load_state_dict(bridge.cpn_coco_from_jax(tree))
    return int(data["epoch"])


def _device(args) -> torch.device:
    """The run's device, never another; fp32 at full precision on a card
    (TF32 off), as the JAX reference computes."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here")
    if device.type == "cuda":
        configure_numerics()
    return device


def train(args) -> dict:
    device = _device(args)
    rng = np.random.RandomState(args.seed)
    backbone = tiny_backbone() if args.tiny else cpn_backbone()
    model = build_model(backbone, device, args.seed)

    if args.synthetic:
        steps_per_epoch = args.steps_per_epoch

        def epoch_batches():
            return _synthetic_batches(rng, steps_per_epoch, args.batch)
    else:
        ds = coco_data.CocoKeypointDataset.from_annotations(
            args.ann, args.image_dir, train=True)
        steps_per_epoch = args.steps_per_epoch or len(ds) // args.batch

        def epoch_batches():
            return ds.batches(args.batch, rng=rng)

    opt = Optimizer(model.parameters(), steps_per_epoch)
    history = []
    for epoch in range(args.epochs):
        step_losses = []
        with staged(epoch_batches(), device) as batches:
            for i, (batch, _) in enumerate(batches):
                if args.steps_per_epoch and i >= args.steps_per_epoch:
                    break
                step_losses.append(train_step(model, opt, batch)["loss"])
        avg = sum(map(float, step_losses)) / max(len(step_losses), 1)
        history.append(avg)
        print(f"epoch {epoch + 1}/{args.epochs} | train_loss {avg:.5f}")
        if args.checkpoint:
            _save(args.checkpoint, epoch, model)
    return {"history": history, "model": model}


def load_torch_checkpoint(model: CPNCoco, path: str) -> None:
    """The reference CPN256x192 checkpoint through the port's
    ``convert.convert_cpn_coco`` (its target: ``cpn_coco_to_jax`` of the
    model) and ``bridge.cpn_coco_from_jax``, in place."""
    from contextaware_poseformer_tpu_torch.models.convert import (
        convert_cpn_coco,
        load_torch_state_dict,
    )

    out = convert_cpn_coco(load_torch_state_dict(path),
                           bridge.cpn_coco_to_jax(model))
    model.load_state_dict(bridge.cpn_coco_from_jax(out))


def evaluate(args) -> dict:
    device = _device(args)
    backbone = tiny_backbone() if args.tiny else cpn_backbone()
    model = build_model(backbone, device)
    if args.checkpoint and os.path.exists(
            os.path.join(args.checkpoint, "latest.npz")):
        _restore(args.checkpoint, model)
    elif args.torch_ckpt:
        load_torch_checkpoint(model, args.torch_ckpt)

    if args.dets:
        ds = coco_data.CocoKeypointDataset.from_detections(
            args.dets, args.ann, args.image_dir)
    else:
        ds = coco_data.CocoKeypointDataset.from_annotations(
            args.ann, args.image_dir, train=False)

    results = []
    with staged(ds.batches(args.batch, drop_last=False), device,
                lambda b: b) as batches:
        for batch, meta in batches:
            maps = eval_step(model, batch.image, args.flip).cpu().numpy()
            results += coco_eval.decode_batch(
                maps, meta["details"], meta["det_score"], meta["image_id"])

    if args.result:
        os.makedirs(args.result, exist_ok=True)
        with open(os.path.join(args.result, "result.json"), "w") as f:
            json.dump(results, f)

    with open(args.ann) as f:
        gt = json.load(f)["annotations"]
    summary = coco_eval.oks_ap(results, gt)
    for k, v in summary.items():
        print(f"{k:>10}: {v:.4f}")
    return summary


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="CPN COCO detector (PyTorch)")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu for a "
                    "smoke run)")
    ap.add_argument("--ann", help="person_keypoints_*.json path")
    ap.add_argument("--image-dir", default=".")
    ap.add_argument("--dets", help="COCO detection results json (eval)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--torch-ckpt", help="reference CPN256x192 .pth.tar")
    ap.add_argument("--result", default="")
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--batch", type=int, default=BATCH_SIZE)
    ap.add_argument("--steps-per-epoch", type=int, default=0)
    ap.add_argument("--flip", action="store_true", default=True)
    ap.add_argument("--no-flip", dest="flip", action="store_false")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.eval:
        return evaluate(args)
    return train(args)


if __name__ == "__main__":
    main()
