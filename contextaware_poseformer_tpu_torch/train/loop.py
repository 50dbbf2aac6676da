"""Epoch-level training and evaluation, on one device or data-parallel.

Port of ``contextaware_poseformer_tpu/train/loop.py:39-294`` (reference:
ContextPose/train.py:140-213,369-412): the loop owns data iteration, device
staging, metric aggregation, the per-epoch log line, the best-P1 checkpoint
policy, the reference checkpoints' loading (through ``models/convert.py``
and ``models/bridge.py``) and, for an int8 deploy config, the calibration
before its first evaluation; the device work is ``train/steps.py``.

Once the process group is joined (``parallel.distributed.initialize``, a
world of one included) the lifter trains under ``DistributedDataParallel``
over the data axis of ``parallel.make_mesh``: each data rank steps on its
own shard of the data (``train_h36m.shard_datasets``) with the per-rank
batch, the gradients are averaged over the data group, only rank 0 writes
metrics and checkpoints (train.py:228-237), evaluation gathers every data
rank's predictions, and an int8 deploy model serves rank 0's calibration.
With ``model_parallel > 1`` every model group of that many ranks splits the
lifter's Linears (``parallel/tensor.py``): each rank builds the whole model
from the seed and keeps its shards, and a checkpoint holds the whole lifter
(gathered before rank 0 writes it), so that it restores at any
``model_parallel``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time
from typing import Any

import numpy as np
import torch

from contextaware_poseformer_tpu_torch.config import Config
from contextaware_poseformer_tpu_torch.data import pipeline
from contextaware_poseformer_tpu_torch.models import bridge, convert
from contextaware_poseformer_tpu_torch.models.backbone_common import (
    calibration_buffers,
    to_storage,
)
from contextaware_poseformer_tpu_torch.models.capf import (
    ContextAwarePoseFormer,
)
from contextaware_poseformer_tpu_torch.models.init import init_parameters
from contextaware_poseformer_tpu_torch.parallel import distributed, tensor
from contextaware_poseformer_tpu_torch.parallel.mesh import make_mesh
from contextaware_poseformer_tpu_torch.serve import (
    configure_numerics,
    prepare,
)
from contextaware_poseformer_tpu_torch.train import metrics as metrics_lib
from contextaware_poseformer_tpu_torch.train import steps
from contextaware_poseformer_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from contextaware_poseformer_tpu_torch.utils.profiling import span


class MetricWriter:
    """stdout + jsonl metric sink (the reference's tqdm prints and
    tensorboardX writer, train.py:135-136,391-395)."""

    def __init__(self, logdir: str | None):
        self.path = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self.path = os.path.join(logdir, "metrics.jsonl")

    def write(self, record: dict[str, Any]) -> None:
        msg = " | ".join(
            f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
            for k, v in record.items()
        )
        print(msg, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")


class Trainer:
    """Trains ``cfg`` on ``device`` (a CUDA device, or the CPU for tests).
    The backbone is frozen and stored in channels-last layout (an int8
    deploy config's int8 convs keep fp32 parameters); fp32 runs at full
    precision (TF32 off) as the JAX reference does. ``train_ds`` and
    ``val_ds`` are this rank's shards under data parallelism.
    ``model_parallel``: the ranks of a model group (``parallel.make_mesh``;
    the process group must be joined for more than one)."""

    def __init__(self, cfg: Config, train_ds, val_ds, device,
                 logdir: str | None = None, model_parallel: int = 1):
        self.cfg = cfg
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.device = torch.device(device)
        self.task = steps.Task.for_config(cfg)
        self.data_parallel = torch.distributed.is_initialized()
        self.mesh = make_mesh(model_parallel, self.device, cfg.model.lifter)
        # the last rank's shard holds the remainder rows: every rank takes
        # the fewest full batches of any rank, so that each DDP step is
        # joined by every rank and the epochs end at the same update
        self.batches_per_epoch = distributed.min_over_ranks(
            len(train_ds) // cfg.train.batch_size)
        self.steps_per_epoch = max(self.batches_per_epoch, 1)
        self.is_main = distributed.rank() == 0
        self.writer = MetricWriter(logdir if self.is_main else None)
        # every rank reads a checkpoint to resume; rank 0 alone writes
        self.ckpt = (CheckpointManager(os.path.join(logdir, "checkpoints"))
                     if logdir else None)
        if self.device.type == "cuda":
            configure_numerics()

    def init_state(self, seed: int) -> steps.TrainState:
        """A fresh model from ``seed`` (flax initializers, CPU generator)
        and its optimizer."""
        dtype = getattr(torch, self.cfg.model.compute_dtype)
        model = ContextAwarePoseFormer(self.cfg.model, dtype=dtype,
                                       device=self.device)
        init_parameters(model, torch.Generator().manual_seed(seed))
        to_storage(model.backbone, dtype)
        if self.cfg.model.backbone.frozen:
            model.backbone.requires_grad_(False)
        tensor.shard_model(model.lifter, self.mesh)
        optimizer = steps.make_optimizer(self.cfg, self.steps_per_epoch,
                                         model)
        ddp = None
        if self.data_parallel:
            # the frozen backbone has no gradient to reduce and no batch
            # statistics to broadcast; every parameter of the lifter takes
            # part in every step (drop-path and dropout multiply by a mask).
            # The inputs already sit on the model's one device.
            ddp = torch.nn.parallel.DistributedDataParallel(
                model, device_ids=None, broadcast_buffers=False,
                process_group=self.mesh.data_group)
        return steps.TrainState(model, optimizer, 0, ddp=ddp,
                                rank=self.mesh.data_rank,
                                data_group=self.mesh.data_group)

    def load_backbone(self, state: steps.TrainState,
                      checkpoint_path: str) -> steps.TrainState:
        """COCO-pretrained backbone init (train.py:292-304): the reference
        checkpoint's convs with their BN folded
        (``convert.convert_conv_backbone``; HRNet's ``final_layer`` and the
        CPN's predict heads skipped), loaded in place: on the trainer's
        device, in each tensor's dtype and layout, still frozen."""
        sd = convert.load_torch_state_dict(checkpoint_path)
        variables = bridge.variables_to_jax(state.model)
        params = variables["params"]
        params["backbone"] = convert.convert_conv_backbone(
            sd, params["backbone"],
            skip_patterns=convert.BACKBONE_SKIPS[self.cfg.model.backbone.kind])
        bridge.load_jax_variables(state.model, variables)
        return state

    def load_model(self, state: steps.TrainState,
                   checkpoint_path: str) -> steps.TrainState:
        """A trained reference CA_PF checkpoint (train.py:307-314;
        ``backbone.*`` and ``volume_net.*``) through
        ``convert.convert_composite``, loaded in place as
        ``load_backbone`` loads."""
        sd = convert.load_torch_state_dict(checkpoint_path)
        model_cfg = self.cfg.model
        params = bridge.variables_to_jax(state.model)["params"]
        full = convert.convert_composite(
            sd, params["backbone"], depth=model_cfg.lifter.depth,
            levels=model_cfg.lifter.levels,
            use_deformable=model_cfg.lifter.use_deformable,
            backbone_kind=model_cfg.backbone.kind)
        bridge.load_jax_variables(
            state.model, bridge.shard_for_rank({"params": full}, self.mesh))
        return state

    def _batches(self, host_iter):
        """The device batches of ``host_iter``, assembled and copied ahead
        of the consumer (``pipeline.device_prefetch``); close it (``with``)
        to stop the producer."""
        return contextlib.closing(pipeline.device_prefetch(
            host_iter, functools.partial(pipeline.to_device,
                                         device=self.device)))

    def train_epoch(self, state: steps.TrainState, epoch: int,
                    max_steps: int | None = None) -> dict[str, Any]:
        host_iter = pipeline.batch_iterator(
            self.train_ds, self.cfg.train.batch_size, shuffle=True,
            seed=self.cfg.train.seed, epoch=epoch,
            num_workers=self.cfg.data.num_workers,
        )
        limit = min(max_steps or self.batches_per_epoch,
                    self.batches_per_epoch)
        losses, n = [], 0
        t0 = time.time()
        with self._batches(host_iter) as batches:
            for batch, _valid in itertools.islice(batches, limit):
                with span("capf.train.step"):
                    m = steps.train_step(state, batch, self.cfg, self.task,
                                         self.cfg.train.seed + 1)
                losses.append(m["loss"])
                n += 1
        step_losses = [float(v) for v in losses]
        return {"train_loss": (float(np.mean(step_losses)) if step_losses
                               else float("nan")),
                "epoch_time_s": time.time() - t0, "steps": n,
                "step_losses": step_losses}

    def ensure_serving_ready(self, model) -> None:
        """An int8 config (``quantize`` "serve", "static" or "c128") has
        its int8 weights made and, where its mode calibrates, its scales
        (``serve.prepare``) before its first evaluation, on the first 64
        validation frames in chunks of 16, as the JAX loop's
        ``_ensure_serving_ready`` does; a no-op for a float config and for
        a model already prepared (its backbone is frozen)."""
        if (self.cfg.model.backbone.quantize == "none"
                or bool(model.backbone.serving_fingerprint.any())):
            return
        n = min(len(self.val_ds), 64)
        frames = np.stack([self.val_ds.load_image(i) for i in range(n)])
        prepare(model, [torch.from_numpy(frames).to(self.device)])
        # each rank calibrated on its own shard: serve rank 0's scales, so
        # that the gathered predictions do not depend on the rank count
        # (``loop.py:233-238``)
        distributed.broadcast_pytree(calibration_buffers(model.backbone))

    def predict_local(self, state: steps.TrainState,
                      max_batches: int | None = None):
        """(predictions, ground truth) over this rank's validation set as
        float32 numpy arrays, the padded last batch trimmed to its valid
        rows."""
        self.ensure_serving_ready(state.model)
        host_iter = pipeline.batch_iterator(
            self.val_ds, self.cfg.train.batch_size, shuffle=False,
            drop_remainder=False, num_workers=self.cfg.data.num_workers,
        )
        preds, gts = [], []
        with self._batches(host_iter) as batches:
            for i, (batch, valid) in enumerate(batches):
                pred, gt = steps.eval_step(state.model, batch, self.cfg,
                                           self.task)
                preds.append(pred[:valid].float().cpu().numpy())
                gts.append(gt[:valid].float().cpu().numpy())
                if max_batches and i + 1 >= max_batches:
                    break
        return np.concatenate(preds), np.concatenate(gts)

    def gather(self, local) -> np.ndarray:
        """``local`` of every data rank, concatenated in rank order (the
        ranks of a model group hold the same rows)."""
        return distributed.allgather_hosts(local, self.mesh.data_group)

    def predict(self, state: steps.TrainState,
                max_batches: int | None = None):
        """``predict_local`` of every data rank, gathered in rank order."""
        return tuple(map(self.gather, self.predict_local(state, max_batches)))

    def evaluate(self, state: steps.TrainState,
                 max_batches: int | None = None):
        """(summary in mm, per-action scores) over the validation set (of
        every rank)."""
        pred, gt = self.predict_local(state, max_batches)
        action_idx = np.asarray(self.val_ds.action_idx[:len(pred)])
        pred, gt, action_idx = map(self.gather, (pred, gt, action_idx))
        scores = metrics_lib.h36m_evaluate(gt, pred, action_idx)
        return metrics_lib.h36m_summary(scores), scores

    def fit(self, state: steps.TrainState, n_epochs: int,
            max_steps_per_epoch: int | None = None,
            eval_batches: int | None = None, start_epoch: int = 0):
        """Train and evaluate every epoch, save a checkpoint after each;
        returns (state, best P1 in mm over the epochs run)."""
        best_p1 = float("inf")
        for epoch in range(start_epoch, n_epochs):
            train_m = self.train_epoch(state, epoch,
                                       max_steps=max_steps_per_epoch)
            summary, _ = self.evaluate(state, max_batches=eval_batches)
            lr = steps.lr_schedule(self.cfg, self.steps_per_epoch)(state.step)
            train_m.pop("step_losses")
            if self.is_main:
                self.writer.write({"epoch": epoch, "lr": lr, **train_m,
                                   **summary})
            if self.ckpt:  # every rank gathers its shards, rank 0 writes
                self.ckpt.save(epoch, state, {"p1_mm": summary["p1_mm"]},
                               write=self.is_main)
            best_p1 = min(best_p1, summary["p1_mm"])
        return state, best_p1
