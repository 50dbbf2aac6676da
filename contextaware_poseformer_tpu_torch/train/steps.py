"""Train and eval steps.

Port of ``contextaware_poseformer_tpu/train/steps.py:41-234``, the reference
recipe (ContextPose/train.py:140-213,337-345,410-412): AdamW (weight decay
0.1) over the LIFTER parameters only (the backbone is frozen), the MPJPE
loss, an exponential per-epoch learning-rate decay, a random flip per batch
in training and the flip-test average in evaluation.

  train_step: raw uint8 batch -> normalize -> augment -> forward
              (deterministic=False) -> loss -> backward -> NaN guard -> update
  eval_step:  raw uint8 batch -> normalize -> one forward of 2B with the
              flipped copy folded into the batch axis -> merged predictions

Randomness comes from one ``torch.Generator`` on the device, reseeded from
(seed, step, rank) at every step, the counterpart of the JAX step's
``fold_in(rng, step)``: a resumed run draws what an uninterrupted one would,
and under data parallelism (``TrainState.ddp``) each rank draws for its own
rows, as one JAX step draws over the whole global batch; rank 0 draws what a
single process draws. The rank folded is the data rank: under tensor
parallelism the ranks of one model group hold the same rows and must draw
the same drop-path masks. The draws differ from JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from contextaware_poseformer_tpu_torch.config import Config
from contextaware_poseformer_tpu_torch.data import augment
from contextaware_poseformer_tpu_torch.data.pipeline import RawBatch
from contextaware_poseformer_tpu_torch.parallel import distributed, tensor
from contextaware_poseformer_tpu_torch.train import losses
from contextaware_poseformer_tpu_torch.utils import skeleton
from contextaware_poseformer_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Task:
    """Dataset-dependent constants of the steps."""

    root_idx: int
    flip_perm: np.ndarray
    crop_width: int

    @staticmethod
    def for_config(cfg: Config) -> "Task":
        if cfg.data.dataset == "human36m":
            return Task(skeleton.H36M_ROOT, skeleton.H36M_FLIP_PERM,
                        cfg.model.image_shape[1])
        return Task(skeleton.MPI3DHP_ROOT, skeleton.MPI3DHP_FLIP_PERM,
                    cfg.model.image_shape[1])


def lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """lr0 * decay^epoch, stepped at epoch boundaries (train.py:410-412);
    3DHP also halves every ``large_decay_epoch`` (run_3dhp.py:318-325)."""
    t = cfg.train

    def fn(step: int) -> float:
        epoch = step // steps_per_epoch
        lr = t.lr * (t.lr_decay ** epoch)
        if t.large_decay_epoch:
            lr = lr * (t.lr_decay_large ** (epoch // t.large_decay_epoch))
        return lr

    return fn


class Optimizer:
    """The JAX package's optax stack on the lifter's parameters:
    ``clip_by_global_norm(grad_clip / lr)`` (when ``grad_clip`` is set)
    then ``adamw(schedule, weight_decay)`` with optax's defaults (betas
    0.9/0.999, eps 1e-8, decay decoupled and applied to every parameter).

    The clip is optax's, not ``clip_grad_norm_``'s: gradients scale by
    ``max_norm / norm`` exactly when ``norm >= max_norm``. The learning rate
    of step ``k`` is ``lr_schedule(k)``, as optax counts updates.

    Under tensor parallelism ``sharded`` holds the parameters that are this
    rank's shards and ``tp`` their model group: the global norm sums the
    shards' squares over the group and counts the replicated parameters,
    the same on every rank, once."""

    def __init__(self, params, cfg: Config, steps_per_epoch: int,
                 sharded=(), tp=None):
        self.params = list(params)
        self.sharded = [any(p is q for q in sharded) for p in self.params]
        self.tp = tp
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.max_norm = (cfg.train.grad_clip / cfg.train.lr
                         if cfg.train.grad_clip else None)
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.train.weight_decay)

    def step(self, step: int, finite: torch.Tensor | None = None) -> None:
        """Apply one update from the parameters' ``.grad`` at update count
        ``step``. ``finite`` (a bool scalar tensor) False zeroes the
        gradients first (the NaN guard); the update still runs, so the
        moments decay and the weight decay applies, as in optax."""
        grads = []
        for p in self.params:
            if p.grad is None:  # optax updates it with a zero gradient
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        with torch.no_grad():
            if finite is not None:
                for g in grads:
                    g.copy_(torch.where(finite, g, 0.0))
            if self.max_norm is not None:
                norm = self.global_norm(grads)
                for g in grads:
                    g.copy_(torch.where(norm < self.max_norm, g,
                                        g / norm * self.max_norm))
            for group in self.adamw.param_groups:
                group["lr"] = self.schedule(step)
            self.adamw.step()

    def global_norm(self, grads) -> torch.Tensor:
        """The L2 norm of the whole model's gradient (a collective over the
        model group under tensor parallelism)."""
        if self.tp is None:
            return torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        squares = [torch.linalg.vector_norm(g).square() for g in grads]
        own = torch.stack([q for q, s in zip(squares, self.sharded) if s])
        shared = [q for q, s in zip(squares, self.sharded) if not s]
        total = tensor.reduce(own.sum(), self.tp)
        return (total + torch.stack(shared).sum() if shared else total).sqrt()

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)


def make_optimizer(cfg: Config, steps_per_epoch: int, model) -> Optimizer:
    """AdamW over ``model.lifter``'s parameters only; the frozen backbone
    gets no optimizer state and no weight decay. A lifter split by
    ``parallel.tensor.shard_model`` clips by the whole model's norm."""
    lifter = model.lifter
    tp = tensor.model_tp(lifter)
    params = dict(lifter.named_parameters())
    sharded = [params[n] for n in tensor.splits(lifter)] if tp else ()
    return Optimizer(lifter.parameters(), cfg, steps_per_epoch,
                     sharded=sharded, tp=tp)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the update count (mutated in place by
    ``train_step``). Under data parallelism ``ddp`` is the model's
    ``DistributedDataParallel`` wrapper, through which the training forward
    runs (it averages the gradients over the data group), ``rank`` this
    process's rank on the data axis (the ranks of one model group hold the
    same rows and draw alike) and ``data_group`` the ranks that hold other
    rows (None: every rank)."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    ddp: torch.nn.Module | None = None
    rank: int = 0
    data_group: object = None


def prepare(raw: RawBatch, backbone_cfg, task: Task,
            image_dtype=torch.float32) -> augment.Batch:
    """Device batch from raw tensors: normalized images, root-centered 3D."""
    return augment.Batch(
        images=augment.serving_images(raw.images_u8, backbone_cfg,
                                      dtype=image_dtype),
        keypoints_3d=augment.root_center(raw.keypoints_3d, task.root_idx),
        keypoints_2d=raw.keypoints_2d,
        keypoints_2d_crop=raw.keypoints_2d_crop,
    )


# a rank's seed offset: odd, so that the ranks stay apart modulo 2**32 (the
# CPU generator keeps the low 32 bits of a seed) and a rank's seeds meet
# another's only some 10**9 steps apart
RANK_STRIDE = 0x9E3779B1


def step_generator(device, seed: int, step: int,
                   rank: int = 0) -> torch.Generator:
    """The generator of one step, seeded from (seed, step, data rank); data
    rank 0's is a single process's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + step + rank * RANK_STRIDE)
    return gen


def augmented_batch(cfg: Config, task: Task, raw: RawBatch,
                    gen: torch.Generator) -> augment.Batch:
    """The training batch: prepare, then the configured augmentations."""
    batch = prepare(raw, cfg.model.backbone, task)
    if cfg.train.flip_aug:
        batch = augment.train_augment(gen, batch, task.flip_perm,
                                      task.crop_width)
    if cfg.train.erase_aug:
        # erase around randomly chosen joints (img.py:179-198 semantics)
        crop = batch.keypoints_2d_crop
        picks = torch.randint(0, cfg.model.lifter.num_joints,
                              (crop.shape[0], cfg.train.erase_joints),
                              generator=gen, device=crop.device)
        centers = torch.gather(crop, 1, picks[..., None].expand(-1, -1, 2))
        batch = batch._replace(images=augment.erase_regions(
            batch.images, centers, size=cfg.train.erase_size))
    return batch


def loss_and_grads(model, cfg: Config, batch: augment.Batch,
                   gen: torch.Generator | None,
                   deterministic: bool = False) -> torch.Tensor:
    """Forward, loss and backward: the lifter's ``.grad`` holds dL/dparams
    afterwards. Returns the loss (a device scalar, no host sync)."""
    pred = model(batch.images, batch.keypoints_2d, batch.keypoints_2d_crop,
                 deterministic=deterministic, generator=gen)
    loss = losses.LOSSES[cfg.train.loss](pred, batch.keypoints_3d)
    loss.backward()
    return loss.detach()


def train_step(state: TrainState, raw: RawBatch, cfg: Config, task: Task,
               seed: int) -> dict[str, torch.Tensor]:
    """One optimizer step on a device batch; returns {"loss", "finite"} as
    device scalars. Under data parallelism ``raw`` is this rank's rows, the
    gradients are averaged over the data group before the clip, and the
    loss is the mean over it: the global batch's, the same on every rank,
    so that every rank's NaN guard decides alike."""
    gen = step_generator(raw.images_u8.device, seed, state.step, state.rank)
    batch = augmented_batch(cfg, task, raw, gen)
    state.optimizer.zero_grad()
    model = state.model if state.ddp is None else state.ddp
    loss = loss_and_grads(model, cfg, batch, gen)
    if state.ddp is not None:
        loss = distributed.mean_over_ranks(loss, state.data_group)
    # NaN guard (train.py:194): zero the gradients of a non-finite loss
    finite = torch.isfinite(loss)
    with span("capf.train.optimizer"):
        state.optimizer.step(state.step, finite)
    state.step += 1
    return {"loss": loss, "finite": finite}


@torch.no_grad()
def eval_step(model, raw: RawBatch, cfg: Config, task: Task
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(predictions, root-centered ground truth). With ``flip_test`` the
    flipped copy is folded into the batch axis: one forward of 2B
    (steps.py:199-216)."""
    img_dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
                 else torch.float32)
    batch = prepare(raw, cfg.model.backbone, task, image_dtype=img_dtype)
    if not cfg.train.flip_test:
        return model(batch.images, batch.keypoints_2d,
                     batch.keypoints_2d_crop), batch.keypoints_3d
    flipped = augment.flip_test_inputs(batch, task.flip_perm, task.crop_width)
    b = batch.images.shape[0]
    pred2 = model(torch.cat([batch.images, flipped.images]),
                  torch.cat([batch.keypoints_2d, flipped.keypoints_2d]),
                  torch.cat([batch.keypoints_2d_crop,
                             flipped.keypoints_2d_crop]))
    pred = augment.flip_test_merge(pred2[:b], pred2[b:], task.flip_perm)
    return pred, batch.keypoints_3d

