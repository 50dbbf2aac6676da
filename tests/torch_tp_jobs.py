"""Jobs that ranks of ``parallel.dryrun.spawn`` run for the tensor-parallel
tests (tests/test_torch_tensor_parallel.py); not collected by pytest. They
import nothing of JAX: a spawned rank re-imports only this module."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def lifter_forward(rank, world, device, lifter_cfg, dims, variables,
                   inputs) -> dict:
    """A ``PoseLifter`` split over the ``world`` ranks (one model group),
    loaded with this rank's shard of ``variables``
    (``bridge.shard_for_rank``), on ``inputs`` (kp2d, ref, features)."""
    from contextaware_poseformer_tpu_torch.models.bridge import (
        load_jax_variables,
        shard_for_rank,
    )
    from contextaware_poseformer_tpu_torch.models.lifter import PoseLifter
    from contextaware_poseformer_tpu_torch.parallel import make_mesh, tensor

    mesh = make_mesh(world, device, lifter_cfg)
    model = PoseLifter(lifter_cfg, dims)
    tensor.shard_model(model, mesh)
    load_jax_variables(model, shard_for_rank(variables, mesh))
    kp2d, ref, feats = inputs
    with torch.no_grad():
        out = model(torch.from_numpy(kp2d), torch.from_numpy(ref),
                    [torch.from_numpy(f) for f in feats])
    return {"out": out.numpy()}


def blank_lifter(trainer):
    """A fresh state of ``trainer`` (the backbone, which no checkpoint
    holds, from the seed) with its lifter's parameters zeroed."""
    from contextaware_poseformer_tpu_torch.parallel import dryrun

    state = trainer.init_state(dryrun.SEED)
    with torch.no_grad():
        for p in state.model.lifter.parameters():
            p.zero_()
    return state


def train_and_checkpoint(rank, world, device, cfg, steps, batch, logdir,
                         variables, inputs) -> dict:
    """One model group of ``world`` ranks: ``lifter_forward``, then
    ``dryrun``'s training and evaluation of ``cfg``; then a checkpoint of
    the trained state (every rank gathers, rank 0 writes), restored into a
    ``blank_lifter``, and one more step from each: their losses and
    parameters."""
    from contextaware_poseformer_tpu_torch.parallel import dryrun
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    result = lifter_forward(rank, world, device, cfg.model.lifter,
                            cfg.model.backbone.feature_dims, variables,
                            inputs)
    train, val = dryrun.datasets(1, batch, 0)
    trainer = Trainer(cfg, train, val, device, logdir=logdir,
                      model_parallel=world)
    state = trainer.init_state(dryrun.SEED)
    losses = [trainer.train_epoch(state, e, max_steps=1)["step_losses"][0]
              for e in range(steps)]
    summary, _ = trainer.evaluate(state)
    trained = dryrun.lifter_vector(state.model.lifter)
    trainer.ckpt.save(steps - 1, state, {"p1_mm": summary["p1_mm"]},
                      write=trainer.is_main)
    torch.distributed.barrier()
    restored, epoch = trainer.ckpt.restore(blank_lifter(trainer))
    same = dryrun.lifter_vector(restored.model.lifter)
    after = [trainer.train_epoch(s, steps, max_steps=1)["step_losses"][0]
             for s in (state, restored)]
    result.update(
        losses=losses, p1_mm=summary["p1_mm"], params=trained,
        restored_equal=bool(np.array_equal(same, trained)),
        restored_epoch=epoch, next_losses=after,
        next_params=[dryrun.lifter_vector(s.model.lifter)
                     for s in (state, restored)])
    return result
