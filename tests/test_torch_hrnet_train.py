"""HRNet training in the port against the JAX package, on the CPU: the
``--tiny`` model's AdamW trajectory from the same variables (PARITY.md's
trajectory rows), and the CLI's ``--tiny`` HRNet and ``_deploy`` paths.

The JAX side runs its train step under ``jit`` with its Pallas kernels as
the JAX package's own tests run them on the CPU; the port takes its plain
PyTorch versions for CPU tensors. Tolerances are stated per test.
"""

import argparse
from dataclasses import asdict, replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu.train import steps as jsteps
from contextaware_poseformer_tpu.train import train_h36m as jtrain_h36m
from contextaware_poseformer_tpu_torch.data import pipeline
from contextaware_poseformer_tpu_torch.models.bridge import (
    load_jax_variables,
    variables_from_jax,
)
from contextaware_poseformer_tpu_torch.models.capf import (
    ContextAwarePoseFormer,
)
from contextaware_poseformer_tpu_torch.train import steps, train_h36m

HW = (64, 64)


def _cut(cfg, **train):
    """Flip and erase augmentation and drop-path off (their draws differ
    between the packages), lr 1e-5."""
    return replace(
        cfg, model=replace(cfg.model, lifter=replace(
            cfg.model.lifter, drop_path_rate=0.0)),
        train=replace(cfg.train, lr=1e-5, flip_aug=False, erase_aug=False,
                      **train))


def tiny_configs(jmake, pmake, name, **train):
    """(JAX config, port config) of the CLIs' ``--tiny`` model of preset
    ``name`` at batch 2, cut by ``_cut``: ``jmake``/``pmake`` are the two
    packages' ``make_config``; the two must be equal."""
    ns = argparse.Namespace(
        preset=name, config=None, epochs=None, batch_size=2, seed=0,
        data_root=None, train_labels=None, val_labels=None, tiny=True)
    jcfg, pcfg = (_cut(make(ns), **train) for make in (jmake, pmake))
    assert asdict(jcfg) == asdict(pcfg)
    return jcfg, pcfg


def _random_variables(model, rng, *args):
    """Flax variables with every leaf drawn from numpy (nothing zero)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name and len(s.shape) == 4:
            v = rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:3]))
        elif "'kernel'" in name:
            v = rng.uniform(-1, 1, s.shape) / np.sqrt(s.shape[0])
        elif "'scale'" in name:
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.randn(*s.shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _raw_batches(rng, n, b):
    out = []
    for _ in range(n):
        kpc = rng.uniform(0, HW[1], (b, 17, 2)).astype(np.float32)
        out.append(pipeline.RawBatch(
            images_u8=rng.randint(0, 256, (b, *HW, 3)).astype(np.uint8),
            keypoints_3d=rng.randn(b, 17, 3).astype(np.float32) * 0.2,
            keypoints_2d=(kpc / 32 - 1).astype(np.float32),
            keypoints_2d_crop=kpc))
    return out


def trajectory(cfg, pcfg, n_steps, seed):
    """(JAX losses, port losses, initial, JAX final and port final lifter
    state dicts) of ``n_steps`` AdamW steps (2 an epoch) of the JAX config
    ``cfg`` and the port's equal ``pcfg`` from the same random variables on
    the same batches."""
    rng = np.random.RandomState(seed)
    batches = _raw_batches(rng, n_steps, 2)
    jmodel = JCAPF(cfg=cfg.model)
    variables = _random_variables(
        jmodel, rng, jnp.zeros((1, *HW, 3)), batches[0].keypoints_2d[:1],
        batches[0].keypoints_2d_crop[:1])

    tx = jsteps.make_optimizer(cfg, steps_per_epoch=2)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jsteps.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    jstep = jax.jit(jsteps.make_train_step(jmodel, cfg, tx))
    theirs = []
    for raw in batches:
        jstate, m = jstep(jstate, jsteps.RawBatch(*map(jnp.asarray, raw)),
                          jax.random.PRNGKey(1))
        theirs.append(float(m["loss"]))

    model = ContextAwarePoseFormer(pcfg.model)
    load_jax_variables(model, variables)
    model.backbone.requires_grad_(False)
    state = steps.TrainState(model, steps.make_optimizer(pcfg, 2, model))
    task = steps.Task.for_config(pcfg)
    ours = [float(steps.train_step(state, pipeline.to_device(raw, "cpu"),
                                   pcfg, task, 1)["loss"])
            for raw in batches]
    assert state.step == n_steps

    def lifter(p):
        return variables_from_jax({"params": {"lifter": jax.tree.map(
            np.asarray, p["lifter"])}})

    return (theirs, ours, lifter(variables["params"]),
            lifter(jstate.params), model.state_dict())


def check_trajectory(theirs, ours, init, want, got, loss_rtol, param_tol):
    """Losses to ``loss_rtol``; final lifter parameters within
    ``param_tol`` of each parameter's RMS; and the change itself (final
    minus initial) within 3e-2 of that change's RMS, the check
    ``test_train_trajectory_matches_jax`` makes (a lifter that never
    updated, or stepped the wrong way, is off by the whole change)."""
    np.testing.assert_allclose(ours, theirs, rtol=loss_rtol)
    assert want.keys() == init.keys()
    for key, value in want.items():
        err = (got[key] - value).abs().max().item()
        assert err <= param_tol * value.pow(2).mean().sqrt().item(), key
        change = value - init[key]
        limit = 3e-2 * change.pow(2).mean().sqrt().item()
        assert change.abs().max().item() > 10 * limit, key
        assert (got[key] - init[key] - change).abs().max().item() <= limit, key


@pytest.mark.parametrize("grad_clip,loss_rtol,param_tol", [
    (None, 3.3e-6, 1.7e-3),  # PARITY.md:112
    (1e-7, 1.8e-6, 2.0e-3),  # PARITY.md:113: the clip binds every step
])
def test_tiny_hrnet_trajectory_matches_jax(grad_clip, loss_rtol, param_tol):
    """12 AdamW steps at lr 1e-5 on the ``--tiny`` HRNet (width 8, one block
    a stage, 64x64 frames, lifter embed 32 depth 2 with deformable blocks;
    the frozen backbone's K1/K6 path through the plain sampler), 2 steps an
    epoch so the learning rate decays 5 times, from the same random
    variables on the same batches. Tolerances: PARITY.md's trajectory rows
    (loss relative, final lifter parameters max error over each
    parameter's RMS)."""
    kw = {} if grad_clip is None else {"grad_clip": grad_clip}
    cfgs = tiny_configs(jtrain_h36m.make_config, train_h36m.make_config,
                        "h36m_hrnet_32", **kw)
    check_trajectory(*trajectory(*cfgs, 12, 12), loss_rtol, param_tol)


def test_cli_tiny_hrnet_trains_and_deploy_evaluates(tmp_path):
    """``--tiny`` with the HRNet presets on the CPU: W32 trains an epoch,
    W48 too (the same tiny model), and the ``_deploy`` form evaluates the
    int8 deploy graph, calibrated on the first validation frames before its
    first evaluation (finite P1, the backbone's int8 state stamped)."""
    common = ["--tiny", "--synthetic", "--device", "cpu", "--batch-size",
              "4", "--eval-batches", "1"]
    for name in ("h36m_hrnet_32", "h36m_hrnet_48"):
        trainer, state, best = train_h36m.main(
            ["--preset", name, *common, "--epochs", "1",
             "--steps-per-epoch", "2", "--logdir", str(tmp_path / name)])
        assert trainer.cfg.model.backbone.width == 8
        assert state.step == 2 and np.isfinite(best)
        assert not any(p.requires_grad
                       for p in state.model.backbone.parameters())
    trainer, state, summary = train_h36m.main(
        ["--preset", "h36m_hrnet_32_deploy", *common, "--eval",
         "--logdir", str(tmp_path / "deploy")])
    assert trainer.cfg.model.backbone.quantize == "serve"
    assert bool(state.model.backbone.serving_fingerprint.any())
    assert np.isfinite(summary["p1_mm"])
