"""The port's training path against the JAX package, on the CPU.

Every case feeds the same numpy inputs to both packages. The JAX side runs
its Pallas backward in interpret mode or its jnp reference; the port's
modules take their plain PyTorch versions for CPU tensors (the CUDA kernels
are held against those on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``). Tolerances are stated per test.
"""

import dataclasses
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from contextaware_poseformer_tpu.config import preset
from contextaware_poseformer_tpu.data import augment as jaug
from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu.ops import deformable as jdef
from contextaware_poseformer_tpu.ops import grid_sample as jgs
from contextaware_poseformer_tpu.train import losses as jlosses
from contextaware_poseformer_tpu.train import metrics as jmetrics
from contextaware_poseformer_tpu.train import steps as jsteps
from contextaware_poseformer_tpu.utils import skeleton
from contextaware_poseformer_tpu_torch import deploy_numerics
from contextaware_poseformer_tpu_torch.data import augment, pipeline
from contextaware_poseformer_tpu_torch.models.bridge import (
    load_jax_variables,
    variables_from_jax,
)
from contextaware_poseformer_tpu_torch.models.capf import (
    ContextAwarePoseFormer,
)
from contextaware_poseformer_tpu_torch.models.layers import DropPath, Dropout
from contextaware_poseformer_tpu_torch.ops import _build, deformable
from contextaware_poseformer_tpu_torch.ops import grid_sample
from contextaware_poseformer_tpu_torch.train import losses, metrics, steps
from contextaware_poseformer_tpu_torch.train import train_3dhp, train_h36m
from contextaware_poseformer_tpu_torch.train.checkpoint import (
    CheckpointManager,
)

BWD_SHAPES = ((16, 12, 8), (8, 6, 16), (4, 4, 32))
EDGES = [[1, 1], [-1, -1], [1, -1], [-1, 1], [1, 0.3], [-0.4, -1],
         [1.25, 0.3], [-0.2, -1.2]]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _edge_points(rng, shape, lo=-1.2, hi=1.2):
    """Uniform points with some exactly on the edges and some past them."""
    pts = rng.uniform(lo, hi, shape).astype(np.float32)
    pts.reshape(-1, 2)[:len(EDGES)] = EDGES
    return pts


def _bwd_inputs(seed):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, h, w, c).astype(np.float32)
             for h, w, c in BWD_SHAPES]
    pts = _edge_points(rng, (2, 3, 17, 16, 2))
    grads = [rng.randn(2, 17, 16, c).astype(np.float32)
             for _, _, c in BWD_SHAPES]
    return feats, pts, grads


# --------------------------------------------------------------------------
# the sampler backward (K6's plain version) and F1
# --------------------------------------------------------------------------


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_sampler_backward_matches_jax(mode, align_corners):
    """The plain backward against the JAX Pallas backward (interpret mode)
    and jax.vjp of the gather sampler, at the JAX kernel test's shapes.
    Tolerance: 1e-5 of the largest value, per output (fp32, sums in other
    orders)."""
    feats, pts, grads = _bwd_inputs(0)
    ours_df, ours_dp = deformable.sample_points_multi_backward_reference(
        [_t(f) for f in feats], _t(pts), [_t(g) for g in grads], mode,
        align_corners)
    jf = tuple(jnp.asarray(f) for f in feats)
    jg = tuple(jnp.asarray(g) for g in grads)
    pallas = jdef._multi_bwd_pallas(jf, jnp.asarray(pts), jg, mode,
                                    align_corners, True)
    _, vjp = jax.vjp(
        lambda f, p: jdef.sample_points_levels(
            f, p, padding_mode=mode, align_corners=align_corners,
            impl="gather"),
        jf, jnp.asarray(pts))
    gather = vjp(jg)
    for theirs_df, theirs_dp in (pallas, gather):
        for ours, theirs in [(ours_dp, theirs_dp)] + list(
                zip(ours_df, theirs_df)):
            theirs = np.asarray(theirs)
            assert ours.shape == theirs.shape
            err = np.abs(ours.numpy() - theirs).max()
            assert err <= 1e-5 * np.abs(theirs).max(), err


def test_grid_sample_point_grads_match_jax_at_the_border():
    """F1: the border clamp's gradient at an exact edge is jnp.clip's 0.5
    tie. Points exactly at x = +-1 and y = +-1, inside and past the edges;
    autograd through the port's plain sampler against jax.grad, 1e-6 of the
    largest gradient."""
    rng = np.random.RandomState(1)
    f = rng.randn(2, 5, 7, 3).astype(np.float32)
    pts = _edge_points(rng, (2, 12, 2), -1.4, 1.4)
    w = rng.randn(2, 12, 3).astype(np.float32)

    p = _t(pts).requires_grad_(True)
    out = grid_sample.grid_sample_points(_t(f), p, padding_mode="border")
    (out * _t(w)).sum().backward()
    theirs = jax.grad(lambda q: jnp.sum(jgs.grid_sample_points(
        jnp.asarray(f), q, padding_mode="border") * w))(jnp.asarray(pts))
    theirs = np.asarray(theirs)
    assert np.abs(theirs[:, :4]).max() > 0  # the edges carry a gradient
    np.testing.assert_allclose(p.grad.numpy(), theirs, rtol=0,
                               atol=1e-6 * np.abs(theirs).max())


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_autograd_function_matches_plain_backward(mode):
    """``sample_points_levels`` under autograd on CPU tensors goes through
    the sampler's autograd Function (plain forward and backward): its
    gradients equal the plain backward's exactly, dF only when a map
    requires grad."""
    feats, pts, grads = _bwd_inputs(2)
    want_df, want_dp = deformable.sample_points_multi_backward_reference(
        [_t(f) for f in feats], _t(pts), [_t(g) for g in grads], mode)
    for maps_grad in (True, False):
        fs = [_t(f).requires_grad_(maps_grad) for f in feats]
        p = _t(pts).requires_grad_(True)
        outs = deformable.sample_points_levels(fs, p, mode)
        torch.autograd.backward(outs, [_t(g) for g in grads])
        assert torch.equal(p.grad, want_dp)
        for f, df in zip(fs, want_df):
            assert (torch.equal(f.grad, df) if maps_grad
                    else f.grad is None)


def test_autograd_function_with_projections_matches_gather():
    """With fused projections the backward is the plain version's VJP;
    against autograd through the gather formulation (rtol 1e-5)."""
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, h, w, 16).astype(np.float32)
             for h, w, _ in BWD_SHAPES]
    projs = [rng.randn(16, 4).astype(np.float32) for _ in feats]
    biases = [rng.randn(4).astype(np.float32) for _ in feats]
    pts = _edge_points(rng, (2, 3, 5, 2))
    results = []
    for impl in ("auto", "gather"):
        leaves = [_t(a).requires_grad_(True)
                  for a in (pts, *feats, *projs, *biases)]
        outs = deformable.sample_points_levels(
            leaves[1:4], leaves[0], "border", True, impl, leaves[4:7],
            leaves[7:])
        sum((o * o).sum() for o in outs).backward()
        results.append([t.grad for t in leaves])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_plain_vjp_function():
    """The autograd Function K2-K4 use: forward is the 'kernel', backward
    the plain version's VJP; non-tensor arguments pass through."""
    calls = []

    def kernel(x, w, scale):
        calls.append(scale)
        return (x @ w * scale).detach()

    def plain(x, w, scale):
        return torch.tanh(x @ w) * 0 + x @ w * scale

    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 2, requires_grad=True)
    out = _build.PlainVjp.apply(kernel, plain, x, w, 2.0)
    out.sum().backward()
    x2, w2 = x.detach().requires_grad_(), w.detach().requires_grad_()
    plain(x2, w2, 2.0).sum().backward()
    assert calls == [2.0]
    assert torch.allclose(x.grad, x2.grad) and torch.allclose(w.grad, w2.grad)
    assert _build.needs_grad(x, None) and not _build.needs_grad(x.detach())


# --------------------------------------------------------------------------
# dropout and drop-path
# --------------------------------------------------------------------------


def test_drop_path():
    x = torch.randn(64, 5, 7)
    gen = torch.Generator().manual_seed(0)
    dp = DropPath(0.25)
    assert dp(x, deterministic=True) is x
    assert DropPath(0.0)(x, deterministic=False) is x
    with pytest.raises(ValueError, match="Generator"):
        dp(x, deterministic=False)
    y = dp(x, deterministic=False, generator=gen)
    kept = [bool((y[i] != 0).any()) for i in range(len(x))]
    for i, k in enumerate(kept):  # one draw per sample, scaled by 1/keep
        want = x[i] / 0.75 if k else torch.zeros_like(x[i])
        assert torch.equal(y[i], want)
    assert 0 < sum(kept) < len(x)
    again = dp(x, deterministic=False,
               generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


def test_dropout_is_elementwise():
    x = torch.ones(200, 50)
    y = Dropout(0.5)(x, deterministic=False,
                    generator=torch.Generator().manual_seed(1))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    rows = (y == 0).float().mean(1)
    assert 0 < rows.min() and rows.max() < 1  # no whole-row masks
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.02


# --------------------------------------------------------------------------
# losses and metrics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jlosses.LOSSES))
def test_losses_match_jax(name):
    rng = np.random.RandomState(4)
    pred = rng.randn(3, 17, 3).astype(np.float32) * 30
    gt = rng.randn(3, 17, 3).astype(np.float32) * 30
    valid = (rng.rand(3, 17, 1) > 0.3).astype(np.float32)
    args = [(), (valid,)] if name != "MPJPE" else [()]
    for extra in args:
        ours = losses.LOSSES[name](_t(pred), _t(gt), *map(_t, extra))
        theirs = jlosses.LOSSES[name](*map(jnp.asarray, (pred, gt, *extra)))
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


def test_other_errors_match_jax():
    rng = np.random.RandomState(5)
    pred = rng.randn(6, 17, 3).astype(np.float32)
    gt = rng.randn(6, 17, 3).astype(np.float32)
    for ours, theirs in (
        (losses.n_mpjpe, jlosses.n_mpjpe),
        (losses.limb_length_error, jlosses.limb_length_error),
    ):
        np.testing.assert_allclose(
            float(ours(_t(pred), _t(gt))),
            float(theirs(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-6)
    assert losses.p_mpjpe(pred.copy(), gt) == jlosses.p_mpjpe(pred.copy(), gt)
    assert losses.mpjve(pred, gt) == jlosses.mpjve(pred, gt)
    assert losses.mpjve(pred[:1], gt[:1]) == 0.0


def test_uncertainty_and_volumetric_losses_match_jax():
    """The two legacy losses on the same inputs (rtol 1e-6, fp32): the
    heteroscedastic loss over two sigma tensors, and the volumetric
    cross-entropy on a 4x5x6 coordinate volume with softmaxed predictions
    and a validity mask; its nearest-voxel picks must agree exactly (the
    ground truth lies off the voxel centres, so no distance ties)."""
    rng = np.random.RandomState(6)
    pred = rng.randn(3, 17, 3).astype(np.float32)
    gt = rng.randn(3, 17, 3).astype(np.float32)
    sigmas = [rng.uniform(0.1, 2.0, (3, 17, 1)).astype(np.float32)
              for _ in range(2)]
    np.testing.assert_allclose(
        float(losses.uncertainty_loss([_t(s) for s in sigmas], _t(pred),
                                      _t(gt))),
        float(jlosses.uncertainty_loss([jnp.asarray(s) for s in sigmas],
                                       jnp.asarray(pred), jnp.asarray(gt))),
        rtol=1e-6)

    b, j, vol = 2, 5, (4, 5, 6)
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in vol]
    coords = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    coords = np.broadcast_to(coords, (b, *vol, 3)).copy()
    logits = rng.randn(b, j, *vol).astype(np.float32)
    volumes = np.exp(logits) / np.exp(logits).reshape(b, j, -1).sum(
        -1)[..., None, None, None]
    kp = (rng.uniform(-1, 1, (b, j, 3)) + 0.013).astype(np.float32)
    validity = (rng.rand(b, j, 1) > 0.3).astype(np.float32)
    args = (coords, volumes, kp, validity)
    np.testing.assert_allclose(
        float(losses.volumetric_ce_loss(*map(_t, args))),
        float(jlosses.volumetric_ce_loss(*map(jnp.asarray, args))),
        rtol=1e-6)


def test_h36m_evaluate_matches_jax():
    rng = np.random.RandomState(6)
    n = 40
    gt = rng.randn(n, 17, 3).astype(np.float32)
    pred = gt + 0.05 * rng.randn(n, 17, 3).astype(np.float32)
    actions = rng.randint(0, 12, n)  # a few actions are absent
    ours = metrics.h36m_evaluate(gt, pred, actions)
    theirs = jmetrics.h36m_evaluate(gt, pred, actions)
    assert ours == theirs
    assert metrics.h36m_summary(ours) == jmetrics.h36m_summary(theirs)
    empty = {k: {**v, "frame_count": 0} for k, v in ours.items()}
    assert np.isnan(metrics.h36m_summary(empty)["p1_mm"])


# --------------------------------------------------------------------------
# augmentation
# --------------------------------------------------------------------------


def _aug_batch(rng, b=3, h=10, w=12):
    return (rng.randn(b, h, w, 3).astype(np.float32),
            rng.randn(b, 17, 3).astype(np.float32),
            rng.uniform(-1, 1, (b, 17, 2)).astype(np.float32),
            rng.uniform(0, w, (b, 17, 2)).astype(np.float32))


def _jax_key(flip: bool):
    """A JAX key whose batch coin comes up ``flip``."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if bool(jax.random.bernoulli(key, 0.5)) == flip:
            return key
    raise AssertionError("no key found")


def _torch_generator(flip: bool):
    """A generator whose batch coin (``train_augment``'s draw) comes up
    ``flip``."""
    for seed in range(100):
        coin = torch.rand((), generator=torch.Generator().manual_seed(seed))
        if bool(coin < 0.5) == flip:
            return torch.Generator().manual_seed(seed)
    raise AssertionError("no seed found")


def _assert_batches_equal(ours, theirs):
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))


@pytest.mark.parametrize("flip", [True, False])
def test_train_augment_matches_jax(flip):
    rng = np.random.RandomState(7)
    arrays = _aug_batch(rng)
    perm = skeleton.H36M_FLIP_PERM
    ours = augment.train_augment(_torch_generator(flip),
                                 augment.Batch(*map(_t, arrays)), perm, 12)
    theirs = jaug.train_augment(_jax_key(flip),
                                jaug.Batch(*map(jnp.asarray, arrays)), perm,
                                12)
    _assert_batches_equal(ours, theirs)
    assert flip == (not torch.equal(ours.images, _t(arrays[0])))


def test_flip_and_centering_match_jax():
    rng = np.random.RandomState(8)
    arrays = _aug_batch(rng)
    perm = skeleton.H36M_FLIP_PERM
    ours_b = augment.Batch(*map(_t, arrays))
    theirs_b = jaug.Batch(*map(jnp.asarray, arrays))
    _assert_batches_equal(augment.flip_batch(*ours_b, perm, 12),
                          jaug.flip_batch(*theirs_b, jnp.asarray(perm), 12))
    _assert_batches_equal(augment.flip_test_inputs(ours_b, perm, 12),
                          jaug.flip_test_inputs(theirs_b, perm, 12))
    np.testing.assert_array_equal(
        augment.flip_test_merge(ours_b.keypoints_3d, ours_b.keypoints_3d * 2,
                                perm).numpy(),
        np.asarray(jaug.flip_test_merge(theirs_b.keypoints_3d,
                                        theirs_b.keypoints_3d * 2, perm)))
    for root in (0, 14):
        np.testing.assert_array_equal(
            augment.root_center(ours_b.keypoints_3d, root).numpy(),
            np.asarray(jaug.root_center(theirs_b.keypoints_3d, root)))


@pytest.mark.parametrize("use_mean", [True, False])
def test_erase_and_gamma_match_jax(use_mean):
    rng = np.random.RandomState(9)
    images = rng.uniform(0, 1, (2, 20, 16, 3)).astype(np.float32)
    centers = np.array([[[3.5, 4.2], [15.9, 19.0]],
                        [[-2.0, 5.0], [8.0, 30.0]]], np.float32)
    ours = augment.erase_regions(_t(images), _t(centers), 5, use_mean)
    theirs = jaug.erase_regions(jnp.asarray(images), jnp.asarray(centers), 5,
                                use_mean)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6)
    for scale in (1.0, 255.0):
        ours = augment.gamma_correct(_t(images * scale), 0.7)
        theirs = jaug.gamma_correct(jnp.asarray(images * scale), 0.7)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-5)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------


def test_optimizer_matches_optax():
    """Five updates of the port's optimizer against the JAX package's optax
    stack: the learning rate decays across an epoch boundary (2 steps an
    epoch), the 1/lr-scaled clip binds, step 3 is non-finite (gradients
    zeroed, update still run), and the frozen partition never moves.
    Tolerance rtol 1e-5 (fp32, other operation orders)."""
    rng = np.random.RandomState(10)
    cfg = preset("h36m_cpn")
    cfg = replace(cfg, train=replace(cfg.train, lr=1e-2, lr_decay=0.5,
                                     grad_clip=2e-2))  # clip norm 2.0
    shapes = {"a": (3, 4), "b": (4,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = jsteps.make_optimizer(cfg, steps_per_epoch=2)
    params = {"lifter": {k: jnp.asarray(v) for k, v in init.items()},
              "backbone": {"w": jnp.ones(3)}}
    opt_state = tx.init(params)
    ours_p = [torch.nn.Parameter(_t(init[k])) for k in shapes]
    opt = steps.Optimizer(ours_p, cfg, steps_per_epoch=2)
    for step in range(5):
        g = {k: rng.randn(*s).astype(np.float32) * (3 if step % 2 else 0.1)
             for k, s in shapes.items()}
        finite = step != 3
        if not finite:
            g["a"][0, 0] = np.nan
        jg = {"lifter": {k: jnp.where(finite, jnp.asarray(v), 0.0)
                         for k, v in g.items()},
              "backbone": {"w": jnp.ones(3)}}
        updates, opt_state = tx.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, k in zip(ours_p, shapes):
            p.grad = _t(g[k])
        opt.step(step, torch.tensor(finite))
        for p, k in zip(ours_p, shapes):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params["lifter"][k]),
                                       rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(params["backbone"]["w"]),
                                  np.ones(3))
    sched = steps.lr_schedule(cfg, 2)
    assert [sched(s) for s in range(5)] == [
        float(jsteps.lr_schedule(cfg, 2)(s)) for s in range(5)]


# --------------------------------------------------------------------------
# end to end: a trajectory against JAX, the CLI with resume
# --------------------------------------------------------------------------

HW = (64, 64)


def _small_cfg(lr=1e-5, batch=2):
    cfg = preset("h36m_cpn")
    model = replace(
        cfg.model, image_shape=HW,
        backbone=replace(cfg.model.backbone, cpn_layers=(1, 1, 1, 1)),
        lifter=replace(cfg.model.lifter, embed_dim_ratio=32, depth=1,
                       drop_path_rate=0.0))
    train = replace(cfg.train, lr=lr, batch_size=batch, flip_aug=False,
                    erase_aug=False)
    return replace(cfg, model=model, train=train)


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


def test_train_trajectory_matches_jax():
    """3 AdamW steps at lr 1e-5 (the PARITY.md trajectory protocol) on a
    narrow CPN (stages (1,1,1,1), 64x64 frames, embed 32, depth 1; flip,
    erase and drop-path off), 2 steps an epoch, from the same random
    variables. Tolerances no looser than PARITY.md's trajectory row: loss
    relative 3.3e-6 per step, final lifter parameters max error 1.7e-3 of
    each parameter's RMS. The parameter change (final minus initial) must
    also match JAX's to 3e-2 of that change's RMS: a few fp32 ulps of a
    parameter near 1 (the LayerNorm scales) at ~3e-5 of change."""
    cfg = _small_cfg()
    rng = np.random.RandomState(11)
    batches = _raw_batches(rng, 3, 2)
    jmodel = JCAPF(cfg=cfg.model)
    variables = _random_variables(
        jmodel, rng, jnp.zeros((1, *HW, 3)), batches[0].keypoints_2d[:1],
        batches[0].keypoints_2d_crop[:1])

    tx = jsteps.make_optimizer(cfg, steps_per_epoch=2)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jsteps.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    jstep = jax.jit(jsteps.make_train_step(jmodel, cfg, tx))
    jlosses_ = []
    for raw in batches:
        jstate, m = jstep(jstate, jsteps.RawBatch(*map(jnp.asarray, raw)),
                          jax.random.PRNGKey(1))
        jlosses_.append(float(m["loss"]))

    model = ContextAwarePoseFormer(cfg.model)
    load_jax_variables(model, variables)
    model.backbone.requires_grad_(False)
    state = steps.TrainState(model, steps.make_optimizer(cfg, 2, model))
    task = steps.Task.for_config(cfg)
    ours = [float(steps.train_step(state, pipeline.to_device(raw, "cpu"),
                                   cfg, task, 1)["loss"])
            for raw in batches]
    np.testing.assert_allclose(ours, jlosses_, rtol=3.3e-6)

    init = variables_from_jax({"params": {"lifter": variables["params"][
        "lifter"]}})
    want = variables_from_jax({"params": {"lifter": jax.tree.map(
        np.asarray, jstate.params["lifter"])}})
    got = model.state_dict()
    assert want.keys() == init.keys()
    for key, value in want.items():
        err = (got[key] - value).abs().max().item()
        assert err <= 1.7e-3 * value.pow(2).mean().sqrt().item(), key
        # the change itself, which the check above cannot see (3 steps at
        # lr 1e-5 move a parameter by ~3e-5): a lifter that never updated,
        # or stepped the wrong way, is off by the whole change
        change = value - init[key]
        limit = 3e-2 * change.pow(2).mean().sqrt().item()
        assert change.abs().max().item() > 10 * limit, key
        assert (got[key] - init[key] - change).abs().max().item() <= limit, key
    assert state.step == 3


_OVERLAY = """
model: {image_shape: [64, 64], backbone: {cpn_layers: [1, 1, 1, 1]},
        lifter: {embed_dim_ratio: 32, depth: 1}}
train: {batch_size: 2}
data: {num_workers: 2}
"""


def _cli(tmp_path, logdir, *extra):
    cfg = tmp_path / "small.yaml"
    cfg.write_text(_OVERLAY)
    return train_h36m.main([
        "--synthetic", "--device", "cpu", "--config", str(cfg),
        "--steps-per-epoch", "2", "--eval-batches", "1",
        "--logdir", str(tmp_path / logdir), *extra])


def _lifter_state(state):
    return {k: v.clone() for k, v in state.model.lifter.state_dict().items()}


def test_cli_trains_and_resumes(tmp_path):
    """``--device cpu`` on a ``--config`` overlay: one epoch, then
    ``--resume`` continues from the saved epoch with identical state (the
    restored lifter, optimizer and step equal the saved ones, and 1 + 1
    resumed epochs end bit-identical to 2 uninterrupted ones)."""
    _, first, _ = _cli(tmp_path, "run", "--epochs", "1")
    index = json.loads((tmp_path / "run/checkpoints/index.json").read_text())
    assert index["latest"] == index["best"] == 0 and first.step == 2

    trainer, resumed, _ = _cli(tmp_path, "run", "--epochs", "1", "--resume")
    # nothing left to run: the restored state is the saved one
    assert resumed.step == first.step
    for k, v in _lifter_state(first).items():
        assert torch.equal(resumed.model.lifter.state_dict()[k], v), k
    saved, restored = (first.optimizer.state_dict()["state"],
                       resumed.optimizer.state_dict()["state"])
    for i in saved:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(saved[i][name], restored[i][name])

    _, cont, _ = _cli(tmp_path, "run", "--epochs", "2", "--resume")
    _, straight, _ = _cli(tmp_path, "straight", "--epochs", "2")
    assert cont.step == straight.step == 4
    for k, v in _lifter_state(straight).items():
        assert torch.equal(cont.model.lifter.state_dict()[k], v), k
    assert (tmp_path / "run/metrics.jsonl").read_text().count("\n") == 2


def test_checkpoint_manager_keeps_latest_and_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)

    class _State:
        step = 0
        model = torch.nn.Module()
        optimizer = steps.Optimizer([torch.nn.Parameter(torch.zeros(2))],
                                    preset("h36m_cpn"), 1)

    _State.model.lifter = torch.nn.Linear(2, 2)
    for epoch, p1 in enumerate([50.0, 40.0, 45.0, 60.0]):
        _State.step = epoch
        mgr.save(epoch, _State, {"p1_mm": p1})
    files = sorted(p.name for p in tmp_path.glob("*.pt"))
    assert files == ["epoch_00001.pt", "epoch_00002.pt", "epoch_00003.pt"]
    assert (mgr.latest_epoch(), mgr.best_epoch()) == (3, 1)
    _, nxt = mgr.restore(_State, "best")
    assert nxt == 2 and _State.step == 1


@pytest.mark.parametrize("cli,argv", [
    (train_h36m, ["--distributed", "--model-parallel", "2"]),
    (train_h36m, ["--model-parallel", "2"]),
    (train_3dhp, ["--distributed", "--model-parallel", "2"]),
])
def test_cli_refuses_what_is_not_ported(cli, argv):
    """The lifter's tensor parallelism splits it over the ranks of a model
    group: ``--model-parallel 2`` is refused without ``--distributed``, and
    in a world of one rank (``--distributed`` outside torchrun), before
    any process group is joined."""
    with pytest.raises(SystemExit, match=r"model.parallel.2"):
        cli.main(["--synthetic", "--device", "cpu", *argv])
    assert not torch.distributed.is_initialized()


def test_cli_needs_a_device(monkeypatch):
    """The CLIs run on the card unless ``--device`` names another: without
    ``--device`` they take ``cuda``, and where there is no card they refuse
    to run rather than fall back to the CPU; ``--device cpu`` stays."""
    assert train_h36m.build_argparser().parse_args(
        ["--synthetic"]).device == "cuda"
    assert train_3dhp.build_argparser().parse_args(
        ["--synthetic"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((train_h36m.main, ["--tiny", "--synthetic"]),
                       (train_3dhp.main, ["--tiny", "--synthetic"]),
                       (deploy_numerics.main, ["--preset", "h36m_cpn"])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
    assert dataclasses.is_dataclass(train_h36m.make_config(
        train_h36m.build_argparser().parse_args(["--device", "cpu"])))
