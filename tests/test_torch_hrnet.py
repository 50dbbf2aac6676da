"""The port's HRNet serving slice against the JAX package, on the CPU.

A small HRNet (64x64 frames, width 8 or 12, one BasicBlock per branch,
stage 3 of one module and stage 4 of two, so that the in-place-mutation
quirk differs from truncation) goes through both packages from the same
random flax weights. The JAX side runs its Pallas kernels in interpret mode;
the port takes its plain versions (CPU tensors).
"""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.data import augment as jaug
from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu.models.hrnet import HRNet as JHRNet
from contextaware_poseformer_tpu.ops import deformable as jdef
from contextaware_poseformer_tpu_torch import config, serve
from contextaware_poseformer_tpu_torch.data import augment
from contextaware_poseformer_tpu_torch.models.backbone_common import (
    add_upsampled_nearest,
)
from contextaware_poseformer_tpu_torch.models.bridge import load_jax_variables
from contextaware_poseformer_tpu_torch.models.capf import (
    ContextAwarePoseFormer,
)
from contextaware_poseformer_tpu_torch.models.hrnet import HRNet
from contextaware_poseformer_tpu_torch.models.init import init_parameters
from contextaware_poseformer_tpu_torch.ops import deformable

HW = (64, 64)
PLAIN_KNOBS = dict(sampler="gather", attention="einsum",
                   attention_joint="einsum", mlp="einsum")
# the HRNet-W32 / W48 pyramids of a 256x192 frame; level 0 is the
# two-stage (K5) level of the TPU sampler
PYRAMIDS = {
    "W32": ((64, 48, 32), (32, 24, 64), (16, 12, 128), (8, 6, 256)),
    "W48": ((64, 48, 48), (32, 24, 96), (16, 12, 192), (8, 6, 384)),
}


def _small_backbone(cfglib, backbone, width, truncate=False):
    """``backbone`` cut to test size: one BasicBlock per branch, stages of
    1, 1 and 2 modules, int8 stack off."""
    c = (width, 2 * width, 4 * width, 8 * width)
    stage = cfglib.HRNetStageConfig
    return replace(
        backbone, quantize="none", width=width,
        hrnet_stage4_truncate=truncate,
        stage2=stage(1, 2, (1, 1), c[:2]),
        stage3=stage(1, 3, (1, 1, 1), c[:3]),
        stage4=stage(2, 4, (1, 1, 1, 1), c))


def _random_variables(model, rng, *args):
    """Flax variables of ``model`` with numpy leaves; the tree comes from
    ``jax.eval_shape``. Conv kernels are he-scaled, Dense kernels
    U(+-1/sqrt(fan_in)), scales U(0.5, 1.5), biases and ``pos_embed``
    N(0, 0.1)."""
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


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_matches_jax(dtype, truncate):
    """The four levels, finest first. fp32: max abs error <= 1e-4 of each
    level's RMS; bf16: relative RMS <= 3e-2 (the frameworks round to bf16
    at different points and sum the convolutions in other orders)."""
    width = 8
    jcfg = _small_backbone(jconfig, jconfig.hrnet_backbone(width), width,
                           truncate)
    cfg = _small_backbone(config, config.hrnet_backbone(width), width,
                          truncate)
    assert asdict(cfg) == asdict(jcfg)
    rng = np.random.RandomState(0)
    x = rng.randn(2, *HW, 3).astype(np.float32)
    jmodel = JHRNet(cfg=jcfg, dtype=jnp.dtype(dtype))
    variables = _random_variables(jmodel, rng, jnp.zeros((1, *HW, 3)))
    theirs = jax.jit(jmodel.apply)(variables, jnp.asarray(x))

    model = HRNet(cfg, dtype=getattr(torch, dtype))
    load_jax_variables(model, variables)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    assert len(ours) == len(theirs) == 4
    for lvl, (o, t) in enumerate(zip(ours, theirs)):
        t = np.asarray(t, np.float32)
        h, w = HW[0] // 4 >> lvl, HW[1] // 4 >> lvl
        assert o.shape == t.shape == (2, h, w, width << lvl), lvl
        assert o.dtype == getattr(torch, dtype)
        o = o.float().numpy()
        if dtype == "float32":
            assert np.abs(o - t).max() <= 1e-4 * _rms(t), lvl
        else:
            assert _rms(o - t) <= 3e-2 * _rms(t), lvl


def test_stage4_quirk_and_truncation():
    """Levels 1-3 are stage-4 module 0's pre-fuse branch outputs with or
    without truncation (equal to the bit), level 0 differs, and truncation
    builds only module 0's parameters, whose fuse then outputs level 0
    only."""
    width = 8
    full = HRNet(_small_backbone(config, config.hrnet_backbone(width), width))
    cut = HRNet(_small_backbone(config, config.hrnet_backbone(width), width,
                                truncate=True))
    init_parameters(full, torch.Generator().manual_seed(0))
    missing = cut.load_state_dict(full.state_dict(), strict=False)
    assert not missing.missing_keys
    assert missing.unexpected_keys and all(
        k.startswith(("stage4_1_", "stage4_0_fuse_layers_1_",
                      "stage4_0_fuse_layers_2_", "stage4_0_fuse_layers_3_"))
        for k in missing.unexpected_keys)
    x = torch.randn(1, *HW, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = full(x), cut(x)
    for lvl in (1, 2, 3):
        assert torch.equal(a[lvl], b[lvl]), lvl
    assert not torch.allclose(a[0], b[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_add_upsampled_nearest_is_the_add_of_the_repeated_map(factor, dtype):
    g = torch.Generator().manual_seed(factor)
    acc = torch.randn(2, 16, 8, 5, generator=g).to(dtype)
    y = torch.randn(2, 16 // factor, 8 // factor, 5, generator=g).to(dtype)
    up = y.repeat_interleave(factor, 1).repeat_interleave(factor, 2)
    assert torch.equal(add_upsampled_nearest(acc, y, factor), acc + up)


def test_hrnet_init_follows_the_flax_initializers():
    """he_normal conv kernels (std sqrt(2 / fan_in)), unit BN scale, zero
    bias, for every conv of the backbone."""
    model = HRNet(config.hrnet_backbone(32))
    init_parameters(model, torch.Generator().manual_seed(0))
    convs = [m for m in model.modules() if hasattr(m, "scale")]
    assert len(convs) == sum(1 for k in model.state_dict()
                             if k.endswith(".weight"))
    for m in convs:
        w = m.weight
        std = float(np.sqrt(2.0 / (w.shape[1] * w.shape[2] * w.shape[3])))
        assert abs(w.std().item() / std - 1) < 0.1 or w.numel() < 2000
        assert torch.equal(m.scale, torch.ones_like(m.scale))
        assert torch.equal(m.bias, torch.zeros_like(m.bias))


def _small_slice(cfg, cfglib, dtype, width, embed):
    """A serving slice cut to test size, in ``dtype`` (backbone and
    lifter)."""
    lifter = replace(cfg.model.lifter, embed_dim_ratio=embed, depth=1,
                     compute_dtype=dtype)
    if dtype == "float32":
        lifter = replace(lifter, sampler_precision="highest")
    model = replace(
        cfg.model, image_shape=HW, compute_dtype=dtype, lifter=lifter,
        backbone=_small_backbone(cfglib, cfg.model.backbone, width))
    return replace(cfg, model=model)


# (preset, backbone width, lifter embed): width 8 with embed 32 keeps W32's
# level 0 raw (C = head dim) and projects levels 1-3 in the sampler; width
# 12 projects level 0 too, as W48 does; the 3DHP lifter has no deformable
# blocks
SLICES = [("h36m_hrnet_32", 8, 32), ("h36m_hrnet_48", 12, 32),
          ("mpi_3dhp_hrnet_32", 8, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,width,embed", SLICES)
def test_slice_matches_jax(name, width, embed, dtype):
    """uint8 frames -> (2, 17, 3) through ``serve.lift`` against the JAX
    package's serving graph. fp32: max abs error <= 1e-3 x output RMS;
    bf16: relative RMS <= 3e-2."""
    cfg = _small_slice(serve.slice_config(name), config, dtype, width, embed)
    jdeployed = jconfig.deploy(jconfig.preset(name))
    jcfg = _small_slice(jdeployed, jconfig, dtype, width, embed)
    assert asdict(cfg) == asdict(jcfg)
    jdtype = jnp.dtype(dtype)
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    kp = rng.uniform(-1, 1, (2, 17, 2)).astype(np.float32)
    kpc = rng.uniform(0, HW[1], (2, 17, 2)).astype(np.float32)
    tree_model = JCAPF(cfg=replace(jcfg.model, lifter=replace(
        jcfg.model.lifter, **PLAIN_KNOBS)))
    variables = _random_variables(tree_model, rng, jnp.zeros((1, *HW, 3)),
                                  kp[:1], kpc[:1])

    jmodel_cfg = replace(jcfg.model, lifter=replace(
        jcfg.model.lifter, sampler="fused_interpret"))
    jmodel = JCAPF(cfg=jmodel_cfg, dtype=jdtype)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(x, jdtype)
        if x.ndim == 4 and "backbone" in jax.tree_util.keystr(path)
        else jnp.asarray(x), variables)

    @jax.jit
    def jax_lift(p, frames, kp, kpc):
        images = jaug.serving_images(frames, jmodel_cfg.backbone,
                                     dtype=jdtype)
        return jmodel.apply(p, images, kp, kpc)

    theirs = np.asarray(jax_lift(params, frames, kp, kpc), np.float32)
    model = serve.build_serving_model(cfg, "cpu", variables=variables)
    ours = serve.lift(model, *map(torch.from_numpy, (frames, kp, kpc)))
    assert ours.shape == (2, 17, 3) and ours.dtype == torch.float32
    ours = ours.numpy()
    if dtype == "float32":
        assert np.abs(ours - theirs).max() <= 1e-3 * _rms(theirs)
    else:
        assert _rms(ours - theirs) <= 3e-2 * _rms(theirs)


def test_lifter_projects_levels_as_the_deploy_knobs_say():
    """W32 at full width: level 0 (C = 32 = head dim) is sampled raw and
    levels 1-3 are projected inside the sampler; W48 projects level 0 too.
    The 3DHP lifter builds no deformable blocks."""
    from contextaware_poseformer_tpu_torch.models.lifter import PoseLifter

    for name, pre in (("h36m_hrnet_32", [False, True, True, True]),
                      ("h36m_hrnet_48", [True, True, True, True])):
        cfg = serve.slice_config(name).model
        lifter = PoseLifter(cfg.lifter, cfg.backbone.feature_dims,
                            device="meta")
        block = lifter.context_block_0
        dims = cfg.backbone.feature_dims
        hd = cfg.lifter.embed_dim_ratio // cfg.lifter.deform_heads
        assert [block.pre_project and deformable.kernel_can_preproject(
            64 >> l, 48 >> l, c, hd, torch.bfloat16)
            for l, c in enumerate(dims)] == pre
    cfg = serve.slice_config("mpi_3dhp_hrnet_32").model
    lifter = PoseLifter(cfg.lifter, cfg.backbone.feature_dims, device="meta")
    assert not lifter._blocks("context")
    assert not any(n.startswith("context_block")
                   for n, _ in lifter.named_children())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hrnet_normalization_matches_jax(dtype):
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (2, 8, 6, 3)).astype(np.uint8)
    cfg = serve.slice_config("h36m_hrnet_32").model.backbone
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ours = augment.serving_images(torch.from_numpy(frames), cfg, dtype)
    theirs = jaug.serving_images(jnp.asarray(frames), cfg, jdtype)
    assert ours.dtype == dtype
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs, np.float32))


def test_bridge_accounting_on_a_full_width_hrnet():
    """The flax tree of the full-width h36m_hrnet_32 serving composite
    (from ``jax.eval_shape``) lands leaf for leaf on the port's modules,
    HRNet names such as ``stage4.0.fuse_layers.0.1.0`` included; a missing
    or stray leaf raises."""
    jcfg = jconfig.deploy(jconfig.preset("h36m_hrnet_32")).model
    jcfg = replace(jcfg, backbone=replace(jcfg.backbone, quantize="none"),
                   lifter=replace(jcfg.lifter, **PLAIN_KNOBS))
    h, w = jcfg.image_shape
    shapes = jax.eval_shape(
        JCAPF(cfg=jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, h, w, 3)), jnp.zeros((1, 17, 2)), jnp.zeros((1, 17, 2)))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    backbone = tree["params"]["backbone"]
    assert {"stage2.0.branches.0.0.conv1", "stage4.0.fuse_layers.0.1.0",
            "stage4.2.fuse_layers.0.3.0", "stage3.3.fuse_layers.2.0.1.0",
            "transition3.3.0.0"} <= set(backbone)

    model = ContextAwarePoseFormer(serve.slice_config("h36m_hrnet_32").model)
    load_jax_variables(model, tree)
    assert model.backbone.stage4_2_fuse_layers_0_3_0.weight.shape == (
        32, 256, 1, 1)
    stray = {**backbone, "stage4.2.fuse_layers.1.0.0.0": {
        "kernel": np.zeros((3, 3, 32, 64), np.float32)}}
    with pytest.raises(ValueError, match="stage4_2_fuse_layers_1_0_0_0"):
        load_jax_variables(model, {"params": {**tree["params"],
                                              "backbone": stray}})
    short = dict(backbone)
    del short["stage3.3.fuse_layers.2.0.1.0"]
    with pytest.raises(ValueError, match="stage3_3_fuse_layers_2_0_1_0"):
        load_jax_variables(model, {"params": {**tree["params"],
                                              "backbone": short}})


def test_int8_hrnet_is_refused_and_the_slice_builds():
    """The int8 deploy backbone (quantize="serve") builds with its int8
    convs (held against the JAX package in tests/test_torch_int8.py);
    quantize="static" builds too, its layer1 conv2 a calibrated int8 conv
    outside any int8 chain (tests/test_torch_quantize_modes.py), and an
    unknown mode is refused; the float slice builds."""
    deployed = config.deploy(config.preset("h36m_hrnet_32")).model.backbone
    model = HRNet(deployed, device="meta")
    assert model.serve and model.layer1_0_conv2.int8
    assert not model.conv1.int8 and model.stage4_0_branches_3_0_conv1.dynamic
    static = HRNet(replace(deployed, quantize="static"), device="meta")
    assert not static.serve and static.layer1_0_conv2.static
    with pytest.raises(ValueError, match="int4"):
        HRNet(replace(deployed, quantize="int4"), device="meta")
    cfg = serve.slice_config("h36m_hrnet_32")
    b = cfg.model.backbone
    assert (b.kind, b.width, b.quantize) == ("hrnet", 32, "none")
    model = ContextAwarePoseFormer(cfg.model, device="meta")
    assert isinstance(model.backbone, HRNet)


@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_k5_two_stage_body_matches_the_plain_sampler(pyramid, mode):
    """K5: the JAX multi-level sampler in interpret mode, whose 64x48 level
    (C < 64) takes the separable two-stage body, against the port's
    ``sample_points_multi_reference``: zeros with the 17 reference points,
    border with 272 deformable points and levels 1-3 projected to 32
    channels (level 0 raw, as for W32). fp32 at full precision: max abs
    error <= 1e-5 of max|plain| per level."""
    rng = np.random.RandomState(5)
    b = 2
    dims = PYRAMIDS[pyramid]
    feats = [rng.randn(b, h, w, c).astype(np.float32) for h, w, c in dims]
    p = 17 if mode == "zeros" else 17 * 16
    pts = rng.uniform(-1.2, 1.2, (b, 4, p, 2)).astype(np.float32)
    pts[0, :, :4] = [[1, 1], [-1, -1], [1, -1], [-1, 1]]
    projs = biases = None
    if mode == "border":
        projs = [None] + [(rng.uniform(-1, 1, (c, 32)) / np.sqrt(c))
                          .astype(np.float32) for _, _, c in dims[1:]]
        biases = [None] + [rng.randn(32).astype(np.float32) * 0.1
                           for _ in dims[1:]]
    assert jdef._use_two_stage(*dims[0]) and not any(
        jdef._use_two_stage(*d) for d in dims[1:])

    def jnp_or_none(vs):
        return None if vs is None else [
            None if v is None else jnp.asarray(v) for v in vs]

    theirs = jdef.sample_points_levels(
        tuple(map(jnp.asarray, feats)), jnp.asarray(pts), padding_mode=mode,
        impl="fused_interpret", projs=jnp_or_none(projs),
        biases=jnp_or_none(biases))

    def torch_or_none(vs):
        return None if vs is None else [
            None if v is None else torch.from_numpy(v) for v in vs]

    ours = deformable.sample_points_multi_reference(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(pts), mode,
        True, torch_or_none(projs), torch_or_none(biases))
    for lvl, (o, t) in enumerate(zip(ours, theirs)):
        t = np.asarray(t)
        assert o.shape == t.shape, lvl
        err = np.abs(o.numpy() - t).max()
        assert err <= 1e-5 * np.abs(t).max(), (lvl, err)
