"""The port's PoseLifter and its layers against the JAX package's.

Weights are random flax variables (every leaf drawn from numpy, so a
mis-mapped parameter shows) carried across with ``models/bridge.py``; inputs
come from numpy. The JAX side runs the serving knobs with its Pallas kernels
in interpret mode. Tolerance: max abs error <= 1e-4 x RMS of the JAX output
(fp32; summation order and erf differ in the last bits).
"""

import math
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu.config import LifterConfig
from contextaware_poseformer_tpu.models import PoseLifter as JaxPoseLifter
from contextaware_poseformer_tpu.models.lifter import (
    _offset_bias_init as jax_offset_bias_init,
)
from contextaware_poseformer_tpu_torch.models import layers
from contextaware_poseformer_tpu_torch.models import lifter as lifter_module
from contextaware_poseformer_tpu_torch.models.bridge import load_jax_variables
from contextaware_poseformer_tpu_torch.models.init import init_parameters
from contextaware_poseformer_tpu_torch.models.lifter import (
    DeformableBlock,
    PoseLifter,
    _offset_bias_init,
)
from contextaware_poseformer_tpu_torch.ops import deformable

# serving knobs (config.deploy) in fp32; pre-projection is exact in border
# mode. Channels (8, 16, 24, 40) against head_dim 8: level 0 samples
# unprojected, the others project in the sampler.
SLICE_KNOBS = dict(attention="fused", attention_joint="grouped", mlp="fused",
                   sampler_pre_project=True)
PLAIN_KNOBS = dict(sampler="gather", attention="einsum",
                   attention_joint="einsum", mlp="einsum")
DIMS = (8, 16, 24, 40)
SIZES = ((2, 2), (4, 4), (8, 8), (16, 16))


def _inputs(rng, batch=2):
    kp2d = rng.uniform(-1, 1, (batch, 17, 2)).astype(np.float32)
    ref = rng.uniform(-1.05, 1.05, (batch, 17, 2)).astype(np.float32)
    feats = [rng.randn(batch, h, w, c).astype(np.float32)
             for (h, w), c in zip(SIZES, DIMS)]
    return kp2d, ref, feats


def _random_variables(model, rng, *args):
    """Flax variables of ``model`` with every leaf drawn from numpy; the tree
    comes from ``jax.eval_shape`` (no init compile). Conv kernels are
    he-scaled, Dense kernels U(+-1/sqrt(fan_in)), scales U(0.5, 1.5), biases
    and ``pos_embed`` N(0, 0.1)."""
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


def _jax_lifter(cfg, rng, kp2d, ref, feats):
    """(numpy variables, output) of the JAX lifter: the param tree of the
    plain config (the same tree), applied with ``cfg``'s kernels
    interpreted."""
    init_model = JaxPoseLifter(cfg=replace(cfg, **PLAIN_KNOBS),
                               feature_dims=DIMS)
    j = [jnp.asarray(f) for f in feats]
    variables = _random_variables(init_model, rng, jnp.asarray(kp2d),
                                  jnp.asarray(ref), j)
    model = JaxPoseLifter(cfg=replace(cfg, sampler="fused_interpret"),
                          feature_dims=DIMS)
    out = jax.jit(model.apply)(variables, jnp.asarray(kp2d),
                               jnp.asarray(ref), j)
    return variables, np.asarray(out)


@pytest.mark.parametrize("embed", [32, 80])
def test_pose_lifter_matches_jax(embed):
    """Head dims 8 and 20 (embed over 4 deformable heads); 20 is F6's case,
    a head dim the tensor-core projection refuses."""
    rng = np.random.RandomState(0)
    cfg = replace(LifterConfig(embed_dim_ratio=embed, depth=1),
                  **SLICE_KNOBS)
    kp2d, ref, feats = _inputs(rng)
    variables, theirs = _jax_lifter(cfg, rng, kp2d, ref, feats)

    ours_model = PoseLifter(cfg, DIMS)
    load_jax_variables(ours_model, variables)
    with torch.no_grad():
        ours = ours_model(torch.from_numpy(kp2d), torch.from_numpy(ref),
                          [torch.from_numpy(f) for f in feats]).numpy()
    assert ours.shape == theirs.shape == (2, 17, 3)
    rms = np.sqrt(np.mean(theirs ** 2))
    assert np.abs(ours - theirs).max() <= 1e-4 * rms

    # the plain knobs compute the same function on the same weights
    plain = PoseLifter(replace(cfg, **PLAIN_KNOBS), DIMS)
    plain.load_state_dict(ours_model.state_dict())
    with torch.no_grad():
        again = plain(torch.from_numpy(kp2d), torch.from_numpy(ref),
                      [torch.from_numpy(f) for f in feats]).numpy()
    assert np.abs(again - ours).max() <= 1e-5 * rms


def test_offset_bias_init_matches_jax():
    got = _offset_bias_init(4, 4)
    want = np.asarray(jax_offset_bias_init(4, 4)(None, (32,)))
    np.testing.assert_array_equal(got, want)


def test_seeded_init_follows_the_flax_initializers():
    cfg = LifterConfig(embed_dim_ratio=32, depth=1)
    a, b = PoseLifter(cfg, DIMS), PoseLifter(cfg, DIMS)
    init_parameters(a, torch.Generator().manual_seed(7))
    init_parameters(b, torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    blk = a.context_block_0
    assert not blk.attention_weights.kernel.any()
    assert not blk.attention_weights.bias.any()
    assert not blk.sampling_offsets.kernel.any()
    np.testing.assert_array_equal(blk.sampling_offsets.bias.detach().numpy(),
                                  _offset_bias_init(4, 4))
    assert not a.pos_embed.any()
    assert torch.equal(blk.norm1.scale, torch.ones(32))
    bound = 1 / np.sqrt(32)
    k = a.res_block_0.attn.qkv.kernel
    assert k.abs().max() <= bound and k.std() > bound / 4


def test_linear_dtype_promotion_matches_flax():
    """dtype=None promotes like flax (bf16 input x fp32 kernel -> fp32); a
    compute dtype casts input and parameters."""
    lin = layers.Linear(4, 3)
    init_parameters(lin, torch.Generator().manual_seed(0))
    x = torch.randn(2, 4).to(torch.bfloat16)
    assert lin(x).dtype == torch.float32
    lin16 = layers.Linear(4, 3, dtype=torch.bfloat16)
    lin16.load_state_dict(lin.state_dict())
    assert lin16(x).dtype == torch.bfloat16


# the per-level channels of the backbones' maps: CPN, HRNet-W32, HRNet-W48
F6_PYRAMIDS = ((256, 256, 256, 256), (32, 64, 128, 256), (48, 96, 192, 384))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("hd", [8, 12, 20, 24, 72, 128])
def test_lifter_hands_the_sampler_only_levels_it_takes(hd, dtype,
                                                       monkeypatch):
    """F6: a deformable block with the in-sampler projection on (as every
    deploy config has it) hands ``sampler_plan`` only levels a body of the
    kernel takes, at head dims the tensor-core projection refuses (not a
    multiple of 8, above 64) and those it takes, on each backbone's
    channels and every map dtype. The plan alone is checked; the samples
    come from the plain version."""
    plans = []

    def planned(features, points, padding_mode="zeros", align_corners=True,
                impl="auto", projs=None, biases=None, scales=None):
        spec = [(f.shape[-1], None if w is None else w.shape[1])
                for f, w in zip(features, projs or [None] * len(features))]
        plans.append(deformable.sampler_plan(
            features[0].dtype, spec, points.shape[0],
            math.prod(points.shape[2:-1])))
        return deformable.sample_points_levels(
            features, points, padding_mode, align_corners, "gather", projs,
            biases, scales)

    monkeypatch.setattr(lifter_module, "sample_points_levels", planned)
    g = torch.Generator().manual_seed(6)
    compute = torch.float32 if dtype == torch.float32 else torch.bfloat16
    for dims in F6_PYRAMIDS:
        block = DeformableBlock(4 * hd, dims, num_heads=4, num_samples=4,
                                dtype=compute, pre_project=True)
        init_parameters(block, torch.Generator().manual_seed(0))
        if dtype == torch.int8:
            feats = [torch.randint(-127, 128, (1, 3, 2, c), generator=g,
                                   dtype=torch.int8) for c in dims]
            scales = [torch.tensor([0.01]) for _ in dims]
        else:
            feats = [torch.randn(1, 3, 2, c, generator=g).to(dtype)
                     for c in dims]
            scales = None
        tokens = torch.randn(1, len(dims) + 1, 17, 4 * hd, generator=g)
        ref = torch.rand(1, 17, 2, generator=g) * 2 - 1
        with torch.no_grad():
            out = block(tokens.to(compute), ref, feats, feat_scales=scales)
        assert out.shape == tokens.shape and torch.isfinite(out).all()
        projected = [l for l, c in enumerate(dims) if c > hd and
                     deformable.kernel_can_preproject(0, 0, c, hd, dtype)]
        bodies = plans[-1].bodies
        assert [l for l, b in enumerate(bodies) if b != "gather"] == projected
        if hd in (8, 24):  # every body takes it: each wider level projects
            assert projected == [l for l, c in enumerate(dims) if c > hd]
        elif dtype != torch.float32:  # the tensor-core body refuses it
            assert projected == []
