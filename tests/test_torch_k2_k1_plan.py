"""K2's route planner, K1's projected plan and K1's rounding points, on the
CPU.

K2 (``ops/csrc/fused_mlp.cu``) has two bf16 routes on Hopper's ``wgmma``:
weights-resident for the narrow blocks and two-phase for the wide ones;
``fused_mlp.plan`` picks one from D, H and the shared-memory budget. K1's
projected body on bf16 and int8 maps (``ops/csrc/sampler.cu``) runs the
projection on the tensor cores, 64 points a block; ``projected_plan`` says
what a level takes. These tests hold, without a GPU:

- the planner at the lifter width of every preset (read from the port's
  ``config.preset``): the route, its shared memory within one block's
  limit, and tile widths that divide or mask H and D;
- K1's plan at every projected level of the five presets' pyramids, and
  the shapes it refuses;
- K1's rounding points (the blend and W rounded to bf16, fp32
  accumulation, an int8 level's dequant scale and the bias applied in
  fp32), emulated in torch, against the plain version and against
  the JAX package's K1 in interpret mode at DEFAULT precision (bf16
  operands, fp32 accumulation), to 2e-2 of max|reference|: the card's bf16
  tolerance. The samples of a point are held, not the map: the JAX kernel
  projects the map before it samples it, which equals projecting the
  samples in border mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contextaware_poseformer_tpu.ops import deformable as jdef
from contextaware_poseformer_tpu_torch import config
from contextaware_poseformer_tpu_torch.ops import _build, deformable, fused_mlp
from contextaware_poseformer_tpu_torch.ops.grid_sample import (
    sample_points_fp32,
)

BF16_TOL = 2e-2


def _lifter(name):
    return config.preset(name).model.lifter


def _width(name, block):
    """D of a lifter block: the per-level blocks (context and res) run at
    ``embed_dim_ratio``, the joint blocks at ``embed_dim``."""
    lc = _lifter(name)
    return lc.embed_dim_ratio if block == "level" else lc.embed_dim


@pytest.mark.parametrize("block", ["level", "joint"])
@pytest.mark.parametrize("name", config.PRESETS)
def test_k2_plan_at_every_preset_width(name, block):
    d = _width(name, block)
    hdim = int(d * _lifter(name).mlp_ratio)
    plan = fused_mlp.plan(torch.bfloat16, d, hdim)
    assert plan.route == ("resident" if d <= 128 else "two-phase")
    assert all(0 < s <= _build.SMEM_LIMIT for s in plan.smem)
    if plan.route == "resident":
        # fc1 in hidden tiles that divide H; fc2 at the full width D
        assert len(plan.smem) == 1
        assert hdim % plan.tiles[0] == 0 and plan.tiles[1] == d
        assert plan.smem[0] == fused_mlp._resident_smem(d, hdim)
    else:
        # two launches; a ragged last tile is masked, never skipped
        assert len(plan.smem) == 2
        for n, tile in zip((hdim, d), plan.tiles):
            tiles = -(-n // tile)
            assert (tiles - 1) * tile < n <= tiles * tile
            assert n % 16 == 0  # wgmma's k-steps and 16-byte stores
        assert plan.smem == fused_mlp._two_phase_smem(d, hdim, plan.tiles[0])
        # the phase-1 tile the measurements chose: 256 from D = 480 on
        assert plan.tiles[0] == (256 if d >= 480 else 128)
    # the fp32 body (parity runs, training) at the same width
    assert fused_mlp.plan(torch.float32, d, hdim).route == "fp32"


@pytest.mark.parametrize("d, hdim, error", [
    (72, 144, ValueError),     # D not a multiple of 16
    (128, 200, ValueError),    # H not a multiple of 16
    (2048, 4096, ValueError),  # the LN tile does not fit in shared memory
])
def test_k2_plan_refuses_what_no_route_takes(d, hdim, error):
    with pytest.raises(error):
        fused_mlp.plan(torch.bfloat16, d, hdim)


def test_k2_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        fused_mlp.plan(torch.float16, 128, 256)


def test_k2_resident_route_only_at_its_instantiations():
    """The resident kernel exists for D = 64, 96, 128 with H = 2D; any other
    pair takes the two-phase route."""
    assert fused_mlp.plan(torch.bfloat16, 128, 384).route == "two-phase"
    assert fused_mlp.plan(torch.bfloat16, 32, 64).route == "two-phase"
    for d in fused_mlp.RESIDENT_WIDTHS:
        assert fused_mlp.plan(torch.bfloat16, d, 2 * d).route == "resident"


def test_k2_weight_cast_once_per_parameter_state():
    """The bf16 routes read W^T in bf16, cast once per parameter state: the
    same tensor at the same version returns the cached cast; an in-place
    update (an optimizer step, ``copy_``) casts anew."""
    w = torch.nn.Parameter(torch.randn(64, 128))
    first = fused_mlp.kernel_weight(w)
    assert first.dtype == torch.bfloat16 and first.is_contiguous()
    assert torch.equal(first, w.detach().t().to(torch.bfloat16))
    assert not first.requires_grad
    assert fused_mlp.kernel_weight(w) is first
    with torch.no_grad():
        w.mul_(2.0)
    second = fused_mlp.kernel_weight(w)
    assert second is not first
    assert torch.equal(second, w.detach().t().to(torch.bfloat16))
    with torch.no_grad():
        w.copy_(torch.ones_like(w))
    assert torch.equal(fused_mlp.kernel_weight(w),
                       torch.ones(128, 64, dtype=torch.bfloat16))


def test_k2_weight_cast_of_inference_tensors():
    """A tensor made under ``torch.inference_mode()`` has no version
    counter: it is cast on every call, never cached, and does not fail."""
    with torch.inference_mode():
        w = torch.randn(32, 16)
        a, b = fused_mlp.kernel_weight(w), fused_mlp.kernel_weight(w)
    assert a is not b and torch.equal(a, b)
    assert torch.equal(a, w.t().to(torch.bfloat16))


def _projected_levels(name, dtype):
    """(C, Cout, points a call) of every level the preset's lifter projects
    inside the sampler on ``dtype`` maps (none without deformable
    blocks)."""
    cfg = config.preset(name)
    lc = cfg.model.lifter
    if not lc.use_deformable:
        return []
    head_dim = lc.embed_dim_ratio // lc.deform_heads
    points = lc.num_joints * lc.deform_heads * lc.deform_samples
    return [(c, head_dim, points) for c in cfg.model.backbone.feature_dims
            if deformable.kernel_can_preproject(0, 0, c, head_dim, dtype)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("name", config.PRESETS)
def test_k1_plan_at_every_projected_level(name, dtype):
    levels = _projected_levels(name, dtype)
    if name.startswith("h36m"):
        assert len(levels) >= 3  # W32 projects 3 levels, W48 and CPN 4
    else:
        assert levels == []  # the 3DHP lifters have no deformable blocks
    for c, cout, points in levels:
        blocks, smem = deformable.projected_plan(dtype, c, cout, points)
        assert blocks == -(-points // deformable._CHUNK) == 5  # 272 points
        assert smem <= _build.SMEM_LIMIT
        # the fp32 body takes the same level
        deformable.projected_plan(torch.float32, c, cout, points)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("c, cout", [
    (40, 32),   # C not a multiple of 16
    (64, 12),   # Cout not a multiple of 8
    (64, 72),   # more outputs than a warp's n-tiles hold
    (8192, 32),  # the A tile does not fit in shared memory
])
def test_k1_plan_refuses_what_the_tensor_cores_do_not_take(dtype, c, cout):
    with pytest.raises(ValueError):
        deformable.projected_plan(dtype, c, cout, 272)


def test_k1_plan_refuses_fp32_channels_off_four():
    with pytest.raises(ValueError):
        deformable.projected_plan(torch.float32, 64, 6, 272)


def _tensor_core_projection(maps, points, projs, biases, scale):
    """K1's projected body on bf16 or int8 maps, emulated: the fp32 blend
    rounded to bf16, W rounded to bf16, the products accumulated in fp32,
    multiplied by the level's scale and the bias added in fp32, the result
    rounded to bf16."""
    outs = []
    for l, f in enumerate(maps):
        s = sample_points_fp32(f, points[:, l], padding_mode="border",
                               align_corners=True)
        a = s.to(torch.bfloat16).float()
        w = projs[l].to(torch.bfloat16).float()
        outs.append(((a @ w) * scale + biases[l]).to(torch.bfloat16))
    return tuple(outs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_k1_rounding_points_match_plain_and_jax(dtype):
    rng = np.random.RandomState(8)
    b, dims, hd = 2, ((8, 6, 64), (4, 3, 48)), 32
    if dtype == torch.int8:
        maps_np = [rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)
                   for h, w, c in dims]
        scale = 0.02  # the dequant scale of the int8 maps
    else:
        maps_np = [rng.randn(b, h, w, c).astype(np.float32)
                   for h, w, c in dims]
        scale = 1.0
    projs_np = [(rng.uniform(-1, 1, (c, hd)) / np.sqrt(c)).astype(np.float32)
                for *_, c in dims]
    biases_np = [rng.uniform(-0.1, 0.1, hd).astype(np.float32) for _ in dims]
    pts_np = rng.uniform(-1.5, 1.5, (b, len(dims), 17, 4, 2)).astype(
        np.float32)

    maps = [torch.from_numpy(m).to(dtype) for m in maps_np]
    pts = torch.from_numpy(pts_np)
    projs = [torch.from_numpy(w) for w in projs_np]
    biases = [torch.from_numpy(v) for v in biases_np]
    # the port hands the sampler W and the scale apart; the JAX lifter
    # folds the scale into W
    scales = [torch.tensor(scale, dtype=torch.float32)] * len(dims)
    ours = _tensor_core_projection(maps, pts, projs, biases, scale)
    plain = deformable.sample_points_multi_reference(
        maps, pts, "border", True, projs, biases, scales)
    jdt = jnp.int8 if dtype == torch.int8 else jnp.bfloat16
    theirs = jdef.sample_points_levels(
        [jnp.asarray(m).astype(jdt) for m in maps_np], jnp.asarray(pts_np),
        padding_mode="border", align_corners=True, impl="fused_interpret",
        precision="default",
        projs=[jnp.asarray(w) * np.float32(scale) for w in projs_np],
        biases=[jnp.asarray(v) for v in biases_np])
    for o, p, t in zip(ours, plain, theirs):
        assert o.dtype == torch.bfloat16 and t.dtype == jnp.bfloat16
        o = o.float().numpy()
        for ref in (p.float().numpy(), np.asarray(t, np.float32)):
            assert o.shape == ref.shape
            err = np.abs(o - ref).max()
            assert err <= BF16_TOL * np.abs(ref).max(), err
