"""K5's and K7's geometry and rounding points, on the CPU.

The sampler (``ops/csrc/sampler.cu``: K1, K5, K8) runs one flat grid of
work units: each level's points, flattened over (item, point), cut into
units of that level's own size (``deformable.sampler_plan``): 64 points
for the tensor-core projection, 32 for the fp32 projection, and for the
gather enough 16-byte channel groups that every thread blends 4, at most
one item's points. K7 (``ops/csrc/aggregate.cu``) pools each (joint, head)
row's samples before it projects the row once, 64 rows a block
(``deformable.aggregate_plan``). These tests hold, without a GPU:

- the sampler's plan at every call of the five presets' lifters (read from
  the port's ``config.preset``), in fp32, bf16 and int8: every point in
  exactly one unit, no empty unit, shared memory within a block's limit,
  one launch (one grid) a call, and the calls it refuses;
- what the wrapper hands the kernel: each level's unit, the plan's order
  and unit ends, W as the cached bf16 W^T (the tensor-core body) or fp32
  (the fp32 body), an int8 level's dequant scale apart from W, and the
  ctypes layouts of the C structs; the scale's contract (the product times
  the scale, before the bias) in the plain version, its dispatcher and its
  gradient;
- K7's pool-first arithmetic, emulated in torch at its rounding points (the
  weighted blend of a row's samples in fp32, rounded once to bf16, W in
  bf16, fp32 accumulation, (sum of the weights) * b in fp32, one rounding
  of the output), against the port's and the JAX package's
  ``aggregate_reference``: ns = 1, 2 and 4, both padding modes, weights
  that do not sum to 1; fp32 to 1e-5 of max|reference|, bf16 to 2e-2 per
  level (the card's bf16 tolerance);
- the gather's arithmetic (the fp32 blend of the four taps, rounded once to
  bf16) over the units of the plan at HRNet-W32's level 0 (64x48x32, the
  shape of K5), against the JAX package's K1 in interpret mode, which takes
  its separable two-stage body there.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contextaware_poseformer_tpu.ops import deformable as jdef
from contextaware_poseformer_tpu_torch import config
from contextaware_poseformer_tpu_torch.ops import _build, deformable
from contextaware_poseformer_tpu_torch.ops.grid_sample import (
    sample_points_fp32,
)

BF16_TOL = 2e-2
FP32_TOL = 1e-5
SAMPLER_DTYPES = [torch.float32, torch.bfloat16, torch.int8]


def _pyramid(name):
    """(H, W, C) of each level the preset's backbone hands the lifter at
    256x192: HRNet finest first, the CPN native pyramid deepest first."""
    cfg = config.preset(name)
    dims = cfg.model.backbone.feature_dims
    if name.endswith("cpn"):
        return [(8 << l, 6 << l, c) for l, c in enumerate(dims)]
    return [(64 >> l, 48 >> l, c) for l, c in enumerate(dims)]


def _calls(name, dtype):
    """(points a level and item, per level the projection's Cout or None)
    of each sampler call the preset's lifter makes: the 17 reference points
    (zeros, no projection) and, with deformable blocks, the border call
    with the in-sampler projections where ``kernel_can_preproject``."""
    lc = config.preset(name).model.lifter
    levels = _pyramid(name)
    calls = [(lc.num_joints, [None] * len(levels))]
    if lc.use_deformable:
        hd = lc.embed_dim_ratio // lc.deform_heads
        points = lc.num_joints * lc.deform_heads * lc.deform_samples
        calls.append((points, [hd if deformable.kernel_can_preproject(
            h, w, c, hd, dtype) else None for h, w, c in levels]))
    return calls


@pytest.mark.parametrize("dtype", SAMPLER_DTYPES)
@pytest.mark.parametrize("name", config.PRESETS)
def test_sampler_plan_at_every_preset_call(name, dtype):
    levels = _pyramid(name)
    for batch in (1, 3, 64):
        for points, couts in _calls(name, dtype):
            spec = [(c, cout) for (_, _, c), cout in zip(levels, couts)]
            plan = deformable.sampler_plan(dtype, spec, batch, points)
            total = batch * points
            assert len(plan.units) == len(levels)  # one grid, every level
            assert plan.blocks == sum(plan.units)
            assert sorted(plan.order) == list(range(len(levels)))
            for (c, cout), body, size, units in zip(
                    spec, plan.bodies, plan.unit_points, plan.units):
                # every point in exactly one unit, no unit empty
                assert (units - 1) * size < total <= units * size
                if cout is None:
                    assert body == "gather"
                    assert 1 <= size <= min(deformable._MAX_POINTS, points)
                else:
                    assert body == ("fp32" if dtype == torch.float32
                                    else "tc")
                    assert size == (deformable._TILE
                                    if dtype == torch.float32
                                    else deformable._CHUNK)
            assert plan.tensor_cores == ("tc" in plan.bodies)
            assert 0 < plan.smem <= _build.SMEM_LIMIT
            # the units with the most work (points x channels) run first
            work = [plan.unit_points[l] * spec[l][0] for l in plan.order]
            assert work == sorted(work, reverse=True)
            assert plan.unit_end == tuple(np.cumsum(
                [plan.units[l] for l in plan.order]))


def test_sampler_plan_of_the_w32_border_call():
    """HRNet-W32's border call at batch 64: level 0 (C = 32, raw) in
    gather units of 256 points, the projected levels in 64-point
    tensor-core units, no empty block (a grid of 32-point tiles for every
    level had 768), the widest level's units first; W^T in bf16 keeps
    the shared memory at the 256-channel level's 52,736 bytes, in bf16
    and int8 alike."""
    spec = [(32, None), (64, 32), (128, 32), (256, 32)]
    for dtype in (torch.bfloat16, torch.int8):
        plan = deformable.sampler_plan(dtype, spec, 64, 272)
        assert plan.bodies == ("gather", "tc", "tc", "tc")
        assert plan.unit_points == (256, 64, 64, 64)
        assert plan.order == (3, 0, 2, 1)
        assert plan.smem == 32 * 64 + 2 * 64 * 264 + 2 * 32 * 264 == 52736
    plan = deformable.sampler_plan(torch.bfloat16, spec, 64, 272)
    assert plan.units == (68, 272, 272, 272)
    assert plan.unit_end == (272, 340, 612, 884) and plan.blocks == 884


@pytest.mark.parametrize("dtype, spec, error", [
    (torch.bfloat16, [(36, None)], ValueError),   # C % 8
    (torch.float32, [(6, None)], ValueError),     # C % 4
    (torch.int8, [(40, None)], ValueError),       # C % 16
    (torch.bfloat16, [(40, 32)], ValueError),     # projected C % 16
    (torch.bfloat16, [(64, 72)], ValueError),     # Cout > 64
    (torch.bfloat16, [(8192, 32)], ValueError),   # no shared memory
    (torch.float32, [(64, 6)], ValueError),       # fp32 Cout % 4
    (torch.float16, [(64, None)], TypeError),     # no body for fp16
])
def test_sampler_plan_refuses_what_no_body_takes(dtype, spec, error):
    with pytest.raises(error):
        deformable.sampler_plan(dtype, spec, 2, 17)


def test_sampler_plan_refuses_an_empty_call():
    with pytest.raises(ValueError):
        deformable.sampler_plan(torch.bfloat16, [(64, None)], 0, 17)


def test_ctypes_layouts_match_the_c_structs():
    """``csrc/sampler.cu``'s CapfSampleLevel (5 pointers, 5 ints, padded
    to 8 bytes) and CapfSampleArgs (a pointer, 8 levels, 6 ints, order and
    unit_end);
    ``csrc/aggregate.cu``'s CapfAggregateArgs (3 pointers, 8 levels of 3
    pointers and 3 ints, 8 ints)."""
    assert ctypes.sizeof(deformable._Level) == 5 * 8 + 5 * 4 + 4
    assert ctypes.sizeof(deformable._Args) == (
        8 + 8 * ctypes.sizeof(deformable._Level) + 6 * 4 + 2 * 8 * 4)
    assert ctypes.sizeof(deformable._AggregateLevel) == 3 * 8 + 3 * 4 + 4
    assert ctypes.sizeof(deformable._AggregateArgs) == (
        3 * 8 + 8 * ctypes.sizeof(deformable._AggregateLevel) + 8 * 4)


def _w32_call(dtype):
    """The W32 border call at batch 2: W parameters (as the lifter holds
    them) on the three projected levels; int8 maps with a dequant scale
    each."""
    g = torch.Generator().manual_seed(3)
    levels = _pyramid("h36m_hrnet_32")
    if dtype == torch.int8:
        maps = [torch.randint(-127, 128, (2, h, w, c), generator=g,
                              dtype=torch.int8) for h, w, c in levels]
    else:
        maps = [torch.randn(2, h, w, c, generator=g).to(dtype)
                for h, w, c in levels]
    pts = torch.rand(2, 4, 17, 16, 2, generator=g) * 3 - 1.5
    projs = [torch.nn.Parameter(torch.randn(c, 32, generator=g))
             if c > 32 else None for *_, c in levels]
    biases = [None if w is None else torch.zeros(32) for w in projs]
    scales = [None] * 4
    if dtype == torch.int8:
        scales = [None if w is None else torch.tensor(0.01 * (l + 1))
                  for l, w in enumerate(projs)]
    return maps, pts, projs, biases, scales


@pytest.mark.parametrize("dtype", SAMPLER_DTYPES)
def test_wrapper_hands_the_kernel_its_plan(dtype):
    maps, pts, projs, biases, scales = _w32_call(dtype)
    with torch.inference_mode():  # as the lifter serves
        args, outs, keep, shapes = deformable._prepare(
            maps, pts, "border", True, projs, biases, scales)
    spec = [(f.shape[-1], None if w is None else 32)
            for f, w in zip(maps, projs)]
    plan = deformable.sampler_plan(dtype, spec, 2, 272)
    lvs = args.levels[:4]
    assert tuple(lv.unit_points for lv in lvs) == plan.unit_points
    assert tuple(args.order[:4]) == plan.order
    assert tuple(args.unit_end[:4]) == plan.unit_end
    assert lvs[0].proj_w is None and lvs[0].proj_scale is None
    for lv, w, sc in zip(lvs[1:], projs[1:], scales[1:]):
        handed = next(t for t in keep if t.data_ptr() == lv.proj_w)
        if dtype == torch.float32:  # the fp32 body reads fp32 W
            assert handed.dtype == torch.float32
            assert torch.equal(handed, w.detach())
        else:  # W^T (Cout, C), cast once per parameter state
            assert handed.dtype == torch.bfloat16
            assert torch.equal(handed, w.detach().t().to(torch.bfloat16))
            assert deformable.kernel_weight(w) is handed
        if sc is None:
            assert lv.proj_scale is None
        else:  # the dequant scale apart from W, one fp32
            scale = next(t for t in keep if t.data_ptr() == lv.proj_scale)
            assert scale.dtype == torch.float32 and scale.item() == sc.item()
    assert shapes[0] == (2, 17, 16, 32) and shapes[3] == (2, 17, 16, 32)
    out_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
    assert all(o.dtype == out_dtype for o in outs)


def test_scaled_projection_is_the_product_times_the_scale():
    """An int8 level's scale multiplies the projection before the bias:
    the plain version, and the dispatcher with and without autograd, give
    what W * scale gives (the JAX lifter's folded kernel), bit for bit."""
    maps, pts, projs, biases, scales = _w32_call(torch.int8)
    biases = [None if b is None else torch.full((32,), 0.25) for b in biases]
    folded = [None if w is None else w.detach() * s
              for w, s in zip(projs, scales)]
    want = deformable.sample_points_multi_reference(
        maps, pts, "border", True, folded, biases)
    got = deformable.sample_points_multi_reference(
        maps, pts, "border", True, projs, biases, scales)
    with torch.no_grad():
        served = deformable.sample_points_levels(
            maps, pts, "border", True, projs=projs, biases=biases,
            scales=scales)
    for a, b, c in zip(want, got, served):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_scaled_projection_gradient_matches_the_folded_kernel():
    """Under autograd the scale rides through the sampler's Function:
    the gradients of W and the points equal those of W * scale."""
    g = torch.Generator().manual_seed(4)
    maps = [torch.randn(2, 8, 6, 64, generator=g)]
    pts = torch.rand(2, 1, 17, 2, generator=g) * 2 - 1
    w0 = torch.randn(64, 16, generator=g)
    bias, scale = torch.randn(16, generator=g), torch.tensor(0.03)
    grads = []
    for scaled in (True, False):
        w = w0.clone().requires_grad_(True)
        p = pts.clone().requires_grad_(True)
        (out,) = deformable.sample_points_levels(
            maps, p, "border", True, projs=[w if scaled else w * scale],
            biases=[bias], scales=[scale] if scaled else None)
        out.square().sum().backward()
        grads.append((w.grad, p.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("projs, scales", [
    (None, [torch.tensor(0.02)]),                    # no projection
    ([torch.randn(64, 16)], [torch.tensor([1.0, 2.0])]),  # not one element
    ([torch.randn(64, 16)], [0.02]),                 # not a tensor
])
def test_a_scale_needs_a_projection_and_one_element(projs, scales):
    maps = [torch.randn(1, 8, 6, 64)]
    pts = torch.rand(1, 1, 17, 2) * 2 - 1
    with pytest.raises(ValueError):
        deformable.sample_points_multi_reference(
            maps, pts, "border", True, projs, None, scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["h36m_cpn", "h36m_hrnet_32",
                                  "h36m_hrnet_48"])
def test_k7_plan_at_the_deformable_presets(name, dtype):
    """K7 at each H36M lifter's first block: 64-row tiles over the items'
    68 rows each (ragged at batch 3), one tile a block, shared memory
    within a block's limit."""
    lc = config.preset(name).model.lifter
    channels = [c for *_, c in _pyramid(name)]
    hd = lc.embed_dim_ratio // lc.deform_heads
    rows = lc.num_joints * lc.deform_heads
    for batch in (1, 3, 64):
        plan = deformable.aggregate_plan(dtype, channels, hd,
                                         lc.deform_samples, batch, rows)
        assert (plan.tiles - 1) * 64 < batch * rows <= plan.tiles * 64
        assert plan.blocks == len(channels) * plan.tiles
        assert 0 < plan.smem <= _build.SMEM_LIMIT


@pytest.mark.parametrize("dtype, channels, hd, ns", [
    (torch.bfloat16, [36], 32, 4),    # C % 8
    (torch.bfloat16, [64], 12, 4),    # bf16 hd % 8
    (torch.bfloat16, [64], 72, 4),    # bf16 hd > 64
    (torch.float32, [6], 32, 4),      # fp32 C % 4
    (torch.float32, [64], 6, 4),      # fp32 hd % 4
    (torch.float32, [8192], 64, 4),   # no shared memory
])
def test_k7_plan_refuses_what_the_kernel_does_not_take(dtype, channels, hd,
                                                       ns):
    with pytest.raises(ValueError):
        deformable.aggregate_plan(dtype, channels, hd, ns, 2, 68)


def _pool_first(maps, points, weights, projs, biases, mode):
    """K7's arithmetic, emulated: per level and row the weighted sum of its
    ns fp32 samples (bf16 maps: rounded once to bf16), projected with W
    (bf16 maps: rounded to bf16) in fp32, plus (sum of the weights) * b,
    rounded once to the maps' dtype."""
    b, levels, p, nh, ns = weights.shape
    outs = []
    for l, f in enumerate(maps):
        s = sample_points_fp32(f, points[:, l], padding_mode=mode,
                               align_corners=True)  # (b, p, nh*ns, C)
        s = s.reshape(b, p, nh, ns, -1)
        w = weights[:, l].float()
        pooled = torch.einsum("bphs,bphsc->bphc", w, s)
        wk = projs[l].float()
        if f.dtype == torch.bfloat16:
            pooled = pooled.to(torch.bfloat16).float()
            wk = wk.to(torch.bfloat16).float()
        out = pooled @ wk + w.sum(-1, keepdim=True) * biases[l].float()
        outs.append(out.reshape(b, p, -1))
    return torch.stack(outs, dim=1).to(maps[0].dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("ns", [1, 2, 4])
def test_k7_pool_first_rounding_matches_plain_and_jax(ns, mode, dtype):
    rng = np.random.RandomState(ns)
    b, p, nh, hd = 2, 17, 4, 16
    dims = ((8, 6, 64), (4, 3, 48))
    maps_np = [rng.randn(b, h, w, c).astype(np.float32) for h, w, c in dims]
    pts_np = rng.uniform(-1.5, 1.5, (b, len(dims), p, nh * ns, 2)).astype(
        np.float32)
    # attention weights that do not sum to 1: the bias counts a sample
    wts_np = rng.uniform(-0.5, 1.5, (b, len(dims), p, nh, ns)).astype(
        np.float32)
    projs_np = [(rng.uniform(-1, 1, (c, hd)) / np.sqrt(c)).astype(np.float32)
                for *_, c in dims]
    biases_np = [rng.uniform(-0.5, 0.5, hd).astype(np.float32)
                 for _ in dims]

    maps = [torch.from_numpy(m).to(dtype) for m in maps_np]
    args = (torch.from_numpy(pts_np), torch.from_numpy(wts_np),
            [torch.from_numpy(w) for w in projs_np],
            [torch.from_numpy(v) for v in biases_np])
    ours = _pool_first(maps, *args, mode).float().numpy()
    plain = deformable.aggregate_reference(maps, *args, mode).float().numpy()
    # the JAX reference on the maps the kernel reads (bf16 maps upcast)
    theirs = np.asarray(jdef.aggregate_reference(
        [jnp.asarray(m.float().numpy()) for m in maps], jnp.asarray(pts_np),
        jnp.asarray(wts_np), [jnp.asarray(w) for w in projs_np],
        [jnp.asarray(v) for v in biases_np], padding_mode=mode,
        align_corners=True), np.float32)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    assert ours.shape == plain.shape == theirs.shape == (b, 2, p, nh * hd)
    for ref in (plain, theirs):
        for level in range(len(dims)):  # each level against its own scale
            err = np.abs(ours[:, level] - ref[:, level]).max()
            assert err <= tol * np.abs(ref[:, level]).max(), (level, err)


def _gather_units(f, pts, mode, plan_points):
    """The gather over the plan's units, emulated: each unit's points'
    four taps blended in fp32 in the tap order 00, 01, 10, 11, rounded once
    to bf16 and written at the unit's flat offset."""
    b, h, w, c = f.shape
    flat = pts.reshape(b * pts.shape[1], 2)
    out = torch.empty(flat.shape[0], c, dtype=torch.bfloat16)
    x = (flat[:, 0] + 1) * 0.5 * (w - 1)
    y = (flat[:, 1] + 1) * 0.5 * (h - 1)
    if mode == "border":
        x, y = x.clamp(0, w - 1), y.clamp(0, h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    item = torch.arange(flat.shape[0]) // pts.shape[1]
    rows = f.reshape(b * h * w, c).float()
    for q0 in range(0, flat.shape[0], plan_points):
        q = slice(q0, q0 + plan_points)
        acc = torch.zeros(min(plan_points, flat.shape[0] - q0), c)
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            yi, xi = y0[q].long() + dy, x0[q].long() + dx
            wk = (wy[q] if dy else 1 - wy[q]) * (wx[q] if dx else 1 - wx[q])
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = item[q] * h * w + yi.clamp(0, h - 1) * w + xi.clamp(
                0, w - 1)
            acc += torch.where(inside, wk, 0.0)[:, None] * rows[idx]
        out[q] = acc.to(torch.bfloat16)
    return out.reshape(b, -1, c)


@pytest.mark.parametrize("mode, points", [("border", 272), ("zeros", 17)])
def test_k5_gather_units_match_jax_interpret(mode, points):
    """K5's shape: HRNet-W32's 64x48x32 level in bf16, 2 items; the gather
    over the plan's units (256 points across items in the border call, one
    item's 17 in the zeros call) against the JAX package's K1 in interpret
    mode (its two-stage body) and the port's plain version."""
    rng = np.random.RandomState(points)
    b, (h, w, c) = 2, _pyramid("h36m_hrnet_32")[0]
    f_np = rng.randn(b, h, w, c).astype(np.float32)
    lim = 1.5 if mode == "border" else 1.1
    pts_np = rng.uniform(-lim, lim, (b, 1, points, 2)).astype(np.float32)
    f = torch.from_numpy(f_np).to(torch.bfloat16)
    plan = deformable.sampler_plan(torch.bfloat16, [(c, None)], b, points)
    assert plan.unit_points == ((256,) if points == 272 else (17,))
    ours = _gather_units(f, torch.from_numpy(pts_np)[:, 0], mode,
                         plan.unit_points[0]).float().numpy()
    (plain,) = deformable.sample_points_multi_reference(
        [f], torch.from_numpy(pts_np), mode)
    (theirs,) = jdef.sample_points_levels(
        [jnp.asarray(f.float().numpy()).astype(jnp.bfloat16)],
        jnp.asarray(pts_np), padding_mode=mode, align_corners=True,
        impl="fused_interpret", precision="default")
    assert jdef._use_two_stage(h, w, c)  # the TPU's K5 body
    for ref in (plain.float().numpy(), np.asarray(theirs, np.float32)):
        assert ref.shape == ours.shape == (b, points, c)
        err = np.abs(ours - ref).max()
        assert err <= BF16_TOL * np.abs(ref).max(), err
