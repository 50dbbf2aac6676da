"""K1's fp32 projected body (the sampler's own fp32 build), on the CPU.

``ops/csrc/sampler.cu`` projects fp32 levels in a build of its own: 64
threads a block, units of 32 points walked through K-slices of 32 channels
(a two-slot ring of the slice's blends and W's rows, 18 KB a block
whatever C and Cout), a register-tiled fp32 product of 4 points x 4 outputs
a thread, outputs past 32 in further passes. It runs only on the card.
These tests hold what Python owns of it, without a GPU:

- the constants ``ops/deformable.py`` mirrors equal the kernel's own
  (parsed from ``sampler.cu``) and the geometry closes: every thread owns
  one micro-tile at 32 outputs and whole gather items;
- the plan of every fp32 sampler call of the five presets' lifters and of
  the deploy-numerics gate's tiny models (with the in-sampler projection
  where ``kernel_can_preproject`` holds, as the served lifters run it):
  units, order, ``unit_end``, the launch's threads, the gather units of a
  mixed call (in the projected build's blocks), and the shared memory, equal
  to the C entry's own accounting;
- the reservation of W32's mixed call, and every C and Cout the body takes
  (its footprint does not grow with either);
- the refusals, unchanged;
- the body's arithmetic (blends, then products slice by slice and pass by
  pass, then the scale and the bias), emulated in torch, against the JAX
  package's fused kernel in interpret mode at HIGHEST precision and the
  port's plain version: 1e-5 of max|reference| (the card holds the kernel
  itself to 1e-4 of its plain version).
"""

import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contextaware_poseformer_tpu.ops import deformable as jdef
from contextaware_poseformer_tpu_torch import config, deploy_numerics
from contextaware_poseformer_tpu_torch.ops import _build, deformable
from contextaware_poseformer_tpu_torch.ops.grid_sample import (
    sample_points_fp32,
)

FP32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _constants():
    """The ``constexpr int`` values of csrc/sampler.cu that are plain
    arithmetic over earlier ones, evaluated in order (C's integer
    division)."""
    text = (_build.CSRC / "sampler.cu").read_text()
    out = {}
    for name, expr in re.findall(r"constexpr int (\w+) =\s*([^;]+);", text):
        try:
            out[name] = eval(" ".join(expr.split()).replace("/", "//"),
                             {"__builtins__": {}}, dict(out))
        except (NameError, SyntaxError, TypeError):
            continue  # template-dependent or sizeof-based
    return out


K = _constants()


def _c_entry(dtype, spec, plan, batch, points):
    """What ``capf_sample_levels`` accepts and reserves for ``plan``: the
    shared memory a block and the threads of the launched build, or an
    AssertionError where the entry would refuse the plan."""
    total, smem, proj = batch * points, 0, False
    for (c, cout), size in zip(spec, plan.unit_points):
        need = K["kTapBytes"] * size
        if cout is None:
            assert 1 <= size <= K["kMaxPoints"]
        elif dtype == FP32:
            assert cout % 4 == 0 and size == K["kF32Points"]
            proj = True
            need += K["kF32RingBytes"]
        else:
            assert c % 16 == 0 and cout % 8 == 0 and cout <= K["kMaxCout"]
            assert size == K["kChunk"]
            proj = True
            lda = max(c, cout) + K["kPad"]
            need += K["kChunk"] * lda * 2 + cout * (c + K["kPad"]) * 2
        smem = max(smem, need)
    units = 0
    assert sorted(plan.order) == list(range(len(spec)))
    for end, l in zip(plan.unit_end, plan.order):
        units += -(-total // plan.unit_points[l])
        assert end == units
    assert smem <= 232448
    threads = (K["kF32Threads"] if proj and dtype == FP32
               else K["kThreads"])
    return smem, threads


def _fp32_calls(cfg):
    """(points a level and item, [(C, Cout or None)]) of each sampler call
    of ``cfg``'s lifter in fp32: the reference points (zeros, gathered)
    and, with deformable blocks, the border call projected where
    ``kernel_can_preproject`` holds."""
    lc = cfg.model.lifter
    dims = cfg.model.backbone.feature_dims
    calls = [(lc.num_joints, [(c, None) for c in dims])]
    if lc.use_deformable:
        hd = lc.embed_dim_ratio // lc.deform_heads
        points = lc.num_joints * lc.deform_heads * lc.deform_samples
        calls.append((points, [
            (c, hd if deformable.kernel_can_preproject(0, 0, c, hd, FP32)
             else None) for c in dims]))
    return calls


def test_k1_fp32_constants_match_the_kernel():
    assert deformable._TILE == K["kF32Points"] == 32
    assert deformable._F32_THREADS == K["kF32Threads"] == 64
    assert deformable._F32_SLICE == K["kF32Slice"] == 32
    assert deformable._F32_COLS == K["kF32Cols"] == 32
    assert deformable._F32_PITCH == K["kF32Pitch"]
    assert deformable._F32_RING == K["kF32RingBytes"] == 17408
    assert deformable._TAP_BYTES == K["kTapBytes"]
    assert deformable._THREADS == K["kThreads"]
    # every thread owns one 4 x 4 micro-tile at 32 outputs, and whole
    # (point, 4-channel) gather items of a slice (4 a thread: 16 loads)
    assert K["kF32RowGroups"] * (K["kF32Cols"] // 4) == K["kF32Threads"]
    assert K["kF32Rows"] * K["kF32RowGroups"] == K["kF32Points"]
    assert K["kF32Rows"] == 4 and K["kF32Items"] == 4
    assert K["kF32Items"] * K["kF32Threads"] == (
        K["kF32Points"] * K["kF32Groups"])
    # rows of the staged blends 4 floats past a multiple of 32: the 4 rows
    # a warp reads at one k start in distinct banks
    assert K["kF32Pitch"] % 32 == 4


CONFIGS = [(name, "preset") for name in config.PRESETS] + [
    (name, "gate tiny") for name in config.PRESETS]


@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("name, kind", CONFIGS)
def test_k1_fp32_plan_at_every_call(name, kind, batch):
    cfg = (config.preset(name) if kind == "preset"
           else deploy_numerics._tiny_cfg(name))
    for points, spec in _fp32_calls(cfg):
        plan = deformable.sampler_plan(FP32, spec, batch, points)
        proj = any(cout is not None for _, cout in spec)
        assert plan.threads == (64 if proj else 256)
        assert plan.tensor_cores is False
        total = batch * points
        for (c, cout), body, size, units in zip(
                spec, plan.bodies, plan.unit_points, plan.units):
            assert (units - 1) * size < total <= units * size
            if cout is None:
                assert body == "gather"
                assert size == deformable.gather_points(FP32, c, points,
                                                        plan.threads)
            else:
                assert body == "fp32" and size == 32
        work = [plan.unit_points[l] * spec[l][0] for l in plan.order]
        assert work == sorted(work, reverse=True)
        smem, threads = _c_entry(FP32, spec, plan, batch, points)
        assert (plan.smem, plan.threads) == (smem, threads)
        if proj:  # the ring, whatever C: 18,432 bytes a block
            assert plan.smem == 32 * 32 + 17408


def test_k1_fp32_plan_of_the_served_border_calls():
    """Batch 64, 272 points: the CPN call in 4 x 544 units (the body
    that held W and the samples whole took 66,560 bytes a block at C =
    256); W32's mixed call gathers level 0 (C = 32) in 32-point units of
    the projected build's 64-thread blocks and reserves the ring, not more;
    W48 projects all four levels."""
    cpn = deformable.sampler_plan(FP32, [(256, 32)] * 4, 64, 272)
    assert cpn.units == (544,) * 4 and cpn.blocks == 2176
    assert cpn.order == (0, 1, 2, 3) and cpn.smem == 18432
    assert 32 * 32 + 4 * 256 * (32 + 32) == 66560
    w32 = deformable.sampler_plan(
        FP32, [(32, None), (64, 32), (128, 32), (256, 32)], 64, 272)
    assert w32.bodies == ("gather", "fp32", "fp32", "fp32")
    assert w32.unit_points == (32, 32, 32, 32) and w32.threads == 64
    assert w32.order == (3, 2, 1, 0) and w32.smem == 18432
    assert w32.unit_end == (544, 1088, 1632, 2176)
    w48 = deformable.sampler_plan(
        FP32, [(48, 32), (96, 32), (192, 32), (384, 32)], 64, 272)
    assert w48.bodies == ("fp32",) * 4 and w48.smem == 18432
    # a call with no projected level keeps the gather's own build (256
    # threads, 4 items a thread: 16 points at C = 256 in fp32)
    zeros = deformable.sampler_plan(FP32, [(256, None)] * 4, 64, 17)
    assert zeros.threads == 256 and zeros.unit_points == (16,) * 4


@pytest.mark.parametrize("c", [4, 8, 36, 48, 384, 1024, 8192])
@pytest.mark.parametrize("cout", [4, 8, 36, 64, 200])
def test_k1_fp32_plan_takes_every_c_and_cout(c, cout):
    """Any C and Cout divisible by 4: the footprint is the ring's whatever
    the level (outputs past 32 take further passes)."""
    blocks, smem = deformable.projected_plan(FP32, c, cout, 300)
    assert blocks == -(-300 // 32) == 10
    assert smem == 32 * 32 + 17408
    plan = deformable.sampler_plan(FP32, [(c, cout), (64, None)], 3, 100)
    assert _c_entry(FP32, [(c, cout), (64, None)], plan, 3, 100) == (
        plan.smem, plan.threads)


@pytest.mark.parametrize("dtype, spec, error", [
    (FP32, [(64, 6)], ValueError),       # Cout % 4
    (FP32, [(6, None)], ValueError),     # C % 4
    (FP32, [(10, 8)], ValueError),       # projected C % 4
    (torch.bfloat16, [(40, 32)], ValueError),   # projected C % 16
    (torch.bfloat16, [(64, 72)], ValueError),   # Cout > 64
    (torch.bfloat16, [(8192, 32)], ValueError),  # no shared memory
    (torch.float16, [(64, 32)], TypeError),      # no body for fp16
])
def test_k1_refusals_unchanged(dtype, spec, error):
    with pytest.raises(error):
        deformable.sampler_plan(dtype, spec, 2, 17)


def _emulated_body(f, pts, w, b, scale):
    """One fp32 projected level as the body computes it: the fp32 blends
    (tap order 00, 01, 10, 11), then per pass of 32 outputs the products
    summed slice by slice (32 channels, zeros past C), then the scale and
    the bias; units of 32 points change nothing in the arithmetic."""
    n, p = pts.shape[:2]
    c, cout = w.shape
    blends = sample_points_fp32(f, pts, padding_mode="border").reshape(-1, c)
    slices = math.ceil(c / 32)
    pad = torch.zeros(blends.shape[0], slices * 32 - c)
    blends = torch.cat([blends, pad], 1)
    wp = torch.cat([w, torch.zeros(slices * 32 - c, cout)], 0)
    out = torch.empty(blends.shape[0], cout)
    for c0 in range(0, cout, 32):
        cols = slice(c0, min(c0 + 32, cout))
        acc = torch.zeros(blends.shape[0], cols.stop - c0)
        for s in range(slices):
            k = slice(32 * s, 32 * s + 32)
            acc = acc + blends[:, k] @ wp[k, cols]
        out[:, cols] = acc * scale + (0.0 if b is None else b[cols])
    return out.reshape(n, p, cout)


def test_k1_fp32_body_arithmetic_matches_jax():
    """Levels with C not a multiple of the slice (36, 8), Cout past one
    pass (36, 64) and a narrow one (8 -> 4), a bias left out; 2 items of
    37 points (three 32-point units, the last ragged). JAX's fused kernel
    takes no scale, so its W carries it, as the JAX lifter folds it."""
    rng = np.random.default_rng(20)
    dims = [(6, 8, 36, 8), (4, 4, 8, 4), (6, 4, 48, 36), (4, 6, 96, 64)]
    maps = [rng.standard_normal((2, h, w, c)).astype(np.float32)
            for h, w, c, _ in dims]
    pts = rng.uniform(-1.3, 1.3, (2, len(dims), 37, 2)).astype(np.float32)
    ws = [(rng.uniform(-1, 1, (c, o)) / np.sqrt(c)).astype(np.float32)
          for _, _, c, o in dims]
    bs = [None] + [rng.uniform(-0.1, 0.1, o).astype(np.float32)
                   for *_, o in dims[1:]]
    scale = np.float32(0.75)
    theirs = jdef.sample_points_levels(
        [jnp.asarray(m) for m in maps], jnp.asarray(pts),
        padding_mode="border", align_corners=True, impl="fused_interpret",
        precision="highest", projs=[jnp.asarray(w * scale) for w in ws],
        biases=[None if b is None else jnp.asarray(b) for b in bs])
    tpts = torch.from_numpy(pts)
    plain = deformable.sample_points_multi_reference(
        [torch.from_numpy(m) for m in maps], tpts, "border", True,
        [torch.from_numpy(w) for w in ws],
        [None if b is None else torch.from_numpy(b) for b in bs],
        [torch.tensor(scale)] * len(dims))
    for l, (m, w, b) in enumerate(zip(maps, ws, bs)):
        ours = _emulated_body(torch.from_numpy(m), tpts[:, l],
                              torch.from_numpy(w),
                              None if b is None else torch.from_numpy(b),
                              float(scale)).numpy()
        for ref in (np.asarray(theirs[l]), plain[l].numpy()):
            assert ours.shape == ref.shape == (2, 37, dims[l][3])
            err = np.abs(ours - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), (l, err)
