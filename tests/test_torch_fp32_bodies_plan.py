"""The fp32 bodies of K2 and K3 (the lifter's fused MLP and short-sequence
attention on the CUDA cores), on the CPU.

K2's fp32 routes (``ops/csrc/fused_mlp.cu``: fused, one launch, for D up to
128 with H = 2D; two-phase, three launches, for any D and H divisible by 4)
and K3's CUDA-core body (``ops/csrc/small_attention.cu``) run only on the
card. These tests hold what Python owns of them, without a GPU:

- the plans at every preset's lifter widths and at the row counts a call
  takes (1 to 5440): the route, the tiles, the threads a block, the shared
  memory within one block's 232,448 bytes and equal to the C sources' own
  formulas (parsed from the .cu files and evaluated here), and a grid
  that owns every output once;
- the tiles the on-card measurements chose at the joint shape;
- what no route takes is refused;
- the operands are made once per parameter state (none for an fp32
  parameter that is contiguous) and follow an in-place update;
- the dispatchers take the plain versions for CPU tensors, and the kernel
  wrappers refuse them.
"""

import re

import pytest
import torch

from contextaware_poseformer_tpu_torch import config
from contextaware_poseformer_tpu_torch.ops import (
    _build,
    fused_mlp,
    small_attention,
)

ROWS = (1, 7, 65, 1088, 4352, 5440)  # a call's rows: ragged to batch 64's
SMEM = 232448  # one H100 block's dynamic shared memory


def _c_source(name):
    return (_build.CSRC / name).read_text()


def _c_constants(*names):
    """``constexpr int NAME = <integer>;`` of the given csrc files."""
    out = {}
    for name in names:
        for key, value in re.findall(r"constexpr int (\w+) = (\d+);",
                                     _c_source(name)):
            out[key] = int(value)
    return out


def _c_formula(name, function, **args):
    """The value of a ``constexpr int`` function of a csrc file (its one
    ``return`` of + and * over its arguments and the file's constants),
    evaluated for ``args``."""
    text = _c_source(name)
    body = re.search(function + r"\([^)]*\) \{\s*return (.*?);\s*\}", text,
                     re.S)
    assert body, f"{function} not found in {name}"
    consts = _c_constants(name, "f32_tile.cuh")
    consts["kF32Stages"] = consts["kStages"]  # = capf::f32::kStages
    return eval(" ".join(body.group(1).split()), {}, {**consts, **args})


def _widths(name):
    lc = config.preset(name).model.lifter
    return [(d, int(d * lc.mlp_ratio))
            for d in (lc.embed_dim_ratio, lc.embed_dim)]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("name", config.PRESETS)
def test_k2_fp32_plan_at_every_preset_width(name, rows):
    """The fused route at the per-level widths (D <= 128, H = 2D), the
    two-phase route at the joint widths; every tile in its bounds, and the
    shared memory the C formula's."""
    for d, hdim in _widths(name):
        p = fused_mlp.plan(torch.float32, d, hdim, rows)
        assert p.route == "fp32"
        if d <= 128:
            (bm,) = p.tiles
            assert len(p.smem) == 1 and bm in (32, 40, 48)
            assert p.smem[0] == _c_formula("fused_mlp.cu", "f32_fused_smem",
                                           bm=bm, d=d, h=hdim) <= SMEM
            continue
        assert len(p.smem) == 3 and p.smem[0] == 0  # the LN: none
        dp, hp = fused_mlp.f32_workspaces(d, hdim)
        assert dp % 32 == 0 and hp % 32 == 0 and dp >= d and hp >= hdim
        for tile, smem in zip((p.tiles[:5], p.tiles[5:]), p.smem[1:]):
            tm, tn, rg, cg, split = tile
            assert tm in (4, 8) and tn in (4, 8) and split in (1, 2)
            assert 128 <= rg * cg <= fused_mlp.gemm_max_threads(tm, tn)
            assert smem == _c_formula("fused_mlp.cu", "f32_gemm_smem",
                                      bm=rg * tm, bn=cg * tn) <= SMEM


def test_k2_fp32_plan_per_call_at_batch_64():
    """The fused route's row tile puts the fewest rows on the busiest SM:
    48 rows (114 blocks) at 5440 rows, 40 (109) at 4352, one wave."""
    assert fused_mlp.plan(torch.float32, 128, 256, 5440).tiles == (48,)
    assert fused_mlp.plan(torch.float32, 128, 256, 4352).tiles == (40,)
    assert fused_mlp.plan(torch.float32, 64, 128, 5440).tiles == (48,)


def test_k2_fp32_joint_tiles_the_measurements_chose():
    """At the joint shape (1088 rows, D = 640): phase 1 in 136 x 80 tiles
    of 8 x 4 (128 blocks of 340 threads, one wave), phase 2 the same with K
    in two parts; the tiles the on-card timings of every candidate put
    first."""
    p = fused_mlp.plan(torch.float32, 640, 1280, 1088)
    assert p.tiles == (8, 4, 17, 20, 1, 8, 4, 17, 20, 2)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d", [320, 480, 640, 1024])
def test_k2_fp32_two_phase_grid_owns_every_output_once(d, rows):
    """Each phase's grid (column tiles x row tiles x parts) covers its
    outputs with tiles no larger than needed; the split counters are one a
    tile of both phases."""
    p = fused_mlp.plan(torch.float32, d, 2 * d, rows)
    dp, hp = fused_mlp.f32_workspaces(d, 2 * d)
    tiles = 0
    for (tm, tn, rg, cg, split), cols, k in (
            (p.tiles[:5], hp, dp), (p.tiles[5:], d, hp)):
        bm, bn = rg * tm, cg * tn
        row_tiles, col_tiles = -(-rows // bm), -(-cols // bn)
        assert (row_tiles - 1) * bm < rows <= row_tiles * bm
        assert (col_tiles - 1) * bn < cols <= col_tiles * bn
        slices = k // 32
        per = -(-slices // split)
        assert k % 32 == 0 and (split - 1) * per < slices <= split * per
        tiles += row_tiles * col_tiles
    assert fused_mlp.split_counters(rows, d, 2 * d, p.tiles) == tiles


def test_k2_gemm_tile_bounds_at_any_shape():
    for rows, cols, k in ((1, 32, 32), (17, 4, 4), (1088, 1280, 640),
                          (5000, 96, 2048), (64, 4096, 64)):
        tm, tn, rg, cg, split = fused_mlp.gemm_tile(rows, cols, k)
        assert 128 <= rg * cg <= fused_mlp.gemm_max_threads(tm, tn)
        assert fused_mlp._f32_gemm_smem(rg * tm, cg * tn) <= SMEM
        assert split in (1, 2)


@pytest.mark.parametrize("tm, tn", [(4, 4), (4, 8), (8, 4), (8, 8)])
def test_k2_gemm_max_threads_is_the_c_sides(tm, tn):
    text = _c_source("fused_mlp.cu")
    body = re.search(r"gemm_max_threads\(int tm, int tn\) \{\s*return "
                     r"tm \* tn >= (\d+) \? (\d+) : (\d+);", text)
    big, few, many = (int(g) for g in body.groups())
    assert fused_mlp.gemm_max_threads(tm, tn) == (
        few if tm * tn >= big else many)


def test_k2_fp32_routes_and_refusals():
    """H other than 2D, D past 128 or D not a multiple of 16 take the
    two-phase route; D or H not a multiple of 4 (16-byte rows) and float16
    are refused."""
    for d, hdim in ((128, 384), (256, 512), (48, 96), (36, 72), (200, 400)):
        p = fused_mlp.plan(torch.float32, d, hdim, 100)
        assert p.route == "fp32"
        fused = hdim == 2 * d and d % 16 == 0 and d <= 128
        assert len(p.smem) == (1 if fused else 3), (d, hdim)
    for d, hdim in ((30, 60), (64, 130), (6, 12)):
        with pytest.raises(ValueError, match="divisible by 4"):
            fused_mlp.plan(torch.float32, d, hdim, 10)
    with pytest.raises(TypeError):
        fused_mlp.plan(torch.float16, 128, 256, 10)


def test_k2_f32_weight_once_per_parameter_state():
    """A contiguous fp32 parameter is read as it is (no copy, no cache
    entry); another dtype or a strided view is converted once per
    parameter state, anew after an in-place update, and on every call for
    an inference tensor."""
    w = torch.nn.Parameter(torch.randn(64, 128))
    assert fused_mlp.f32_weight(w) is w
    h = torch.nn.Parameter(torch.randn(64, 128).to(torch.bfloat16))
    first = fused_mlp.f32_weight(h)
    assert first.dtype == torch.float32 and first.is_contiguous()
    assert torch.equal(first, h.detach().float())
    assert fused_mlp.f32_weight(h) is first
    with torch.no_grad():
        h.mul_(2.0)
    second = fused_mlp.f32_weight(h)
    assert second is not first and torch.equal(second, h.detach().float())
    base = torch.nn.Parameter(torch.randn(128, 64))
    view = base.t()
    made = fused_mlp.f32_weight(view)
    assert made.is_contiguous() and torch.equal(made, view.detach())
    with torch.inference_mode():
        v = torch.randn(32, 16).to(torch.bfloat16)
        a, b = fused_mlp.f32_weight(v), fused_mlp.f32_weight(v)
    assert a is not b and torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 5, 17, 20])
@pytest.mark.parametrize("name", config.PRESETS)
def test_k3_cores_plan_at_every_preset_width(name, n):
    """fp32 at the lifters' per-level widths on the CUDA-core body: tiles of
    whole rows within 48 tokens, shared memory the C formula's."""
    lc = config.preset(name).model.lifter
    d = lc.embed_dim_ratio
    p = small_attention.plan(torch.float32, n, d, lc.num_heads)
    assert (p.route, p.group) == ("cuda-core", 0)
    assert p.rows_per_tile == small_attention.CORES_TILE // n >= 2
    assert small_attention.cores_smem_bytes(d) == _c_formula(
        "small_attention.cu", "cores_smem", d=d) <= SMEM
    assert _c_constants("small_attention.cu")["kCoresBM"] == (
        small_attention.CORES_TILE)


def test_k3_cores_plan_refusals():
    """The CUDA cores take N <= 20, D a multiple of 16 from 32 to 128 (3D
    threads a block, two K-slices a weight) and a head dim that is a
    multiple of 4 (16-byte reads in the middle)."""
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, heads in ((21, 128, 8), (5, 16, 4), (5, 144, 8),
                            (5, 40, 8), (5, 48, 8), (5, 24, 8)):
            if dtype == torch.bfloat16 and (d, d // heads) in (
                    small_attention.TC_SHAPES) and n <= 16:
                continue
            with pytest.raises(ValueError, match="CUDA cores take"):
                small_attention.plan(dtype, n, d, heads)
        for n, d, heads in ((5, 32, 8), (20, 64, 16), (1, 128, 1),
                            (5, 96, 8)):
            if dtype == torch.bfloat16 and (d, d // heads) in (
                    small_attention.TC_SHAPES):
                continue
            assert small_attention.plan(dtype, n, d, heads).route == (
                "cuda-core")


def test_k3_cores_operands_once_per_parameter_state():
    """fp32 parameters are read as they are in an fp32 call; a bf16 call
    reads fp32 copies of their bf16 values, made once per parameter state
    and anew after an in-place update."""
    d = 32
    params = [torch.nn.Parameter(torch.randn(*s)) for s in (
        (d, 3 * d), (3 * d,), (d, d), (d,))]
    ops = small_attention.cores_operands(*params, torch.float32)
    assert all(o is p for o, p in zip(ops, params))
    first = small_attention.cores_operands(*params, torch.bfloat16)
    for o, p in zip(first, params):
        assert o.dtype == torch.float32 and o.is_contiguous()
        assert torch.equal(o, p.detach().to(torch.bfloat16).float())
    again = small_attention.cores_operands(*params, torch.bfloat16)
    assert all(a is b for a, b in zip(again, first))
    with torch.no_grad():
        params[0].mul_(3.0)
    second = small_attention.cores_operands(*params, torch.bfloat16)
    assert second[0] is not first[0] and second[1] is first[1]
    assert torch.equal(second[0],
                       params[0].detach().to(torch.bfloat16).float())


def _k2_args(d, rows, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, d, generator=g)
    return x, (torch.rand(d, generator=g) + 0.5,
               torch.rand(d, generator=g) - 0.5,
               torch.randn(d, 2 * d, generator=g) * d ** -0.5,
               torch.randn(2 * d, generator=g) * 0.1,
               torch.randn(2 * d, d, generator=g) * (2 * d) ** -0.5,
               torch.randn(d, generator=g) * 0.1)


@pytest.mark.parametrize("d", [32, 320])
def test_dispatchers_take_the_plain_versions_on_the_cpu(d):
    """On CPU tensors the dispatchers return the plain versions' results,
    bit for bit, and launch nothing."""
    x, p = _k2_args(d, 7)
    before = (fused_mlp.launches, small_attention.launches)
    assert torch.equal(fused_mlp.ln_mlp_residual(x, *p, 1e-6),
                       fused_mlp.ln_mlp_reference(x, *p, 1e-6))
    g = torch.Generator().manual_seed(1)
    xa = torch.randn(3, 5, 32, generator=g)
    w = (torch.randn(32, 96, generator=g) * 0.2, torch.randn(96) * 0.1,
         torch.randn(32, 32, generator=g) * 0.2, torch.randn(32) * 0.1)
    assert torch.equal(small_attention.small_attention(xa, *w, 8),
                       small_attention.attention_reference(xa, *w, 8))
    assert (fused_mlp.launches, small_attention.launches) == before


@pytest.mark.parametrize("d", [32, 128, 640])
def test_kernel_wrappers_refuse_cpu_tensors(d):
    """The kernel wrappers (fused and two-phase fp32 K2, K3's CUDA-core
    body) refuse a CPU tensor before any launch: no fallback."""
    x, p = _k2_args(d, 5)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6)
    if d <= 128:
        xa = torch.randn(2, 5, d)
        w = (torch.randn(d, 3 * d), torch.randn(3 * d), torch.randn(d, d),
             torch.randn(d))
        with pytest.raises(ValueError, match="CUDA device"):
            small_attention.small_attention_kernel(xa, *w, 8)
