"""K9's schedule and K3's tensor-core layout, on the CPU.

The redesigned kernels (``ops/csrc/layer1_chain.cu``, the tensor-core body of
``ops/csrc/small_attention.cu``) run only on the card. These tests hold the
pieces of their designs that Python owns, without a GPU:

- K9's planner (``layer1_chain.plan``) at every layer1 launch of the four
  HRNet deploy graphs, enumerated on the meta device, for batch 1, 3, 16
  (the calibration chunk), 64 and 128: the persistent grid's walk over its
  strips owns every (image, output row) exactly once, the 64-pixel steps
  cover each strip, conv1's lead covers the 3x3's halo, and the layout fits
  a block's 232,448 bytes;
- K3's tile order: a plain-torch emulation of the kernel's schedule (tiles of
  whole rows, qkv a head group at a time from the head-group-permuted
  weights, fp32 qkv, scores and softmax, o rounded to the call's dtype
  before the projection) against JAX ``small_attention(..., interpret=True)``;
- K3's operands are made once per parameter state, follow an in-place
  update, and are contiguous in any parameter dtype (K2's too).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contextaware_poseformer_tpu.ops import small_attention as jsa
from contextaware_poseformer_tpu_torch import config, serve
from contextaware_poseformer_tpu_torch.models.hrnet import HRNet
from contextaware_poseformer_tpu_torch.ops import (
    fused_mlp,
    int8_conv,
    layer1_chain,
    small_attention,
)

HRNET_PRESETS = sorted(n for n in config.PRESETS if "hrnet" in n)
BATCHES = (1, 3, 16, 64, 128)


def _layer1_launches(name, monkeypatch):
    """The (H, W, Cin) of every K9 launch of ``deploy_config(name)``'s
    backbone, from a forward on the meta device (K9 and K10 stubbed)."""
    shapes = []

    def k9(x, in_amax, blocks, impl="auto"):
        b, h, w, c = x.shape
        shapes.extend([(h, w, c)] + [(h, w, layer1_chain.EXPANSION)] * (
            len(blocks) - 1))
        return torch.empty((b, h, w, layer1_chain.EXPANSION),
                           dtype=torch.int8, device=x.device)

    def k10(x, kq, ws, sc, bi, amax, stride, relu, dtype=torch.bfloat16,
            impl="auto", residual=None, res_amax=None, out_amax=None):
        k = int8_conv._kernel_size(kq, x.shape[-1])
        ho = int8_conv.out_size(x.shape[1], k, stride)
        wo = int8_conv.out_size(x.shape[2], k, stride)
        return torch.empty((x.shape[0], ho, wo, kq.shape[0]),
                           dtype=torch.bfloat16 if out_amax is None
                           else torch.int8, device=x.device)

    monkeypatch.setattr(int8_conv, "int8_conv", k10)
    monkeypatch.setattr(layer1_chain, "layer1_chain", k9)
    cfg = serve.deploy_config(name).model
    backbone = HRNet(cfg.backbone, dtype=torch.bfloat16, device="meta")
    images = torch.empty(2, *cfg.image_shape, 3, dtype=torch.bfloat16,
                         device="meta")
    with torch.inference_mode():
        backbone(images)
    return shapes


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", HRNET_PRESETS)
def test_k9_plan_owns_every_row_once_and_fits(name, batch, monkeypatch):
    """Each K9 launch's schedule: blocks b, b + grid, ... walk the strips;
    every (image, output row) belongs to exactly one strip, a strip's
    64-pixel steps cover its rows, conv1 leads by at least W + 1 pixels,
    the grid is at most one block an SM, and the layout fits."""
    launches = _layer1_launches(name, monkeypatch)
    assert len(launches) == 4 and launches[0][2] == layer1_chain.PLANES
    for h, w, cin in set(launches):
        p = layer1_chain.plan(batch, h, w, cin)
        assert p.smem == layer1_chain.smem_bytes(cin, p.lead, p.depth)
        assert p.smem <= 232448
        assert p.depth == layer1_chain.DEPTH
        assert p.lead * layer1_chain.TILE >= w + 1
        assert 1 <= p.grid <= min(p.strips, layer1_chain.SMS)
        per_image = -(-h // p.strip_rows)
        assert p.strips == batch * per_image
        owner = torch.zeros(batch, h, dtype=torch.int64)
        for blk in range(p.grid):
            for strip in range(blk, p.strips, p.grid):
                img, s = divmod(strip, per_image)
                r0 = s * p.strip_rows
                rows = min(p.strip_rows, h - r0)
                assert rows >= 1
                tiles = -(-rows * w // layer1_chain.TILE)
                assert rows * w <= tiles * layer1_chain.TILE
                owner[img, r0:r0 + rows] += 1
        assert torch.equal(owner, torch.ones_like(owner))


def test_k9_plan_at_the_w32_request():
    """Batch 64 at 64x48: strips of 32 rows, 128 strips, one wave, so the
    weights are staged 128 times a launch, not once for each of 1,024
    4-row windows."""
    for cin in (layer1_chain.PLANES, layer1_chain.EXPANSION):
        p = layer1_chain.plan(64, 64, 48, cin)
        assert (p.strip_rows, p.strips, p.grid) == (32, 128, 128)


def test_k9_plan_refuses_what_fits_no_block():
    with pytest.raises(ValueError, match="shared memory"):
        layer1_chain.plan(1, 8, 700, layer1_chain.EXPANSION)
    with pytest.raises(ValueError, match="no schedule"):
        layer1_chain.plan(1, 8, 48, 128)


def _emulate_tiles(x, wqkv, bqkv, wproj, bproj, heads):
    """The tensor-core route's schedule in plain torch: 64-token tiles of
    whole rows; per tile and head group, fp32 qkv from the permuted
    operands, fp32 scores, softmax and AV, o rounded to x's dtype; the
    projection in fp32 from the rounded o, + bias, rounded at the end."""
    r, n, d = x.shape
    dt = x.dtype
    hd = d // heads
    group = small_attention.TC_SHAPES[(d, hd)]
    rows_per_tile = small_attention.plan(torch.bfloat16, n, d,
                                         heads).rows_per_tile
    wk, bk, wp, bp = small_attention.kernel_operands(
        wqkv, bqkv, wproj, bproj, heads, group)
    if dt == torch.float32:  # the same order on the fp32 weights
        order = small_attention.head_group_order(d, heads, group)
        wk, bk = wqkv[:, order].t(), bqkv[order]
        wp, bp = wproj.t(), bproj
    ng = 3 * group * hd
    out = torch.empty_like(x)
    for t0 in range(0, r, rows_per_tile):
        tile = x[t0:t0 + rows_per_tile].reshape(-1, d).float()
        toks = tile.shape[0]
        o = torch.empty(toks, d)
        for g in range(heads // group):
            qkv = tile @ wk[g * ng:(g + 1) * ng].float().t() + bk[
                g * ng:(g + 1) * ng].float()
            q, k, v = (qkv[:, i * group * hd:(i + 1) * group * hd].reshape(
                -1, n, group, hd) for i in range(3))
            s = torch.einsum("rnhe,rmhe->rhnm", q, k) / np.sqrt(hd)
            p = torch.softmax(s, dim=-1)
            og = torch.einsum("rhnm,rmhe->rnhe", p, v).reshape(toks, -1)
            o[:, g * group * hd:(g + 1) * group * hd] = og
        o = o.to(dt).float()
        y = o @ wp.float().t() + bp.float()
        out[t0:t0 + rows_per_tile] = y.to(dt).reshape(-1, n, d)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 13, 1088, 1089])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_k3_tile_order_matches_jax_interpret(d, rows, dtype):
    """The tensor-core route's tile and head-group order against the TPU
    kernel in interpret mode. Tolerance, of max|JAX|: 1e-5 in fp32 (sums in
    another order), 1e-2 in bf16 (both keep qkv in fp32 and round o once;
    a rounding of o that falls the other way moves the output by one bf16
    step of a product term)."""
    rng = np.random.RandomState(d + rows)
    x = rng.randn(rows, 5, d)
    w = [rng.randn(d, 3 * d) / np.sqrt(d), rng.randn(3 * d) * 0.1,
         rng.randn(d, d) / np.sqrt(d), rng.randn(d) * 0.1]
    tdt = getattr(torch, dtype)
    ours = _emulate_tiles(
        torch.from_numpy(x.astype(np.float32)).to(tdt),
        *(torch.from_numpy(a.astype(np.float32)) for a in w), 8)
    jdt = getattr(jnp, dtype)
    theirs = jsa.small_attention(*(jnp.asarray(a, jnp.float32).astype(jdt)
                                   for a in (x, *w)), 8, True)
    theirs = np.asarray(theirs.astype(jnp.float32))
    err = np.abs(ours.float().numpy() - theirs).max() / np.abs(theirs).max()
    assert err <= (1e-5 if dtype == "float32" else 1e-2), err


def test_k3_operands_once_per_parameter_state():
    """The tensor-core route's operands (Wqkv^T in head-group order, the
    permuted bias, Wproj^T, the proj bias; bf16 weights, fp32 values of the
    bf16 biases) are made once per parameter state: the same tensors at the
    same version give the cached operands; an in-place update (an optimizer
    step, a ``copy_``) makes them anew."""
    torch.manual_seed(0)
    d, heads = 128, 8
    params = [torch.nn.Parameter(torch.randn(*s)) for s in (
        (d, 3 * d), (3 * d,), (d, d), (d,))]
    group = small_attention.TC_SHAPES[(d, d // heads)]
    first = small_attention.kernel_operands(*params, heads, group)
    order = small_attention.head_group_order(d, heads, group)
    wqkv, bqkv, wproj, bproj = (p.detach().clone() for p in params)
    expect = (wqkv.to(torch.bfloat16)[:, order].t(),
              bqkv.to(torch.bfloat16)[order].float(),
              wproj.t().to(torch.bfloat16), bproj.to(torch.bfloat16).float())
    for got, want in zip(first, expect):
        assert torch.equal(got, want) and got.is_contiguous()
        assert not got.requires_grad
    assert [t.dtype for t in first] == [torch.bfloat16, torch.float32,
                                        torch.bfloat16, torch.float32]
    again = small_attention.kernel_operands(*params, heads, group)
    assert all(a is b for a, b in zip(first, again))
    with torch.no_grad():
        params[0].mul_(2.0)
        params[3].copy_(torch.ones(d))
    second = small_attention.kernel_operands(*params, heads, group)
    assert second[0] is not first[0] and second[3] is not first[3]
    assert second[1] is first[1] and second[2] is first[2]
    assert torch.equal(second[0], params[0].detach().to(torch.bfloat16)[
        :, order].t())
    assert torch.equal(second[3], torch.ones(d))


def test_k3_head_group_order_is_a_permutation():
    """Each group's columns are its heads' q, then k, then v; together the
    groups hold every qkv column once."""
    for (d, hd), group in small_attention.TC_SHAPES.items():
        heads = d // hd
        order = small_attention.head_group_order(d, heads, group)
        assert sorted(order.tolist()) == list(range(3 * d))
        ng = 3 * group * hd
        for g in range(heads // group):
            cols = order[g * ng:(g + 1) * ng].view(3, group * hd)
            for part in range(3):
                start = part * d + g * group * hd
                assert cols[part].tolist() == list(
                    range(start, start + group * hd))


def test_k3_plan_routes_and_refusals():
    """bf16 at the lifters' widths takes the tensor cores (12 rows of 5
    tokens a 64-token tile); fp32, and bf16 at other shapes (a cut lifter's
    D = 32, 17 tokens), the CUDA cores; what no route takes is refused."""
    for (d, hd), group in small_attention.TC_SHAPES.items():
        p = small_attention.plan(torch.bfloat16, 5, d, d // hd)
        assert (p.route, p.group, p.rows_per_tile) == ("tensor-core", group,
                                                        12)
        assert small_attention.smem_bytes(d, hd, group) <= 232448
        assert small_attention.plan(torch.float32, 5, d,
                                    d // hd).route == "cuda-core"
    for n, d in ((5, 32), (17, 128)):
        p = small_attention.plan(torch.bfloat16, n, d, 8)
        assert (p.route, p.group) == ("cuda-core", 0)
    with pytest.raises(ValueError, match="CUDA cores take"):
        small_attention.plan(torch.bfloat16, 21, 128, 8)
    with pytest.raises(ValueError, match="CUDA cores take"):
        small_attention.plan(torch.float32, 5, 42, 6)
    with pytest.raises(TypeError):
        small_attention.plan(torch.float16, 5, 128, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_and_k2_operands_are_contiguous_in_any_dtype(dtype):
    """The kernels read the transposed weights row by row: the operands
    are contiguous whether the parameters hold fp32 or already bf16 (a
    bf16 ``t().to(bfloat16)`` is a view)."""
    torch.manual_seed(1)
    d, heads = 64, 8
    params = [torch.randn(*s).to(dtype) for s in (
        (d, 3 * d), (3 * d,), (d, d), (d,))]
    group = small_attention.TC_SHAPES[(d, d // heads)]
    ops = small_attention.kernel_operands(*params, heads, group)
    assert all(t.is_contiguous() for t in ops)
    assert torch.equal(ops[2], params[2].to(torch.bfloat16).t())
    w = fused_mlp.kernel_weight(torch.randn(d, 2 * d).to(dtype))
    assert w.is_contiguous() and w.shape == (2 * d, d)
