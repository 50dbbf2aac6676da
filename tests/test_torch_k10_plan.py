"""K10's quantize-once design and its tile planner, on the CPU.

The CUDA kernel (``ops/csrc/int8_conv.cu``) quantizes a float input once and
then convolves the int8 tensor, as the JAX package does
(``models/backbone_common.py:192-204``). These tests hold the pieces that
design rests on, without a GPU:

- the quantize pass's plain version against the JAX package's
  ``clip(round(x / step))`` served under ``jit``, bit for bit;
- ``int8_conv_reference`` on a float input against the int8-input route on
  the quantized tensor (the identity the kernel relies on);
- the tile planner over every K10 call of the five deploy graphs at batch
  64, enumerated from their configurations on the meta device.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu_torch import config, serve
from contextaware_poseformer_tpu_torch.models.cpn import CPN
from contextaware_poseformer_tpu_torch.models.hrnet import HRNet
from contextaware_poseformer_tpu_torch.ops import (
    _build,
    int8_conv,
    layer1_chain,
)

BATCH = 64
STEP_AMAX = 127 / 16  # its step, amax * fl32(1/127), is 1/16 exactly
FULL_RING = int8_conv.STAGES * int8_conv.K_TILE  # K bytes of the whole ring


@jax.jit
def _jax_quantize_dynamic(x):
    # backbone_common.py:197-200, the dynamic route
    amax = jnp.max(jnp.abs(x)).astype(jnp.float32) / 127.0
    return jnp.clip(jnp.round(x.astype(jnp.float32) / amax), -127,
                    127).astype(jnp.int8)


@jax.jit
def _jax_quantize_static(x, amax_v):
    # backbone_common.py:195-196 and 198-200, serve_static_amax
    amax = jnp.maximum(amax_v, 1e-12) / 127.0
    return jnp.clip(jnp.round(x.astype(jnp.float32) / amax), -127,
                    127).astype(jnp.int8)


def _bf16_input(seed, amax):
    """bf16 NHWC values within +-amax with zeros, exact halves of the step
    1/16 (ties that round half to even) and +-amax; as a float32 array of
    bf16 numbers."""
    rng = np.random.RandomState(seed)
    x = np.clip(rng.randn(2, 6, 5, 64) * amax / 2.5, -amax, amax)
    flat = x.reshape(-1)
    flat[:16] = 0.0
    flat[16:32] = (np.arange(16) - 7.5) / 16
    flat[32], flat[33] = amax, -amax
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("route", ["dynamic", "static", "static clipped"])
def test_quantize_pass_matches_jax_under_jit(route, seed):
    """The quantize pass's plain version equals the JAX package's served
    quantization bit for bit: the dynamic step max|x| / 127 unclamped, the
    static one max(amax, 1e-12) / 127; an IEEE division, round half to
    even, a clip at +-127 (the clipped case calibrates a smaller amax)."""
    x = _bf16_input(seed, STEP_AMAX)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    if route == "dynamic":
        ours = int8_conv.quantize_reference(x, None)
        theirs = _jax_quantize_dynamic(xj)
    else:
        amax = np.float32(STEP_AMAX if route == "static" else 2.5)
        ours = int8_conv.quantize_reference(x, torch.tensor(amax))
        theirs = _jax_quantize_static(xj, jnp.float32(amax))
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    if route != "static clipped":  # the ties went to even
        halves = ours.reshape(-1)[16:32].tolist()
        assert halves == [-8, -6, -6, -4, -4, -2, -2, 0, 0, 2, 2, 4, 4, 6,
                          6, 8]


@pytest.mark.parametrize("variant", [
    ("dynamic", None, False, 1, 3),
    ("dynamic", "bf16", True, 2, 3),
    ("static", None, True, 1, 1),
    ("static", "int8", False, 1, 3),
    ("static", "bf16", False, 2, 1),
], ids=lambda v: "-".join(map(str, v)))
def test_float_input_equals_int8_route_on_the_quantized_tensor(variant):
    """``int8_conv_reference`` on a bf16 input equals the int8-input route
    on the quantize pass's output with the same step: the identity that
    lets the kernel quantize once and then read only int8."""
    kind, res, out8, stride, k = variant
    rng = np.random.RandomState(7)
    x = torch.relu(torch.from_numpy(rng.randn(2, 7, 6, 32) * 2)).to(
        torch.bfloat16)
    cout = 24
    kq = torch.from_numpy(rng.randint(-127, 128, (cout, k * k * 32))).to(
        torch.int8)
    vecs = [torch.from_numpy(v.astype(np.float32)) for v in (
        rng.rand(cout) * 0.01 + 1e-3, rng.rand(cout) + 0.5,
        rng.randn(cout) * 0.1)]
    amax = None if kind == "dynamic" else torch.tensor(3.0)
    ho = int8_conv.out_size(7, k, stride)
    wo = int8_conv.out_size(6, k, stride)
    kw = {"out_amax": torch.tensor(20.0) if out8 else None}
    if res == "bf16":
        kw["residual"] = torch.from_numpy(
            rng.randn(2, ho, wo, cout).astype(np.float32) * 3).to(
                torch.bfloat16)
    elif res == "int8":
        kw["residual"] = torch.from_numpy(
            rng.randint(-127, 128, (2, ho, wo, cout))).to(torch.int8)
        kw["res_amax"] = torch.tensor(11.0)
    float_route = int8_conv.int8_conv_reference(x, kq, *vecs, amax, stride,
                                                True, **kw)
    xq = int8_conv.quantize_reference(x, amax)
    # the int8 route clamps its amax at 1e-12; max|x| is far above it
    step_amax = int8_conv.absmax(x) if amax is None else amax
    int8_route = int8_conv.int8_conv_reference(xq, kq, *vecs, step_amax,
                                               stride, True, **kw)
    assert float_route.dtype == int8_route.dtype
    assert torch.equal(float_route, int8_route)


def _deploy_k10_calls(name, monkeypatch, mode="serve",
                      dtype=torch.bfloat16):
    """Every K10 call of ``deploy_config(name)``'s backbone (``mode``
    "serve"), or of ``quantize_config(name, mode)``'s ("static", "c128"),
    at batch 64 on its frames: [(M, N, Cin, k, stride, input dtype,
    residual dtype or None)], from
    a forward on the meta device (shapes only; K9, K10 and the CPN
    stream's quantizes, K10q and K10p, stubbed). ``dtype`` float32: the
    backbone in fp32, ``config.deploy(preset(name))`` for "serve" (an fp32
    HRNet takes the per-conv layer1, K9 being bf16 only), and the calls'
    epilogue dtype in place of the input's."""
    calls = []

    def k10(x, kq, ws, sc, bi, amax, stride, relu, dtype=torch.bfloat16,
            impl="auto", residual=None, res_amax=None, out_amax=None):
        k = int8_conv._kernel_size(kq, x.shape[-1])
        ho = int8_conv.out_size(x.shape[1], k, stride)
        wo = int8_conv.out_size(x.shape[2], k, stride)
        calls.append((x.shape[0] * ho * wo, kq.shape[0], x.shape[-1], k,
                      stride, x.dtype if dtype == torch.bfloat16
                      else (x.dtype, dtype),
                      None if residual is None else residual.dtype))
        return torch.empty((x.shape[0], ho, wo, kq.shape[0]),
                           dtype=dtype if out_amax is None
                           else torch.int8, device=x.device)

    def k9(x, in_amax, blocks, impl="auto"):
        return torch.empty((*x.shape[:3], 256), dtype=torch.int8,
                           device=x.device)

    def k10q(x, amax, clamp, form="step"):
        return torch.empty(x.shape, dtype=torch.int8, device=x.device)

    def k10p(x, amax):
        b, h, w, c = x.shape
        return torch.empty((b, (h + 1) // 2, (w + 1) // 2, c),
                           dtype=torch.int8, device=x.device)

    monkeypatch.setattr(int8_conv, "int8_conv", k10)
    monkeypatch.setattr(layer1_chain, "layer1_chain", k9)
    monkeypatch.setattr(int8_conv, "quantize_kernel", k10q)
    monkeypatch.setattr(int8_conv, "quant_max_pool_kernel", k10p)
    if mode != "serve":
        cfg = serve.quantize_config(name, mode).model
    elif dtype == torch.float32:
        cfg = config.deploy(config.preset(name)).model
    else:
        cfg = serve.deploy_config(name).model
    kind = {"cpn": CPN, "hrnet": HRNet}[cfg.backbone.kind]
    backbone = kind(cfg.backbone, dtype=dtype, device="meta")
    images = torch.empty(BATCH, *cfg.image_shape, 3, dtype=dtype,
                         device="meta")
    with torch.inference_mode():
        backbone(images)
    return calls


# the K10 calls a request of the five presets' graphs (tests/
# test_torch_cuda.py, chip_smoke.py): the deploy graphs ("serve": CPN 83,
# HRNet 87); "static" (every 3x3 conv with both channel counts >= 16 and
# every wide conv: CPN 76, HRNet 256, its 208 branch convs included);
# "c128" (the wide convs: CPN 73, HRNet 85). Each is the JAX graph's count
# of "qweights" (the "static" ones, of "calib" too)
K10_CALLS = {
    "serve": {"h36m_cpn": 83, "h36m_hrnet_32": 87, "h36m_hrnet_48": 87,
              "mpi_3dhp_hrnet_32": 87, "mpi_3dhp_hrnet_48": 87},
    "static": {"h36m_cpn": 76, "h36m_hrnet_32": 256, "h36m_hrnet_48": 256,
               "mpi_3dhp_hrnet_32": 256, "mpi_3dhp_hrnet_48": 256},
    "c128": {"h36m_cpn": 73, "h36m_hrnet_32": 85, "h36m_hrnet_48": 85,
             "mpi_3dhp_hrnet_32": 85, "mpi_3dhp_hrnet_48": 85},
}


@pytest.mark.parametrize("name,mode", [
    pytest.param(name, mode, id=name if mode == "serve" else f"{name}-{mode}")
    for mode in K10_CALLS for name in sorted(config.PRESETS)])
def test_plan_covers_every_deploy_k10_shape(name, mode, monkeypatch):
    """The tile planner at every K10 call of each int8 graph (batch 64;
    the deploy graph, "static" and "c128"): a tile width the kernel
    builds, whose shared memory fits 227 KB, whose blocks cover M x N, and
    whose K stages hold whole 16-byte pieces of one tap (Cin a multiple of
    16 divides into them) and cover K, the last stage's tail zero-filled
    where K = 9 Cin is not a multiple of 128 bytes (W48's Cin 48 under
    "static")."""
    calls = _deploy_k10_calls(name, monkeypatch, mode)
    assert int8_conv.CIN_MULTIPLE == 16
    assert len(calls) == K10_CALLS[mode][name]
    if mode == "static" and name.endswith("_48"):
        assert {(c[2], c[4]) for c in calls} >= {(48, 1), (48, 2)}
    bf16 = torch.bfloat16
    for m, n, cin, k, stride, dtype, res in set(calls):
        bm = int8_conv.BLOCK_M
        bn = int8_conv.plan(m, n, k * k * cin, bf16, res)
        assert bn in int8_conv.TILE_N
        assert res in (None, bf16, torch.int8)
        assert int8_conv.block_smem(bn, FULL_RING, bf16, bf16) <= 227 * 1024
        assert -(-m // bm) * bm >= m and -(-n // bn) * bn >= n
        assert cin % int8_conv.CIN_MULTIPLE == 0
        assert cin % int8_conv.K_PIECE == 0  # a piece stays in one tap
        assert int8_conv.K_TILE % int8_conv.K_PIECE == 0
        stages = -(-k * k * cin // int8_conv.K_TILE)
        assert stages * int8_conv.K_TILE >= k * k * cin
        assert n % 8 == 0 and stride in (1, 2) and k in (1, 3)
        assert dtype in (torch.int8, torch.bfloat16)


def test_plan_fills_the_card_at_the_w32_shapes():
    """Two W32 shapes the planner exists for: 8x6x256 (M 3,072, N 256)
    would give 48 blocks of 128x128 and 16x12x128 (M 12,288, N 128) 96 for
    132 SMs; the planner's 64-row tiles give twice as many, and the 64x48
    maps of the CPN stream (M 196,608) take 64x64 tiles."""
    bf16 = torch.bfloat16
    for (m, n), least in (((3072, 256), 96), ((12288, 128), 192)):
        bm = int8_conv.BLOCK_M
        bn = int8_conv.plan(m, n, 9 * n // 2, bf16, None)  # 3x3, Cin N/2
        assert -(-m // bm) * -(-n // bn) >= least
    assert int8_conv.plan(64 * 64 * 48, 256, 2304, bf16, None) == 64
    # pads N less
    assert int8_conv.plan(3072, 192, 1728, bf16, None) == 64


@pytest.mark.parametrize("bn", int8_conv.TILE_N)
def test_plan_smem_at_fp32(bn):
    """The tile's shared memory on a full ring with an fp32 epilogue: the
    fp32 staged tile (64 x (BN + 8) x 4 bytes) fits the ring it reuses,
    and the block with an fp32 residual tile fits 227 KB
    (``_build.SMEM_LIMIT``); it is the bf16 block's plus a residual tile
    twice as wide, and the block without a residual's plus one tile."""
    f32, bf16 = torch.float32, torch.bfloat16
    ring = int8_conv.STAGES * (int8_conv.BLOCK_M + bn) * int8_conv.K_TILE
    assert int8_conv.BLOCK_M * (bn + 8) * 4 <= ring

    def smem(dtype, res):
        return int8_conv.block_smem(bn, FULL_RING, dtype, res)

    assert smem(f32, f32) <= _build.SMEM_LIMIT
    assert smem(f32, f32) - smem(bf16, bf16) == int8_conv.BLOCK_M * bn * 2
    assert smem(f32, f32) - smem(f32, None) == int8_conv.BLOCK_M * bn * 4
    assert smem(f32, f32) == {128: 133192, 64: 83528}[bn]


@pytest.mark.parametrize("m,n,k_bytes,dtype,res_dtype,tile", [
    # HRNet-W32's int8 block tails at batch 512: 3x3 convs on a full ring
    (98304, 128, 1152, torch.bfloat16, None, 128),
    (98304, 128, 1152, torch.bfloat16, torch.bfloat16, 64),
    (24576, 256, 2304, torch.bfloat16, torch.bfloat16, 64),
    (98304, 128, 1152, torch.float32, torch.float32, 64),
    # the CPN stream's conv3s: an int8 skip's tile leaves room for two
    # blocks; a downsample's bf16 tile does on layer3.0's 2-stage ring
    # (K 256), not on layer4.0's full one (K 512)
    (98304, 1024, 256, torch.bfloat16, torch.int8, 128),
    (98304, 1024, 256, torch.bfloat16, torch.bfloat16, 128),
    (24576, 2048, 512, torch.bfloat16, torch.bfloat16, 64),
], ids=["w32-no-residual", "w32-branch2-tail", "w32-branch3-tail",
        "w32-fp32-tail", "cpn-int8-skip", "cpn-layer3-ds", "cpn-layer4-ds"])
def test_plan_keeps_two_blocks_an_sm(m, n, k_bytes, dtype, res_dtype, tile):
    """A 128-wide tile only where two of its blocks fit an SM's shared
    memory with their residual tiles (each block also holding the 1 KB the
    system reserves); else 64, whose blocks always fit at least twice."""
    assert int8_conv.plan(m, n, k_bytes, dtype, res_dtype) == tile
    per_block = int8_conv.block_smem(tile, k_bytes, dtype,
                                     res_dtype) + int8_conv.BLOCK_RESERVED
    assert 2 * per_block <= int8_conv.SM_SMEM
    wide = int8_conv.block_smem(128, k_bytes, dtype, res_dtype)
    assert (2 * (wide + int8_conv.BLOCK_RESERVED) <= int8_conv.SM_SMEM) == (
        tile == 128)


# the K10 calls a request of the fp32 deploy graphs: the CPN's 83; an fp32
# HRNet's 100 (its per-conv layer1's 13, the 85 wide convs, transition1's 2)
K10_CALLS_FP32 = {"h36m_cpn": 83, "h36m_hrnet_32": 100}


@pytest.mark.parametrize("name", sorted(K10_CALLS_FP32))
def test_plan_covers_every_fp32_deploy_k10_shape(name, monkeypatch):
    """Every K10 call of the fp32 deploy graphs (``config.deploy`` built in
    fp32, batch 64) has its epilogue in fp32 and an int8 or fp32 input, a
    tile width the kernel builds and a block (fp32 residual tile
    included) within 227 KB."""
    calls = _deploy_k10_calls(name, monkeypatch, dtype=torch.float32)
    assert len(calls) == K10_CALLS_FP32[name]
    for m, n, cin, k, stride, (x_dtype, dtype), res in set(calls):
        bn = int8_conv.plan(m, n, k * k * cin, dtype, res)
        assert dtype == torch.float32 and x_dtype in (torch.int8, dtype)
        assert res in (None, dtype, torch.int8)
        assert bn in int8_conv.TILE_N
        assert (int8_conv.block_smem(bn, FULL_RING, dtype, dtype)
                <= _build.SMEM_LIMIT)
        assert cin % int8_conv.CIN_MULTIPLE == 0 and n % 8 == 0
