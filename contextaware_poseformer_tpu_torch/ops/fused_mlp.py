"""Fused LayerNorm -> MLP -> residual (K2): CUDA kernel wrapper, route
planner, plain version and dispatcher.

Port of ``contextaware_poseformer_tpu/ops/fused_mlp.py:59-157``:

    y = x + fc2(gelu_erf(fc1(LN(x))))

LN statistics and the residual add are fp32; the matmul operands are in
``x.dtype`` (bfloat16 on the serving path, float32 for parity) with fp32
accumulation, and the LN and GELU outputs are rounded to ``x.dtype`` before
the matmul that reads them. GELU is the exact erf form (the TPU kernel's
rational erf approximation was a Mosaic workaround; CUDA has ``erff``).
The kernel is ``csrc/fused_mlp.cu``. Its bf16 routes run the products on
Hopper's tensor cores (``wgmma``) and need D and H divisible by 16:
``plan`` picks the weights-resident route (one persistent block an SM that
loads W1 and W2 once) where both fit in shared memory, else the two-phase
route (LN + fc1 + GELU into a bf16 hidden workspace, then fc2 + residual:
two launches a call). The bf16 routes read the weights as bf16 W1^T and
W2^T, cast once per parameter state (``kernel_weight``). In fp32 the
products are exact FMAs on the CUDA cores, register-tiled: where D and H =
2D fit one block (D <= 128, a multiple of 16) the fused route keeps a row
tile whole in shared memory (one launch); otherwise the fp32 two-phase
route takes three launches (the LN of every row into an fp32 workspace,
then LN(x) W1 + GELU into an fp32 hidden workspace, then fc2 + residual).
Both read the fp32 weights as the model holds them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from contextaware_poseformer_tpu_torch.ops import _build

launches = 0  # calls of ln_mlp_residual_kernel (two or three launches on
# the two-phase routes)

# the bf16 routes: rows of a tile (wgmma's M), bytes of a swizzled K chunk
# (64 bf16), the two-phase ring's depth and its column tiles, the 1024-byte
# alignment of the swizzled regions
_BM, _CHUNK, _STAGES, _BN2, _ALIGN = 64, 128, 4, 64, 1024
_CHUNK_ELEMS = _CHUNK // 2
RESIDENT_WIDTHS = (64, 96, 128)  # D instantiated with H = 2D in the .cu
# the two-phase route's phase-1 tile (hidden columns a block): 256 from
# D = 480 on, 128 below; the block's fixed cost (x and its LN) is most of
# its time, and 256 halves the blocks (one wave at the joint shape) and
# the LN work: 51 -> 30 us at D = 640, 50 -> 29 at D = 480, but 18 -> 20
# at D = 320, whose 85 blocks fill one wave already (batch 64, an H100 80GB
# HBM3; PERF.md)
_BN1_WIDE_FROM = 480
_ROUTE_CODES = {"fp32": 0, "resident": 1, "two-phase": 2}
_F32_TWO_PHASE = 3  # the fp32 route's code when it takes three launches
# the fp32 routes (csrc/fused_mlp.cu): the ring's slots; the fused route's
# row tiles (8 row groups x 6, 5 or 4 rows a thread), K a slice and most
# threads (2D); the two-phase GEMM's K a slice and a thread's micro-tiles
# (TM rows x TN columns), each with the share of the SMs' FMA peak its
# inner loop reaches alone with 8 warps or more an SM and 4 x 8 lanes a
# warp (``tools/torch_fp32_tiles.py --loop`` on an H100 80GB HBM3: PERF.md
# section 6; 8 x 8's 0.65 lowered to 0.50, what its 170-180 registers a
# thread leave of it in the kernel), and the most threads a block
# (``gemm_max_threads``)
_F32_STAGES = 3
_FUSED_ROWS, _FUSED_BK, _FUSED_MAX_THREADS = (48, 40, 32), 16, 256
_GEMM_BK = 32
_GEMM_MICRO = {(4, 4): 0.57, (4, 8): 0.63, (8, 4): 0.66, (8, 8): 0.50}
_GEMM_SPLITS = (1, 2)  # K in one part or two
# the H100 SXM's SMs, each one's fp32 FMAs a cycle and the L2 bytes a cycle
# one SM draws (~4.2 TB/s over 132 SMs at 1.98 GHz: the joint call's
# staging alone drew 3.8, a 64 x 64 tile's 5.2, ``tools/torch_fp32_tiles.py
# --staging`` on an H100 80GB HBM3: PERF.md section 6)
SMS, _FMAS_A_CYCLE, _L2_BYTES_A_CYCLE = 132, 128, 16


@dataclass(frozen=True)
class Plan:
    """A K2 call's route: its shared memory a block for each launch, and
    its tiles (resident: fc1's hidden tile and fc2's full width D;
    two-phase: phase 1's hidden tile and phase 2's output tile, a tile
    past H or D masked; fp32 fused: the rows a block; fp32 two-phase:
    (TM, TN, RG, CG, split) of each phase, ``gemm_tile``). fp32 two-phase is
    three launches (the LN first, no dynamic shared memory)."""

    route: str
    smem: tuple[int, ...]
    tiles: tuple[int, ...]


def _chunks(n: int) -> int:
    return -(-n // _CHUNK_ELEMS)


def _resident_smem(d: int, hdim: int) -> int:
    """``Resident<D, H>::kSmem`` of csrc/fused_mlp.cu."""
    kc1, kc2 = _chunks(d), hdim // _CHUNK_ELEMS
    return (_ALIGN + kc1 * hdim * _CHUNK + kc2 * d * _CHUNK
            + (kc1 + kc2) * _BM * _CHUNK + 2 * _BM * (d + 8) * 2
            + (hdim + 3 * d) * 4 + 2 * 8)


def _two_phase_smem(d: int, hdim: int, bn1: int) -> tuple[int, int]:
    """``phase1_smem(bn1, d)`` and ``phase2_smem(hdim)`` of
    csrc/fused_mlp.cu."""
    kc1, kc2 = _chunks(d), _chunks(hdim)
    ring1 = max(min(_STAGES, kc1) * bn1 * _CHUNK, _BM * (bn1 + 8) * 2)
    ring2 = max(min(_STAGES, kc2) * (_BM + _BN2) * _CHUNK,
                _BM * (_BN2 + 8) * 4)
    return (_ALIGN + kc1 * _BM * _CHUNK + ring1 + _STAGES * 8 + 2 * d * 4,
            _ALIGN + ring2 + _STAGES * 8)


def _f32_fused_smem(bm: int, d: int, hdim: int) -> int:
    """``f32_fused_smem`` of csrc/fused_mlp.cu: the x and LN(x) tiles, the
    hidden tile and the ring of W1 / W2 slices, in fp32."""
    return 4 * (2 * bm * (d + 4) + bm * (hdim + 4)
                + _F32_STAGES * _FUSED_BK * hdim)


def _f32_gemm_smem(bm: int, bn: int) -> int:
    """``f32_gemm_smem`` of csrc/fused_mlp.cu: the ring of A (bm rows) and
    B (bn columns) slices."""
    return 4 * _F32_STAGES * (bm * (_GEMM_BK + 4) + _GEMM_BK * bn)


def _waves(blocks: int) -> int:
    return -(-blocks // SMS)


def f32_workspaces(d: int, hdim: int) -> tuple[int, int]:
    """The fp32 two-phase route's workspace widths (Dp, Hp): the LN rows
    and the hidden rows padded to the GEMM's K-slice (``round_up`` in
    csrc/fused_mlp.cu)."""
    return -(-d // _GEMM_BK) * _GEMM_BK, -(-hdim // _GEMM_BK) * _GEMM_BK


def gemm_max_threads(tm: int, tn: int) -> int:
    """``gemm_max_threads`` of csrc/fused_mlp.cu."""
    return 256 if tm * tn >= 64 else 384


@functools.lru_cache(maxsize=None)
def gemm_tile(rows: int, cols: int, k: int
              ) -> tuple[int, int, int, int, int]:
    """(TM, TN, RG, CG, split) of a two-phase GEMM launch of rows x cols
    outputs over K = k: a block of RG x CG threads (128 to
    ``gemm_max_threads``) owns RG * TM rows x CG * TN columns and 1 / split
    of K (two parts: the last to finish adds them). Chosen by the cycles of
    the busiest SM: the larger of its FMAs (at the micro-tile's measured
    share of the peak, times warps / 8 below 8 warps an SM and 0.9 without
    4 x 8 lanes a warp) and its L2 bytes (every block reads its rows of A
    and columns of B, and a split part writes and reads its sums once).
    Ties: fewer bytes, then more threads."""
    best = None
    for (tm, tn), share in _GEMM_MICRO.items():
        for rg in range(1, 65):
            for cg in range(1, 65):
                threads = rg * cg
                bm, bn = rg * tm, cg * tn
                smem = _f32_gemm_smem(bm, bn)
                if (not 128 <= threads <= gemm_max_threads(tm, tn)
                        or smem > _build.SMEM_LIMIT):
                    continue
                tiles = -(-rows // bm) * -(-cols // bn)
                for split in _GEMM_SPLITS:
                    per_sm = _waves(tiles * split)
                    resident = min(per_sm, _build.SMEM_LIMIT // smem,
                                   2048 // threads)
                    warps = resident * -(-threads // 32)
                    eff = share * min(1.0, warps / 8) * (
                        1.0 if rg % 4 == 0 and cg % 8 == 0 else 0.9)
                    fmas = per_sm * bm * bn * (k / split) / (
                        _FMAS_A_CYCLE * eff)
                    moved = per_sm * ((k / split) * (bm + bn)
                                      + (2 * bm * bn if split > 1 else 0)
                                      ) * 4 / _L2_BYTES_A_CYCLE
                    key = (max(fmas, moved), moved, -threads)
                    if best is None or key < best[0]:
                        best = (key, (tm, tn, rg, cg, split))
    return best[1]


def split_counters(rows: int, d: int, hdim: int,
                   tiles: tuple[int, ...]) -> int:
    """The fp32 two-phase route's split-K counters: one a tile of each
    phase (``gemm_grid`` in csrc/fused_mlp.cu), zeroed by its LN launch."""
    dp, hp = f32_workspaces(d, hdim)
    n = 0
    for (tm, tn, rg, cg, _), cols in ((tiles[:5], hp), (tiles[5:], d)):
        n += -(-rows // (rg * tm)) * -(-cols // (cg * tn))
    return n


def _f32_plan(d: int, hdim: int, rows: int | None) -> Plan:
    """The fp32 route: fused where D and H = 2D fit one block, with the row
    tile that puts the fewest rows on the busiest SM (ties: the larger);
    else two-phase, each phase's tile from ``gemm_tile``. ``rows`` None
    plans for a call of many waves."""
    if d % 4 or hdim % 4:
        raise ValueError(f"ln_mlp_residual: the fp32 kernel needs D and H "
                         f"divisible by 4 (16-byte rows), got D={d}, "
                         f"H={hdim}")
    if hdim == 2 * d and d % _FUSED_BK == 0 and 2 * d <= _FUSED_MAX_THREADS:
        fits = [bm for bm in _FUSED_ROWS
                if _f32_fused_smem(bm, d, hdim) <= _build.SMEM_LIMIT]
        if fits:
            bm = fits[0] if rows is None else min(
                fits, key=lambda m: (_waves(-(-rows // m)) * m, -m))
            return Plan("fp32", (_f32_fused_smem(bm, d, hdim),), (bm,))
    dp, hp = f32_workspaces(d, hdim)
    rows = 1 << 16 if rows is None else rows
    g1, g2 = gemm_tile(rows, hp, dp), gemm_tile(rows, d, hp)
    return Plan("fp32", (0, *(_f32_gemm_smem(g[0] * g[2], g[1] * g[3])
                              for g in (g1, g2))), (*g1, *g2))


def plan(dtype: torch.dtype, d: int, hdim: int,
         rows: int | None = None) -> Plan:
    """The route of a K2 call at width D and hidden width H (and ``rows``
    rows, on which the fp32 tiles depend): fp32 -> the CUDA-core routes
    (``_f32_plan``); bf16 -> weights-resident where the kernel has the
    width and both weights fit in shared memory, else two-phase. Raises
    ValueError for a shape no route takes."""
    name = "ln_mlp_residual"
    if dtype == torch.float32:
        return _f32_plan(d, hdim, rows)
    if dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if d % 16 or hdim % 16:
        raise ValueError(f"{name}: the bf16 (wgmma) kernel needs D and H "
                         f"divisible by 16, got D={d}, H={hdim}")
    if d in RESIDENT_WIDTHS and hdim == 2 * d:
        smem = _resident_smem(d, hdim)
        if smem <= _build.SMEM_LIMIT:
            return Plan("resident", (smem,), (_CHUNK_ELEMS, d))
    for bn1 in (256, 128) if d >= _BN1_WIDE_FROM else (128,):
        smem = _two_phase_smem(d, hdim, bn1)
        if max(smem) <= _build.SMEM_LIMIT:
            return Plan("two-phase", smem, (bn1, _BN2))
    raise ValueError(f"{name}: D={d} rows do not fit in shared memory")


def ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
    """Plain version: x (..., D), w1 (D, H), w2 (H, D).

    The LayerNorm uses the fast variance E[x^2] - mu^2, as the TPU and CUDA
    kernels and flax's LayerNorm do; ``F.layer_norm`` uses the two-pass
    variance, which differs in the last bits (the lifter's unfused blocks
    take ``F.layer_norm``)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    h = (xf - mu) * torch.rsqrt(var + eps)
    h = h * ln_scale.float() + ln_bias.float()
    a = h.to(dt).float() @ w1.to(dt).float() + b1.float()
    g = F.gelu(a)  # exact erf
    o = g.to(dt).float() @ w2.to(dt).float() + b2.float()
    return (xf + o).to(dt)


def f32_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight (K, N) as the fp32 routes read it: fp32, row-major. A
    contiguous fp32 parameter is read as it is; any other is converted once
    per parameter state (``_build.cached_operand``)."""
    if w.dtype == torch.float32 and w.is_contiguous():
        return w
    return _build.cached_operand(w, "f32", lambda v: v.float().contiguous())


def _cast_t(w: torch.Tensor) -> torch.Tensor:
    return w.t().to(torch.bfloat16).contiguous()


def kernel_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight (K, N) as the bf16 routes read it: W^T (N, K) in bf16,
    contiguous, cast once per parameter state (``_build.cached_operand``:
    an in-place update casts anew; a tensor made under
    ``torch.inference_mode()`` is cast on every call)."""
    return _build.cached_operand(w, "t_bf16", _cast_t)


class _Args(ctypes.Structure):  # csrc/fused_mlp.cu::CapfMlpArgs
    _fields_ = [
        ("x", ctypes.c_void_p),
        ("ln_scale", ctypes.c_void_p),
        ("ln_bias", ctypes.c_void_p),
        ("w1", ctypes.c_void_p),
        ("b1", ctypes.c_void_p),
        ("w2", ctypes.c_void_p),
        ("b2", ctypes.c_void_p),
        ("hidden", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("rows", ctypes.c_int),
        ("d", ctypes.c_int),
        ("hdim", ctypes.c_int),
        ("eps", ctypes.c_float),
        ("dtype", ctypes.c_int),
        ("route", ctypes.c_int),
        ("tile1", ctypes.c_int),
        ("normed", ctypes.c_void_p),
        ("gemm1", ctypes.c_int * 5),
        ("gemm2", ctypes.c_int * 5),
        ("partial", ctypes.c_void_p),
        ("count", ctypes.c_void_p),
    ]


def ln_mlp_residual_kernel(x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
    """The CUDA kernel: same contract as ``ln_mlp_reference``; the weights
    are cast to ``x.dtype`` and the LN parameters and biases to fp32. Under
    autograd the backward is the plain version's VJP."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    if _build.needs_grad(*args[:-1]):
        return _build.PlainVjp.apply(_launch, ln_mlp_reference, *args)
    return _launch(*args)


def _launch(x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
    global launches
    name = "ln_mlp_residual"
    code = _build.dtype_code(name, x.dtype)
    d = x.shape[-1]
    hdim = w1.shape[-1]
    if w1.shape != (d, hdim) or w2.shape != (hdim, d):
        raise ValueError(f"{name}: w1 {tuple(w1.shape)} / w2 "
                         f"{tuple(w2.shape)} do not fit D={d}")
    for v, n in ((ln_scale, d), (ln_bias, d), (b1, hdim), (b2, d)):
        if v.shape != (n,):
            raise ValueError(f"{name}: vector of shape {tuple(v.shape)}, "
                             f"expected ({n},)")
    rows = x.numel() // d
    p = plan(x.dtype, d, hdim, rows)
    route = p.route
    if route == "fp32":
        w1k, w2k = f32_weight(w1), f32_weight(w2)
    else:
        w1k, w2k = kernel_weight(w1), kernel_weight(w2)
    vecs = [v.float().contiguous() for v in (ln_scale, ln_bias, b1, b2)]
    _build.require_cuda(name, x, w1k, w2k, *vecs)
    out = torch.empty_like(x)
    if any(t.data_ptr() % 16 for t in (x, out, w1k, w2k, *vecs[:2])):
        raise ValueError(f"{name}: x, out, the weights and the LN parameters "
                         "must start on a 16-byte boundary (16-byte loads, "
                         "cp.async, TMA)")
    hidden = normed = partial = count = None
    code_route, tile1, gemm = _ROUTE_CODES[route], 0, (0,) * 10
    if route == "two-phase":
        hidden = torch.empty((rows, hdim), dtype=torch.bfloat16,
                             device=x.device)
        tile1 = p.tiles[0]
    elif route == "fp32" and len(p.smem) == 1:
        tile1 = p.tiles[0]
    elif route == "fp32":
        code_route, gemm = _F32_TWO_PHASE, p.tiles
        dp, hp = f32_workspaces(d, hdim)
        normed = torch.empty((rows, dp), dtype=torch.float32,
                             device=x.device)
        hidden = torch.empty((rows, hp), dtype=torch.float32,
                             device=x.device)
        if gemm[4] > 1 or gemm[9] > 1:
            partial = torch.empty((2, rows, max(hp, d)),
                                  dtype=torch.float32, device=x.device)
            count = torch.empty(split_counters(rows, d, hdim, gemm),
                                dtype=torch.int32, device=x.device)
    ls, lb, b1c, b2c = (v.data_ptr() for v in vecs)
    args = _Args(x=x.data_ptr(), ln_scale=ls, ln_bias=lb,
                 w1=w1k.data_ptr(), b1=b1c, w2=w2k.data_ptr(), b2=b2c,
                 hidden=None if hidden is None else hidden.data_ptr(),
                 out=out.data_ptr(), rows=rows, d=d, hdim=hdim,
                 eps=float(eps), dtype=code, route=code_route, tile1=tile1,
                 normed=None if normed is None else normed.data_ptr(),
                 gemm1=(ctypes.c_int * 5)(*gemm[:5]),
                 gemm2=(ctypes.c_int * 5)(*gemm[5:]),
                 partial=None if partial is None else partial.data_ptr(),
                 count=None if count is None else count.data_ptr())
    lib = _build.library()
    err = lib.capf_ln_mlp_residual(ctypes.addressof(args),
                                   *_build.launch_target(x))
    _build.check(lib, err, name)
    launches += 1
    return out


def ln_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-6):
    """Dispatcher: the plain version for a CPU tensor, the CUDA kernel for
    any other (which raises unless it is a CUDA tensor)."""
    if x.device.type == "cpu":
        return ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    return ln_mlp_residual_kernel(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
