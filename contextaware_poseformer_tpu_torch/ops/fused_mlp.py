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
two launches a call). Its fp32 body runs the products on CUDA cores. The
bf16 routes read the weights as bf16 W1^T and W2^T, cast once per
parameter state (``kernel_weight``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from contextaware_poseformer_tpu_torch.ops import _build

launches = 0  # calls of ln_mlp_residual_kernel (two launches on route 2)

_ROWS = 8  # rows per block of the fp32 body in csrc/fused_mlp.cu
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


@dataclass(frozen=True)
class Plan:
    """A K2 call's route: its shared memory a block for each launch, and
    the column widths its products take (resident: fc1's hidden tile and
    fc2's full width D; two-phase: phase 1's hidden tile and phase 2's
    output tile; a tile past H or D is masked)."""

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


def plan(dtype: torch.dtype, d: int, hdim: int) -> Plan:
    """The route of a K2 call at width D and hidden width H: fp32 -> the
    CUDA-core body; bf16 -> weights-resident where the kernel has the width
    and both weights fit in shared memory, else two-phase. Raises
    ValueError for a shape no route takes."""
    name = "ln_mlp_residual"
    if dtype == torch.float32:
        smem = 4 * _ROWS * (2 * d + hdim)
        if smem > _build.SMEM_LIMIT:
            raise ValueError(f"{name}: D={d}, H={hdim} rows do not fit in "
                             "shared memory")
        return Plan("fp32", (smem,), ())
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
    p = plan(x.dtype, d, hdim)
    route = p.route
    if route == "fp32":
        w1k, w2k = (w.to(x.dtype).contiguous() for w in (w1, w2))
    else:
        w1k, w2k = kernel_weight(w1), kernel_weight(w2)
    vecs = [v.float().contiguous() for v in (ln_scale, ln_bias, b1, b2)]
    _build.require_cuda(name, x, w1k, w2k, *vecs)
    out = torch.empty_like(x)
    rows = x.numel() // d
    hidden = (torch.empty((rows, hdim), dtype=torch.bfloat16,
                          device=x.device) if route == "two-phase" else None)
    if route != "fp32" and any(
            t.data_ptr() % 16 for t in (x, out, w1k, w2k)):
        raise ValueError(f"{name}: x, out and the weights must start on a "
                         "16-byte boundary (16-byte loads, TMA)")
    ls, lb, b1c, b2c = (v.data_ptr() for v in vecs)
    args = _Args(x=x.data_ptr(), ln_scale=ls, ln_bias=lb,
                 w1=w1k.data_ptr(), b1=b1c, w2=w2k.data_ptr(), b2=b2c,
                 hidden=None if hidden is None else hidden.data_ptr(),
                 out=out.data_ptr(), rows=rows, d=d, hdim=hdim,
                 eps=float(eps), dtype=code, route=_ROUTE_CODES[route],
                 tile1=p.tiles[0] if route == "two-phase" else 0)
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
