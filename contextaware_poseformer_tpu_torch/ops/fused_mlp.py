"""Fused LayerNorm -> MLP -> residual (K2): CUDA kernel wrapper, plain
version and dispatcher.

Port of ``contextaware_poseformer_tpu/ops/fused_mlp.py:59-157``:

    y = x + fc2(gelu_erf(fc1(LN(x))))

LN statistics and the residual add are fp32; the matmul operands are in
``x.dtype`` (bfloat16 on the serving path, float32 for parity) with fp32
accumulation, and the LN and GELU outputs are rounded to ``x.dtype`` before
the matmul that reads them. GELU is the exact erf form (the TPU kernel's
rational erf approximation was a Mosaic workaround; CUDA has ``erff``).
The kernel is ``csrc/fused_mlp.cu``: its bf16 body runs the products on
tensor cores (WMMA) and needs D and H divisible by 32; its fp32 body runs
them on CUDA cores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from contextaware_poseformer_tpu_torch.ops import _build

launches = 0  # kernel launches made by ln_mlp_residual_kernel

_ROWS = 8  # rows per block of the fp32 body in csrc/fused_mlp.cu
# the bf16 (WMMA) body: rows per block, warps, tile edge, output strip,
# k-steps per B load group, row padding
_TC_ROWS, _WARPS, _TILE, _STRIP, _GROUP, _PAD = 16, 8, 16, 32, 4, 8


def _smem_bytes(dtype, d, hdim):
    """Shared memory one block of csrc/fused_mlp.cu takes."""
    if dtype == torch.bfloat16:
        b_buffers = _WARPS * _GROUP * _TILE * (_STRIP + _PAD)
        return (4 * (_TC_ROWS * d + _WARPS * _TILE * _TILE)
                + 2 * (b_buffers + _TC_ROWS * (d + hdim + 2 * _PAD)))
    return 4 * _ROWS * (2 * d + hdim)


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
    if _smem_bytes(x.dtype, d, hdim) > _build.SMEM_LIMIT:
        raise ValueError(f"{name}: D={d}, H={hdim} rows do not fit in "
                         "shared memory")
    if x.dtype == torch.bfloat16 and (d % _STRIP or hdim % _STRIP):
        raise ValueError(f"{name}: the bf16 (tensor-core) kernel needs D "
                         f"and H divisible by {_STRIP}, got D={d}, H={hdim}")
    for v, n in ((ln_scale, d), (ln_bias, d), (b1, hdim), (b2, d)):
        if v.shape != (n,):
            raise ValueError(f"{name}: vector of shape {tuple(v.shape)}, "
                             f"expected ({n},)")
    w1c = w1.to(x.dtype).contiguous()
    w2c = w2.to(x.dtype).contiguous()
    vecs = [v.float().contiguous() for v in (ln_scale, ln_bias, b1, b2)]
    _build.require_cuda(name, x, w1c, w2c, *vecs)
    if x.dtype == torch.bfloat16 and (w1c.data_ptr() % 16
                                      or w2c.data_ptr() % 16):
        raise ValueError(f"{name}: the weights must start on a 16-byte "
                         "boundary (the kernel loads them 16 bytes a lane)")
    out = torch.empty_like(x)
    rows = x.numel() // d
    ls, lb, b1c, b2c = (v.data_ptr() for v in vecs)
    lib = _build.library()
    err = lib.capf_ln_mlp_residual(
        code, x.data_ptr(), ls, lb, w1c.data_ptr(), b1c, w2c.data_ptr(), b2c,
        out.data_ptr(), rows, d, hdim, float(eps), *_build.launch_target(x),
    )
    _build.check(lib, err, name)
    launches += 1
    return out


def ln_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-6):
    """Dispatcher: the plain version for a CPU tensor, the CUDA kernel for
    any other (which raises unless it is a CUDA tensor)."""
    if x.device.type == "cpu":
        return ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    return ln_mlp_residual_kernel(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
