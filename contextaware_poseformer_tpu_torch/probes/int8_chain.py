"""Counterparts of ``experiments/int8_chain_conv.py`` and
``experiments/int8_chain_micro.py``: K10 chained through its requantizing
int8 epilogue, and K10's pieces timed apart.

The TPU probes run an int8 3x3 conv chain at HRNet branch 0's shape (64x48,
32 channels, batch 128), HBM touched only at the chain's ends, and time its
pieces (``matmul3``: the three dy-band matmuls with their edge masks;
``matmul3_nomask``; ``matmul1``: one (M, 576) x (576, 128) matmul over a
pre-windowed input; ``requant``: the epilogue back to int8;
``bf16_matmul3``). On Hopper the chain is K10 with an int8 output
(``ops/int8_conv.py``), each conv reading the previous one's int8 tensor,
and the pieces are builds of K10's code in ``csrc/int8_conv.cu``:

- ``accum``: the main loop alone (the ``wgmma`` ring) with an int32 output
  (``matmul3``; over a (B, 64, 12, 576) pre-windowed input with a 1x1
  kernel it is the ``matmul1`` GEMM), and with ``mask=False`` the same
  with the border test compiled out (``matmul3_nomask``: wrong at the
  edges on purpose, timing only);
- ``bf16_conv``: the same ring on bf16 operands (``wgmma`` m64nNk16), fp32
  out (``bf16_matmul3``);
- ``requant``: the epilogue alone, int32 -> folded bf16 affine -> ReLU ->
  int8, K10's per-chunk code;
- ``quantize``: the quantize pass alone, bf16 -> int8 (K10's own, on the
  path since the quantize-once design).

Each has a plain version here; every wrapper launches only on CUDA tensors
and counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from contextaware_poseformer_tpu_torch.ops import _build, int8_conv

H, W, C = 64, 48, 32  # HRNet branch 0, the probes' shape
BATCH = 128
launches = dict.fromkeys(
    ("accum", "accum_nomask", "bf16_conv", "requant", "quantize"), 0)


def chain(x, convs, amaxes, impl="auto"):
    """The n-conv chain: ``x`` int8 (B, H, W, C) with amax ``amaxes[0]``;
    conv i (``convs[i]`` = (kernel_q, wscale, scale, bias), 3x3, ReLU)
    reads amax ``amaxes[i]`` and requantizes its output with
    ``amaxes[i + 1]`` in K10's epilogue. Returns the last int8 tensor."""
    for i, (kq, ws, sc, bi) in enumerate(convs):
        x = int8_conv.int8_conv(x, kq, ws, sc, bi, amaxes[i], 1, True,
                                impl=impl, out_amax=amaxes[i + 1])
    return x


def library_chain(x, weight, scale, bias, n):
    """The yardstick: cuDNN's bf16 3x3 conv + affine + ReLU, ``n`` deep
    on a bf16 NHWC ``x`` with one OIHW bf16 ``weight`` (channels last)."""
    y = x.permute(0, 3, 1, 2)
    for _ in range(n):
        y = torch.relu(F.conv2d(y, weight, padding=1) * scale + bias)
    return y


def accum_reference(x, kernel_q, stride=1):
    """Plain version of ``accum``: the int32 accumulation."""
    return int8_conv.accumulate(x, kernel_q, stride)


def _probe_launch(name, mode, x, weight, stride, out_dtype):
    b, h, w, _ = x.shape
    ksize = int8_conv._kernel_size(weight, x.shape[-1])
    ho = int8_conv.out_size(h, ksize, stride)
    wo = int8_conv.out_size(w, ksize, stride)
    out = torch.empty((b, ho, wo, weight.shape[0]), dtype=out_dtype,
                      device=x.device)
    _build.require_cuda(name, x, weight, out)
    args = int8_conv.conv_args(x, weight, None, stride, out)
    lib = _build.library()
    err = lib.capf_int8_conv_probe(ctypes.addressof(args), mode,
                                   *_build.launch_target(x))
    _build.check(lib, err, name)
    return out


def accum(x, kernel_q, stride=1, mask=True):
    """K10's main loop on an int8 ``x`` (B, H, W, Cin), Cin a multiple of
    32: the int32 accumulation (B, Ho, Wo, Cout); ``mask=False`` compiles
    the border predication out (edge outputs wrong on purpose)."""
    if x.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise TypeError("accum: int8 x and kernel_q")
    key = "accum" if mask else "accum_nomask"
    out = _probe_launch(key, 1 if mask else 2, x, kernel_q, stride,
                        torch.int32)
    launches[key] += 1
    return out


def bf16_conv_reference(x, weight):
    """Plain version of ``bf16_conv``: the bf16 operands' products summed
    in float64, as fp32 (the kernel sums in fp32, in another order)."""
    return int8_conv.accumulate_float(x, weight, 1)


def bf16_conv(x, weight):
    """K10's main loop on bf16 operands (wgmma m64nNk16): ``x`` bf16 (B, H,
    W, Cin), ``weight`` bf16 (Cout, 9 * Cin) ordered as ``kernel_q``;
    fp32 (B, H, W, Cout)."""
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError("bf16_conv: bf16 x and weight")
    out = _probe_launch("bf16_conv", 3, x, weight, 1, torch.float32)
    launches["bf16_conv"] += 1
    return out


def requant_reference(acc, wscale, scale, bias, amax, out_amax, relu=True):
    """Plain version of ``requant``: K10's epilogue on an int32 ``acc``
    (..., N) from an input of calibrated amax ``amax``."""
    step = int8_conv.dequant_step(amax, clamp=True)
    eff = (scale.float() * wscale.float() * step).to(torch.bfloat16)
    y = acc.to(torch.bfloat16) * eff + bias.to(torch.bfloat16)
    return int8_conv.quant_reference(torch.relu(y) if relu else y,
                                     out_amax)


class _RequantArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "acc", "wscale", "scale", "bias", "amax", "out_amax", "out")] + [
        (n, ctypes.c_int) for n in ("rows", "cols", "relu")]


def requant(acc, wscale, scale, bias, amax, out_amax, relu=True):
    """The epilogue alone: int32 ``acc`` (..., N), N a multiple of 16 ->
    int8."""
    name = "requant"
    if acc.dtype != torch.int32:
        raise TypeError(f"{name}: int32 acc")
    n = acc.shape[-1]
    amax, out_amax = amax.float(), out_amax.float()
    out = torch.empty(acc.shape, dtype=torch.int8, device=acc.device)
    _build.require_cuda(name, acc, wscale, scale, bias, amax, out_amax, out)
    args = _RequantArgs(acc.data_ptr(), wscale.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), amax.data_ptr(), out_amax.data_ptr(),
                        out.data_ptr(), acc.numel() // n, n, int(relu))
    lib = _build.library()
    err = lib.capf_int8_requant(ctypes.addressof(args),
                                *_build.launch_target(acc))
    _build.check(lib, err, name)
    launches[name] += 1
    return out


def quantize_reference(x, amax):
    """Plain version of ``quantize``: clip(round(x / step)) with the
    calibrated step max(amax, 1e-12) / 127."""
    return int8_conv.quantize_reference(x, amax)


def quantize(x, amax):
    """K10's quantize pass alone: bf16 ``x`` -> int8 (numel a multiple of
    16), the calibrated route's step."""
    out = int8_conv.quantize_kernel(x, amax.float().reshape(()), True)
    launches["quantize"] += 1
    return out
