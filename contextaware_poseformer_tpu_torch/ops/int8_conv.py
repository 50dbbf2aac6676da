"""The int8 convolution of the HRNet deploy graph (K10): CUDA kernel
wrapper, plain version and dispatcher.

Port of the int8 routes of ``ConvBN`` in
``contextaware_poseformer_tpu/models/backbone_common.py`` (157-213), which
the JAX package leaves to XLA (PyTorch has no CUDA int8 convolution). NHWC
input, a (Cout, kh*kw*Cin) int8 kernel with K ordered (kh, kw, Cin),
square 1x1 or 3x3, stride 1 or 2, zero padding (k - 1) // 2:

    int8 x (``x_quant``):  step = max(amax, 1e-12) / 127, xq = x
    float x (dynamic):     step = max|x| / 127,
                           xq = clip(round(x / step), -127, 127)
    acc = conv(xq, kernel_q)                      int32, exact
    y = bf16(acc) * bf16(scale * wscale * step) + bf16(bias), then ReLU

with the JAX package's rounding points as it serves them (under ``jit``):
fp32 for the scales (``/ 127`` as a multiplication by fl32(1/127)), the
division by ``step`` and the round-half-even; the affine as a bf16 multiply
and a bf16 add, two roundings. The kernel is ``csrc/int8_conv.cu``; it quantizes a bf16 input
as it loads it, and takes the max|x| reduction from ``torch`` (the JAX
package computes it outside any kernel as well).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from contextaware_poseformer_tpu_torch.ops import _build

launches = 0  # kernel launches made by int8_conv_kernel

_CHUNK = 32  # input channels a thread loads at once
RECIP_127 = float(np.float32(1) / np.float32(127))  # fl32(1 / 127)


def f32_const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim fp32 tensor on ``like``'s device. Dividing by it
    is IEEE division on every device (CUDA turns a division by a Python
    number into a multiplication by its reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max|x| as a 0-dim fp32 tensor (exact: no rounding in a max)."""
    return torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)


def dequant_step(amax: torch.Tensor, clamp: bool) -> torch.Tensor:
    """The int8 step of a tensor of max|value| ``amax`` (fp32, 0-dim):
    ``max(amax, 1e-12) / 127`` for a calibrated scale, ``amax / 127`` for
    a runtime one. The JAX package serves under ``jit``, where XLA turns a
    division by the constant 127 into a multiplication by its fp32
    reciprocal; so does this."""
    a = amax.float()
    if clamp:
        a = torch.clamp(a, min=1e-12)
    return a * RECIP_127


def _kernel_size(kernel_q: torch.Tensor, cin: int) -> int:
    taps = kernel_q.shape[1] // cin
    k = math.isqrt(taps)
    if k * k * cin != kernel_q.shape[1] or k not in (1, 3):
        raise ValueError(f"int8_conv: kernel {tuple(kernel_q.shape)} is not "
                         f"1x1 or 3x3 over {cin} input channels")
    return k


def accumulate(xq, kernel_q, stride):
    """The int32 accumulation of the int8 values ``xq`` (NHWC, int8 or
    float holding integers) with ``kernel_q``, in float64: exact, since
    every product is below 2**14 and every sum below 2**26 (rounded before
    the cast, in case the library's algorithm leaves a residue far below
    0.5)."""
    ksize = _kernel_size(kernel_q, xq.shape[-1])
    w = kernel_q.reshape(kernel_q.shape[0], ksize, ksize, -1)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   w.permute(0, 3, 1, 2).double(), stride=stride,
                   padding=(ksize - 1) // 2)
    return torch.round(acc).permute(0, 2, 3, 1).to(torch.int32)


def int8_conv_reference(x, kernel_q, wscale, scale, bias, amax, stride,
                        relu, dtype=torch.bfloat16):
    """Plain version. ``x`` (B, H, W, Cin) int8 with ``amax`` its calibrated
    max|value|, or float with ``amax=None`` (dynamic)."""
    if x.dtype == torch.int8:
        step = dequant_step(amax, clamp=True)
        xq = x
    else:
        step = dequant_step(absmax(x), clamp=False)
        xq = torch.clamp(torch.round(x.float() / step), -127, 127)
    acc = accumulate(xq, kernel_q, stride)
    eff = (scale.float() * wscale.float() * step).to(dtype)
    y = acc.to(dtype) * eff + bias.to(dtype)
    return torch.relu(y) if relu else y


class _Args(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p),
        ("wq", ctypes.c_void_p),
        ("wscale", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("bias", ctypes.c_void_p),
        ("amax", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("batch", ctypes.c_int),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("cin", ctypes.c_int),
        ("cout", ctypes.c_int),
        ("ksize", ctypes.c_int),
        ("stride", ctypes.c_int),
        ("ho", ctypes.c_int),
        ("wo", ctypes.c_int),
        ("x_int8", ctypes.c_int),
        ("relu", ctypes.c_int),
    ]


def int8_conv_kernel(x, kernel_q, wscale, scale, bias, amax, stride, relu,
                     dtype=torch.bfloat16):
    """The CUDA kernel: same contract as ``int8_conv_reference``, for a
    bf16 output; ``x`` int8 or bf16 with Cin a multiple of 32, Cout a
    multiple of 8, fp32 ``wscale``/``scale``/``bias``."""
    global launches
    name = "int8_conv"
    if dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel writes bf16, not {dtype}")
    if x.dim() != 4 or x.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"{name}: x must be NHWC int8 or bf16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    b, h, w, cin = x.shape
    cout = kernel_q.shape[0]
    ksize = _kernel_size(kernel_q, cin)
    if cin % _CHUNK or cout % 8 or stride not in (1, 2):
        raise ValueError(f"{name}: Cin {cin} (multiple of {_CHUNK}), Cout "
                         f"{cout} (multiple of 8), stride {stride} (1 or 2)")
    if kernel_q.dtype != torch.int8:
        raise TypeError(f"{name}: kernel_q must be int8")
    vecs = (wscale, scale, bias)
    if any(v.dtype != torch.float32 or v.shape != (cout,) for v in vecs):
        raise TypeError(f"{name}: wscale, scale and bias must be fp32 "
                        f"({cout},)")
    if x.dtype == torch.int8:
        if amax is None:
            raise ValueError(f"{name}: an int8 input needs its amax")
        amax = amax.float()
    else:
        if amax is not None:
            raise ValueError(f"{name}: a float input is quantized with its "
                             "own max|x| (amax=None)")
        amax = absmax(x)
    _build.require_cuda(name, x, kernel_q, *vecs, amax)
    if x.data_ptr() % 16 or kernel_q.data_ptr() % 16:
        raise ValueError(f"{name}: x and kernel_q must start on a 16-byte "
                         "boundary (16-byte loads)")
    pad = (ksize - 1) // 2
    ho = (h + 2 * pad - ksize) // stride + 1
    wo = (w + 2 * pad - ksize) // stride + 1
    out = torch.empty((b, ho, wo, cout), dtype=torch.bfloat16,
                      device=x.device)
    args = _Args(x.data_ptr(), kernel_q.data_ptr(), wscale.data_ptr(),
                 scale.data_ptr(), bias.data_ptr(), amax.data_ptr(),
                 out.data_ptr(), b, h, w, cin, cout, ksize, stride, ho, wo,
                 int(x.dtype == torch.int8), int(relu))
    lib = _build.library()
    err = lib.capf_int8_conv(ctypes.addressof(args),
                             *_build.launch_target(x))
    _build.check(lib, err, name)
    launches += 1
    return out


def int8_conv(x, kernel_q, wscale, scale, bias, amax, stride, relu,
              dtype=torch.bfloat16, impl: str = "auto"):
    """Dispatcher: the plain version for a CPU tensor or ``impl="plain"``,
    the CUDA kernel for any other (which raises unless it is a CUDA
    tensor)."""
    if impl == "plain" or x.device.type == "cpu":
        return int8_conv_reference(x, kernel_q, wscale, scale, bias, amax,
                                   stride, relu, dtype)
    if impl != "auto":
        raise ValueError(f"int8_conv: impl {impl!r} (auto or plain)")
    return int8_conv_kernel(x, kernel_q, wscale, scale, bias, amax, stride,
                            relu, dtype)
