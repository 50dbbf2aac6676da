"""The float convolutions' epilogue: CUDA kernel wrapper, plain version and
dispatcher.

A float ``ConvBN`` (``models/backbone_common.py``) ends its convolution
``y`` (NHWC, in the backbone's dtype T, bf16 or fp32) with its folded BN
affine, and a block tail adds its residual and takes the ReLU:

    out = relu?(T(T(y * scale + bias) + residual?))

with ``scale`` and ``bias`` (C,) in T. The plain version is the chain of
PyTorch ops that computes it (``torch.addcmul``, an add, ``torch.relu``:
each in fp32 from T operands, rounded once to T; on the card the
``addcmul`` is one fp32 FMA). The kernel,
``csrc/conv_epilogue.cu``, makes the same roundings in one pass over the
tensor, so it equals the chain bit for bit, NaN and -0 included. It
replaces no TPU kernel: the JAX package leaves this chain to XLA, which
fuses it into the convolution's output.

The dispatcher takes the plain version for a tensor off the card (the CPU,
the meta device) and under ``impl="plain"``, and the kernel for any other.
The kernel writes into ``y`` itself (``ConvBN`` hands it the convolution's
fresh output), except where autograd records a graph through an operand
(an unfrozen backbone in training): there it writes a fresh tensor, and
the backward is the plain version's VJP (``_build.PlainVjp``, which keeps
``y``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from contextaware_poseformer_tpu_torch.ops import _build

launches = 0  # kernel launches made by conv_epilogue_kernel

THREADS = 256  # a block (csrc/conv_epilogue.cu kThreads)
UNROLL = 4  # 16-byte vectors of each operand a thread loads at once
VECTOR_BYTES = 16


def conv_epilogue_reference(y, scale, bias, residual=None, relu=False):
    """Plain version: ``relu?(addcmul(bias, y, scale) + residual?)``."""
    out = torch.addcmul(bias, y, scale)
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


@dataclass(frozen=True)
class Plan:
    width: int  # values a thread loads at once: 16 bytes, or 1 (scalar)
    stride: int  # threads that work; with vectors a multiple of C / width
    blocks: int  # ceil(stride / THREADS)


@functools.lru_cache(maxsize=None)
def plan(pixels: int, c: int, itemsize: int, aligned: bool = True) -> Plan:
    """The launch over ``pixels`` x ``c`` values of ``itemsize`` bytes.
    Where C is a multiple of the 16-byte vector's values and every tensor
    starts on a 16-byte boundary (``aligned``), a thread takes UNROLL
    vectors ``stride`` apart, ``stride`` a multiple of the groups (vectors)
    a pixel, so that all its vectors are one channel group's and it loads
    that group's scale and bias once; the grid is as many blocks as that
    takes, one pass each (a grid of 3 blocks an SM walking the tensor in a
    loop measured 3-8% slower at the served shapes). Otherwise the scalar
    body, a thread a value."""
    width = VECTOR_BYTES // itemsize
    if c % width or not aligned:
        n = pixels * c
        return Plan(1, n, math.ceil(n / THREADS))
    stride = c // width * math.ceil(pixels / UNROLL)
    return Plan(width, stride, math.ceil(stride / THREADS))


def conv_epilogue_kernel(y, scale, bias, residual=None, relu=False,
                         out=None):
    """The CUDA kernel: ``conv_epilogue_reference``'s function on a dense
    NHWC ``y`` (bf16 or fp32), ``scale``/``bias`` (C,) and ``residual``
    (y's shape) in y's dtype, into ``out`` (a fresh tensor when None; ``y``
    itself for an in-place pass). A HRNet request makes ~190 of these
    calls, so the checks stay few: the host's time a request is about the
    card's."""
    global launches
    name = "conv_epilogue"
    dtype, shape = y.dtype, y.shape
    code = _build.dtype_code(name, dtype)
    if len(shape) != 4:
        raise ValueError(f"{name}: y must be NHWC, got {tuple(shape)}")
    c = shape[3]
    if (scale.shape != (c,) or bias.shape != (c,) or scale.dtype != dtype
            or bias.dtype != dtype):
        raise TypeError(f"{name}: scale and bias must be {dtype} ({c},), "
                        f"got {scale.dtype} {tuple(scale.shape)} and "
                        f"{bias.dtype} {tuple(bias.shape)}")
    if residual is not None and (residual.shape != shape
                                 or residual.dtype != dtype):
        raise TypeError(f"{name}: residual must be {dtype} {tuple(shape)}, "
                        f"got {residual.dtype} {tuple(residual.shape)}")
    if out is None:
        out = torch.empty_like(y, memory_format=torch.contiguous_format)
    elif out.shape != shape or out.dtype != dtype:
        raise TypeError(f"{name}: out must be {dtype} {tuple(shape)}")
    tensors = ((y, scale, bias, out) if residual is None
               else (y, scale, bias, residual, out))
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: y, scale, bias, residual and out "
                             "must be dense (contiguous NHWC)")
    _build.require_cuda(name, *tensors)
    n = y.numel()
    if not n:
        return out
    pixels = n // c
    index, stream = _build.launch_target(y)
    y_ptr, out_ptr = y.data_ptr(), out.data_ptr()
    res_ptr = 0 if residual is None else residual.data_ptr()
    p = plan(pixels, c, y.element_size(),
             aligned=not (y_ptr | out_ptr | res_ptr) % VECTOR_BYTES)
    lib = _build.library()
    err = lib.capf_conv_epilogue(
        y_ptr, scale.data_ptr(), bias.data_ptr(), res_ptr or None, out_ptr,
        pixels, c, code, int(relu), p.width, p.stride, p.blocks, index,
        stream)
    _build.check(lib, err, name)
    launches += 1
    return out


def conv_epilogue(y, scale, bias, residual=None, relu=False,
                  impl: str = "auto"):
    """Dispatcher: the plain version off the card or under
    ``impl="plain"``; else the kernel, which writes into ``y``: the caller
    hands over a fresh tensor (ConvBN, its convolution's output). Where
    autograd records through an operand the kernel writes a fresh tensor
    and the backward is the plain version's VJP."""
    if impl == "plain" or not y.is_cuda:
        return conv_epilogue_reference(y, scale, bias, residual, relu)
    if impl != "auto":
        raise ValueError(f"conv_epilogue: impl {impl!r} (auto or plain)")
    if _build.needs_grad(y, scale, bias, residual):
        return _build.PlainVjp.apply(conv_epilogue_kernel,
                                     conv_epilogue_reference, y, scale, bias,
                                     residual, relu)
    return conv_epilogue_kernel(y, scale, bias, residual, relu, y)
