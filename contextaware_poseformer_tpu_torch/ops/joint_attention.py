"""Softmax-attention middle for the joint blocks (K4): CUDA kernel wrapper,
plain version and dispatcher.

Port of ``contextaware_poseformer_tpu/ops/joint_attention.py:35-119``: qkv
(B, N, 3D) -> softmax(q k^T / sqrt(hd)) v -> (B, N, D); the qkv and output
projections stay plain matmuls in the caller. The CUDA kernel
(``csrc/joint_attention.cu``) runs one block per (image, head or group of
heads), pads the tokens to 32 and, in bf16, runs the scores and AV on the
tensor cores (``mma.sync``); fp32 stays on exact FMAs. It takes N <= 32
tokens (the lifter's joint blocks have 17), D a multiple of 8 and an even
head dim (at most 128 in bf16).
"""

from __future__ import annotations

import functools

import torch

from contextaware_poseformer_tpu_torch.ops import _build
from contextaware_poseformer_tpu_torch.ops.small_attention import (
    _heads_split,
    softmax_middle,
)

launches = 0  # kernel launches made by attention_middle_kernel

MAX_TOKENS = 32  # tokens a block pads to (csrc/joint_attention.cu)
MAX_HEAD_DIM_BF16 = 128


@functools.lru_cache(maxsize=None)
def heads_per_block(heads: int, hd: int) -> int:
    """The heads one block of the kernel takes (two warps a head): the
    fewest whose values of a token fill whole 16-byte pieces, one for head
    dims 40 and 80, two for 60 (one a block measured 4% faster than two at
    (64, 17, 640) on the card, PERF.md, PR 7)."""
    for hb in range(1, heads + 1):
        if heads % hb == 0 and hb * hd % 8 == 0:
            return hb
    raise ValueError(f"attention_middle: {heads} heads of {hd}")


def attention_middle_reference(qkv, num_heads):
    """Plain version (the JAX einsum form)."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    q, k, v = _heads_split(qkv, d, num_heads)
    return softmax_middle(q, k, v).reshape(b, n, d)


def attention_middle_kernel(qkv, num_heads):
    """The CUDA kernel: qkv (B, N, 3D) float32 or bfloat16. Under autograd
    the backward is the plain version's VJP."""
    if _build.needs_grad(qkv):
        return _build.PlainVjp.apply(
            _launch, attention_middle_reference, qkv, num_heads)
    return _launch(qkv, num_heads)


def _launch(qkv, num_heads):
    global launches
    name = "attention_middle"
    code = _build.dtype_code(name, qkv.dtype)
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} with "
                         f"{num_heads} heads")
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    if n > MAX_TOKENS or d % 8 or hd % 2 or (
            qkv.dtype == torch.bfloat16 and hd > MAX_HEAD_DIM_BF16):
        raise ValueError(f"{name}: N={n} (at most {MAX_TOKENS}), D={d} (a "
                         f"multiple of 8), head dim {hd} (even; at most "
                         f"{MAX_HEAD_DIM_BF16} in bf16)")
    _build.require_cuda(name, qkv)
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must start on a 16-byte boundary")
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    err = lib.capf_attention_middle(
        code, qkv.data_ptr(), out.data_ptr(), b, n, d, num_heads,
        heads_per_block(num_heads, hd), *_build.launch_target(qkv),
    )
    _build.check(lib, err, name)
    launches += 1
    return out


def attention_middle(qkv, num_heads: int):
    """Dispatcher: the plain version for a CPU tensor, the CUDA kernel for
    any other (which raises unless it is a CUDA tensor)."""
    if qkv.device.type == "cpu":
        return attention_middle_reference(qkv, num_heads)
    return attention_middle_kernel(qkv, num_heads)
