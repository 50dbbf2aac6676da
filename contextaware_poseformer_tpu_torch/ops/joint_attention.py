"""Softmax-attention middle for the joint blocks (K4): CUDA kernel wrapper,
plain version and dispatcher.

Port of ``contextaware_poseformer_tpu/ops/joint_attention.py:35-119``: qkv
(B, N, 3D) -> softmax(q k^T / sqrt(hd)) v -> (B, N, D); the qkv and output
projections stay plain matmuls in the caller. The CUDA kernel
(``csrc/joint_attention.cu``) runs one block per (image, head) on exactly N
tokens, so the TPU kernel's padding to 24 tokens and its mask are gone.
"""

from __future__ import annotations

import torch

from contextaware_poseformer_tpu_torch.ops import _build
from contextaware_poseformer_tpu_torch.ops.small_attention import (
    _heads_split,
    softmax_middle,
)

launches = 0  # kernel launches made by attention_middle_kernel


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
    if (3 * n * (d // num_heads) + n * n) * 4 > _build.SMEM_LIMIT:
        raise ValueError(f"{name}: N={n}, D={d} do not fit in shared memory")
    _build.require_cuda(name, qkv)
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    err = lib.capf_attention_middle(
        code, qkv.data_ptr(), out.data_ptr(), b, n, d, num_heads,
        *_build.launch_target(qkv),
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
