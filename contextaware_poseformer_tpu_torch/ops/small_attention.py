"""Fused multi-head self-attention for very short sequences (K3): CUDA
kernel wrapper, plain version and dispatcher.

Port of ``contextaware_poseformer_tpu/ops/small_attention.py:41-159``: x
(R, N, D) -> qkv -> softmax(q k^T / sqrt(hd)) v -> proj, with qkv and the
output projection inside the kernel (``csrc/small_attention.cu``). Scores and
softmax are fp32. The TPU kernel's token-on-lanes layout and one-hot head
reducers are TPU formulations and are not carried over.
"""

from __future__ import annotations

import torch

from contextaware_poseformer_tpu_torch.ops import _build

launches = 0  # kernel launches made by small_attention_kernel

MAX_TOKENS = 20  # tokens per block in csrc/small_attention.cu


def _heads_split(qkv, d, num_heads):
    shape = qkv.shape[:-1] + (num_heads, d // num_heads)
    return (qkv[..., i * d:(i + 1) * d].reshape(shape) for i in range(3))


def softmax_middle(q, k, v):
    """softmax(q k^T / sqrt(hd)) v on (B, N, H, hd) heads: fp32 scores and
    softmax, probabilities rounded to v's dtype (the JAX einsum form)."""
    scale = q.shape[-1] ** -0.5
    a = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    a = torch.softmax(a, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", a, v)


def attention_reference(x, wqkv, bqkv, wproj, bproj, num_heads):
    """Plain version, in ``x.dtype`` like the JAX reference."""
    r, n, d = x.shape
    q, k, v = _heads_split(x @ wqkv + bqkv, d, num_heads)
    o = softmax_middle(q, k, v).reshape(r, n, d)
    return o @ wproj + bproj


def small_attention_kernel(x, wqkv, bqkv, wproj, bproj, num_heads):
    """The CUDA kernel: x (R, N, D); every operand in ``x.dtype``. Under
    autograd the backward is the plain version's VJP."""
    args = (x, wqkv, bqkv, wproj, bproj, num_heads)
    if _build.needs_grad(*args[:-1]):
        return _build.PlainVjp.apply(_launch, attention_reference, *args)
    return _launch(*args)


def _launch(x, wqkv, bqkv, wproj, bproj, num_heads):
    global launches
    name = "small_attention"
    code = _build.dtype_code(name, x.dtype)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (R, N, D), got {tuple(x.shape)}")
    r, n, d = x.shape
    if n > MAX_TOKENS or d % num_heads or d % 4:
        raise ValueError(f"{name}: N={n} (max {MAX_TOKENS}), D={d} (a "
                         f"multiple of 4 and of heads={num_heads})")
    expect = ((d, 3 * d), (3 * d,), (d, d), (d,))
    for t, shape in zip((wqkv, bqkv, wproj, bproj), expect):
        if t.shape != shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {x.dtype}")
    _build.require_cuda(name, x, wqkv, bqkv, wproj, bproj)
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.capf_small_attention(
        code, *(t.data_ptr() for t in (x, wqkv, bqkv, wproj, bproj, out)),
        r, n, d, num_heads, *_build.launch_target(x),
    )
    _build.check(lib, err, name)
    launches += 1
    return out


def small_attention(x, wqkv, bqkv, wproj, bproj, num_heads: int):
    """Dispatcher: the plain version for a CPU tensor, the CUDA kernel for
    any other (which raises unless it is a CUDA tensor)."""
    if x.device.type == "cpu":
        return attention_reference(x, wqkv, bqkv, wproj, bproj, num_heads)
    return small_attention_kernel(x, wqkv, bqkv, wproj, bproj, num_heads)
