"""Transformer layers of the lifter.

Port of ``contextaware_poseformer_tpu/models/layers.py:60-315``: ``Linear``,
``LayerNorm``, ``Dropout``, ``DropPath``, ``Mlp``, ``Attention`` (einsum /
fused / grouped), ``Block`` and ``apply_ln_mlp_residual``.

Randomness: every ``forward`` takes ``deterministic`` (True: dropout and
drop-path are the identity, as at inference) and ``generator``, an explicit
``torch.Generator`` on the tensors' device that a random draw needs. As in
the JAX package, the fused kernels (K2, K3, K4) are taken only where
dropout and drop-path are inactive: they have no random numbers inside.

Numeric contracts carried over:
- ``Linear`` keeps the flax (in, out) kernel. ``dtype`` is the compute dtype
  (parameters stay fp32); ``None`` promotes input and parameter dtypes as
  flax does, so a bf16 input meets an fp32 kernel in fp32.
- ``LayerNorm`` computes in fp32 and outputs ``dtype`` (fp32 on every path
  of the lifter).
- GELU is the exact erf form; the attention scale is head_dim ** -0.5;
  scores and softmax run in fp32.
- ``Block`` uses LayerNorm eps 1e-6.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from contextaware_poseformer_tpu_torch.models import init
from contextaware_poseformer_tpu_torch.ops.fused_mlp import ln_mlp_residual
from contextaware_poseformer_tpu_torch.ops.joint_attention import (
    attention_middle,
)
from contextaware_poseformer_tpu_torch.ops.small_attention import (
    _heads_split,
    small_attention,
    softmax_middle,
)
from contextaware_poseformer_tpu_torch.parallel import tensor


def _dtype(name: str | None):
    """Config dtype name -> torch dtype; "float32"/None -> None (promote)."""
    if name in (None, "float32"):
        return None
    return getattr(torch, name)


class Linear(nn.Module):
    """Dense layer, flax layout: ``kernel`` (in, out), ``bias`` (out,).

    Initialisation: U(+-1/sqrt(fan_in)) for kernel and bias (torch's
    default), or with ``zero_init`` a zero kernel and a bias of
    ``bias_values`` (zeros when None).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype | None = None, zero_init: bool = False,
                 bias_values=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.zero_init = zero_init
        self.bias_values = bias_values
        self.kernel = nn.Parameter(
            torch.empty(in_features, out_features, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)

    def reset_parameters(self, generator) -> None:
        if not self.zero_init:
            bound = 1.0 / math.sqrt(self.kernel.shape[0])
            init.uniform_(self.kernel, bound, generator)
            if self.bias is not None:
                init.uniform_(self.bias, bound, generator)
            return
        init.zeros_(self.kernel)
        if self.bias is None:
            return
        if self.bias_values is None:
            init.zeros_(self.bias)
        else:
            init.fill_(self.bias, torch.as_tensor(self.bias_values))

    def forward(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """``tp`` (a ``parallel.tensor.TensorParallel``): this Linear is a
        row shard; its partial products are summed over the model group,
        then the bias is added, once."""
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        if tp is None:
            return F.linear(x.to(dt), self.kernel.to(dt).t(), bias)
        y = tensor.reduce(F.linear(x.to(dt), self.kernel.to(dt).t()), tp)
        return y if bias is None else y + bias


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's param names (``scale``,
    ``bias``); statistics in fp32, output in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, generator) -> None:
        del generator
        init.ones_(self.scale)
        init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.scale.shape, self.scale.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate). The identity when ``deterministic`` or the
    rate is 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def active(self, deterministic: bool) -> bool:
        return not deterministic and self.rate > 0.0

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return tuple(x.shape)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None,
                tp=None, axis: int = -1) -> torch.Tensor:
        """``tp`` (a ``parallel.tensor.TensorParallel``): ``x`` is this
        rank's shard along ``axis``; the whole tensor's mask is drawn, as
        one process draws it, and this rank's part of it kept."""
        if not self.active(deterministic):
            return x
        if generator is None:
            raise ValueError("dropout with deterministic=False needs an "
                             "explicit torch.Generator")
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        shape = list(self.mask_shape(x))
        if tp is not None:
            shape[axis] *= tp.size
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        if tp is not None:
            mask = mask.chunk(tp.size, axis)[tp.rank]
        return torch.where(mask, x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(Dropout):
    """Stochastic depth: drop a whole residual branch per sample (dropout
    with one draw per sample, ``layers.py:243-256``)."""

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return (x.shape[0],) + (1,) * (x.dim() - 1)


class Mlp(nn.Module):
    """fc1 -> GELU -> dropout -> fc2 -> dropout.

    Under tensor parallelism (``tp``, set by ``parallel.tensor.
    shard_model``) fc1 holds this rank's columns and fc2 its rows: the
    input is ``copy``-ed in, the hidden stays this rank's, and fc2's
    partial products are all-reduced before its bias."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dtype=None, drop: float = 0.0,
                 device=None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype,
                          device=device)
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype,
                          device=device)
        self.drop = Dropout(drop)
        self.tp = None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        tp = self.tp
        if tp is not None:
            x = tensor.copy(x, tp)
        h = self.drop(F.gelu(self.fc1(x)), deterministic, generator, tp)  # erf
        return self.drop(self.fc2(h, tp), deterministic, generator)


def apply_ln_mlp_residual(x, norm: LayerNorm, mlp: Mlp) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN(x)))) through the fused K2 dispatcher
    (``ops/fused_mlp.py``): the matmul operands are in ``x.dtype``, which
    on every lifter path equals the blocks' compute dtype."""
    return ln_mlp_residual(
        x, norm.scale, norm.bias, mlp.fc1.kernel, mlp.fc1.bias,
        mlp.fc2.kernel, mlp.fc2.bias, norm.eps,
    )


class Attention(nn.Module):
    """Multi-head self-attention over a short token axis.

    ``impl``: "einsum" (plain torch), "fused" (K3: the whole attention with
    qkv and proj in one kernel, for the 5-token res blocks) or "grouped"
    (K4: the softmax middle as a kernel, qkv and proj as plain matmuls, for
    the 17-token joint blocks).

    Under tensor parallelism (``tp``, set by ``parallel.tensor.
    shard_model``; einsum only) qkv holds this rank's heads and proj their
    rows: the input is ``copy``-ed in, the rank's heads attend, and proj's
    partial products are all-reduced before its bias."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype=None, impl: str = "einsum", attn_drop: float = 0.0,
                 proj_drop: float = 0.0, device=None):
        super().__init__()
        if impl not in ("einsum", "fused", "grouped"):
            raise ValueError(f"unknown attention impl {impl!r}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.impl = impl
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype,
                          device=device)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        self.tp = None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        b, n, c = x.shape
        droppable = not (self.attn_drop.active(deterministic)
                         or self.proj_drop.active(deterministic))
        if self.impl == "grouped" and droppable:
            out = attention_middle(self.qkv(x), self.num_heads)
            return self.proj(out)
        if self.impl == "fused" and droppable:
            # the weights go as they are: the kernel casts them once per
            # parameter state, the plain version per call
            bq = self.qkv.bias
            if bq is None:
                bq = torch.zeros(3 * c, device=x.device)
            return small_attention(
                x.to(self.dtype or x.dtype), self.qkv.kernel, bq,
                self.proj.kernel, self.proj.bias, self.num_heads,
            )
        tp, heads, width = self.tp, self.num_heads, c
        if tp is not None:
            x = tensor.copy(x, tp)
            heads, width = heads // tp.size, width // tp.size
        q, k, v = _heads_split(self.qkv(x), width, heads)
        if self.attn_drop.active(deterministic):
            a = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
            a = torch.softmax(a * q.shape[-1] ** -0.5, dim=-1)
            a = self.attn_drop(a, deterministic, generator, tp,
                               axis=1).to(v.dtype)
            o = torch.einsum("bhnm,bmhd->bnhd", a, v)
        else:
            o = softmax_middle(q, k, v)
        o = o.reshape(b, n, width)
        return self.proj_drop(self.proj(o, tp), deterministic, generator)


class Block(nn.Module):
    """Pre-norm transformer block, LayerNorm eps 1e-6.

    ``mlp_impl``: "einsum" (LayerNorm + Mlp, plain torch) or "fused" (the
    K2 dispatcher; same parameters), the latter only while dropout and
    drop-path are inactive (``layers.py:295-297``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 qkv_bias: bool = True, ln_eps: float = 1e-6, dtype=None,
                 ln_dtype=torch.float32, attn_impl: str = "einsum",
                 mlp_impl: str = "einsum", drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        if mlp_impl not in ("einsum", "fused"):
            raise ValueError(f"unknown mlp impl {mlp_impl!r}")
        self.mlp_impl = mlp_impl
        self.norm1 = LayerNorm(dim, ln_eps, ln_dtype, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype, attn_impl,
                              attn_drop_rate, drop_rate, device=device)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, ln_eps, ln_dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype, drop_rate,
                       device=device)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        h = self.attn(self.norm1(x), deterministic, generator)
        x = x + self.drop_path1(h, deterministic, generator)
        if self.mlp_impl == "fused" and not (
                self.mlp.drop.active(deterministic)
                or self.drop_path2.active(deterministic)):
            return apply_ln_mlp_residual(x, self.norm2, self.mlp)
        h = self.mlp(self.norm2(x), deterministic, generator)
        return x + self.drop_path2(h, deterministic, generator)
