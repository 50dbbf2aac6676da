"""Fused multi-head self-attention for very short sequences (K3): CUDA
kernel wrapper, plain version and dispatcher.

Port of ``contextaware_poseformer_tpu/ops/small_attention.py:41-159``: x
(R, N, D) -> qkv -> softmax(q k^T / sqrt(hd)) v -> proj, with qkv and the
output projection inside the kernel (``csrc/small_attention.cu``). qkv,
scores and softmax are fp32; the attention output is rounded to the call's
dtype before the projection. The TPU kernel's token-on-lanes layout and
one-hot head reducers are TPU formulations and are not carried over.

Routes (``plan``): bf16 at the lifters' widths (D = 128, 64, 96) runs on
the tensor cores (``wgmma``), 64-token tiles of whole rows, qkv a head group
at a time, the weights resident in shared memory; its operands (Wqkv^T with
its rows in head-group order, Wproj^T, both bf16, and the fp32 biases of the
bf16 values) are made once per parameter state (``kernel_operands``). fp32,
and bf16 at any other width (D a multiple of 16 from 32 to 128, head dims
a multiple of 4), run exact FMAs on the CUDA cores, register-tiled over
48-token tiles of whole rows in persistent blocks, the fp32 weights
streamed through shared memory in K-slices; they read the weights as fp32
holding their values cast to the call's dtype (``cores_operands``: the
parameters themselves in fp32).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from contextaware_poseformer_tpu_torch.ops import _build

launches = 0  # kernel launches made by small_attention_kernel

MAX_TOKENS = 20  # tokens a row on the CUDA-core body
# the CUDA-core body (csrc/small_attention.cu): tokens a tile (whole rows),
# K a slice of the weights' ring (3 slots), widths it takes (3D threads)
CORES_TILE, CORES_BK, CORES_STAGES = 48, 16, 3
CORES_WIDTHS = (32, 128)  # D from, to (a multiple of CORES_BK)
MAX_TOKENS_TC = 16  # tokens a row on the tensor-core route
TILE = 64  # tokens of a tensor-core tile (wgmma's M), whole rows
# (D, head dim) -> heads a group on the tensor-core route: the group's q, k
# and v columns, 3 * group * head dim, are one wgmma width (96, 96, 72)
TC_SHAPES = {(128, 16): 2, (64, 8): 4, (96, 12): 2}


@dataclass(frozen=True)
class Plan:
    route: str  # "tensor-core" (bf16) or "cuda-core"
    group: int  # heads a group (tensor-core route; 0 on the CUDA cores)
    rows_per_tile: int  # whole rows of N tokens a tile


def smem_bytes(d: int, hd: int, group: int) -> int:
    """Dynamic shared memory of the tensor-core route (mirrors ``Tc`` in
    csrc/small_attention.cu): Wqkv^T, Wproj^T, the x and o tiles in
    swizzled 64-value chunks, two fp32 exchange tiles, 1 KB of alignment."""
    chunks = -(-d // 64)
    ng = 3 * group * hd
    return (1024 + chunks * 3 * d * 128 + chunks * d * 128
            + 2 * chunks * TILE * 128 + 2 * TILE * (ng + 4) * 4)


def cores_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the CUDA-core body (``cores_smem`` in
    csrc/small_attention.cu): the x, qkv and o tiles in fp32 (rows padded
    by 4 values) and the ring of weight slices."""
    return 4 * (2 * CORES_TILE * (d + 4) + CORES_TILE * (3 * d + 4)
                + CORES_STAGES * CORES_BK * 3 * d)


def plan(dtype: torch.dtype, n: int, d: int, num_heads: int) -> Plan:
    """The route for a call: bf16 on the tensor cores at the instantiated
    (D, head dim) pairs with N <= 16; fp32, and bf16 at any other shape, on
    the CUDA cores with N <= 20, D a multiple of 16 from 32 to 128 and a
    head dim that is a multiple of 4; ValueError for what no route
    takes."""
    if d % num_heads:
        raise ValueError(f"small_attention: D={d} is not a multiple of "
                         f"heads={num_heads}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"small_attention: the CUDA kernel takes float32 or "
                        f"bfloat16, got {dtype}")
    group = TC_SHAPES.get((d, d // num_heads))
    if dtype == torch.bfloat16 and group is not None and n <= MAX_TOKENS_TC:
        return Plan("tensor-core", group, TILE // n)
    lo, hi = CORES_WIDTHS
    if (n > MAX_TOKENS or d % CORES_BK or not lo <= d <= hi
            or (d // num_heads) % 4):
        raise ValueError(f"small_attention: the CUDA cores take N <= "
                         f"{MAX_TOKENS}, D a multiple of {CORES_BK} from "
                         f"{lo} to {hi} and a head dim that is a multiple "
                         f"of 4, got N={n} D={d} heads={num_heads}")
    return Plan("cuda-core", 0, CORES_TILE // n)


def head_group_order(d: int, num_heads: int, group: int) -> torch.Tensor:
    """The qkv columns in the tensor-core route's order: for each group of
    ``group`` heads, their q columns, then their k, then their v."""
    hd = d // num_heads
    span = torch.arange(group * hd)
    return torch.cat([part * d + g * group * hd + span
                      for g in range(num_heads // group)
                      for part in range(3)])


def kernel_operands(wqkv, bqkv, wproj, bproj, num_heads, group):
    """(Wqkv^T (3D, D) bf16 with its rows in head-group order, the qkv bias
    in that order, Wproj^T (D, D) bf16, the proj bias): what the
    tensor-core route reads, each made once per parameter state
    (``_build.cached_operand``). The biases are the fp32 values of their
    bf16 casts, as the plain version adds them."""
    d = wproj.shape[0]
    tag = ("k3", num_heads, group)

    def order():
        return head_group_order(d, num_heads, group).to(wqkv.device)

    return (
        _build.cached_operand(wqkv, tag, lambda w: w.to(torch.bfloat16)[
            :, order()].t().contiguous()),
        _build.cached_operand(bqkv, tag, lambda b: b.to(torch.bfloat16)[
            order()].float()),
        _build.cached_operand(wproj, tag, lambda w: w.t().to(
            torch.bfloat16).contiguous()),
        _build.cached_operand(bproj, tag, lambda b: b.to(
            torch.bfloat16).float()),
    )


def cores_operands(wqkv, bqkv, wproj, bproj, dtype):
    """(Wqkv, bqkv, Wproj, bproj) as the CUDA-core body reads them: fp32,
    contiguous, holding their values cast to ``dtype``: an fp32 parameter
    itself in an fp32 call, else made once per parameter state
    (``_build.cached_operand``)."""
    def make(v):
        return v.to(dtype).float().contiguous()

    return tuple(
        t if dtype == torch.float32 and t.dtype == torch.float32
        and t.is_contiguous()
        else _build.cached_operand(t, ("k3cores", dtype), make)
        for t in (wqkv, bqkv, wproj, bproj))


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
    """Plain version, in ``x.dtype`` like the JAX reference (the weights
    are cast to it)."""
    r, n, d = x.shape
    wqkv, bqkv, wproj, bproj = (t.to(x.dtype) for t in (wqkv, bqkv, wproj,
                                                         bproj))
    q, k, v = _heads_split(x @ wqkv + bqkv, d, num_heads)
    o = softmax_middle(q, k, v).reshape(r, n, d)
    return o @ wproj + bproj


def small_attention_kernel(x, wqkv, bqkv, wproj, bproj, num_heads):
    """The CUDA kernel: x (R, N, D) in fp32 or bf16; the weights in any
    float dtype, used as cast to ``x.dtype``. Under autograd the backward is
    the plain version's VJP."""
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
    expect = ((d, 3 * d), (3 * d,), (d, d), (d,))
    for t, shape in zip((wqkv, bqkv, wproj, bproj), expect):
        if t.shape != shape or not t.is_floating_point():
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} floating point")
    p = plan(x.dtype, n, d, num_heads)
    if p.route == "cuda-core":
        ops = list(cores_operands(wqkv, bqkv, wproj, bproj, x.dtype))
    else:
        ops = list(kernel_operands(wqkv, bqkv, wproj, bproj, num_heads,
                                   p.group))
    _build.require_cuda(name, x, *ops)
    out = torch.empty_like(x)
    if any(t.data_ptr() % 16 for t in (x, out, ops[0], ops[2])):
        raise ValueError(f"{name}: x, out and the weights must start on a "
                         "16-byte boundary (16-byte cp.async)")
    lib = _build.library()
    err = lib.capf_small_attention(
        code, *(t.data_ptr() for t in (x, *ops, out)), r, n, d, num_heads,
        p.group, *_build.launch_target(x),
    )
    _build.check(lib, err, name)
    launches += 1
    return out


def small_attention(x, wqkv, bqkv, wproj, bproj, num_heads: int):
    """Dispatcher: the plain version for a CPU tensor, the CUDA kernel for
    any other (which raises unless it is a CUDA tensor). The weights may be
    in any float dtype; both routes use them cast to ``x.dtype``."""
    if x.device.type == "cpu":
        return attention_reference(x, wqkv, bqkv, wproj, bproj, num_heads)
    return small_attention_kernel(x, wqkv, bqkv, wproj, bproj, num_heads)
