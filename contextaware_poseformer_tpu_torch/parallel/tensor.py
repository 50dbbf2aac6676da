"""The lifter's tensor parallelism: Megatron's split of its Linears.

Port of the "model" axis of ``contextaware_poseformer_tpu/parallel/
mesh.py:50-80``, where it is a GSPMD annotation (``_lifter_spec``: qkv and
fc1 kernels split by columns, proj and fc2 by rows). Here the collectives
are written out, over the ranks of one model group (``mesh.Mesh``):

- ``copy`` at a block's input: identity forward, all-reduce backward (the
  gradient of a replicated input is the sum of the ranks' partial ones);
- ``reduce`` at its output: all-reduce forward, identity backward.

``Attention`` and ``Mlp`` (``models/layers.py``) run on their rank's shard
between the two: rank ``r`` of ``tp`` holds heads ``[r*h/tp, (r+1)*h/tp)``
of qkv (their q, k and v columns: ``SPLIT_QKV``; JAX's ``P(None,
"model")`` cuts the 3c columns contiguously and relies on GSPMD's
re-layout, so the shards differ from JAX's while the split set and the
numbers are the same), columns ``[r*H/tp, (r+1)*H/tp)`` of fc1, and the
matching rows of proj and fc2, whose bias is added once, after the
all-reduce. Everything else is replicated: every rank of a model group
computes it alike from the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

COLUMNS, ROWS, SPLIT_QKV = "columns", "rows", "qkv"


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A module's place in its model group: ``size`` ranks, this one
    ``rank``, the ``torch.distributed`` group."""

    size: int
    rank: int
    group: object


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Identity forward, all-reduce (sum) of the gradient backward."""
    return _Copy.apply(x, tp.group)


def reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward."""
    return _Reduce.apply(x, tp.group)


# (module leaf names, split) of the split parameters: a name ending in one
# of these under an ``attn`` / ``mlp`` module; the axis is the one split
_SPLITS = {("attn", "qkv", "kernel"): (SPLIT_QKV, 1),
           ("attn", "qkv", "bias"): (SPLIT_QKV, 0),
           ("attn", "proj", "kernel"): (ROWS, 0),
           ("mlp", "fc1", "kernel"): (COLUMNS, 1),
           ("mlp", "fc1", "bias"): (COLUMNS, 0),
           ("mlp", "fc2", "kernel"): (ROWS, 0)}


def split_of(path) -> tuple[str, int] | None:
    """The split of a parameter by its path (a dotted port name, or a flax
    path whose ``dense`` level is dropped): (kind, axis), or None for a
    replicated one."""
    names = path.split(".") if isinstance(path, str) else list(path)
    names = [n for n in names if n != "dense"]
    return _SPLITS.get(tuple(names[-3:]))


def _pieces(x, kind: str, axis: int, tp: int):
    """``x`` cut into ``tp`` shards along ``axis`` (qkv: each of q, k and v
    cut alike, heads kept whole)."""
    if kind != SPLIT_QKV:
        return np.split(x, tp, axis) if isinstance(x, np.ndarray) else \
            torch.chunk(x, tp, axis)
    shape = x.shape
    three = shape[:axis] + (3, shape[axis] // 3) + shape[axis + 1:]
    x3 = x.reshape(three)
    parts = (np.split(x3, tp, axis + 1) if isinstance(x3, np.ndarray)
             else torch.chunk(x3, tp, axis + 1))
    return [p.reshape(shape[:axis] + (-1,) + shape[axis + 1:]) for p in parts]


def shard(x, split: tuple[str, int], rank: int, tp: int):
    """Rank ``rank``'s shard of a full parameter (numpy or torch)."""
    return _pieces(x, *split, tp)[rank]


def unshard(parts, split: tuple[str, int]):
    """The full parameter from its ``tp`` shards in rank order (the
    inverse of ``shard``)."""
    kind, axis = split
    cat = (np.concatenate if isinstance(parts[0], np.ndarray)
           else torch.cat)
    if kind != SPLIT_QKV:
        return cat(parts, axis)
    s = parts[0].shape
    three = [p.reshape(s[:axis] + (3, s[axis] // 3) + s[axis + 1:])
             for p in parts]
    full = cat(three, axis + 1)
    return full.reshape(s[:axis] + (-1,) + s[axis + 1:])


def splits(lifter: torch.nn.Module) -> dict[str, tuple[str, int]]:
    """The split parameters of ``lifter`` by state-dict name."""
    return {name: sp for name, _ in lifter.named_parameters()
            if (sp := split_of(name)) is not None}


def shard_model(lifter: torch.nn.Module, mesh) -> None:
    """Keep this rank's shard of every split parameter of ``lifter`` (a
    full model, the same on every rank), in place, and hand its
    ``Attention`` and ``Mlp`` modules their ``TensorParallel``; a no-op at
    ``mesh.model == 1``."""
    from contextaware_poseformer_tpu_torch.models.layers import (
        Attention,
        Mlp,
    )

    if mesh.model == 1:
        return
    tp = TensorParallel(mesh.model, mesh.model_rank, mesh.model_group)
    params = dict(lifter.named_parameters())
    with torch.no_grad():
        for name, sp in splits(lifter).items():
            p = params[name]
            p.data = shard(p.data, sp, tp.rank, tp.size).contiguous().clone()
    for m in lifter.modules():
        if isinstance(m, (Attention, Mlp)):
            m.tp = tp


def _all_gather(t: torch.Tensor, tp: TensorParallel) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on each) in rank order; on a gloo
    group the tensors go through the host."""
    dev = t.device
    if dist.get_backend(tp.group) != "nccl":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t.contiguous(), group=tp.group)
    return [p.to(dev) for p in parts]


def model_tp(lifter: torch.nn.Module) -> TensorParallel | None:
    """The ``TensorParallel`` of a sharded lifter, None for a whole one."""
    from contextaware_poseformer_tpu_torch.models.layers import Mlp

    for m in lifter.modules():
        if isinstance(m, Mlp):
            return m.tp
    return None


def full_state(lifter: torch.nn.Module, optimizer_state: dict | None = None):
    """The whole lifter's state dict (and, given one, the optimizer state
    dict with its moments made whole) from the shards of every rank of the
    model group: a collective over it. A whole lifter's come back as they
    are."""
    tp = model_tp(lifter)
    sd = lifter.state_dict()
    if tp is None:
        return sd, optimizer_state
    sp = splits(lifter)
    full = {k: (unshard(_all_gather(v, tp), sp[k]) if k in sp else v)
            for k, v in sd.items()}
    return full, _map_moments(lifter, optimizer_state, sp,
                              lambda v, s: unshard(_all_gather(v, tp), s))


def shard_state(lifter: torch.nn.Module, state: Mapping,
                optimizer_state: dict | None = None):
    """``full_state``'s inverse for this rank of ``lifter``'s model group:
    the whole state dict's (and optimizer state's) shards. A whole lifter
    takes them as they are."""
    tp = model_tp(lifter)
    if tp is None:
        return dict(state), optimizer_state
    sp = splits(lifter)
    sd = {k: (shard(v, sp[k], tp.rank, tp.size).contiguous().clone()
              if k in sp else v) for k, v in state.items()}
    return sd, _map_moments(
        lifter, optimizer_state, sp,
        lambda v, s: shard(v, s, tp.rank, tp.size).contiguous().clone())


def _map_moments(lifter, optimizer_state, sp, fn):
    """``optimizer_state`` with ``fn(tensor, split)`` applied to every
    per-element moment of a split parameter (the optimizer's parameters
    are ``lifter.parameters()`` in order)."""
    if optimizer_state is None:
        return None
    names = [n for n, _ in lifter.named_parameters()]
    out = {**optimizer_state, "state": {}}
    for i, st in optimizer_state["state"].items():
        s = sp.get(names[int(i)])
        out["state"][i] = {k: (fn(v, s) if s is not None and k != "step"
                               else v) for k, v in st.items()}
    return out
