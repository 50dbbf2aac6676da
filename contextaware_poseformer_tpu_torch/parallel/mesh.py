"""The device mesh of multi-process training: a data axis and a model axis.

Port of ``contextaware_poseformer_tpu/parallel/mesh.py:33-80``. The JAX
package lays its devices on a ("data", "model") mesh, row-major, and lets
GSPMD insert the collectives: the batch is split on "data", and the
lifter's transformer Linears on "model" (Megatron: qkv and fc1 by columns,
proj and fc2 by rows, ``_lifter_spec``). The port lays its ranks out the
same way, ``(world // tp, tp)`` row-major: ranks ``[k*tp, (k+1)*tp)`` form
model group ``k``, which holds one shard of the data and splits the lifter
between its ranks (``parallel/tensor.py``, the collectives written out);
ranks equal modulo ``tp`` form a data group, over which
``DistributedDataParallel`` averages the gradients
(ContextPose/train.py:240-249,361-362, the reference's only strategy).

Training reaches the split Linears only on the einsum route: the Trainer
runs the preset configs, whose attention and MLP are einsum, and the fused
kernels (K2, K3, K4) serve only (the JAX package cannot train through
their Pallas calls either: they have no VJP). So ``tp > 1`` needs no
kernel of its own; the kernels on its path, K1 and K6, run replicated on
every rank of a model group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from contextaware_poseformer_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks; this process's global ``rank``, its
    place on each axis (``data_rank``: ``rank // model``, which seeds its
    draws; ``model_rank``: ``rank % model``), its ``device``, and
    the ``torch.distributed`` groups of its two axes (None: the default
    group for ``data_group`` when ``model == 1``; no ``model_group`` then,
    there being nothing to reduce)."""

    data: int
    rank: int
    device: torch.device
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: object = None
    model_group: object = None


def check_tensor_parallel(model_parallel: int, lifter=None,
                          world: int | None = None) -> None:
    """Refuse what ``model_parallel`` cannot split, with a message: a world
    of ``world`` ranks it does not divide; with a ``LifterConfig``, a head
    count or hidden width of a split block it does not divide, and (for
    ``model_parallel > 1``) attention or MLP routed through the fused
    kernels (K2, K3, K4), which compute a whole block and have no
    backward."""
    tp = model_parallel
    if tp < 1:
        raise ValueError(f"model_parallel={tp}: must be at least 1")
    if world is not None and world % tp:
        raise ValueError(f"{world} ranks not divisible by "
                         f"model_parallel={tp}")
    if lifter is None or tp == 1:
        return
    routes = {"attention": lifter.attention,
              "attention_joint": lifter.attention_joint, "mlp": lifter.mlp}
    fused = {k: v for k, v in routes.items() if v != "einsum"}
    if fused:
        raise ValueError(
            f"model_parallel={tp} splits the lifter's Linears on the einsum "
            f"route only; this config routes {fused} through fused kernels "
            "(K2, K3, K4: whole blocks, serving only, no backward)")
    d = lifter.embed_dim_ratio
    widths = {"heads": lifter.num_heads,
              "hidden": int(d * lifter.mlp_ratio),
              "joint hidden": int(d * (lifter.levels + 1) * lifter.mlp_ratio)}
    bad = {k: v for k, v in widths.items() if v % tp}
    if bad:
        raise ValueError(f"model_parallel={tp} does not divide the split "
                         f"blocks' {bad}")


def make_mesh(model_parallel: int = 1, device="cuda", lifter=None) -> Mesh:
    """The (data, model) mesh over every rank of the process group (a
    single process: 1 x 1), after ``check_tensor_parallel``. With
    ``model_parallel > 1`` every rank makes every group (a collective:
    call it on all ranks alike)."""
    tp = model_parallel
    world, rank = distributed.world_size(), distributed.rank()
    check_tensor_parallel(tp, lifter, world)
    device = distributed.local_device(device)
    data_group = model_group = None
    if tp > 1:
        for k in range(world // tp):  # ranks [k*tp, (k+1)*tp): a model group
            g = dist.new_group(list(range(k * tp, (k + 1) * tp)))
            if rank // tp == k:
                model_group = g
        for r in range(tp):  # ranks equal modulo tp: one data group
            g = dist.new_group(list(range(r, world, tp)))
            if rank % tp == r:
                data_group = g
    return Mesh(world // tp, rank, device, tp, rank // tp, rank % tp,
                data_group, model_group)
