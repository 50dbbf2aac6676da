"""Multi-process initialisation and the host-side collectives.

Port of ``contextaware_poseformer_tpu/parallel/distributed.py:24-150``. The
reference's distributed story is ``torch.distributed.launch`` with NCCL and
env:// rendezvous (ContextPose/train.py:216-249, README.md:110-127); the
port keeps it: one process a device, started by torchrun::

  torchrun --nproc_per_node 8 -m \\
      contextaware_poseformer_tpu_torch.train.train_h36m --distributed

``initialize`` joins the process group (NCCL for CUDA, one rank a device,
``cuda:LOCAL_RANK``; gloo for the CPU), after which ``train/loop.Trainer``
wraps its trainable model in ``DistributedDataParallel`` and each rank
holds only its own rows of the global batch (there is no ``put_batch``:
the global batch is world size x the per-rank batch, as the JAX package's
``put_batch`` makes it). Evaluation gathers the ranks' results with
``allgather_hosts``; an int8 deploy model serves rank 0's calibration
(``broadcast_pytree``).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def initialize(device: str = "cuda", backend: str | None = None,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None) -> dict:
    """Join the process group; a no-op when it is already joined, and for
    a single process that neither torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) nor the arguments make
    part of one. ``backend`` defaults to NCCL for a CUDA ``device`` and
    gloo for the CPU; ``init_method`` to ``env://``. A CUDA rank takes
    ``cuda:LOCAL_RANK`` (``local_device``). Returns the topology, as the
    JAX package's ``initialize``: ``process_index``, ``process_count``,
    ``local_devices`` (one a rank) and ``global_devices``."""
    if not dist.is_initialized():
        env_world = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size is None and init_method is None and env_world == 1:
            return topology()
        device = torch.device(device)
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(local_device(device))
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=int(os.environ["RANK"]) if rank is None else rank,
            world_size=env_world if world_size is None else world_size)
    return topology()


def topology() -> dict:
    world = world_size()
    return {"process_index": rank(), "process_count": world,
            "local_devices": 1, "global_devices": world}


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size(group=None) -> int:
    """The ranks of ``group`` (default: the world); 1 outside a process
    group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def local_device(device) -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    ``cuda:LOCAL_RANK`` (0 outside torchrun); any other stays as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _collective_device() -> torch.device:
    """Where the host-side collectives stage their tensors: NCCL reduces
    only CUDA tensors, gloo takes host tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_rows(x):
    """This process's rows of a batch: with DDP a rank holds only its own,
    so this is the batch itself (the JAX package's ``local_rows`` picks a
    process's shards out of a global array)."""
    return x


def allgather_hosts(local, group=None) -> np.ndarray:
    """Concatenate per-rank arrays along axis 0 in rank order, allowing
    DIFFERENT lengths per rank: gather the counts, pad to the largest,
    gather, trim, concatenate (``distributed.py:69-93``; the reference's
    padded all_gather and ``dist_size`` trim, ContextPose/train.py:216-226).
    ``group``: the ranks gathered (default every rank; under tensor
    parallelism the data group, whose ranks hold distinct rows). A single
    process gets its array back."""
    local = np.ascontiguousarray(local)
    if world_size(group) == 1:
        return local
    dev = _collective_device()
    n = torch.tensor([local.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(n) for _ in range(world_size(group))]
    dist.all_gather(counts, n, group=group)
    counts = [int(c.item()) for c in counts]
    rows = torch.zeros((max(counts), *local.shape[1:]),
                       dtype=torch.from_numpy(local[:0]).dtype, device=dev)
    rows[:local.shape[0]] = torch.from_numpy(local).to(dev)
    parts = [torch.empty_like(rows) for _ in counts]
    dist.all_gather(parts, rows, group=group)
    return np.concatenate([p[:c].cpu().numpy()
                           for p, c in zip(parts, counts)], axis=0)


def broadcast_pytree(tree: Any) -> Any:
    """Rank 0's values to every rank, in place for tensors (a tensor, or a
    dict / list / tuple of them, with the same structure and shapes on
    every rank); returns ``tree``. A single process: identity."""
    if world_size() == 1:
        return tree
    dev = _collective_device()
    for t in _tensors(tree):
        buf = t.detach().to(dev)
        dist.broadcast(buf, 0)
        with torch.no_grad():
            t.copy_(buf)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        raise TypeError(f"broadcast_pytree: {type(tree).__name__} leaf")


def mean_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of a tensor over the ranks of ``group`` (default every
    rank; a sum all-reduce: gloo has no average), as a new tensor; in a
    group of one the tensor itself."""
    if world_size(group) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / world_size(group)


def min_over_ranks(n: int) -> int:
    """The least of an integer over the ranks; in a world of one, ``n``."""
    if world_size() == 1:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
