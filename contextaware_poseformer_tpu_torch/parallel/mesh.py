"""The data axis of multi-device training.

Port of ``contextaware_poseformer_tpu/parallel/mesh.py:34-80``. The JAX
package lays its devices on a ("data", "model") mesh and lets GSPMD insert
the gradient all-reduce; the port runs the reference's only multi-device
strategy, data parallelism over NCCL (DistributedDataParallel,
ContextPose/train.py:240-249,361-362), so its mesh is the data axis alone:
the world size, this rank and this rank's device.

The "model" axis (the lifter's Megatron split of qkv/fc1 by columns and
proj/fc2 by rows) is refused: those blocks run inside fused kernels (fc1/fc2
in K2, qkv/proj in K3 and K4), and a split needs each kernel to emit a
partial sum that is all-reduced before the residual add (ROADMAP [11b]).
"""

from __future__ import annotations

import dataclasses

import torch

from contextaware_poseformer_tpu_torch.parallel import distributed

TENSOR_PARALLEL_REFUSED = (
    "model_parallel > 1 (the lifter's tensor parallelism) is not ported: "
    "its blocks run inside fused kernels (K2, K3, K4), which would have to "
    "emit partial sums all-reduced before the residual add (ROADMAP [11b])")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: ``data`` ranks, this process's ``rank`` on it, and
    the device it computes on."""

    data: int
    rank: int
    device: torch.device


def make_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """The data axis over every rank of the process group (a single
    process: one); refuses ``model_parallel > 1`` (ROADMAP [11b])."""
    if model_parallel != 1:
        raise NotImplementedError(TENSOR_PARALLEL_REFUSED)
    return Mesh(distributed.world_size(), distributed.rank(),
                distributed.local_device(device))
