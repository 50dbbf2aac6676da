"""Checkpoints with the best-P1 policy and true resume.

Port of ``contextaware_poseformer_tpu/train/checkpoint.py:19-69`` on
``torch.save``: every save holds the lifter's parameters, the optimizer
state, the update count, the epoch and the epoch's P1, so a run resumes
where it stopped. The frozen backbone is not saved: it is rebuilt from the
same seed (or, later, from its checkpoint). The manager keeps the
``max_to_keep`` newest epochs and, beside them, the best one (smallest P1),
and records both in ``index.json``: ``latest`` for resume, ``best`` for the
reference's best-P1 checkpoint. A checkpoint always holds the whole lifter
(tensor-parallel shards gathered), so it restores at any
``model_parallel``.
"""

from __future__ import annotations

import json
import os

import torch

from contextaware_poseformer_tpu_torch.parallel import tensor
from contextaware_poseformer_tpu_torch.train.steps import TrainState


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:05d}.pt")

    def _index_path(self) -> str:
        return os.path.join(self.directory, "index.json")

    def _index(self) -> dict:
        try:
            with open(self._index_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {"p1_mm": {}}

    def save(self, epoch: int, state: TrainState,
             metrics: dict[str, float], write: bool = True) -> None:
        """Save epoch ``epoch``. A lifter split by tensor parallelism is
        gathered whole first, a collective over its model group: every
        rank calls ``save``, and only the one with ``write`` writes."""
        lifter, optimizer = tensor.full_state(state.model.lifter,
                                              state.optimizer.state_dict())
        if not write:
            return
        payload = {
            "lifter": lifter,
            "optimizer": optimizer,
            "step": state.step,
            "epoch": epoch,
            "metrics": dict(metrics),
        }
        tmp = self._path(epoch) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))  # a reader never sees half a file
        index = self._index()
        p1 = index["p1_mm"]
        p1[str(epoch)] = float(metrics["p1_mm"])
        epochs = sorted(int(e) for e in p1)
        best = min(epochs, key=lambda e: (p1[str(e)], e))
        keep = set(epochs[-self.max_to_keep:]) | {best}
        for e in epochs:
            if e not in keep:
                del p1[str(e)]
                if os.path.exists(self._path(e)):
                    os.unlink(self._path(e))
        index.update(latest=epochs[-1], best=best)
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1)
        os.replace(tmp, self._index_path())

    def restore(self, state: TrainState, epoch=None) -> tuple[TrainState, int]:
        """Load epoch ``epoch`` (an int, "best", or None for the latest)
        into ``state`` in place; returns (state, the epoch to run next)."""
        index = self._index()
        if epoch == "best":
            epoch = index.get("best")
        elif epoch is None:
            epoch = index.get("latest")
        if epoch is None:
            return state, 0
        payload = torch.load(self._path(epoch), map_location="cpu",
                             weights_only=True)
        lifter, optimizer = tensor.shard_state(
            state.model.lifter, payload["lifter"], payload["optimizer"])
        state.model.lifter.load_state_dict(lifter)
        state.optimizer.load_state_dict(optimizer)
        state.step = int(payload["step"])
        return state, int(payload["epoch"]) + 1

    def best_epoch(self) -> int | None:
        return self._index().get("best")

    def latest_epoch(self) -> int | None:
        return self._index().get("latest")
