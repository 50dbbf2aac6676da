"""One rank of the port's multi-process CLI checks
(tests/test_torch_parallel.py); not collected by pytest.

Started as torchrun starts a rank (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) with
the output directory as its argument. Through the CLIs' own
``--distributed``, on the CPU (gloo) at the tiny size: the int8 deploy
graph of ``h36m_hrnet_32_deploy`` evaluated (each rank calibrates on its
own shard, then serves rank 0's scales), ``allgather_hosts`` on 3 and 2
rows, a 3DHP evaluation (sequence indices gathered beside the
predictions), and one training epoch on train shards of unequal length.
Writes ``rank<r>.npz``.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def uneven_epoch() -> dict:
    """One epoch of the tiny DDP ``Trainer`` on 15 train rows at batch 4,
    sharded as the CLIs shard them: 7 rows on rank 0, 8 on rank 1."""
    import numpy as np
    import torch

    from contextaware_poseformer_tpu_torch.data.synthetic import (
        SyntheticPoseDataset,
    )
    from contextaware_poseformer_tpu_torch.parallel import (
        distributed,
        dryrun,
    )
    from contextaware_poseformer_tpu_torch.train import train_h36m
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    train, val = train_h36m.shard_datasets(
        *(SyntheticPoseDataset(size=15, image_shape=(64, 64), seed=s)
          for s in (0, 99)), distributed.topology())
    trainer = Trainer(dryrun.config(4), train, val, "cpu")
    state = trainer.init_state(0)
    epoch = trainer.train_epoch(state, 0)
    params = torch.cat([p.detach().reshape(-1)
                        for p in state.model.lifter.parameters()])
    return {"uneven_rows": len(train), "uneven_steps": epoch["steps"],
            "uneven_steps_per_epoch": trainer.steps_per_epoch,
            "uneven_params": params.numpy()}


def main() -> None:
    out = sys.argv[1]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from contextaware_poseformer_tpu_torch.models.backbone_common import (
        calibration_buffers,
    )
    from contextaware_poseformer_tpu_torch.parallel import distributed
    from contextaware_poseformer_tpu_torch.train import (
        train_3dhp,
        train_h36m,
    )

    common = ["--tiny", "--synthetic", "--device", "cpu", "--eval",
              "--batch-size", "4", "--logdir", "", "--distributed"]
    _, state, deploy = train_h36m.main(
        ["--preset", "h36m_hrnet_32_deploy", "--eval-batches", "1", *common])
    rank = distributed.rank()
    calib = {f"calib/{k}": v.cpu().numpy() for k, v in
             calibration_buffers(state.model.backbone).items()}
    rows = 3 if rank == 0 else 2
    local = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2) + 10 * rank
    gathered = distributed.allgather_hosts(local)
    gathered_int = distributed.allgather_hosts(
        np.full(rows, rank, dtype=np.int64))
    _, _, mpi = train_3dhp.main(common)
    uneven = uneven_epoch()
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             world=distributed.world_size(), deploy_p1=deploy["p1_mm"],
             gathered=gathered, gathered_int=gathered_int,
             mpi_p1=mpi["p1_mm"], mpi_pck=mpi["pck"], **calib, **uneven)
    distributed.shutdown()


if __name__ == "__main__":
    main()
