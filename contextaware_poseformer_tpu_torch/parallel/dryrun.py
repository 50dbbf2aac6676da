"""Multi-process dry run of data-parallel training.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
and ``dryrun_multiprocess`` (``__graft_entry__.py:75,354``): ``run`` spawns
``nproc`` processes that join one process group (gloo on the CPU or for
several ranks on one card, NCCL with one rank a card), train the tiny model
(``train_h36m.tiny`` of ``h36m_hrnet_32``'s recipe) through the ``Trainer`` under
``DistributedDataParallel`` for a few steps, evaluate, and send back their
losses, P1 and lifter parameters, and gather rows of unequal counts (3 on
even ranks, 2 on odd ones) through ``allgather_hosts``. It fails unless the
loss falls, every rank holds the same parameters and reports the same P1,
and every rank gathered every rank's rows in rank order. ``reference``
trains the same model in one process on the ranks' rows concatenated:
with augmentation and dropout off (``config``), a data-parallel run must
reach its parameters up to the summation order::

  python -m contextaware_poseformer_tpu_torch.parallel.dryrun --nproc 2

runs on the card, NCCL with one rank a card (with fewer cards than ranks,
pass ``--backend gloo``); ``--device cpu`` runs over gloo on the host.

Each step of a run sees the same rows (a train set of exactly one global
batch), so the loss falls within a few steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import queue as queue_lib
import socket
import traceback

import numpy as np
import torch

from contextaware_poseformer_tpu_torch import config as cfglib

BATCH = 4  # rows a rank a step
STEPS = 4
SEED = 0


def config(batch: int = BATCH) -> cfglib.Config:
    """The tiny model (``train_h36m.tiny``: a width-8 HRNet, lifter embed
    32 depth 2, 64x64 frames) with augmentation and dropout off, one host
    worker."""
    from contextaware_poseformer_tpu_torch.train import train_h36m

    cfg = train_h36m.tiny(cfglib.preset("h36m_hrnet_32"))
    lifter = dataclasses.replace(cfg.model.lifter, drop_rate=0.0,
                                 attn_drop_rate=0.0, drop_path_rate=0.0)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, lifter=lifter),
        train=dataclasses.replace(cfg.train, batch_size=batch,
                                  flip_aug=False, erase_aug=False),
        data=dataclasses.replace(cfg.data, num_workers=1))


def datasets(world: int, batch: int, rank: int | None = None):
    """The train set (one global batch) and a validation set of one row
    more, which the shards split unevenly; ``rank`` takes its shard."""
    from contextaware_poseformer_tpu_torch.data.synthetic import (
        SyntheticPoseDataset,
    )

    train = SyntheticPoseDataset(size=world * batch, image_shape=(64, 64),
                                 seed=SEED)
    val = SyntheticPoseDataset(size=world * batch + 1, image_shape=(64, 64),
                               seed=SEED + 99)
    if rank is not None and world > 1:
        train.shard(rank, world)
        val.shard(rank, world)
    return train, val


def train_and_evaluate(trainer, steps: int) -> dict:
    """``steps`` epochs of one step, then the evaluation; the losses, P1
    and the lifter's parameters as one float64 vector."""
    state = trainer.init_state(SEED)
    losses = [trainer.train_epoch(state, epoch, max_steps=1)["step_losses"][0]
              for epoch in range(steps)]
    summary, _ = trainer.evaluate(state)
    params = torch.cat([p.detach().reshape(-1).to("cpu", torch.float64)
                        for p in state.model.lifter.parameters()])
    return {"losses": losses, "p1_mm": summary["p1_mm"],
            "params": params.numpy()}


def reference(world: int, device="cuda", steps: int = STEPS,
              batch: int = BATCH) -> dict:
    """One process on the concatenated rows of ``world`` ranks (batch
    ``world * batch``), in this process, without a process group."""
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    need_device(device)
    if torch.distributed.is_initialized():
        raise RuntimeError("dryrun.reference runs without a process group")
    train, val = datasets(world, batch)
    trainer = Trainer(config(world * batch), train, val, device)
    return train_and_evaluate(trainer, steps)


def _worker(rank, world, init_method, backend, device, steps, batch, out):
    """One rank: join the group, train, evaluate, report on ``out``."""
    try:
        from contextaware_poseformer_tpu_torch.parallel import distributed
        from contextaware_poseformer_tpu_torch.train.loop import Trainer

        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        topo = distributed.initialize(device, backend=backend,
                                      init_method=init_method, rank=rank,
                                      world_size=world)
        train, val = datasets(world, batch, rank)
        trainer = Trainer(config(batch), train, val, device)
        result = train_and_evaluate(trainer, steps)
        result.update(rank=rank, topology=topo,
                      backend=torch.distributed.get_backend(),
                      gathered=distributed.allgather_hosts(gather_rows(rank)))
        distributed.shutdown()
        out.put(result)
    except BaseException:  # reported to the parent, which raises
        out.put({"rank": rank, "error": traceback.format_exc()})
        raise


def gather_rows(rank: int) -> np.ndarray:
    """A rank's rows for the gather check: 3 on an even rank, 2 on an odd
    one, each (rank, row)."""
    n = 3 if rank % 2 == 0 else 2
    return np.stack([np.full(n, rank), np.arange(n)], axis=1).astype(np.int64)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def need_device(device) -> None:
    """Refuse a CUDA ``device`` where there is no card (no fallback)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"dryrun: --device {device}: no CUDA device here")


def run(nproc: int = 2, device: str = "cuda", backend: str | None = None,
        steps: int = STEPS, batch: int = BATCH,
        timeout: float = 600.0) -> list[dict]:
    """Spawn ``nproc`` ranks (``backend`` by default NCCL with rank ``r``
    on ``cuda:r`` for a CUDA ``device``, else gloo, every rank on
    ``device``), wait for their results (sorted by rank) and check them:
    the loss falls, and every rank holds the same lifter parameters and
    P1."""
    import multiprocessing as mp

    need_device(device)
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and torch.cuda.device_count() < nproc:
        raise ValueError(f"NCCL takes one card a rank: {nproc} ranks, "
                         f"{torch.cuda.device_count()} card(s)")
    devices = ([f"cuda:{r}" for r in range(nproc)] if backend == "nccl"
               else [device] * nproc)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_worker, args=(
        r, nproc, init_method, backend, devices[r], steps, batch, out))
        for r in range(nproc)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in procs:  # drain before joining
            try:
                results.append(out.get(timeout=timeout))
            except queue_lib.Empty:
                raise TimeoutError(f"dryrun: no result in {timeout} s")
            if "error" in results[-1]:
                raise RuntimeError(f"dryrun rank {results[-1]['rank']} "
                                   f"failed:\n{results[-1]['error']}")
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results.sort(key=lambda r: r["rank"])
    check(results)
    return results


def check(results: list[dict]) -> None:
    """Every rank's parameters, losses and P1 equal rank 0's, bit for bit
    (DDP reduces one gradient for all), every rank gathered every rank's
    rows in rank order, and the loss fell."""
    first = results[0]
    want = np.concatenate([gather_rows(r["rank"]) for r in results])
    for r in results:
        if not np.array_equal(r["gathered"], want):
            raise AssertionError(f"rank {r['rank']} gathered "
                                 f"{r['gathered'].tolist()}, not "
                                 f"{want.tolist()}")
    for r in results[1:]:
        if not np.array_equal(r["params"], first["params"]):
            raise AssertionError(f"rank {r['rank']}'s parameters differ "
                                 "from rank 0's")
        if r["losses"] != first["losses"] or r["p1_mm"] != first["p1_mm"]:
            raise AssertionError(f"rank {r['rank']}: losses {r['losses']} "
                                 f"P1 {r['p1_mm']}; rank 0: "
                                 f"{first['losses']} {first['p1_mm']}")
    if not first["losses"][-1] < first["losses"][0]:
        raise AssertionError(f"the loss did not fall: {first['losses']}")


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs over gloo)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    p.add_argument("--steps", type=int, default=STEPS)
    args = p.parse_args(argv)
    results = run(args.nproc, args.device, args.backend, args.steps)
    ref = reference(args.nproc, args.device, args.steps)
    print(f"dryrun: {args.nproc} ranks over {results[0]['backend']} on "
          f"{args.device}: losses {results[0]['losses']}, P1 "
          f"{results[0]['p1_mm']:.4f} mm, equal on every rank; one process "
          f"on the concatenated rows: parameters rel L2 "
          f"{rel_l2(results[0]['params'], ref['params']):.3e}, P1 "
          f"{ref['p1_mm']:.4f} mm")
    return results


if __name__ == "__main__":
    main()
