"""Data-parallel training of the port (``parallel/``, the ``Trainer`` under
``DistributedDataParallel``, the CLIs' ``--distributed``), on the CPU over
gloo with two real processes at the tiny size: the counterpart of the JAX
package's ``tests/test_multiprocess.py``, held against one process on the
same rows instead of against JAX (the collectives have no JAX twin)."""

import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from contextaware_poseformer_tpu_torch import config as cfglib
from contextaware_poseformer_tpu_torch.data import pipeline
from contextaware_poseformer_tpu_torch.data.synthetic import (
    SyntheticPoseDataset,
)
from contextaware_poseformer_tpu_torch.parallel import (
    distributed,
    dryrun,
    make_mesh,
)
from contextaware_poseformer_tpu_torch.train import steps, train_3dhp
from contextaware_poseformer_tpu_torch.train.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6  # fp32: the same sums in another order


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dry():
    """Two gloo ranks through ``dryrun.run`` and one process on their rows
    concatenated (``dryrun.reference``)."""
    return dryrun.run(2, "cpu", timeout=300), dryrun.reference(2, "cpu")


@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    """Two ranks of ``tests/torch_mp_worker.py``, started as torchrun starts
    them; each rank's npz."""
    out = tmp_path_factory.mktemp("ranks")
    port = dryrun.free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_mp_worker.py"),
             str(out)], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_ddp_on_halves_equals_one_process_on_the_concatenated_batch(dry):
    """Each rank steps on its half (augmentation and dropout off); the
    averaged gradients give one process's parameters on the whole batch,
    and the loss every rank reports is the global batch's."""
    ranks, ref = dry
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["backend"] == "gloo" for r in ranks)
    assert ranks[0]["topology"] == {"process_index": 0, "process_count": 2,
                                    "local_devices": 1, "global_devices": 2}
    for r in ranks:
        assert dryrun.rel_l2(r["params"], ref["params"]) <= RTOL
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=RTOL)
    assert ref["losses"][-1] < ref["losses"][0]


def test_evaluate_p1_is_one_processes_on_every_rank(dry):
    """``Trainer.evaluate`` on uneven validation shards (4 and 5 rows, the
    last batch padded): both ranks report the same P1, that of one process
    on the whole validation set (``tests/test_multiprocess.py:111``)."""
    ranks, ref = dry
    assert ranks[0]["p1_mm"] == ranks[1]["p1_mm"]
    assert ranks[0]["p1_mm"] == pytest.approx(ref["p1_mm"], rel=RTOL)


def test_rank_draws_differ_and_rank_0_draws_a_single_processes():
    """Folding the rank into a step's seed: rank 0's steps (flip
    augmentation and drop-path on) are a single process's, bit for bit, and
    rank 1's draws differ."""
    cfg = dryrun.config(4)
    cfg = replace(cfg, train=replace(cfg.train, flip_aug=True),
                  model=replace(cfg.model, lifter=replace(
                      cfg.model.lifter, drop_path_rate=0.5)))
    ds = SyntheticPoseDataset(size=4, image_shape=(64, 64))
    raw, _ = next(pipeline.batch_iterator(ds, 4, shuffle=False,
                                          num_workers=1))
    raw = pipeline.to_device(raw, "cpu")
    trainer = Trainer(cfg, ds, ds, "cpu")
    stepped = []
    for rank in (None, 0, 1):
        state = trainer.init_state(0)
        if rank is not None:
            state.rank = rank
        for _ in range(2):  # Adam's first update is lr * sign(gradient)
            steps.train_step(state, raw, cfg, trainer.task, 1)
        stepped.append(torch.cat([p.detach().reshape(-1) for p in
                                  state.model.lifter.parameters()]))
    assert torch.equal(stepped[0], stepped[1])
    assert not torch.equal(stepped[2], stepped[0])
    a = torch.rand(8, generator=steps.step_generator("cpu", 1, 3))
    b = torch.rand(8, generator=steps.step_generator("cpu", 1, 3, rank=0))
    c = torch.rand(8, generator=steps.step_generator("cpu", 1, 3, rank=1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_allgather_hosts_on_unequal_lengths(cli_ranks):
    """3 rows on rank 0 and 2 on rank 1, gathered in rank order on both,
    float32 and int64 kept."""
    want = np.concatenate([np.arange(6, dtype=np.float32).reshape(3, 2),
                           np.arange(4, dtype=np.float32).reshape(2, 2)
                           + 10])
    for r in cli_ranks:
        assert int(r["world"]) == 2
        assert r["gathered"].dtype == np.float32
        np.testing.assert_array_equal(r["gathered"], want)
        np.testing.assert_array_equal(r["gathered_int"], [0, 0, 0, 1, 1])


def test_allgather_and_broadcast_are_identities_in_one_process():
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(distributed.allgather_hosts(x), x)
    assert distributed.local_rows(x) is x
    assert distributed.min_over_ranks(3) == 3
    t = {"a": torch.ones(2)}
    assert distributed.broadcast_pytree(t) is t
    assert distributed.topology() == {"process_index": 0,
                                      "process_count": 1,
                                      "local_devices": 1, "global_devices": 1}
    assert distributed.initialize("cpu") == distributed.topology()
    assert not torch.distributed.is_initialized()


def test_deploy_calibration_is_rank_0s_on_both_ranks(cli_ranks):
    """``train_h36m --distributed --eval`` of a ``_deploy`` preset: each
    rank calibrates on its own validation shard, then both serve rank 0's
    scales (``loop.py:233-238``) and report one P1."""
    a, b = cli_ranks
    names = sorted(k for k in a if k.startswith("calib/"))
    assert names and names == sorted(k for k in b if k.startswith("calib/"))
    for k in names:
        assert np.all(a[k] > 0), k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert float(a["deploy_p1"]) == float(b["deploy_p1"])


def test_3dhp_distributed_eval_is_one_processes(cli_ranks):
    """``train_3dhp --distributed --eval``: the sequence indices ride the
    gather beside the predictions; both ranks report the P1 and PCK of one
    process on the whole validation set."""
    _, _, one = train_3dhp.main(["--tiny", "--synthetic", "--device", "cpu",
                                 "--eval", "--batch-size", "4",
                                 "--logdir", ""])
    for r in cli_ranks:
        assert float(r["mpi_p1"]) == pytest.approx(one["p1_mm"], rel=RTOL)
        assert float(r["mpi_pck"]) == pytest.approx(one["pck"], rel=RTOL)


def test_uneven_train_shards_take_the_same_steps(cli_ranks):
    """15 train rows over 2 ranks at batch 4: shards of 7 and 8 rows, one
    and two full batches. Both ranks take one step an epoch, the fewest of
    any rank, so that every DDP step's all-reduce is joined and the LR
    schedule's epochs end at the same update; both hold one model."""
    a, b = cli_ranks
    assert (int(a["uneven_rows"]), int(b["uneven_rows"])) == (7, 8)
    for r in cli_ranks:
        assert int(r["uneven_steps"]) == 1
        assert int(r["uneven_steps_per_epoch"]) == 1
    np.testing.assert_array_equal(a["uneven_params"], b["uneven_params"])


def test_model_parallel_is_refused_naming_11b():
    """The data axis is the mesh; the lifter's tensor parallelism is not
    ported (ROADMAP [11b])."""
    mesh = make_mesh(1, "cpu")
    assert (mesh.data, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match=r"\[11b\]"):
        make_mesh(2, "cpu")
    assert cfglib.preset("h36m_cpn").mesh.model_parallel == 1
