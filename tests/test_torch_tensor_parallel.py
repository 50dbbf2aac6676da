"""The lifter's tensor parallelism (``parallel/tensor.py``, the "model"
axis of ``parallel.make_mesh``): its split set against the JAX package's
``_lifter_spec``, the shard/gather round trip of JAX's parameters, a split
forward against JAX's ``apply``, and training at tp=2 and dp=2 x tp=2 over
gloo (real processes on the CPU) against one process on the same rows, with
the gradient clip active and with drop-path on; a checkpoint saved at tp=2
restores at tp=2 and at tp=1."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_tp_jobs
from contextaware_poseformer_tpu.config import preset as jpreset
from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu.models import PoseLifter as JaxPoseLifter
from contextaware_poseformer_tpu.parallel.mesh import _lifter_spec
from contextaware_poseformer_tpu_torch import config as cfglib
from contextaware_poseformer_tpu_torch.models import bridge
from contextaware_poseformer_tpu_torch.models.lifter import PoseLifter
from contextaware_poseformer_tpu_torch.parallel import dryrun, tensor
from contextaware_poseformer_tpu_torch.parallel.mesh import Mesh
from contextaware_poseformer_tpu_torch.train.loop import Trainer

RTOL = 1e-6  # fp32: the same sums in another order
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_split_set(name):
    """JAX's split kernels of preset ``name`` by path (flax names, the
    ``dense`` level dropped), from its parameter shapes."""
    cfg = jpreset(name)
    h, w = cfg.model.image_shape
    model = JCAPF(cfg=cfg.model)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 3)), jnp.zeros((1, 17, 2)),
                            jnp.zeros((1, 17, 2)))["params"]["lifter"]
    out = {}

    def visit(path, leaf):
        spec = _lifter_spec(path, leaf)
        if spec != jax.sharding.PartitionSpec():
            names = [p.key for p in path if p.key != "dense"]
            out[".".join(names)] = (
                tensor.COLUMNS if spec[1] is not None else tensor.ROWS,
                int(np.prod(leaf.shape)))
        return leaf

    jax.tree_util.tree_map_with_path(visit, shapes)
    return out


@pytest.mark.parametrize("name,count", [("h36m_cpn", 40),
                                        ("mpi_3dhp_hrnet_32", 32)])
def test_split_kernels_are_jaxs(name, count):
    """The port splits exactly the kernels JAX's ``_lifter_spec`` shards
    (qkv and fc1 by columns, proj and fc2 by rows) on the real preset
    trees; a column split also cuts its bias, which JAX replicates and
    GSPMD re-lays out."""
    theirs = _jax_split_set(name)
    cfg = cfglib.preset(name).model
    lifter = PoseLifter(cfg.lifter, cfg.backbone.feature_dims, device="meta")
    ours = {k: sp for k, sp in tensor.splits(lifter).items()
            if k.endswith("kernel")}
    assert len(theirs) == len(ours) == count
    assert set(ours) == set(theirs)
    for k, (kind, axis) in ours.items():
        assert {tensor.SPLIT_QKV: tensor.COLUMNS}.get(kind, kind) \
            == theirs[k][0], k
        assert axis == (1 if theirs[k][0] == tensor.COLUMNS else 0), k
    biases = {k for k in tensor.splits(lifter) if k.endswith("bias")}
    assert biases == {k[:-len("kernel")] + "bias" for k, (kind, _) in
                      ours.items() if kind != tensor.ROWS}


def _lifter_setup(rng, batch=2):
    """A tiny lifter config (``dryrun.config``'s), random flax variables of
    JAX's lifter for it (every leaf from numpy), inputs and JAX's output."""
    cfg = dryrun.config().model
    dims = cfg.backbone.feature_dims
    kp2d = rng.uniform(-1, 1, (batch, 17, 2)).astype(np.float32)
    ref = rng.uniform(-1.05, 1.05, (batch, 17, 2)).astype(np.float32)
    feats = [rng.randn(batch, s, s, c).astype(np.float32)
             for s, c in zip((16, 8, 4, 2), dims)]
    model = JaxPoseLifter(cfg=cfg.lifter, feature_dims=dims)
    j = (jnp.asarray(kp2d), jnp.asarray(ref), [jnp.asarray(f) for f in feats])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *j)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            v = rng.uniform(-1, 1, s.shape) / np.sqrt(s.shape[0])
        elif "'scale'" in name:
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.randn(*s.shape) * 0.1
        return np.asarray(v, np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    variables = jax.tree.map(np.asarray, variables)
    out = np.asarray(jax.jit(model.apply)(variables, *j))
    return cfg, variables, (kp2d, ref, feats), out


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_and_gather_round_trip_jaxs_parameters(tp):
    """``bridge.shard_for_rank`` then ``gather_shards`` give JAX's tree
    back bit for bit; each rank's qkv shard holds whole heads of q, k and
    v."""
    _, variables, _, _ = _lifter_setup(np.random.RandomState(1))
    shards = [bridge.shard_for_rank(variables, Mesh(1, r, "cpu", tp, 0, r))
              for r in range(tp)]
    back = bridge.gather_shards(shards)
    flat = dict(bridge._leaves(variables))
    assert dict(bridge._leaves(back)).keys() == flat.keys()
    for path, leaf in bridge._leaves(back):
        assert leaf.dtype == flat[path].dtype
        np.testing.assert_array_equal(leaf, flat[path], err_msg=str(path))
    qkv = ("params", "joint_block_0", "attn", "qkv", "dense", "kernel")
    full = flat[qkv].reshape(flat[qkv].shape[0], 3, -1)
    c = full.shape[2] // tp
    for r, s in enumerate(shards):
        part = dict(bridge._leaves(s))[qkv]
        np.testing.assert_array_equal(
            part, full[:, :, r * c:(r + 1) * c].reshape(part.shape))
        fc2 = ("params", "res_block_1", "mlp", "fc2", "dense", "kernel")
        assert dict(bridge._leaves(s))[fc2].shape[0] * tp == \
            flat[fc2].shape[0]


def _clip_config(batch=dryrun.BATCH):
    """``dryrun.config`` with the gradient clip active at every step."""
    cfg = dryrun.config(batch)
    return replace(cfg, train=replace(cfg.train, grad_clip=1e-7))


def _drop_config(batch=dryrun.BATCH):
    """``dryrun.config`` with drop-path, dropout and flip augmentation on
    (one data rank draws what one process draws)."""
    cfg = dryrun.config(batch)
    return replace(
        cfg, train=replace(cfg.train, flip_aug=True),
        model=replace(cfg.model, lifter=replace(
            cfg.model.lifter, drop_path_rate=0.5, drop_rate=0.2,
            attn_drop_rate=0.2)))


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """Two gloo ranks of one model group: the split forward, training with
    drop-path on, and a checkpoint (``torch_tp_jobs.train_and_checkpoint``);
    JAX's output of the same lifter; the checkpoint's directory."""
    import functools

    logdir = str(tmp_path_factory.mktemp("tp2"))
    cfg, variables, inputs, jax_out = _lifter_setup(np.random.RandomState(0))
    ranks = dryrun.spawn(2, functools.partial(
        torch_tp_jobs.train_and_checkpoint, cfg=_drop_config(), steps=STEPS,
        batch=dryrun.BATCH, logdir=logdir, variables=variables,
        inputs=inputs), "cpu", timeout=300)
    return ranks, jax_out, logdir


def test_split_forward_matches_jax(tp2):
    """A lifter split over two ranks against JAX's ``apply`` on the same
    weights (fp32, 1e-3 of the output's RMS); both ranks hold the same
    output, bit for bit."""
    ranks, theirs, _ = tp2
    rms = np.sqrt(np.mean(theirs ** 2))
    for r in ranks:
        assert r["out"].shape == theirs.shape == (2, 17, 3)
        assert np.abs(r["out"] - theirs).max() <= 1e-3 * rms
    np.testing.assert_array_equal(ranks[0]["out"], ranks[1]["out"])


def test_tp2_with_drop_path_is_one_process(tp2):
    """tp=2 with drop-path, dropout and flip augmentation on: both ranks
    draw the masks of the data rank (one process's), so both report one
    loss a step and reach one process's parameters and P1."""
    ranks, _, _ = tp2
    ref = dryrun.reference(1, "cpu", STEPS, cfg=_drop_config())
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["p1_mm"] == ranks[1]["p1_mm"]
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
    for r in ranks:
        assert dryrun.rel_l2(r["params"], ref["params"]) <= RTOL
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=RTOL)
        assert r["p1_mm"] == pytest.approx(ref["p1_mm"], rel=1e-5)


def test_dp2_tp2_with_the_clip_active_is_one_process():
    """Four gloo ranks, two data groups of a two-rank model group, the
    clip active at every step: the global norm sums the shards over the
    model group, so every rank reaches one process's parameters on the
    concatenated batch; every rank reports the same losses and P1."""
    ranks = dryrun.run(4, "cpu", steps=STEPS, timeout=300, model_parallel=2,
                       cfg=_clip_config())
    ref = dryrun.reference(2, "cpu", STEPS, cfg=_clip_config())
    assert [r["topology"]["process_count"] for r in ranks] == [4] * 4
    for r in ranks:
        assert dryrun.rel_l2(r["params"], ref["params"]) <= RTOL
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=RTOL)
        assert r["p1_mm"] == pytest.approx(ref["p1_mm"], rel=1e-5)


def test_data_ranks_draw_their_own_masks_at_tp1_and_tp2():
    """Drop-path, dropout and flips on, two data ranks: under plain data
    parallelism (tp=1, two gloo ranks) each rank seeds its draws from its
    own rank, and under dp=2 x tp=2 (four) from its data rank, so both
    runs draw the same masks for the same rows and reach the same
    parameters, data rank 1's draws included."""
    import functools

    def ranks(nproc, tp):
        return dryrun.spawn(nproc, functools.partial(
            dryrun.train_job, steps=STEPS, batch=dryrun.BATCH,
            model_parallel=tp, cfg=_drop_config()), "cpu", timeout=300)

    dp, dp_tp = ranks(2, 1), ranks(4, 2)
    assert [r["draw_rank"] for r in dp] == [0, 1]
    assert [r["draw_rank"] for r in dp_tp] == [0, 0, 1, 1]
    for r in dp + dp_tp:
        assert dryrun.rel_l2(r["params"], dp[0]["params"]) <= RTOL
        np.testing.assert_allclose(r["losses"], dp[0]["losses"], rtol=RTOL)


def test_tp2_checkpoint_restores_at_tp2_and_tp1(tp2):
    """A checkpoint written at tp=2 holds the whole lifter: restored at
    tp=2 it gives the trained parameters bit for bit and the same next
    step; restored in one process (tp=1) the same parameters and, from
    there, the tp=2 run's next step."""
    ranks, _, logdir = tp2
    for r in ranks:
        assert r["restored_equal"] and r["restored_epoch"] == STEPS
        assert r["next_losses"][0] == r["next_losses"][1]
        np.testing.assert_array_equal(*r["next_params"])
    train, val = dryrun.datasets(1, dryrun.BATCH)
    trainer = Trainer(_drop_config(), train, val, "cpu", logdir=logdir)
    state, epoch = trainer.ckpt.restore(torch_tp_jobs.blank_lifter(trainer))
    assert epoch == STEPS
    np.testing.assert_array_equal(dryrun.lifter_vector(state.model.lifter),
                                  ranks[0]["params"])
    loss = trainer.train_epoch(state, STEPS, max_steps=1)["step_losses"][0]
    assert loss == pytest.approx(ranks[0]["next_losses"][0], rel=RTOL)
    assert dryrun.rel_l2(dryrun.lifter_vector(state.model.lifter),
                         ranks[0]["next_params"][0]) <= RTOL


def test_cli_trains_with_model_parallel_under_distributed(tmp_path):
    """``train_h36m --distributed --model-parallel 2`` as torchrun starts
    it (two gloo ranks on the CPU, the tiny model): both ranks train one
    group split over them, report one best P1, and rank 0 writes the
    checkpoint of the whole lifter."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = dryrun.free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "contextaware_poseformer_tpu_torch.train.train_h36m",
             "--distributed", "--model-parallel", "2", "--tiny",
             "--synthetic", "--device", "cpu", "--epochs", "1",
             "--steps-per-epoch", "1", "--eval-batches", "1",
             "--batch-size", "4", "--logdir", str(tmp_path)],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
        assert "model parallel 2" in log
    best = [[ln for ln in log.splitlines() if ln.startswith("best p1")]
            for log in logs]
    assert best[0] == best[1] and len(best[0]) == 1
    payload = torch.load(tmp_path / "checkpoints" / "epoch_00000.pt",
                         weights_only=True)
    lifter = cfglib.preset("h36m_hrnet_32")
    from contextaware_poseformer_tpu_torch.train import train_h36m

    model = train_h36m.tiny(lifter).model
    whole = PoseLifter(model.lifter, model.backbone.feature_dims,
                       device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in payload["lifter"].items()} == \
        {k: tuple(v.shape) for k, v in whole.items()}
