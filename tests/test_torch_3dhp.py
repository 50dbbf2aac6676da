"""3DHP training in the port against the JAX package, on the CPU: a 3-step
AdamW trajectory of the ``--tiny`` 3DHP model (root joint 14, no deformable
blocks), and ``train_3dhp``'s CLI (train, resume, evaluate, export the
MATLAB pipeline's ``.mat``). Tolerances are stated per test."""

import numpy as np
import scipy.io

from contextaware_poseformer_tpu.train import metrics as jmetrics
from contextaware_poseformer_tpu.train import train_3dhp as jtrain_3dhp
from contextaware_poseformer_tpu_torch.train import train_3dhp
from test_torch_hrnet_train import check_trajectory, tiny_configs, trajectory


def test_tiny_3dhp_trajectory_matches_jax():
    """3 AdamW steps at lr 1e-5 on the ``--tiny`` 3DHP model (the tiny HRNet,
    the lifter without deformable blocks, the 3D root-centred at joint 14)
    from the same random variables on the same batches. Tolerances: the CPN
    trajectory's (``test_train_trajectory_matches_jax``), loss relative
    3.3e-6, final lifter parameters 1.7e-3 of each parameter's RMS."""
    jcfg, pcfg = tiny_configs(jtrain_3dhp.make_config, train_3dhp.make_config,
                              "mpi_3dhp_hrnet_32")
    assert pcfg.data.dataset == "mpi_inf_3dhp"
    assert not pcfg.model.lifter.use_deformable
    check_trajectory(*trajectory(jcfg, pcfg, 3, 3), 3.3e-6, 1.7e-3)


def _cli(tmp_path, *extra):
    return train_3dhp.main([
        "--synthetic", "--tiny", "--device", "cpu", "--batch-size", "4",
        "--eval-batches", "2", "--logdir", str(tmp_path / "run"), *extra])


def test_cli_trains_resumes_and_exports_mat(tmp_path):
    """``--synthetic --tiny --device cpu``: one epoch of 2 steps, a resumed
    second epoch, then ``--eval --resume --export-mat``. The evaluation's
    P1 zeroes root 14 on both sides; its PCK and AUC are the JAX package's
    ``mpi3dhp_evaluate`` of the same errors (exact); the ``.mat`` holds
    each sequence's predictions as (3, 17, 1, frames), as the reference's
    MATLAB scripts read them."""
    _, first, _ = _cli(tmp_path, "--epochs", "1", "--steps-per-epoch", "2")
    assert first.step == 2
    _, resumed, best = _cli(tmp_path, "--epochs", "2", "--steps-per-epoch",
                            "2", "--resume")
    assert resumed.step == 4 and np.isfinite(best)

    mat = tmp_path / "inference_data.mat"
    trainer, state, summary = _cli(tmp_path, "--eval", "--resume",
                                   "--export-mat", str(mat))
    assert state.step == 4
    pred = trainer.last_pred
    assert pred.shape == (8, 17, 3) and not pred[:, 14].any()
    gt = trainer.val_ds.joints_3d[:8] - trainer.val_ds.joints_3d[:8, 14:15]
    np.testing.assert_allclose(
        summary["p1_mm"], np.linalg.norm(pred - gt, axis=-1).mean(),
        rtol=1e-6)
    seq = np.asarray(trainer.val_ds.seq_idx[:8])
    errors = jmetrics.joint_errors_mm(pred, gt)
    tables = jmetrics.mpi3dhp_evaluate({
        name: errors[seq == i]
        for i, name in enumerate(trainer.val_ds.seq_names) if (seq == i).any()})
    assert summary["pck"] == tables["All"]["pck"]
    assert summary["auc"] == tables["All"]["auc"]

    loaded = scipy.io.loadmat(str(mat))
    for i, name in enumerate(trainer.val_ds.seq_names):
        want = pred[seq == i].transpose(2, 1, 0)[:, :, None, :]
        if want.shape[-1]:
            np.testing.assert_array_equal(loaded[name], want)
