"""The port's deploy-numerics gate against the JAX package's
(``tools/deploy_numerics.py``, loaded by path: ``tools/`` is not a
package), on the CPU at a few steps: the same tiny configurations, and
finite P1 numbers under the JAX gate's keys."""

import math
from dataclasses import asdict

import pytest
import torch

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu_torch import deploy_numerics
from test_torch_checkpoints import jax_tiny_cfg

JAX_KEYS = ("preset", "tiny_trained_fp32_p1_mm", "tiny_trained_deploy_p1_mm",
            "tiny_trained_delta_mm")


@pytest.mark.parametrize("name", jconfig.PRESETS)
def test_tiny_cfg_equals_the_jax_package(name):
    """Width-32 HRNet stages (the int8 rule for convs with both channel
    counts >= 128 engages), the CPN cut to one block a stage, the 3DHP
    lifters without deformable blocks, batch 16, 64x64 frames."""
    cfg = deploy_numerics._tiny_cfg(name)
    assert asdict(cfg) == asdict(jax_tiny_cfg(name))
    if cfg.model.backbone.kind == "hrnet":
        assert max(cfg.model.backbone.feature_dims) >= 128


@pytest.mark.parametrize("name", ["h36m_hrnet_32", "mpi_3dhp_hrnet_32"])
def test_preset_gate_runs_each_deploy_class(name):
    """3 training steps, then P1 of the fp32 model and of its deploy stack
    (calibrated by ``serve.prepare``; on the CPU the kernels' plain
    versions): finite numbers under the JAX gate's keys, the delta their
    difference to the rounding, and a calibrated deploy model that holds
    the trained parameters, each cast to its dtype. The HRNet classes, with and without
    deformable blocks; the CPN's int8 deploy graph, the CPU's costliest,
    is held against JAX by ``tests/test_torch_cpn_int8.py`` and gated on
    the card by ``chip_smoke.py``."""
    seen = []

    def inspect(fp32, deploy):
        seen.append((fp32[1].model, deploy[1].model))

    row = deploy_numerics.preset_gate(name, steps_n=3, device="cpu",
                                      inspect=inspect)
    assert tuple(row) == JAX_KEYS and row["preset"] == name
    # the deploy model evaluated the trained weights, each in its own dtype
    ((trained, served),) = seen
    deploy_params = dict(served.named_parameters())
    for k, p in trained.named_parameters():
        q = deploy_params[k]
        assert torch.equal(p.detach().to(q.dtype), q.detach()), k
    assert bool(served.backbone.serving_fingerprint.any())
    assert all(math.isfinite(row[k]) for k in JAX_KEYS[1:])
    assert abs(row["tiny_trained_delta_mm"]
               - (row["tiny_trained_deploy_p1_mm"]
                  - row["tiny_trained_fp32_p1_mm"])) <= 2e-4
