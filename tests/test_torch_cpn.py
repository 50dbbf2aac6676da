"""The port's CPN backbone and its building blocks against the JAX package's.

Weights: random flax variables (every leaf drawn from numpy) carried
across with ``models/bridge.py``; inputs from numpy. Tolerance: per level,
max abs error <= 1e-4 x RMS of the JAX map (fp32 through ~40 convolutions;
XLA and PyTorch sum in different orders).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu.config import cpn_backbone
from contextaware_poseformer_tpu.models import backbone_common as jbc
from contextaware_poseformer_tpu.models.cpn import CPN as JaxCPN
from contextaware_poseformer_tpu_torch.models import backbone_common as bc
from contextaware_poseformer_tpu_torch.models.bridge import load_jax_variables
from contextaware_poseformer_tpu_torch.models.cpn import CPN


def _random_variables(model, rng, *args):
    """Flax variables of ``model`` with every leaf drawn from numpy; the tree
    comes from ``jax.eval_shape`` (no init compile). Conv kernels are
    he-scaled, Dense kernels U(+-1/sqrt(fan_in)), scales U(0.5, 1.5), biases
    and ``pos_embed`` N(0, 0.1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name and len(s.shape) == 4:
            v = rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:3]))
        elif "'kernel'" in name:
            v = rng.uniform(-1, 1, s.shape) / np.sqrt(s.shape[0])
        elif "'scale'" in name:
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.randn(*s.shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("native_pyramid", [True, False])
def test_cpn_matches_jax(native_pyramid):
    cfg = replace(cpn_backbone(), cpn_layers=(1, 1, 1, 1),
                  cpn_native_pyramid=native_pyramid)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jmodel = JaxCPN(cfg=cfg)
    variables = _random_variables(jmodel, rng, jnp.asarray(x))
    theirs = jax.jit(jmodel.apply)(variables, jnp.asarray(x))

    model = CPN(cfg)
    load_jax_variables(model, variables)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    sizes = ((2, 2), (4, 4), (8, 8), (16, 16)) if native_pyramid else (
        ((16, 16),) * 4)
    assert len(ours) == 4
    for o, t, hw in zip(ours, theirs, sizes):
        t = np.asarray(t)
        assert o.shape == t.shape == (2, *hw, 256)
        assert o.is_contiguous()  # NHWC rows, ready for the sampler
        rms = np.sqrt(np.mean(t ** 2))
        assert np.abs(o.numpy() - t).max() <= 1e-4 * rms


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (7, 5)),
                                          ((1, 3), (4, 6))])
def test_resize_bilinear_align_corners_matches_jax(in_hw, out_hw):
    """Shapes the CPN test does not reach: a shrinking axis and a
    single-pixel one."""
    x = np.random.RandomState(1).randn(2, *in_hw, 5).astype(np.float32)
    ours = bc.resize_bilinear_align_corners(torch.from_numpy(x), out_hw)
    theirs = jbc.resize_bilinear_align_corners(jnp.asarray(x), out_hw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               rtol=1e-5, atol=1e-5)


def test_max_pool_matches_jax():
    x = np.random.RandomState(2).randn(2, 9, 7, 4).astype(np.float32)
    np.testing.assert_array_equal(
        bc.max_pool_3x3_s2(torch.from_numpy(x)).numpy(),
        np.asarray(jbc.max_pool_3x3_s2(jnp.asarray(x))))
