"""The port's kernel modules (K1-K4) against the JAX package's kernels.

Inputs come from numpy and go into both packages. The JAX side runs its
Pallas kernels in interpret mode (``impl="fused_interpret"`` /
``interpret=True``) under conftest's "highest" matmul precision; the port's
dispatchers take their plain PyTorch versions for CPU tensors. Tolerance:
rtol 1e-4, atol 1e-5 (fp32; the two sides sum in different orders, and the
TPU MLP kernel's rational erf is within 1.5e-7 of erf).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contextaware_poseformer_tpu.ops import deformable as jdef
from contextaware_poseformer_tpu.ops import fused_mlp as jmlp
from contextaware_poseformer_tpu.ops import grid_sample as jgs
from contextaware_poseformer_tpu.ops import joint_attention as jja
from contextaware_poseformer_tpu.ops import small_attention as jsa
from contextaware_poseformer_tpu_torch.ops import (
    deformable,
    fused_mlp,
    grid_sample,
    joint_attention,
    small_attention,
)

RTOL, ATOL = 1e-4, 1e-5
CPN_LEVELS = ((8, 6), (16, 12), (32, 24), (64, 48))  # native pyramid


def _close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               rtol=RTOL, atol=ATOL)


def _points(rng, shape, lo=-1.3, hi=1.3):
    """Uniform points with exact +-1 corners and out-of-range ones planted."""
    pts = rng.uniform(lo, hi, shape).astype(np.float32)
    flat = pts.reshape(-1, 2)
    flat[:6] = [[1, 1], [-1, -1], [1, -1], [-1, 1], [1.25, 0.3], [-0.2, -1.2]]
    return pts


def _mlp_params(rng, d):
    h = 2 * d
    return [
        rng.uniform(0.5, 1.5, d), rng.randn(d) * 0.1,
        rng.randn(d, h) / np.sqrt(d), rng.randn(h) * 0.1,
        rng.randn(h, d) / np.sqrt(h), rng.randn(d) * 0.1,
    ]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("mode", ["zeros", "border", "border_proj"])
def test_sampler_matches_jax(mode):
    """K1 over the four CPN pyramid levels at batch 2: 17 reference points
    (zeros) or 17x16 deformable points (border, optionally with the fused
    256 -> 32 projection)."""
    rng = np.random.RandomState(0)
    b, c, hd = 2, 256, 32
    feats = [rng.randn(b, h, w, c).astype(np.float32) for h, w in CPN_LEVELS]
    shape = (b, 4, 17, 2) if mode == "zeros" else (b, 4, 17, 16, 2)
    pts = _points(rng, shape)
    padding = "zeros" if mode == "zeros" else "border"
    projs = biases = None
    if mode == "border_proj":
        projs = [rng.randn(c, hd).astype(np.float32) / 16 for _ in feats]
        biases = [rng.randn(hd).astype(np.float32) for _ in feats]
    theirs = jdef.sample_points_levels(
        _j(*feats), jnp.asarray(pts), padding_mode=padding,
        align_corners=True, impl="fused_interpret", precision="highest",
        projs=projs and _j(*projs), biases=biases and _j(*biases),
    )
    ours = deformable.sample_points_levels(
        _t(*feats), torch.from_numpy(pts), padding_mode=padding,
        align_corners=True, projs=projs and _t(*projs),
        biases=biases and _t(*biases),
    )
    assert len(ours) == 4
    for o, t in zip(ours, theirs):
        assert tuple(o.shape) == t.shape
        _close(o, t)


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_points_matches_jax(padding, align_corners):
    rng = np.random.RandomState(1)
    f = rng.randn(3, 5, 7, 6).astype(np.float32)
    pts = _points(rng, (3, 4, 9, 2), -1.6, 1.6)
    ours = grid_sample.grid_sample_points(
        torch.from_numpy(f), torch.from_numpy(pts), padding_mode=padding,
        align_corners=align_corners)
    theirs = jgs.grid_sample_points(
        jnp.asarray(f), jnp.asarray(pts), padding_mode=padding,
        align_corners=align_corners)
    _close(ours, theirs)


@pytest.mark.parametrize("d", [128, 640])
def test_ln_mlp_residual_matches_jax(d):
    """K2 at the lifter's widths (H = 2D), eps 1e-5 and 1e-6."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 7, d).astype(np.float32)
    params = _mlp_params(rng, d)
    for eps in (1e-5, 1e-6):
        theirs = jmlp.ln_mlp_residual(*_j(x, *params), eps, "highest", True)
        ours = fused_mlp.ln_mlp_residual(*_t(x, *params), eps)
        _close(ours, theirs)


def test_small_attention_matches_jax():
    """K3 at the res blocks' shape: 5 tokens, D 128, 8 heads."""
    rng = np.random.RandomState(3)
    d = 128
    x = rng.randn(6, 5, d)
    w = [rng.randn(d, 3 * d) / np.sqrt(d), rng.randn(3 * d) * 0.1,
         rng.randn(d, d) / np.sqrt(d), rng.randn(d) * 0.1]
    theirs = jsa.small_attention(*_j(x, *w), 8, True)
    ours = small_attention.small_attention(*_t(x, *w), 8)
    _close(ours, theirs)


@pytest.mark.parametrize("b", [2, 11])
def test_attention_middle_matches_jax(b):
    """K4 at the joint blocks' shape: 17 tokens, D 640, 8 heads."""
    rng = np.random.RandomState(4)
    qkv = rng.randn(b, 17, 3 * 640)
    theirs = jja.attention_middle(*_j(qkv), 8, True)
    ours = joint_attention.attention_middle(*_t(qkv), 8)
    _close(ours, theirs)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """The dispatchers pick by device: CPU tensors reach the plain versions
    and never a kernel (no launch is counted, no library is built)."""
    rng = np.random.RandomState(5)
    mods = (deformable, fused_mlp, small_attention, joint_attention)
    for mod in mods:
        monkeypatch.setattr(mod, "launches", 0)
    feats = _t(*[rng.randn(2, h, w, 8) for h, w in CPN_LEVELS])
    pts = torch.from_numpy(_points(rng, (2, 4, 5, 2)))
    a = deformable.sample_points_levels(feats, pts, "zeros")
    b = deformable.sample_points_multi_reference(feats, pts, "zeros")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    x, *p = _t(rng.randn(4, 16), *_mlp_params(rng, 16))
    assert torch.equal(fused_mlp.ln_mlp_residual(x, *p, 1e-6),
                       fused_mlp.ln_mlp_reference(x, *p, 1e-6))
    xa, *w = _t(rng.randn(3, 5, 16), rng.randn(16, 48), rng.randn(48),
                rng.randn(16, 16), rng.randn(16))
    assert torch.equal(small_attention.small_attention(xa, *w, 4),
                       small_attention.attention_reference(xa, *w, 4))
    (qkv,) = _t(rng.randn(2, 17, 48))
    assert torch.equal(joint_attention.attention_middle(qkv, 4),
                       joint_attention.attention_middle_reference(qkv, 4))
    assert [m.launches for m in mods] == [0, 0, 0, 0]


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises; it never falls
    back to the plain version."""
    rng = np.random.RandomState(6)
    feats = _t(rng.randn(1, 4, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        deformable.sample_points_multi(
            feats, torch.zeros(1, 1, 3, 2), "zeros")
    x, *p = _t(rng.randn(4, 16), *_mlp_params(rng, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6)
    xa, *w = _t(rng.randn(3, 5, 16), rng.randn(16, 48), rng.randn(48),
                rng.randn(16, 16), rng.randn(16))
    with pytest.raises(ValueError, match="CUDA"):
        small_attention.small_attention_kernel(xa, *w, 4)
    with pytest.raises(ValueError, match="CUDA"):
        joint_attention.attention_middle_kernel(*_t(rng.randn(2, 17, 48)), 4)
    with pytest.raises(ValueError, match="unknown sampler"):
        deformable.sample_points_levels(feats, torch.zeros(1, 1, 3, 2),
                                        impl="fused_interpret")


def test_projection_needs_border_mode():
    feats = [torch.zeros(1, 4, 4, 8)]
    pts = torch.zeros(1, 1, 3, 2)
    w = [torch.zeros(8, 2)]
    with pytest.raises(ValueError, match="border"):
        deformable.sample_points_multi_reference(feats, pts, "zeros",
                                                 projs=w)
    with pytest.raises(ValueError, match="border"):
        deformable.sample_points_multi(feats, pts, "zeros", projs=w)


def test_kernel_can_preproject():
    # every CPN level projects 256 -> 32 in the sampler
    assert all(deformable.kernel_can_preproject(h, w, 256, 32, dtype)
               for h, w in CPN_LEVELS
               for dtype in (torch.bfloat16, torch.int8, torch.float32))
    assert not deformable.kernel_can_preproject(64, 48, 32, 32,
                                                torch.bfloat16)
