"""The port's single-level sampler (K8, ``sample_points``), its deformable
aggregation (K7, ``deformable_aggregate``) and its int8-map sampling (F4)
against the JAX package.

Inputs come from numpy and go into both packages. The JAX side runs its
gather and its Pallas kernels in interpret mode (``impl="fused_interpret"``
/ ``interpret=True``) under conftest's "highest" matmul precision; the
port's entries take their plain PyTorch versions for CPU tensors. Each
test states its tolerance: fp32 forwards at 1e-5 of the reference's RMS
(max |difference|), bf16 at a relative RMS of 3e-2 (the JAX gather blends
in bf16, the port in fp32), gradients at 1e-4 of the largest reference
gradient.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextaware_poseformer_tpu.ops import deformable as jdef
from contextaware_poseformer_tpu.ops import grid_sample as jgs
from contextaware_poseformer_tpu_torch.ops import deformable, grid_sample

# K8's maps: the TPU kernel's one-stage body, and its two-stage body
# (H*W >= 1024 and C < 64)
K8_MAPS = {"one-stage": (2, 8, 6, 16), "two-stage": (2, 32, 32, 8)}
K7_LEVELS = ((8, 6, 16), (4, 3, 32))
B, P, NH, HD = 2, 3, 2, 8  # K7: batch, joints, heads, head dim


def _points(rng, shape, lo=-1.3, hi=1.3):
    """Uniform points with exact corners, points on the edges and
    out-of-range ones planted."""
    pts = rng.uniform(lo, hi, shape).astype(np.float32)
    flat = pts.reshape(-1, 2)
    flat[:8] = [[1, 1], [-1, -1], [1, -1], [-1, 1], [1, 0.3], [-0.4, -1],
                [1.25, 0.3], [-0.2, -1.2]]
    return pts


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float64)


def _close_fp32(ours, theirs, tol=1e-5):
    """max |difference| within ``tol`` of the reference's RMS."""
    err = np.abs(_f32(ours) - _f32(theirs)).max()
    assert err <= tol * _rms(_f32(theirs)), err


def _close_rel_rms(ours, theirs, tol=3e-2):
    d = _f32(ours) - _f32(theirs)
    assert _rms(d) <= tol * _rms(_f32(theirs)), _rms(d)


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at each value of ``x``."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _int8_map(rng, shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("entry", [
    "grid_sample_points", "sample_points", "sample_points_levels"])
def test_int8_map_samples_match_jax(entry):
    """F4: an int8 map's samples are raw quantized numbers in float32, as
    the JAX gather gives them (to 1e-6 of the largest), and within one bf16
    ulp of the JAX kernel's bf16 samples (interpret mode)."""
    rng = np.random.RandomState(10)
    if entry == "sample_points_levels":
        maps = [_int8_map(rng, (2, h, w, c)) for h, w, c in K7_LEVELS]
        pts = _points(rng, (2, 2, 17, 2))
        ours = deformable.sample_points_levels(
            [torch.from_numpy(m) for m in maps], torch.from_numpy(pts))
        kw = dict(padding_mode="zeros", align_corners=True)
        jmaps = [jnp.asarray(m) for m in maps]
        gather = jdef.sample_points_levels(jmaps, jnp.asarray(pts),
                                           impl="gather", **kw)
        fused = jdef.sample_points_levels(jmaps, jnp.asarray(pts),
                                          impl="fused_interpret", **kw)
    else:
        fmap = _int8_map(rng, (2, 8, 6, 16))
        pts = _points(rng, (2, 17, 4, 2))
        f, p = torch.from_numpy(fmap), torch.from_numpy(pts)
        if entry == "grid_sample_points":
            ours = grid_sample.grid_sample_points(f, p, padding_mode="border")
        else:
            ours = deformable.sample_points(f, p, "border")
        gather = jgs.grid_sample_points(jnp.asarray(fmap), jnp.asarray(pts),
                                        padding_mode="border")
        fused = jdef.sample_points(jnp.asarray(fmap), jnp.asarray(pts),
                                   "border", impl="fused_interpret")
        ours, gather, fused = (ours,), (gather,), (fused,)
    for o, g, k in zip(ours, gather, fused):
        assert o.dtype == torch.float32 and g.dtype == jnp.float32
        assert k.dtype == jnp.bfloat16
        o, g, k = o.numpy(), np.asarray(g), _f32(k)
        assert np.abs(o - g).max() <= 1e-6 * np.abs(g).max()
        assert np.all(np.abs(o - k) <= _bf16_ulp(k)), np.abs(o - k).max()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("kind", sorted(K8_MAPS))
def test_sample_points_matches_jax(kind, padding, align_corners):
    """K8: the port's ``sample_points`` (CPU: the plain version) against the
    JAX gather and the JAX kernel's one-stage or two-stage body, points
    (b, 17, 4, 2); fp32 at 1e-5 of the RMS, bf16 at relative RMS 3e-2."""
    rng = np.random.RandomState(11)
    fmap = rng.randn(*K8_MAPS[kind]).astype(np.float32)
    pts = _points(rng, (2, 17, 4, 2))
    assert jdef._use_two_stage(*fmap.shape[1:]) == (kind == "two-stage")
    for dtype, jdtype, close in ((torch.float32, jnp.float32, _close_fp32),
                                 (torch.bfloat16, jnp.bfloat16,
                                  _close_rel_rms)):
        f = torch.from_numpy(fmap).to(dtype)
        jf = jnp.asarray(fmap).astype(jdtype)
        jp = jnp.asarray(pts)
        theirs = [
            jdef.sample_points(jf, jp, padding, align_corners, impl="gather"),
            jdef.sample_points_fused(jf, jp, padding, align_corners, True),
        ]
        for impl in ("auto", "gather"):
            ours = deformable.sample_points(f, torch.from_numpy(pts), padding,
                                            align_corners, impl=impl)
            assert ours.dtype == dtype and ours.shape == (2, 17, 4,
                                                          fmap.shape[-1])
            for t in theirs:
                close(ours, t)


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("kind", sorted(K8_MAPS))
def test_sample_points_grads_match_jax(kind, padding):
    """K8 under autograd (CPU: the plain backward behind the sampler's
    autograd Function, and autograd through the gather) against
    ``jax.grad`` through the JAX kernel (whose backward is the gather's
    VJP), points on the map's edges included (F1's 0.5 tie in border
    mode): map and point gradients at 1e-4 of the largest."""
    rng = np.random.RandomState(12)
    fmap = rng.randn(*K8_MAPS[kind]).astype(np.float32)
    pts = _points(rng, (2, 17, 4, 2))
    g = rng.randn(2, 17, 4, fmap.shape[-1]).astype(np.float32)

    def loss(f, p):
        return jnp.sum(jdef.sample_points_fused(f, p, padding, True, True) * g)

    theirs = jax.grad(loss, argnums=(0, 1))(jnp.asarray(fmap),
                                            jnp.asarray(pts))
    for impl in ("auto", "gather"):
        f = torch.from_numpy(fmap).requires_grad_(True)
        p = torch.from_numpy(pts).requires_grad_(True)
        out = deformable.sample_points(f, p, padding, impl=impl)
        (out * torch.from_numpy(g)).sum().backward()
        for ours, t in zip((f.grad, p.grad), theirs):
            t = np.asarray(t)
            assert np.abs(ours.numpy() - t).max() <= 1e-4 * np.abs(t).max()


def _aggregate_inputs(rng, ns):
    """K7's inputs: two levels, weights that do not sum to one over ns."""
    maps = [rng.randn(B, h, w, c).astype(np.float32) for h, w, c in K7_LEVELS]
    pts = _points(rng, (B, 2, P, NH * ns, 2))
    wts = rng.uniform(-0.5, 1.5, (B, 2, P, NH, ns)).astype(np.float32)
    assert np.abs(wts.sum(-1) - 1).min() > 1e-3  # the bias trap is live
    projs = [(rng.randn(c, HD) / np.sqrt(c)).astype(np.float32)
             for _, _, c in K7_LEVELS]
    biases = [rng.randn(HD).astype(np.float32) for _ in K7_LEVELS]
    return maps, pts, wts, projs, biases


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("ns", [2, 3])
def test_deformable_aggregate_matches_jax(ns, padding, dtype):
    """K7: the port's ``deformable_aggregate`` (CPU: the plain version)
    against the JAX package's gather and its Pallas kernel in interpret
    mode (which pads the rows to a multiple of 8 * ns when ns = 3), at
    b=2, maps 8x6x16 and 4x3x32, p=3, nh=2, hd=8; fp32: max |difference|
    under 1e-5 of the RMS (the bound of the JAX package's own test), bf16
    at relative RMS 3e-2. Sample-then-project in both modes, the bias on
    every sample before the weighting."""
    rng = np.random.RandomState(13 + ns)
    maps, pts, wts, projs, biases = _aggregate_inputs(rng, ns)
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    args = ([jnp.asarray(m).astype(jdtype) for m in maps], jnp.asarray(pts),
            jnp.asarray(wts), [jnp.asarray(w) for w in projs],
            [jnp.asarray(b) for b in biases])
    theirs = [jdef.deformable_aggregate(*args, padding, impl=impl)
              for impl in ("gather", "fused_interpret")]
    targs = ([torch.from_numpy(m).to(tdtype) for m in maps],
             torch.from_numpy(pts), torch.from_numpy(wts),
             [torch.from_numpy(w) for w in projs],
             [torch.from_numpy(b) for b in biases])
    ours = deformable.deformable_aggregate(*targs, padding)
    assert ours.shape == (B, 2, P, NH * HD) and ours.dtype == tdtype
    assert torch.equal(ours, deformable.aggregate_reference(*targs, padding))
    close = _close_fp32 if dtype == "float32" else _close_rel_rms
    for t in theirs:
        close(ours, t)


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("ns", [2, 3])
def test_deformable_aggregate_grads_match_jax(ns, padding):
    """K7 under autograd (CPU: the plain version's VJP behind the
    autograd Function, as the JAX ``_aggregate_bwd``) against ``jax.grad``
    through the JAX kernel in interpret mode: the gradients of the maps,
    points, weights, projections and biases at 1e-4 of the largest."""
    rng = np.random.RandomState(17 + ns)
    maps, pts, wts, projs, biases = _aggregate_inputs(rng, ns)
    g = rng.randn(B, 2, P, NH * HD).astype(np.float32)

    def loss(m0, m1, p, w, w0, w1, b0, b1):
        out = jdef.deformable_aggregate([m0, m1], p, w, [w0, w1], [b0, b1],
                                        padding, impl="fused_interpret")
        return jnp.sum(out * g)

    flat = [*maps, pts, wts, *projs, *biases]
    theirs = jax.grad(loss, argnums=tuple(range(8)))(
        *[jnp.asarray(a) for a in flat])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in flat]
    out = deformable.deformable_aggregate(ts[:2], ts[2], ts[3], ts[4:6],
                                          ts[6:], padding)
    (out * torch.from_numpy(g)).sum().backward()
    for t, ref in zip(ts, theirs):
        ref = np.asarray(ref)
        assert np.abs(t.grad.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_entries_refuse_what_they_do_not_take(monkeypatch):
    """K7 refuses int8 maps (with the reason), an int8 level refuses a fused
    projection, the kernel routes refuse CPU tensors (no fallback), JAX's
    interpret routes are unknown here, and the CPU routes launch nothing."""
    monkeypatch.setattr(deformable, "launches_k7", 0)
    monkeypatch.setattr(deformable, "launches_k8", 0)
    rng = np.random.RandomState(20)
    maps, pts, wts, projs, biases = _aggregate_inputs(rng, 2)
    args = ([torch.from_numpy(m) for m in maps], torch.from_numpy(pts),
            torch.from_numpy(wts), [torch.from_numpy(w) for w in projs],
            [torch.from_numpy(b) for b in biases])
    int8_maps = [torch.from_numpy(_int8_map(rng, m.shape)) for m in maps]
    for entry in (deformable.deformable_aggregate,
                  deformable.deformable_aggregate_kernel,
                  deformable.aggregate_reference):
        with pytest.raises(TypeError, match="int8 maps are refused"):
            entry(int8_maps, *args[1:])
    # an int8 level takes a fused projection (weights carrying its dequant
    # scale; tests/test_torch_cpn_int8.py), in border mode only
    proj = deformable.sample_points_levels(
        int8_maps[:1], args[1][:, :1, :, 0], "border", projs=args[3][:1],
        biases=args[4][:1])
    assert proj[0].dtype == torch.float32
    assert proj[0].shape[-1] == args[3][0].shape[1]
    with pytest.raises(ValueError, match="border mode"):
        deformable.sample_points_levels(int8_maps[:1], args[1][:, :1, :, 0],
                                        "zeros", projs=args[3][:1],
                                        biases=args[4][:1])
    with pytest.raises(ValueError, match="CUDA"):
        deformable.deformable_aggregate_kernel(*args)
    f, p = args[0][0], args[1][:, 0, :, 0]
    with pytest.raises(ValueError, match="CUDA"):
        deformable.sample_points(f, p, impl="fused")
    with pytest.raises(ValueError, match="unknown"):
        deformable.sample_points(f, p, impl="fused_interpret")
    deformable.sample_points(f, p)
    deformable.deformable_aggregate(*args)
    assert (deformable.launches_k7, deformable.launches_k8) == (0, 0)
