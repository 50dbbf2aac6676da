"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
no JAX, so it also runs on a GPU machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: error relative to max|plain| of 1e-4 in fp32 (TF32 off) and
2e-2 in bf16 (the kernels keep some intermediates in fp32 where the plain
versions round to bf16).
"""

from dataclasses import replace

import pytest
import torch

from contextaware_poseformer_tpu_torch import serve
from contextaware_poseformer_tpu_torch.ops import (
    deformable,
    fused_mlp,
    joint_attention,
    small_attention,
)

LEVELS = ((8, 6), (16, 12), (32, 24), (64, 48))
KERNEL_MODULES = (deformable, fused_mlp, small_attention, joint_attention)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    serve.configure_numerics()
    return torch.device("cuda")


def _cases(dev, dtype):
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    feats = [r(3, h, w, 64) for h, w in LEVELS]
    pts = (torch.rand(3, 4, 17, 4, 2, generator=g) * 3 - 1.5).to(dev)
    projs = [r(64, 16, scale=0.1).float() for _ in feats]
    biases = [r(16).float() for _ in feats]
    # K2 at both lifter widths; row counts leave a partial row tile
    mlp = {}
    for d in (640, 128):
        p = [t.float() for t in (r(d), r(d), r(d, 2 * d, scale=d ** -0.5),
                                 r(2 * d), r(2 * d, d, scale=(2 * d) ** -0.5),
                                 r(d))]
        mlp[d] = (r(5, 17, d), p)
    xa = r(7, 5, 128)
    w = (r(128, 384, scale=0.09), r(384), r(128, 128, scale=0.09), r(128))
    qkv = r(3, 17, 1920)
    return {
        "K1-zeros": (
            lambda: deformable.sample_points_multi(feats, pts, "zeros"),
            lambda: deformable.sample_points_multi_reference(
                feats, pts, "zeros")),
        "K1-border-proj": (
            lambda: deformable.sample_points_multi(
                feats, pts, "border", True, projs, biases),
            lambda: deformable.sample_points_multi_reference(
                feats, pts, "border", True, projs, biases)),
        **{f"K2-{d}": (
            lambda x=x, p=p: fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6),
            lambda x=x, p=p: fused_mlp.ln_mlp_reference(x, *p, 1e-6))
           for d, (x, p) in mlp.items()},
        "K3": (lambda: small_attention.small_attention_kernel(xa, *w, 8),
               lambda: small_attention.attention_reference(xa, *w, 8)),
        "K4": (lambda: joint_attention.attention_middle_kernel(qkv, 8),
               lambda: joint_attention.attention_middle_reference(qkv, 8)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["K1-zeros", "K1-border-proj", "K2-640",
                                  "K2-128", "K3", "K4"])
def test_kernel_matches_plain_version(cuda_device, case, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    kernel, plain = _cases(cuda_device, dtype)[case]
    with torch.inference_mode():
        outs, refs = kernel(), plain()
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    for o, p in zip(outs, refs):
        assert o.shape == p.shape and o.dtype == p.dtype
        err = (o.float() - p.float()).abs().max().item()
        assert err <= tol * p.float().abs().max().item(), (case, err)


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_require_grad(cuda_device):
    x = torch.randn(4, 16, device=cuda_device, requires_grad=True)
    p = [torch.ones(16, device=cuda_device),
         torch.zeros(16, device=cuda_device),
         torch.randn(16, 32, device=cuda_device),
         torch.zeros(32, device=cuda_device),
         torch.randn(32, 16, device=cuda_device),
         torch.zeros(16, device=cuda_device)]
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_mlp.ln_mlp_residual(x, *p, 1e-6)
    with torch.no_grad():
        assert fused_mlp.ln_mlp_residual(x, *p, 1e-6).shape == (4, 16)


@pytest.mark.cuda
def test_serving_slice_runs_through_every_kernel(cuda_device, monkeypatch):
    """A cut slice (CPN stages (1,1,1,1), 64x64 frames, lifter depth 2)
    launches K1 = 1 + depth, K2 = 3 * depth, K3 = K4 = depth times per
    request and agrees with the plain knobs on the same weights."""
    for mod in KERNEL_MODULES:
        monkeypatch.setattr(mod, "launches", 0)
    cfg = serve.slice_config()
    depth = 2
    cfg = replace(cfg, model=replace(
        cfg.model, image_shape=(64, 64),
        backbone=replace(cfg.model.backbone, cpn_layers=(1, 1, 1, 1)),
        lifter=replace(cfg.model.lifter, depth=depth)))
    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        cfg.model.lifter, sampler="gather", attention="einsum",
        attention_joint="einsum", mlp="einsum")))
    gen = torch.Generator().manual_seed(0)
    model = serve.build_serving_model(cfg, cuda_device, generator=gen)
    plain = serve.build_serving_model(plain_cfg, cuda_device, generator=gen)
    plain.load_state_dict(model.state_dict())
    frames = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                           generator=gen)
    kp = torch.rand(4, 17, 2, generator=gen) * 2 - 1
    kpc = torch.rand(4, 17, 2, generator=gen) * 64
    out = serve.lift(model, frames, kp, kpc)
    assert [m.launches for m in KERNEL_MODULES] == [
        1 + depth, 3 * depth, depth, depth]
    ref = serve.lift(plain, frames, kp, kpc)
    assert [m.launches for m in KERNEL_MODULES] == [
        1 + depth, 3 * depth, depth, depth]
    assert out.shape == (4, 17, 3) and bool(torch.isfinite(out).all())
    rel = ((out - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    assert rel.item() <= 2e-2
