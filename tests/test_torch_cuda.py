"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
no JAX, so it also runs on a GPU machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: error relative to max|plain| of 1e-4 in fp32 (TF32 off) and
2e-2 in bf16 (the kernels keep some intermediates in fp32 where the plain
versions round to bf16). The int8 kernels K9 and K10 round at the same
points as their plain versions and must equal them; so do K10q and K10p.
"""

from dataclasses import replace

import pytest
import torch

from contextaware_poseformer_tpu_torch import serve
from contextaware_poseformer_tpu_torch.data import augment
from contextaware_poseformer_tpu_torch.models import backbone_common
from contextaware_poseformer_tpu_torch.ops import (
    deformable,
    fused_mlp,
    int8_conv,
    joint_attention,
    layer1_chain,
    small_attention,
)

LEVELS = ((8, 6), (16, 12), (32, 24), (64, 48))
KERNEL_MODULES = (deformable, fused_mlp, small_attention, joint_attention)
# the HRNet-W32 / W48 pyramids of a 256x192 frame (level 0: K5's shapes)
HRNET_PYRAMIDS = {
    "W32": ((64, 48, 32), (32, 24, 64), (16, 12, 128), (8, 6, 256)),
    "W48": ((64, 48, 48), (32, 24, 96), (16, 12, 192), (8, 6, 384)),
}


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
    # K2 at the H36M lifter's widths (embed 128, joint 640) and the 3DHP
    # lifters' (64/96, 320/480); row counts leave a partial row tile
    mlp = {}
    for d in (640, 128, 64, 96, 320, 480):
        p = [t.float() for t in (r(d), r(d), r(d, 2 * d, scale=d ** -0.5),
                                 r(2 * d), r(2 * d, d, scale=(2 * d) ** -0.5),
                                 r(d))]
        mlp[d] = (r(5, 17, d), p)
    # K3 at embed 128 (64/96 for 3DHP), K4 at joint width 640 (320/480)
    attn = {}
    for d in (128, 64, 96):
        attn[d] = (r(7, 5, d), (r(d, 3 * d, scale=d ** -0.5), r(3 * d),
                                r(d, d, scale=d ** -0.5), r(d)))
    qkvs = {d: r(3, 17, 3 * d) for d in (640, 320, 480)}
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
        **{"K3" if d == 128 else f"K3-{d}": (
            lambda x=x, w=w: small_attention.small_attention_kernel(
                x, *w, 8),
            lambda x=x, w=w: small_attention.attention_reference(x, *w, 8))
           for d, (x, w) in attn.items()},
        **{"K4" if d == 640 else f"K4-{d}": (
            lambda q=q: joint_attention.attention_middle_kernel(q, 8),
            lambda q=q: joint_attention.attention_middle_reference(q, 8))
           for d, q in qkvs.items()},
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    "K1-zeros", "K1-border-proj", "K2-640", "K2-128", "K3", "K4",
    "K2-64", "K2-96", "K2-320", "K2-480", "K3-64", "K3-96", "K4-320",
    "K4-480"])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("pyramid", sorted(HRNET_PYRAMIDS))
def test_k5_sampler_matches_plain_version(cuda_device, pyramid, mode, dtype):
    """K5: the sampler at an HRNet pyramid, the zeros call with the 17
    reference points and the border call with 272 deformable points and the
    lifter's in-kernel projections to 32 channels (W32's level 0, whose
    C = 32 is the head dim, stays raw). Counts one K1 and one K5 launch;
    tolerance as above."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(2)
    dims = HRNET_PYRAMIDS[pyramid]
    feats = [torch.randn(3, h, w, c, generator=g).to(cuda_device, dtype)
             for h, w, c in dims]
    p = (17,) if mode == "zeros" else (17, 16)
    pts = (torch.rand(3, 4, *p, 2, generator=g) * 3 - 1.5).to(cuda_device)
    projs = biases = None
    if mode == "border":
        on = [deformable.kernel_can_preproject(h, w, c, 32, dtype)
              for h, w, c in dims]
        assert on == [pyramid == "W48", True, True, True]
        projs = [(torch.randn(c, 32, generator=g) * c ** -0.5).to(cuda_device)
                 if o else None for (_, _, c), o in zip(dims, on)]
        biases = [torch.randn(32, generator=g).to(cuda_device) * 0.1
                  if o else None for o in on]
    before = (deformable.launches, deformable.launches_k5)
    with torch.inference_mode():
        outs = deformable.sample_points_multi(feats, pts, mode, True, projs,
                                              biases)
        refs = deformable.sample_points_multi_reference(feats, pts, mode,
                                                        True, projs, biases)
    assert (deformable.launches, deformable.launches_k5) == (
        before[0] + 1, before[1] + 1)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and o.dtype == r.dtype
        err = (o.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), err


@pytest.mark.cuda
def test_kernels_run_under_autograd(cuda_device):
    """K1-K4 run under autograd (K1's backward is K6, K2-K4's the plain
    versions' VJP) and their gradients match autograd through the plain
    versions (fp32, 1e-4 of max|plain grad|)."""
    torch.manual_seed(0)
    cases = _cases(cuda_device, torch.float32)
    counts = [m.launches for m in KERNEL_MODULES] + [deformable.launches_bwd]
    for name in ("K1-zeros", "K1-border-proj", "K2-128", "K3", "K4"):
        kernel, plain = cases[name]
        grads = []
        for fn in (kernel, plain):
            leaves = _grad_leaves(fn)
            outs = fn()
            outs = outs if isinstance(outs, tuple) else (outs,)
            w = [torch.randn_like(o) for o in outs] if not grads else w
            torch.autograd.backward(outs, w)
            grads.append([t.grad.clone() for t in leaves])
            for t in leaves:
                t.grad = None
        for a, b in zip(*grads):
            err = (a - b).abs().max().item()
            assert err <= 1e-4 * b.abs().max().item(), (name, err)
    after = [m.launches for m in KERNEL_MODULES] + [deformable.launches_bwd]
    # K1 twice (zeros, border+proj), K2-K4 once each; K6 for zeros only
    assert [a - b for a, b in zip(after, counts)] == [2, 1, 1, 1, 1]


def _grad_leaves(fn):
    """The float tensors a case closes over (or binds as defaults), set to
    require grad."""
    leaves = []
    bound = [c.cell_contents for c in fn.__closure__ or ()]
    for vals in bound + list(fn.__defaults__ or ()):
        for v in vals if isinstance(vals, (list, tuple)) else (vals,):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                leaves.append(v.requires_grad_(True))
    return leaves


def _bwd_case(dev, dtype):
    g = torch.Generator().manual_seed(1)
    feats = [(torch.randn(3, h, w, 64, generator=g)).to(dev, dtype)
             for h, w in LEVELS]
    pts = torch.rand(3, 4, 17, 4, 2, generator=g) * 2.6 - 1.3
    flat = pts.view(-1, 2)
    flat[:6] = torch.tensor([[1, 1], [-1, -1], [1, -1], [-1, 1],
                             [1.25, 0.3], [-0.2, -1.2]])
    grads = [torch.randn(3, 17, 4, 64, generator=g).to(dev, dtype)
             for _ in LEVELS]
    return feats, pts.to(dev), grads


@pytest.mark.cuda
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("need_df", [True, False])
@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampler_backward_matches_plain_version(cuda_device, dtype, padding,
                                                need_df, align):
    """K6 against the plain backward, points exactly on and past the
    edges; tolerance as above (of max|plain|, per output)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    feats, pts, grads = _bwd_case(cuda_device, dtype)
    before = deformable.launches_bwd
    ours = deformable.sample_points_multi_backward(
        feats, pts, grads, padding, align, need_df)
    theirs = deformable.sample_points_multi_backward_reference(
        feats, pts, grads, padding, align, need_df)
    assert deformable.launches_bwd == before + 1
    assert (ours[0] is None) == (theirs[0] is None) == (not need_df)
    pairs = [(ours[1], theirs[1])] + list(zip(ours[0] or (), theirs[0] or ()))
    for o, p in pairs:
        assert o.shape == p.shape and o.dtype == p.dtype
        err = (o.float() - p.float()).abs().max().item()
        assert err <= tol * p.float().abs().max().item(), err


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


@pytest.mark.cuda
def test_hrnet_slice_runs_through_every_kernel(cuda_device, monkeypatch):
    """A cut h36m_hrnet_32 slice (256x192 frames, so level 0 is 64x48 and
    takes K5; width 8 with one block a branch; lifter embed 32, depth 2)
    launches K1 = K5 = 1 + depth, K2 = 3 * depth, K3 = K4 = depth times per
    request and agrees with the plain knobs on the same weights."""
    from contextaware_poseformer_tpu_torch.config import HRNetStageConfig

    for mod in KERNEL_MODULES:
        monkeypatch.setattr(mod, "launches", 0)
    monkeypatch.setattr(deformable, "launches_k5", 0)
    depth, width = 2, 8
    c = (width, 2 * width, 4 * width, 8 * width)
    cfg = serve.slice_config("h36m_hrnet_32")
    cfg = replace(cfg, model=replace(
        cfg.model,
        backbone=replace(
            cfg.model.backbone, width=width,
            stage2=HRNetStageConfig(1, 2, (1, 1), c[:2]),
            stage3=HRNetStageConfig(1, 3, (1, 1, 1), c[:3]),
            stage4=HRNetStageConfig(2, 4, (1, 1, 1, 1), c)),
        lifter=replace(cfg.model.lifter, embed_dim_ratio=32, depth=depth)))
    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        cfg.model.lifter, sampler="gather", attention="einsum",
        attention_joint="einsum", mlp="einsum")))
    gen = torch.Generator().manual_seed(0)
    model = serve.build_serving_model(cfg, cuda_device, generator=gen)
    plain = serve.build_serving_model(plain_cfg, cuda_device, generator=gen)
    plain.load_state_dict(model.state_dict())
    h, w = cfg.model.image_shape
    frames = torch.randint(0, 256, (4, h, w, 3), dtype=torch.uint8,
                           generator=gen)
    kp = torch.rand(4, 17, 2, generator=gen) * 2 - 1
    kpc = torch.rand(4, 17, 2, generator=gen) * w
    expected = [1 + depth, 3 * depth, depth, depth, 1 + depth]
    out = serve.lift(model, frames, kp, kpc)
    counts = [m.launches for m in KERNEL_MODULES] + [deformable.launches_k5]
    assert counts == expected
    ref = serve.lift(plain, frames, kp, kpc)
    counts = [m.launches for m in KERNEL_MODULES] + [deformable.launches_k5]
    assert counts == expected
    assert out.shape == (4, 17, 3) and bool(torch.isfinite(out).all())
    rel = ((out - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    assert rel.item() <= 2e-2


# K10 at the deploy graph's shapes (batch 64): (name, H, W, Cin, Cout, k,
# stride, int8 input) for the W32 and W48 branch channels
def _k10_shapes(c):
    return [("transition1.0", 64, 48, 256, c[0], 3, 1, True),
            ("transition1.1", 64, 48, 256, c[1], 3, 2, True),
            ("branch 16x12", 16, 12, c[2], c[2], 3, 1, False),
            ("branch 8x6", 8, 6, c[3], c[3], 3, 1, False),
            ("fuse 1x1", 8, 6, c[3], c[2], 1, 1, False),
            ("fuse / transition3 s2", 16, 12, c[2], c[3], 3, 2, False)]


K10_SHAPES = [(f"{tag} {name}", *rest)
              for tag, dims in sorted(HRNET_PYRAMIDS.items())
              for name, *rest in _k10_shapes([d[2] for d in dims])]


def _int8_conv_case(g, dev, b, h, w, cin, cout, k, int8_in,
                    dtype=torch.bfloat16):
    if int8_in:
        x = torch.randint(-127, 128, (b, h, w, cin), generator=g,
                          dtype=torch.int8).to(dev)
        amax = torch.tensor(9.5, device=dev)
    else:  # post-ReLU, as the wide convs see their inputs (half zeros)
        x = torch.relu(torch.randn(b, h, w, cin, generator=g) * 2).to(
            dev, dtype)
        amax = None
    kq = torch.randint(-127, 128, (cout, k * k * cin), generator=g,
                       dtype=torch.int8).to(dev)
    vecs = [(torch.rand(cout, generator=g) * 0.01 + 1e-3).to(dev),
            (torch.rand(cout, generator=g) + 0.5).to(dev),
            (torch.randn(cout, generator=g) * 0.1).to(dev)]
    return x, kq, vecs, amax


@pytest.mark.cuda
@pytest.mark.parametrize("case", K10_SHAPES, ids=lambda c: c[0])
def test_k10_int8_conv_matches_plain_version(cuda_device, case):
    """K10 at every shape of the deploy graph (batch 64), ReLU on: its
    bf16 output equals the plain version's (float64 accumulation, the same
    epilogue), one launch."""
    _, h, w, cin, cout, k, stride, int8_in = case
    g = torch.Generator().manual_seed(cin + cout + k + stride)
    x, kq, vecs, amax = _int8_conv_case(g, cuda_device, 64, h, w, cin, cout,
                                        k, int8_in)
    before = int8_conv.launches
    with torch.inference_mode():
        out = int8_conv.int8_conv(x, kq, *vecs, amax, stride, True)
        ref = int8_conv.int8_conv_reference(x, kq, *vecs, amax, stride, True)
    assert int8_conv.launches == before + 1
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


# K10's CPN-stream variants (batch 8): (name, H, W, Cin, Cout, k, stride,
# input kind, residual kind, int8 output)
K10_CPN_CASES = [
    ("layer1 conv2 int8->int8", 64, 48, 64, 64, 3, 1, "int8", None, True),
    ("layer2 conv2 s2 int8->int8", 64, 48, 128, 128, 3, 2, "int8", None,
     True),
    ("conv3 + bf16 downsample", 32, 24, 128, 512, 1, 1, "int8", "bf16",
     True),
    ("conv3 + int8 skip", 16, 12, 256, 1024, 1, 1, "int8", "int8", True),
    ("refine conv3, bf16 out", 8, 6, 128, 256, 1, 1, "int8", "bf16", False),
    ("up-conv, calibrated amax", 16, 12, 256, 256, 1, 1, "static", None,
     False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K10_CPN_CASES, ids=lambda c: c[0])
def test_k10_cpn_variants_match_plain_version(cuda_device, case):
    """K10's variants of the CPN int8 stream: a bf16 input with its
    calibrated amax (``serve_static_amax``), a bf16 or int8 residual added
    before the ReLU, the requantizing int8 output: equal to the plain
    version, one launch."""
    _, h, w, cin, cout, k, stride, kind, res, out8 = case
    g = torch.Generator().manual_seed(cin + cout + k)
    x, kq, vecs, amax = _int8_conv_case(g, cuda_device, 8, h, w, cin, cout,
                                        k, kind == "int8")
    if kind == "static":
        amax = torch.tensor(4.5, device=cuda_device)  # some values clip
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    kw = {"out_amax": torch.tensor(20.0, device=cuda_device) if out8
          else None}
    if res == "bf16":
        kw["residual"] = (torch.randn(8, ho, wo, cout, generator=g) * 3).to(
            cuda_device, torch.bfloat16)
    elif res == "int8":
        kw["residual"] = torch.randint(-127, 128, (8, ho, wo, cout),
                                       generator=g, dtype=torch.int8).to(
            cuda_device)
        kw["res_amax"] = torch.tensor(11.0, device=cuda_device)
    before = int8_conv.launches
    with torch.inference_mode():
        out = int8_conv.int8_conv(x, kq, *vecs, amax, stride, True, **kw)
        ref = int8_conv.int8_conv_reference(x, kq, *vecs, amax, stride, True,
                                            **kw)
    assert int8_conv.launches == before + 1
    assert out.dtype == ref.dtype == (torch.int8 if out8 else torch.bfloat16)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


@pytest.mark.cuda
def test_k1_projects_int8_maps(cuda_device):
    """K1 projecting the CPN pyramid's int8 levels (weights carrying the
    dequant scale) to bf16 samples, against the plain version's fp32:
    within the bf16 tolerance."""
    g = torch.Generator().manual_seed(3)
    maps = [torch.randint(-127, 128, (3, h, w, 256), generator=g,
                          dtype=torch.int8).to(cuda_device)
            for h, w in LEVELS]
    pts = (torch.rand(3, 4, 17, 16, 2, generator=g) * 3 - 1.5).to(cuda_device)
    projs = [((torch.rand(256, 32, generator=g) * 2 - 1) / 16 * 0.02).to(
        cuda_device) for _ in maps]
    biases = [(torch.rand(32, generator=g) * 0.2 - 0.1).to(cuda_device)
              for _ in maps]
    before = deformable.launches
    out = deformable.sample_points_multi(maps, pts, "border", True, projs,
                                         biases)
    ref = deformable.sample_points_multi_reference(maps, pts, "border", True,
                                                   projs, biases)
    assert deformable.launches == before + 1
    for o, r in zip(out, ref):
        assert o.dtype == torch.bfloat16 and r.dtype == torch.float32
        err = (o.float() - r).abs().max() / r.abs().max()
        assert err <= 2e-2, err


def _layer1_blocks(g, dev):
    def pieces(o, k):
        return (torch.randint(-127, 128, (o, k), generator=g,
                              dtype=torch.int8).to(dev),
                (torch.rand(o, generator=g) * 0.02 + 1e-3).to(dev),
                (torch.rand(o, generator=g) + 0.5).to(dev),
                (torch.randn(o, generator=g) * 0.1).to(dev))

    return [{"conv1": pieces(64, 64 if b == 0 else 256),
             "conv2": pieces(64, 576), "conv3": pieces(256, 64),
             "downsample": pieces(256, 64) if b == 0 else None,
             "t1": torch.tensor(60.0 + b, device=dev),
             "t2": torch.tensor(80.0 + b, device=dev),
             "out": torch.tensor(45.0 + b, device=dev)} for b in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 64])
def test_k9_layer1_chain_matches_plain_version(cuda_device, batch):
    """K9 on a 64x48 stem output against its plain version (the per-conv
    chain through K10's plain version): the int8 output equal, four
    launches; and against the per-conv chain through K10 on the card."""
    g = torch.Generator().manual_seed(batch)
    x = (torch.randn(batch, 64, 48, 64, generator=g) * 2).to(
        cuda_device, torch.bfloat16)
    blocks = _layer1_blocks(g, cuda_device)
    amax = torch.tensor(6.0, device=cuda_device)
    before = (layer1_chain.launches, int8_conv.launches)
    with torch.inference_mode():
        out = layer1_chain.layer1_chain(x, amax, blocks)
        ref = layer1_chain.layer1_chain_reference(x, amax, blocks)
        chain = layer1_chain.layer1_int8_chain(x, amax, blocks)
    assert (layer1_chain.launches, int8_conv.launches) == (
        before[0] + 4, before[1] + 13)
    assert out.shape == (batch, 64, 48, 256) and out.dtype == torch.int8
    assert torch.equal(out, ref)
    assert torch.equal(out, chain)
    frac = (ref.abs() == 127).float().mean().item()
    assert 0.0 < frac < 0.6, frac


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h", [(1, 64), (3, 64), (64, 64), (64, 61),
                                     (3, 37)])
def test_k9_blocks_at_ragged_shapes(cuda_device, batch, h):
    """K9's persistent schedule at ragged batches and at heights the strip
    does not divide (64x61: strips of 31 rows), block 0 (bf16 stem output
    in) and blocks 1-3 (int8 in) launched one at a time: each equal bit for
    bit to its plain version and to K10's per-conv chain on the card."""
    p = layer1_chain.plan(batch, h, 48, layer1_chain.EXPANSION,
                          layer1_chain._sms(cuda_device))
    if (batch, h) == (64, 61):
        assert h % p.strip_rows != 0
    g = torch.Generator().manual_seed(batch * h)
    x = (torch.randn(batch, h, 48, 64, generator=g) * 2).to(
        cuda_device, torch.bfloat16)
    blocks = _layer1_blocks(g, cuda_device)
    src, amax = x, torch.tensor(6.0, device=cuda_device)
    with torch.inference_mode():
        for i, blk in enumerate(blocks):
            before = layer1_chain.launches
            out = layer1_chain.layer1_block_kernel(src, amax, blk)
            assert layer1_chain.launches == before + 1
            if i == 0:
                ref = layer1_chain.layer1_chain_reference(x, amax, blocks[:1])
                chain = layer1_chain.layer1_int8_chain(x, amax, blocks[:1])
            else:  # the per-conv chain of block i on the int8 input
                res = int8_conv.dequant(src, amax, torch.bfloat16)
                outs = []
                for conv in (int8_conv.int8_conv_reference,
                             int8_conv.int8_conv):
                    y = conv(src, *blk["conv1"], amax, 1, True)
                    y = conv(int8_conv.quant_reference(y, blk["t1"]),
                             *blk["conv2"], blk["t1"], 1, True)
                    y = conv(int8_conv.quant_reference(y, blk["t2"]),
                             *blk["conv3"], blk["t2"], 1, False)
                    outs.append(int8_conv.quant_reference(
                        torch.relu(y + res), blk["out"]))
                ref, chain = outs
            assert out.shape == (batch, h, 48, 256)
            assert torch.equal(out, ref), i
            assert torch.equal(out, chain), i
            src, amax = out, blk["out"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 13, 1088, 1089])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_k3_at_every_width_and_ragged_rows(cuda_device, d, rows, dtype):
    """K3 (the tensor-core route in bf16, the CUDA-core one in fp32) at the
    lifters' widths and row counts that leave a partial 12-row tile,
    against its plain version; fp32 parameters made outside inference mode,
    as the lifter holds them."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(d + rows)
    x = torch.randn(rows, 5, d, generator=g).to(cuda_device, dtype)
    w = [(torch.randn(*s, generator=g) * sc).to(cuda_device) for s, sc in (
        ((d, 3 * d), d ** -0.5), ((3 * d,), 0.1), ((d, d), d ** -0.5),
        ((d,), 0.1))]
    before = small_attention.launches
    with torch.inference_mode():
        out = small_attention.small_attention_kernel(x, *w, 8)
        ref = small_attention.attention_reference(x, *w, 8)
    assert small_attention.launches == before + 1
    assert out.shape == ref.shape and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_deploy_request_launch_counts(cuda_device, monkeypatch):
    """One request of the full-width h36m_hrnet_32 deploy graph (batch 2,
    after ``serve.prepare``) launches K9 4 times and K10 87 times, beside
    K1-K5's 5/12/4/4/5, and agrees with the plain versions of every kernel
    (relative RMS 2e-2)."""
    counters = [(m, "launches") for m in (*KERNEL_MODULES, int8_conv,
                                          layer1_chain)]
    counters.append((deformable, "launches_k5"))
    for mod, attr in counters:
        monkeypatch.setattr(mod, attr, 0)
    cfg = serve.deploy_config("h36m_hrnet_32")
    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        cfg.model.lifter, sampler="gather", attention="einsum",
        attention_joint="einsum", mlp="einsum")))
    gen = torch.Generator().manual_seed(0)
    model = serve.build_serving_model(cfg, cuda_device, generator=gen)
    h, w = cfg.model.image_shape
    frames = torch.randint(0, 256, (2, h, w, 3), dtype=torch.uint8,
                           generator=gen)
    serve.prepare(model, [frames])
    plain = serve.build_serving_model(plain_cfg, cuda_device, generator=gen)
    plain.load_state_dict(model.state_dict())
    plain.backbone.int8_impl = "plain"
    kp = torch.rand(2, 17, 2, generator=gen) * 2 - 1
    kpc = torch.rand(2, 17, 2, generator=gen) * w
    for mod, attr in counters:
        monkeypatch.setattr(mod, attr, 0)
    out = serve.lift(model, frames, kp, kpc)
    expected = [5, 12, 4, 4, 87, 4, 5]
    assert [getattr(m, a) for m, a in counters] == expected
    ref = serve.lift(plain, frames, kp, kpc)
    assert [getattr(m, a) for m, a in counters] == expected
    assert out.shape == (2, 17, 3) and bool(torch.isfinite(out).all())
    rel = ((out - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    assert rel.item() <= 2e-2


# K10 at the narrow inputs of the "static" graphs: K = 9 Cin = 144 or 432
# bytes fills no whole 128-byte stage (W48's 48-channel branch and fuse
# convs, stride 1 and 2; the CPU tests' width-16 branch), beside Cin 64
K10_NARROW = [(cin, cout, k, stride) for cin, cout in ((16, 16), (16, 32),
                                                      (48, 48), (48, 96))
              for k, stride in ((3, 1), (3, 2))] + [(48, 48, 1, 1),
                                                    (64, 64, 3, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K10_NARROW,
                         ids=lambda c: "cin{}-cout{}-k{}-s{}".format(*c))
@pytest.mark.parametrize("route", ["static", "int8"])
def test_k10_at_cin_16_and_48_matches_plain_version(cuda_device, case,
                                                    route):
    """K10 with Cin a multiple of 16 (zero-filled K tails), batch 8 at
    W48's 64x48 level: a bf16 input with its calibrated amax (the "static"
    route: the quantize pass, then the conv) or an int8 input, equal to the
    plain version bit for bit, one conv launch."""
    cin, cout, k, stride = case
    g = torch.Generator().manual_seed(cin + cout + k + stride)
    x, kq, vecs, amax = _int8_conv_case(g, cuda_device, 8, 64, 48, cin,
                                        cout, k, route == "int8")
    if route == "static":
        amax = torch.tensor(4.5, device=cuda_device)  # some values clip
    before = int8_conv.launches, int8_conv.launches_quantize
    with torch.inference_mode():
        out = int8_conv.int8_conv(x, kq, *vecs, amax, stride, True)
        ref = int8_conv.int8_conv_reference(x, kq, *vecs, amax, stride, True)
    assert (int8_conv.launches, int8_conv.launches_quantize) == (
        before[0] + 1, before[1] + (route == "static"))
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["h36m_hrnet_48", "h36m_cpn"])
@pytest.mark.parametrize("mode", ["static", "c128"])
def test_quantize_mode_request_matches_plain_version(cuda_device, name,
                                                     mode):
    """One request (batch 2) of ``serve.quantize_config(name, mode)`` at
    full width after ``serve.prepare``: K10 once a static or wide conv (the
    counts of tests/test_torch_k10_plan.py), K10q as often, and the maps
    equal K10's plain version bit for bit; "c128" unprepared equals
    prepared."""
    calls = {("static", "h36m_hrnet_48"): 256, ("static", "h36m_cpn"): 76,
             ("c128", "h36m_hrnet_48"): 85, ("c128", "h36m_cpn"): 73}
    cfg = serve.quantize_config(name, mode)
    gen = torch.Generator().manual_seed(0)
    model = serve.build_serving_model(cfg, cuda_device, generator=gen)
    h, w = cfg.model.image_shape
    frames = torch.randint(0, 256, (2, h, w, 3), dtype=torch.uint8,
                           generator=gen).to(cuda_device)
    images = augment.serving_images(frames, cfg.model.backbone,
                                    dtype=torch.bfloat16)
    with torch.inference_mode():
        unprepared = (model.backbone(images) if mode == "c128" else None)
    serve.prepare(model, [frames])
    before = int8_conv.launches, int8_conv.launches_quantize
    with torch.inference_mode():
        maps = model.backbone(images)
        n = calls[(mode, name)]
        assert (int8_conv.launches, int8_conv.launches_quantize) == (
            before[0] + n, before[1] + n)
        model.backbone.int8_impl = "plain"
        plain = model.backbone(images)
    for a, b in zip(maps, plain):
        assert torch.equal(a, b)
    if unprepared is not None:
        for a, b in zip(maps, unprepared):
            assert torch.equal(a, b)


def _k8_case(dev, dims, mode, dtype, batch=8):
    g = torch.Generator().manual_seed(sum(dims))
    if dtype == torch.int8:
        f = torch.randint(-127, 128, (batch, *dims), generator=g,
                          dtype=torch.int8).to(dev)
    else:
        f = torch.randn(batch, *dims, generator=g).to(dev, dtype)
    pts = (torch.rand(batch, 17, 16, 2, generator=g) * 3 - 1.5).to(dev)
    return f, pts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("dims", [(64, 48, 256), (64, 48, 32)],
                         ids=["64x48x256", "64x48x32"])
def test_k8_sampler_matches_plain_version(cuda_device, dims, mode, dtype):
    """K8: ``sample_points`` through the kernel (one level) against its
    plain version, batch 8, 17x16 points, on the CPN serving pyramid's
    64x48x256 level and HRNet-W32's 64x48x32 one (the TPU's two-stage
    body). int8 maps sample to bf16 (the plain version: fp32). One K8
    launch, no K1 launch; tolerance as above (bf16 for int8)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    f, pts = _k8_case(cuda_device, dims, mode, dtype)
    before = (deformable.launches, deformable.launches_k8)
    with torch.inference_mode():
        out = deformable.sample_points(f, pts, mode)
        ref = deformable.sample_points(f, pts, mode, impl="gather")
    assert (deformable.launches, deformable.launches_k8) == (
        before[0], before[1] + 1)
    assert out.shape == ref.shape == (8, 17, 16, dims[2])
    assert out.dtype == (torch.bfloat16 if dtype == torch.int8 else dtype)
    assert ref.dtype == (torch.float32 if dtype == torch.int8 else dtype)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def _k7_case(dev, dims, ns, hd, dtype, batch=4, p=17, nh=4):
    g = torch.Generator().manual_seed(ns + hd)
    maps = [torch.randn(batch, *d, generator=g).to(dev, dtype) for d in dims]
    pts = (torch.rand(batch, len(dims), p, nh * ns, 2, generator=g) * 3
           - 1.5).to(dev)
    # weights that do not sum to one: the bias goes on every sample
    wts = (torch.rand(batch, len(dims), p, nh, ns, generator=g) * 2
           - 0.5).to(dev)
    projs = [(torch.randn(d[2], hd, generator=g) * d[2] ** -0.5).to(dev)
             for d in dims]
    biases = [(torch.randn(hd, generator=g) * 0.1).to(dev) for _ in dims]
    return maps, pts, wts, projs, biases


K7_CASES = {  # pyramid, ns, hd
    "CPN": (tuple((h, w, 256) for h, w in LEVELS), 4, 32),
    "W48": (HRNET_PYRAMIDS["W48"], 4, 32),  # the most shared memory
    "ns=3 hd=8": (((8, 6, 16), (4, 3, 32)), 3, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_aggregate_matches_plain_version(cuda_device, case, mode, dtype):
    """K7 against ``aggregate_reference`` (batch 4, 17 joints, 4 heads) at
    the CPN and HRNet-W48 pyramids and a small case with ns = 3; one
    launch; tolerance as above, level by level."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    dims, ns, hd = K7_CASES[case]
    args = _k7_case(cuda_device, dims, ns, hd, dtype)
    before = deformable.launches_k7
    with torch.inference_mode():
        out = deformable.deformable_aggregate(*args, mode)
        ref = deformable.aggregate_reference(*args, mode)
    assert deformable.launches_k7 == before + 1
    assert out.shape == ref.shape == (4, len(dims), 17, 4 * hd)
    assert out.dtype == ref.dtype == dtype
    for level in range(len(dims)):  # each level against its own scale
        o, r = out[:, level].float(), ref[:, level].float()
        err = (o - r).abs().max().item()
        assert err <= tol * r.abs().max().item(), (level, err)


def _k5_mixed_case(dev, dims, points, batch, mode, dtype, g):
    """Maps of an HRNet pyramid (int8: raw quantized numbers) and points
    (batch, 4, points, 2), with the lifter's projections in border mode
    (where ``kernel_can_preproject`` holds; to 32 channels; parameters, as
    the lifter holds them) and, on int8 maps, each projected level's
    dequant scale."""
    if dtype == torch.int8:
        feats = [torch.randint(-127, 128, (batch, h, w, c), generator=g,
                               dtype=torch.int8).to(dev) for h, w, c in dims]
    else:
        feats = [torch.randn(batch, h, w, c, generator=g).to(dev, dtype)
                 for h, w, c in dims]
    pts = (torch.rand(batch, len(dims), points, 2, generator=g) * 3
           - 1.5).to(dev)
    projs = biases = scales = None
    if mode == "border":
        on = [deformable.kernel_can_preproject(h, w, c, 32, dtype)
              for h, w, c in dims]
        projs = [torch.nn.Parameter(
            (torch.randn(c, 32, generator=g) * c ** -0.5).to(dev))
            if o else None for (_, _, c), o in zip(dims, on)]
        biases = [(torch.randn(32, generator=g) * 0.1).to(dev) if o else None
                  for o in on]
        if dtype == torch.int8:
            scales = [torch.tensor(0.02, device=dev) if o else None
                      for o in on]
    return feats, pts, projs, biases, scales


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("points", [1, 17, 272, 300])
@pytest.mark.parametrize("pyramid", sorted(HRNET_PYRAMIDS))
def test_k5_mixed_calls_at_every_point_count(cuda_device, pyramid, points,
                                             batch, mode, dtype):
    """K5's call geometry (one flat grid of per-level units,
    ``deformable.sampler_plan``) at the W32 and W48 pyramids: 1, 17, 272
    and 300 points (ragged last units), batch 1 and 3, fp32, bf16 and int8
    maps (sampled to bf16), zeros and border. In border mode the lifter's
    projections run as served: W a parameter (the tensor-core body reads
    its cached bf16 W^T), and on int8 maps the dequant scale applied to
    the product. One K1 and one K5 launch a call; tolerance as above (bf16
    for int8)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(points + batch)
    feats, pts, projs, biases, scales = _k5_mixed_case(
        cuda_device, HRNET_PYRAMIDS[pyramid], points, batch, mode, dtype, g)
    before = (deformable.launches, deformable.launches_k5)
    with torch.inference_mode():
        outs = deformable.sample_points_multi(feats, pts, mode, True, projs,
                                              biases, scales)
        refs = deformable.sample_points_multi_reference(
            feats, pts, mode, True, projs, biases, scales)
    assert (deformable.launches, deformable.launches_k5) == (
        before[0] + 1, before[1] + 1)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape
        assert o.dtype == (torch.bfloat16 if dtype == torch.int8 else dtype)
        err = (o.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [1, 7, 33, 255])
def test_k5_gather_units_of_any_size(cuda_device, monkeypatch, unit):
    """The gather takes any unit of 1..256 points (the sweep's sizes): the
    W32 pyramid's zeros call, bf16, batch 3, 272 points."""
    monkeypatch.setattr(deformable, "gather_points",
                        lambda dtype, c, points, *_: unit)
    g = torch.Generator().manual_seed(unit)
    feats, pts, *_ = _k5_mixed_case(cuda_device, HRNET_PYRAMIDS["W32"], 272,
                                    3, "zeros", torch.bfloat16, g)
    with torch.inference_mode():
        outs = deformable.sample_points_multi(feats, pts, "zeros")
        refs = deformable.sample_points_multi_reference(feats, pts, "zeros")
    for o, r in zip(outs, refs):
        err = (o.float() - r.float()).abs().max().item()
        assert err <= 2e-2 * r.float().abs().max().item(), err


K7_PAD = ((8, 6, 24), (4, 3, 40))  # C a multiple of 8, not of 16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("ns", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["W48", "pad"])
def test_k7_pools_every_sample_count(cuda_device, case, ns, mode, dtype):
    """K7's pool-first body: ns = 1, 2, 4 and 8 samples a row, 3 items of
    68 rows (204 rows a level: the last 64-row tile is ragged), weights
    that do not sum to 1 (the bias counts once a sample), both padding
    modes, at the W48 pyramid (hd 32) and at C = 24 and 40 (hd 16: the A
    tile and W^T zero-padded to 16 channels); level by level against the
    plain version, tolerance as above."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    dims, hd = (HRNET_PYRAMIDS["W48"], 32) if case == "W48" else (K7_PAD, 16)
    args = _k7_case(cuda_device, dims, ns, hd, dtype, batch=3)
    before = deformable.launches_k7
    with torch.inference_mode():
        out = deformable.deformable_aggregate(*args, mode)
        ref = deformable.aggregate_reference(*args, mode)
    assert deformable.launches_k7 == before + 1
    assert out.shape == ref.shape == (3, len(dims), 17, 4 * hd)
    for level in range(len(dims)):
        o, r = out[:, level].float(), ref[:, level].float()
        err = (o - r).abs().max().item()
        assert err <= tol * r.abs().max().item(), (level, err)


@pytest.mark.cuda
def test_k7_k8_run_under_autograd(cuda_device):
    """K8 under autograd takes K6 as its backward, K7 its plain version's
    VJP; their gradients match autograd through the plain versions (fp32,
    1e-4 of max|plain grad|)."""
    f, pts = _k8_case(cuda_device, (16, 12, 64), "border", torch.float32)
    agg = _k7_case(cuda_device, K7_CASES["ns=3 hd=8"][0], 3, 8,
                   torch.float32)
    cases = {
        "K8": ([f, pts], lambda kernel: deformable.sample_points(
            f, pts, "border", impl="fused" if kernel else "gather")),
        "K7": ([*agg[0], agg[1], agg[2], *agg[3], *agg[4]],
               lambda kernel: (deformable.deformable_aggregate if kernel
                               else deformable.aggregate_reference)(
                   *agg, "border")),
    }
    before = (deformable.launches_k8, deformable.launches_bwd,
              deformable.launches_k7)
    for name, (leaves, fn) in cases.items():
        for t in leaves:
            t.requires_grad_(True)
        grads = []
        for kernel in (True, False):
            out = fn(kernel)
            w = torch.randn_like(out) if not grads else w
            out.backward(w)
            grads.append([t.grad.clone() for t in leaves])
            for t in leaves:
                t.grad = None
        for a, b in zip(*grads):
            err = (a - b).abs().max().item()
            assert err <= 1e-4 * b.abs().max().item(), (name, err)
    assert (deformable.launches_k8, deformable.launches_bwd,
            deformable.launches_k7) == (before[0] + 1, before[1] + 1,
                                        before[2] + 1)


@pytest.mark.cuda
def test_cpn_deploy_request_launch_counts(cuda_device, monkeypatch):
    """One request of the full-width h36m_cpn deploy graph (batch 2, after
    ``serve.prepare``) launches K10 83 times (every conv but the stem),
    K10q 7 (the 3 up-convs' bf16 inputs, the step form; the 3 cascades'
    inputs and the int8 /4 map, the scale form) and K10p once (the stem)
    beside K1-K4's 5/12/4/4, and agrees with the plain versions of every
    kernel (relative RMS 2e-2), which launch none."""
    counters = [(m, "launches") for m in (*KERNEL_MODULES, int8_conv)] + [
        (int8_conv, "launches_quantize"), (int8_conv, "launches_quant_pool")]
    cfg = serve.deploy_config("h36m_cpn")
    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        cfg.model.lifter, sampler="gather", attention="einsum",
        attention_joint="einsum", mlp="einsum")))
    gen = torch.Generator().manual_seed(0)
    model = serve.build_serving_model(cfg, cuda_device, generator=gen)
    h, w = cfg.model.image_shape
    frames = torch.randint(0, 256, (2, h, w, 3), dtype=torch.uint8,
                           generator=gen)
    serve.prepare(model, [frames])
    plain = serve.build_serving_model(plain_cfg, cuda_device, generator=gen)
    plain.load_state_dict(model.state_dict())
    plain.backbone.int8_impl = "plain"
    kp = torch.rand(2, 17, 2, generator=gen) * 2 - 1
    kpc = torch.rand(2, 17, 2, generator=gen) * w
    for mod, attr in counters:
        monkeypatch.setattr(mod, attr, 0)
    out = serve.lift(model, frames, kp, kpc)
    expected = [5, 12, 4, 4, 83, 7, 1]
    assert [getattr(m, a) for m, a in counters] == expected
    ref = serve.lift(plain, frames, kp, kpc)
    assert [getattr(m, a) for m, a in counters] == expected
    assert out.shape == (2, 17, 3) and bool(torch.isfinite(out).all())
    rel = ((out - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    assert rel.item() <= 2e-2


@pytest.mark.cuda
def test_probe_counterparts_match_plain_versions(cuda_device):
    """The TPU probes' counterparts at a small batch: K10's int8 chain, its
    int32 main loop (and the build without border predication, which
    differs only at the edges), the epilogue alone, the quantize pass
    alone and the bf16 main loop; K9 on one block against K10's chain of
    it, K9's floor build; the window shift both ways."""
    from contextaware_poseformer_tpu_torch.probes import int8_chain, window

    g = torch.Generator().manual_seed(5)
    dev = cuda_device
    b, h, w, c = 2, int8_chain.H, int8_chain.W, int8_chain.C
    x = torch.randint(0, 128, (b, h, w, c), generator=g,
                      dtype=torch.int8).to(dev)
    convs = [(torch.randint(-8, 9, (c, 9 * c), generator=g,
                            dtype=torch.int8).to(dev),
              torch.full((c,), 0.02, device=dev),
              (torch.rand(c, generator=g) + 0.5).to(dev),
              (torch.randn(c, generator=g) * 0.1).to(dev)) for _ in range(3)]
    amaxes = [torch.tensor(10.0, device=dev)] * 4
    with torch.inference_mode():
        assert torch.equal(int8_chain.chain(x, convs, amaxes),
                           int8_chain.chain(x, convs, amaxes, impl="plain"))
        kq = convs[0][0]
        acc = int8_chain.accum(x, kq)
        assert torch.equal(acc, int8_chain.accum_reference(x, kq))
        nomask = int8_chain.accum(x, kq, mask=False)
        inner = (slice(None), slice(1, -1), slice(1, -1))
        assert torch.equal(nomask[inner], acc[inner])
        ws, sc, bi = convs[0][1:]
        a_in, a_out = amaxes[0], torch.tensor(12.0, device=dev)
        assert torch.equal(
            int8_chain.requant(acc, ws, sc, bi, a_in, a_out),
            int8_chain.requant_reference(acc, ws, sc, bi, a_in, a_out))
        xb = torch.randn(b, h, w, c, generator=g).to(dev, torch.bfloat16)
        assert torch.equal(int8_chain.quantize(xb, a_in),
                           int8_chain.quantize_reference(xb, a_in))
        wb = (torch.randn(c, 9 * c, generator=g) / 17).to(dev, torch.bfloat16)
        got = int8_chain.bf16_conv(xb, wb)
        ref = int8_chain.bf16_conv_reference(xb, wb)
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
        x9 = (torch.randn(b, 64, 48, 64, generator=g) * 2).to(
            dev, torch.bfloat16)
        blocks = _layer1_blocks(g, dev)
        a9 = torch.tensor(6.0, device=dev)
        one = layer1_chain.layer1_block_kernel(x9, a9, blocks[0])
        assert torch.equal(one, layer1_chain.layer1_int8_chain(
            x9, a9, blocks[:1]))
        floor = layer1_chain.layer1_chain_kernel(x9, a9, blocks, floor=True)
        assert floor.shape == (b, 64, 48, 256) and floor.dtype == torch.int8
        xf = (torch.randn(window.M, window.LANES, generator=g) * 2).to(dev)
        wv = torch.randint(-20, 21, (window.K, window.N), generator=g,
                           dtype=torch.int8).to(dev)
        a4 = torch.tensor(4.0, device=dev)
        want = window.window_matmul_reference(xf, wv, a4)
        for words in (False, True):
            assert torch.equal(window.window_matmul(xf, wv, a4, words), want)


# K10 at ragged shapes: (name, batch, H, W, Cin, Cout, k, stride); batch 1,
# a stride-2 8x6 -> 4x3 map, Cout 8, 24 and 72, Cin 32, 64 and 576
K10_RAGGED = [
    ("batch 1, 16x12 64->64 k3", 1, 16, 12, 64, 64, 3, 1),
    ("8x6 s2 -> 4x3, 32->24 k3", 2, 8, 6, 32, 24, 3, 2),
    ("Cout 8, 16x12 32->8 k1", 2, 16, 12, 32, 8, 1, 1),
    ("Cout 72, 8x6 64->72 k3", 3, 8, 6, 64, 72, 3, 1),
    ("Cin 576, 8x6 576->128 k1", 2, 8, 6, 576, 128, 1, 1),
    ("Cin 576, 8x6 s2 576->72 k3", 1, 8, 6, 576, 72, 3, 2),
]


def _k10_variants():
    """Every variant: (input, residual, relu, int8 out)."""
    return [(kind, res, relu, out8)
            for kind in ("int8", "dynamic", "static")
            for res in (None, "bf16", "int8")
            for relu in (False, True)
            for out8 in (False, True)]


def _k10_variant_args(g, dev, b, h, w, cin, cout, k, stride, kind, res,
                      out8, dtype=torch.bfloat16):
    """A K10 call's (positional arguments up to ``stride``, keywords); a
    float input and a "bf16" residual in ``dtype``, the epilogue's."""
    x, kq, vecs, amax = _int8_conv_case(g, dev, b, h, w, cin, cout, k,
                                        kind == "int8", dtype)
    if kind == "static":
        amax = torch.tensor(4.5, device=dev)  # some values clip
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    kw = {"out_amax": torch.tensor(20.0, device=dev) if out8 else None}
    if res == "bf16":
        kw["residual"] = (torch.randn(b, ho, wo, cout, generator=g) * 3).to(
            dev, dtype)
    elif res == "int8":
        kw["residual"] = torch.randint(-127, 128, (b, ho, wo, cout),
                                       generator=g, dtype=torch.int8).to(dev)
        kw["res_amax"] = torch.tensor(11.0, device=dev)
    return (x, kq, *vecs, amax, stride), kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", K10_RAGGED, ids=lambda c: c[0])
def test_k10_ragged_shapes_every_variant(cuda_device, case):
    """K10 at ragged M and N tiles, in every variant (int8, dynamic or
    calibrated bf16 input; no, bf16 or int8 residual; ReLU or not; bf16 or
    requantized int8 output): equal to the plain version, one K10 launch
    and one quantize launch for a bf16 input."""
    _, b, h, w, cin, cout, k, stride = case
    g = torch.Generator().manual_seed(b + cin + cout + k + stride)
    for kind, res, relu, out8 in _k10_variants():
        args, kw = _k10_variant_args(g, cuda_device, b, h, w, cin, cout, k,
                                     stride, kind, res, out8)
        before = (int8_conv.launches, int8_conv.launches_quantize)
        with torch.inference_mode():
            out = int8_conv.int8_conv(*args, relu, **kw)
            ref = int8_conv.int8_conv_reference(*args, relu, **kw)
        assert (int8_conv.launches, int8_conv.launches_quantize) == (
            before[0] + 1, before[1] + int(kind != "int8"))
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.equal(out, ref), (kind, res, relu, out8, (
            out.float() - ref.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", int8_conv.TILE_N)
def test_k10_every_tile_matches_plain_version(cuda_device, monkeypatch,
                                              tile):
    """Each tile width the kernel builds, forced on one shape with ragged
    M and N (3x8x6 pixels, Cout 200) and a K of 4.5 stages: equal to the
    plain version, bf16 and int8 outputs, with a residual."""
    monkeypatch.setattr(int8_conv, "plan", lambda m, n, *plan_inputs: tile)
    g = torch.Generator().manual_seed(tile)
    for kind, res, out8 in (("dynamic", "bf16", False),
                            ("int8", "int8", True)):
        args, kw = _k10_variant_args(g, cuda_device, 3, 8, 6, 64, 200, 3, 1,
                                     kind, res, out8)
        with torch.inference_mode():
            out = int8_conv.int8_conv(*args, True, **kw)
            ref = int8_conv.int8_conv_reference(*args, True, **kw)
        assert torch.equal(out, ref), (tile, kind)


# K10 with an fp32 epilogue (a backbone computing in fp32): (name, batch,
# H, W, Cin, Cout, k, stride); Cin 16, 48 and 64 (K tails zero-filled at
# 16 and 48), stride 2, ragged M and N
K10_FP32 = [
    ("Cin 16, 16x12 16->32 k3", 2, 16, 12, 16, 32, 3, 1),
    ("Cin 48 s2, 16x12 48->96 k3", 2, 16, 12, 48, 96, 3, 2),
    ("Cin 48, 8x6 48->48 k1", 3, 8, 6, 48, 48, 1, 1),
    ("Cin 64, 16x12 64->64 k3", 2, 16, 12, 64, 64, 3, 1),
    ("8x6 s2 -> 4x3, 64->72 k3", 2, 8, 6, 64, 72, 3, 2),
    ("Cout 200, 8x6 64->200 k1", 3, 8, 6, 64, 200, 1, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", int8_conv.TILE_N)
@pytest.mark.parametrize("case", K10_FP32, ids=lambda c: c[0])
def test_k10_fp32_epilogue_every_variant(cuda_device, monkeypatch, case,
                                         tile):
    """K10 with its epilogue in fp32, each tile width forced, in every
    variant (int8, dynamic or calibrated fp32 input; no, fp32 or int8
    residual; ReLU or not; fp32 or requantized int8 output): equal to the
    plain version bit for bit, one K10 launch and one quantize launch for
    an fp32 input."""
    monkeypatch.setattr(int8_conv, "plan", lambda m, n, *plan_inputs: tile)
    _, b, h, w, cin, cout, k, stride = case
    g = torch.Generator().manual_seed(b + cin + cout + k + stride + tile)
    f32 = torch.float32
    for kind, res, relu, out8 in _k10_variants():
        args, kw = _k10_variant_args(g, cuda_device, b, h, w, cin, cout, k,
                                     stride, kind, res, out8, f32)
        before = (int8_conv.launches, int8_conv.launches_quantize)
        with torch.inference_mode():
            out = int8_conv.int8_conv(*args, relu, f32, **kw)
            ref = int8_conv.int8_conv_reference(*args, relu, f32, **kw)
        assert (int8_conv.launches, int8_conv.launches_quantize) == (
            before[0] + 1, before[1] + int(kind != "int8"))
        assert out.dtype == ref.dtype == (torch.int8 if out8 else f32)
        assert out.shape == ref.shape
        assert torch.equal(out, ref), (kind, res, relu, out8, (
            out.float() - ref.float()).abs().max())


def _step_plain(x, amax, clamp):
    """The step form's plain version with its amax given (the dynamic
    route's stands for max|x|): clip(round(x / step)) in fp32."""
    step = int8_conv.dequant_step(amax, clamp=clamp)
    return torch.clamp(torch.round(x.float() / step), -127, 127).to(
        torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["step dynamic", "step calibrated",
                                  "scale"])
def test_quantize_pass_matches_plain_version(cuda_device, form):
    """K10q on the card equals its plain version bit for bit, zeros, exact
    halves of the step and +-amax included (amax 127/16: the step is 1/16
    and the scale 16 exactly, so (k + 0.5) / 16 lies halfway), in each
    form: the step form's dynamic and calibrated routes (``quantize_
    reference``) and the scale form (``quant_reference``)."""
    g = torch.Generator().manual_seed(11)
    amax = torch.tensor(127 / 16)
    x = (torch.randn(4, 8, 6, 64, generator=g) * 3).clamp(-amax, amax).to(
        torch.bfloat16)
    flat = x.view(-1)
    flat[:8] = 0
    flat[8:16] = (torch.arange(8) - 3.5) / 16
    flat[16], flat[17] = amax, -amax
    x = x.to(cuda_device)
    a = amax.to(cuda_device)
    before = int8_conv.launches_quantize
    if form == "scale":
        got = int8_conv.quant(x, a)
        want = int8_conv.quant_reference(x, a)
    else:
        calibrated = form == "step calibrated"
        got = int8_conv.quantize_kernel(x, a, calibrated)
        want = int8_conv.quantize_reference(x, a if calibrated else None)
    assert int8_conv.launches_quantize == before + 1
    assert got.dtype == torch.int8 and torch.equal(got, want)


# K10q's amax values on every bf16 pattern: the 1e-12 clamp (amax 0), tiny
# (the dynamic route's step below 2^-64 takes the IEEE division), powers
# of two, random draws, the largest finite bf16
K10Q_AMAXES = [0.0, 1e-30, 1e-19, 1e-15, 2.0 ** -20, 2.0 ** -3, 1.0, 127 / 16,
               2.0 ** 7, 2.0 ** 40, 0.0371, 5.7, 190.11514, 3.1e4, 6.02e11,
               3.3895e38]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["step dynamic", "step calibrated",
                                  "scale"])
def test_quantize_pass_on_every_bf16_pattern(cuda_device, form):
    """K10q equals its plain version bit for bit on all 65,536 bf16
    patterns (NaN and +-inf included) at each amax of K10Q_AMAXES, and the
    dynamic route on max|x| of the finite patterns and of a random
    tensor."""
    allp = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).to(cuda_device)
    for amax in K10Q_AMAXES:
        a = torch.tensor(amax, dtype=torch.float32, device=cuda_device)
        if form == "scale":
            got = int8_conv.quantize_kernel(allp, a, True, form="scale")
            want = int8_conv.quant_reference(allp, a)
        else:
            clamp = form == "step calibrated"
            got = int8_conv.quantize_kernel(allp, a, clamp)
            want = _step_plain(allp, a, clamp)
        assert torch.equal(got, want), (form, amax, int((got != want).sum()))
    if form == "step dynamic":
        finite = allp[torch.isfinite(allp.float())]
        finite = finite[:finite.numel() // 16 * 16]
        rand = (torch.randn(4096, 16, generator=torch.Generator()
                            .manual_seed(5)) * 2.5).to(torch.bfloat16)
        for x in (finite, rand.to(cuda_device)):
            got = int8_conv.quantize_kernel(x, int8_conv.absmax(x), False)
            assert torch.equal(got, int8_conv.quantize_reference(x, None))


def _fp32_edges(amax):
    """fp32 values where the step and scale forms could part from their
    plain versions: +-0, exact halves of the step 1/16 and their
    neighbours, +-amax and their neighbours, subnormals, the largest
    finite value, +-inf and NaN (a multiple of 16 values)."""
    halves = (torch.arange(-256, 257, dtype=torch.float32) + 0.5) / 16
    near = torch.cat([torch.nextafter(halves, torch.tensor(-1e30)),
                      torch.nextafter(halves, torch.tensor(1e30))])
    a = torch.tensor([amax, -amax], dtype=torch.float32)
    special = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38,
                            3.4028235e38, -3.4028235e38, float("inf"),
                            float("-inf"), float("nan")])
    x = torch.cat([halves, near, a, torch.nextafter(a, torch.zeros(2)),
                   torch.nextafter(a, a * 2), special])
    return torch.cat([x, torch.zeros(-x.numel() % 16)])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["step dynamic", "step calibrated",
                                  "scale"])
def test_quantize_pass_fp32_matches_plain_version(cuda_device, form):
    """K10q on fp32 inputs equals its plain version bit for bit in each
    form, at each amax of K10Q_AMAXES: on the edge values of
    ``_fp32_edges`` and on 2^24 random fp32 bit patterns (NaN, +-inf and
    subnormals among them); one launch a call."""
    g = torch.Generator().manual_seed(7)
    rand = torch.randint(-2 ** 31, 2 ** 31, (2 ** 24,), generator=g,
                         dtype=torch.int64).to(torch.int32).view(
        torch.float32).to(cuda_device)
    for amax in K10Q_AMAXES:
        a = torch.tensor(amax, dtype=torch.float32, device=cuda_device)
        for x in (_fp32_edges(127 / 16).to(cuda_device), rand):
            before = int8_conv.launches_quantize
            if form == "scale":
                got = int8_conv.quantize_kernel(x, a, True, form="scale")
                want = int8_conv.quant_reference(x, a)
            else:
                clamp = form == "step calibrated"
                got = int8_conv.quantize_kernel(x, a, clamp)
                want = _step_plain(x, a, clamp)
            assert int8_conv.launches_quantize == before + 1
            assert torch.equal(got, want), (form, amax,
                                            int((got != want).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(64, 128, 96, 64), (2, 15, 11, 32),
                                   (3, 9, 13, 64), (1, 1, 1, 16)])
def test_quant_pool_with_nan_inf_and_zeros(cuda_device, shape, dtype):
    """K10p, bf16 and fp32, equals ``max_pool_3x3_s2(quant(x, amax))`` bit
    for bit on a tensor seeded with NaN (a NaN quantizes to 0, so a window
    of NaN and negative values pools to 0), +-inf and +-0, a twentieth of
    the values each and the first five values one each, one launch a
    call."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(*shape, generator=g) * 3
    pick = torch.randint(0, 20, shape, generator=g)
    pick.view(-1)[:5] = torch.arange(5)
    for i, v in enumerate((float("nan"), float("inf"), float("-inf"), 0.0,
                           -0.0)):
        x = torch.where(pick == i, torch.tensor(v), x)
    x = x.to(dtype).to(cuda_device)
    a = torch.tensor(4.1, device=cuda_device)
    before = int8_conv.launches_quant_pool
    got = int8_conv.quant_max_pool_3x3_s2(x, a)
    assert int8_conv.launches_quant_pool == before + 1
    want = backbone_common.max_pool_3x3_s2(int8_conv.quant_reference(x, a))
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(got, int8_conv.quant_max_pool_3x3_s2_reference(x, a))
    assert bool(torch.isnan(x).any())


# one request of an fp32 deploy graph (``config.deploy`` built in fp32):
# K10, K10q and K10p a request, K9 none
FP32_DEPLOY_COUNTS = {"h36m_cpn": (83, 7, 1), "h36m_hrnet_32": (100, 98, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FP32_DEPLOY_COUNTS))
def test_fp32_deploy_request_matches_plain_version(cuda_device, name,
                                                   monkeypatch):
    """One request (batch 2) of ``config.deploy(preset(name))`` with its
    backbone built in fp32 (``serve.build_model(..., torch.float32,
    ...)``), after ``serve.prepare``: K10, K10q and K10p at their counts
    (the CPN 83/7/1; HRNet 100 convs, its per-conv layer1's 13 among them,
    and 85 + 13 quantizes; K9 none); against the plain graph (the same
    state with ``int8_impl="plain"`` and the plain lifter knobs, which
    launches no kernel) the backbone's maps equal bit for bit and the
    poses within 2e-2 relative RMS."""
    from contextaware_poseformer_tpu_torch import config
    from contextaware_poseformer_tpu_torch.models.capf import backbone_maps

    counters = [(int8_conv, "launches"), (int8_conv, "launches_quantize"),
                (int8_conv, "launches_quant_pool"), (layer1_chain,
                                                     "launches")]
    cfg = config.deploy(config.preset(name))
    gen = torch.Generator().manual_seed(0)
    model = serve.build_model(cfg.model, torch.float32, cuda_device, gen)
    h, w = cfg.model.image_shape
    frames = torch.randint(0, 256, (2, h, w, 3), dtype=torch.uint8,
                           generator=gen)
    serve.prepare(model, [frames])
    plain_lifter = replace(cfg.model.lifter, sampler="gather",
                           attention="einsum", attention_joint="einsum",
                           mlp="einsum")
    plain = serve.build_model(replace(cfg.model, lifter=plain_lifter),
                              torch.float32, cuda_device, gen)
    plain.load_state_dict(model.state_dict())
    plain.backbone.int8_impl = "plain"
    kp = torch.rand(2, 17, 2, generator=gen) * 2 - 1
    kpc = torch.rand(2, 17, 2, generator=gen) * w
    for mod, attr in counters:
        monkeypatch.setattr(mod, attr, 0)
    out = serve.lift(model, frames, kp, kpc)
    assert [getattr(m, a) for m, a in counters] == [
        *FP32_DEPLOY_COUNTS[name], 0]
    images = augment.serving_images(frames.to(cuda_device),
                                    cfg.model.backbone, dtype=torch.float32)
    with torch.inference_mode():
        maps, scales = backbone_maps(model.backbone(images))
        before = [getattr(m, a) for m, a in counters]
        plain_maps, plain_scales = backbone_maps(plain.backbone(images))
        ref = serve.lift(plain, frames, kp, kpc)
        assert [getattr(m, a) for m, a in counters] == before
    for a, b in zip(list(maps) + list(scales or []),
                    list(plain_maps) + list(plain_scales or [])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert out.shape == (2, 17, 3) and bool(torch.isfinite(out).all())
    rel = ((out - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    assert rel.item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128, 96, 64), (2, 15, 11, 32),
                                   (3, 9, 13, 64), (2, 16, 12, 16),
                                   (1, 1, 1, 16), (2, 7, 1, 48)])
def test_quant_pool_matches_plain_version(cuda_device, shape):
    """K10p equals ``max_pool_3x3_s2(quant(x, amax))`` bit for bit at the
    main path's stem (64, 128, 96, 64) and at ragged H and W, one launch a
    call."""
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(*shape, generator=g) * 3).to(torch.bfloat16).to(
        cuda_device)
    a = torch.tensor(4.1, device=cuda_device)
    before = int8_conv.launches_quant_pool
    got = int8_conv.quant_max_pool_3x3_s2(x, a)
    assert int8_conv.launches_quant_pool == before + 1
    want = backbone_common.max_pool_3x3_s2(int8_conv.quant_reference(x, a))
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(got, int8_conv.quant_max_pool_3x3_s2_reference(x, a))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [40, 60, 80])
@pytest.mark.parametrize("n", [1, 17, 24, 32])
def test_k4_token_and_head_counts(cuda_device, n, hd, dtype):
    """K4 at N = 1, 17, 24 and 32 tokens and head dims 40, 60 and 80 (8
    heads), against its plain version: 1e-4 of max|plain| in fp32 (TF32
    off), 2e-2 in bf16."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(n + hd)
    qkv = torch.randn(5, n, 3 * 8 * hd, generator=g).to(cuda_device, dtype)
    before = joint_attention.launches
    with torch.inference_mode():
        out = joint_attention.attention_middle_kernel(qkv, 8)
        ref = joint_attention.attention_middle_reference(qkv, 8)
    assert joint_attention.launches == before + 1
    assert out.shape == ref.shape == (5, n, 8 * hd) and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


def _mlp_params(g, dev, d):
    """LN and MLP parameters at width D (H = 2D), fp32 as the lifter holds
    them, made outside inference mode (the bf16 routes cast them once)."""
    def u(lo, hi, *shape):
        return (torch.rand(*shape, generator=g) * (hi - lo) + lo).to(dev)

    return [u(0.5, 1.5, d), u(-0.1, 0.1, d),
            u(-1, 1, d, 2 * d) / d ** 0.5, u(-0.1, 0.1, 2 * d),
            u(-1, 1, 2 * d, d) / (2 * d) ** 0.5, u(-0.1, 0.1, d)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 63, 65, 1088, 5440])
@pytest.mark.parametrize("d", [64, 96, 128, 320, 480, 640])
def test_k2_routes_at_every_width_and_ragged_rows(cuda_device, d, rows):
    """K2's bf16 routes (weights-resident at D <= 128, two-phase above) at
    the six lifter widths and row counts that leave partial 64-row tiles,
    against the plain version: 2e-2 of max|plain|; one call counted."""
    g = torch.Generator().manual_seed(d + rows)
    x = torch.randn(rows, d, generator=g).to(cuda_device, torch.bfloat16)
    p = _mlp_params(g, cuda_device, d)
    route = fused_mlp.plan(torch.bfloat16, d, 2 * d).route
    assert route == ("resident" if d <= 128 else "two-phase")
    before = fused_mlp.launches
    out = fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6)
    ref = fused_mlp.ln_mlp_reference(x, *p, 1e-6)
    assert fused_mlp.launches == before + 1
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item(), (route, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 640])
def test_k2_bf16_routes_run_under_autograd(cuda_device, d):
    """Both bf16 routes under autograd: the forward is the kernel, the
    backward the plain version's VJP; outputs within 2e-2 and gradients
    of x and the weights within 2e-2 of max|plain grad| of autograd
    through the plain version."""
    g = torch.Generator().manual_seed(d)
    x0 = torch.randn(3, 17, d, generator=g).to(cuda_device, torch.bfloat16)
    p0 = _mlp_params(g, cuda_device, d)
    w = torch.randn(3, 17, d, generator=g).to(cuda_device, torch.bfloat16)
    results = []
    for fn in (fused_mlp.ln_mlp_residual_kernel, fused_mlp.ln_mlp_reference):
        x = x0.clone().requires_grad_(True)
        p = [t.clone().requires_grad_(True) for t in p0]
        out = fn(x, *p, 1e-6)
        out.backward(w)
        results.append([out.detach(), x.grad] + [t.grad for t in p])
    for a, b in zip(*results):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * b.float().abs().max().item(), err


@pytest.mark.cuda
def test_k2_weight_cast_follows_in_place_updates(cuda_device):
    """The bf16 routes cast W1 and W2 once per parameter state: an in-place
    update of a weight changes the next call's output, as the plain
    version's; tensors made under inference mode are cast every call."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(70, 128, generator=g).to(cuda_device, torch.bfloat16)
    p = _mlp_params(g, cuda_device, 128)
    first = fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6)
    with torch.no_grad():
        p[2].mul_(-1.0)
    second = fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6)
    ref = fused_mlp.ln_mlp_reference(x, *p, 1e-6)
    assert not torch.equal(first, second)
    err = (second.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item()
    with torch.inference_mode():
        q = [t.clone() for t in p]
        out = fused_mlp.ln_mlp_residual_kernel(x, *q, 1e-6)
    assert torch.equal(out, second)


K1_PYRAMIDS = {"CPN": tuple((h, w, 256) for h, w in LEVELS),
               **HRNET_PYRAMIDS}


@pytest.mark.cuda
@pytest.mark.parametrize("points", [(17,), (17, 16), (300,)],
                         ids=["P17", "P272", "P300"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("pyramid", sorted(K1_PYRAMIDS))
def test_k1_projected_body_at_every_pyramid(cuda_device, pyramid, dtype,
                                            points):
    """K1 (K5 at the HRNet pyramids) in border mode with the lifter's
    in-sampler projection to 32 channels on every level with C > 32, on
    bf16 and int8 maps (weights carrying a dequant scale), against the
    plain version, level by level: 2e-2 of max|plain|; one launch."""
    dims = K1_PYRAMIDS[pyramid]
    g = torch.Generator().manual_seed(len(points) + dims[0][2])
    if dtype == torch.int8:
        maps = [torch.randint(-127, 128, (3, h, w, c), generator=g,
                              dtype=torch.int8).to(cuda_device)
                for h, w, c in dims]
        scale = 0.02
    else:
        maps = [torch.randn(3, h, w, c, generator=g).to(cuda_device, dtype)
                for h, w, c in dims]
        scale = 1.0
    pts = (torch.rand(3, 4, *points, 2, generator=g) * 3 - 1.5).to(
        cuda_device)
    projs = [((torch.rand(c, 32, generator=g) * 2 - 1) / c ** 0.5
              * scale).to(cuda_device) if c > 32 else None
             for *_, c in dims]
    biases = [(torch.rand(32, generator=g) * 0.2 - 0.1).to(cuda_device)
              if c > 32 else None for *_, c in dims]
    before = deformable.launches
    out = deformable.sample_points_multi(maps, pts, "border", True, projs,
                                         biases)
    ref = deformable.sample_points_multi_reference(maps, pts, "border", True,
                                                   projs, biases)
    assert deformable.launches == before + 1
    for o, r, (*_, c) in zip(out, ref, dims):
        assert o.dtype == torch.bfloat16
        assert o.shape == r.shape == (3, *points, 32 if c > 32 else c)
        err = (o.float() - r.float()).abs().max().item()
        assert err <= 2e-2 * r.float().abs().max().item(), (c, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("hd", [20, 72])
def test_f6_deformable_block_serves_head_dims_the_projection_refuses(
        cuda_device, hd, dtype):
    """F6: a deformable block with the in-sampler projection on serves head
    dims the tensor-core projection refuses (20: not a multiple of 8; 72:
    above 64) on the W32 pyramid's bf16 and int8 maps, through K1 (the
    levels gathered, then ``embed_proj``), and agrees with its plain
    version (``sampler="gather"``) to 2e-2 relative to max|plain|."""
    from contextaware_poseformer_tpu_torch.models.init import init_parameters
    from contextaware_poseformer_tpu_torch.models.lifter import (
        DeformableBlock,
    )

    dims = [c for _, _, c in HRNET_PYRAMIDS["W32"]]
    g = torch.Generator().manual_seed(6)
    blocks = []
    for impl in ("auto", "gather"):
        block = DeformableBlock(4 * hd, dims, sampler_impl=impl,
                                dtype=torch.bfloat16, pre_project=True,
                                device=cuda_device)
        init_parameters(block, torch.Generator().manual_seed(0))
        blocks.append(block)
    if dtype == torch.int8:
        feats = [torch.randint(-127, 128, (4, h, w, c), generator=g,
                               dtype=torch.int8).to(cuda_device)
                 for h, w, c in HRNET_PYRAMIDS["W32"]]
        scales = [torch.tensor([0.02], device=cuda_device) for _ in dims]
    else:
        feats = [torch.randn(4, h, w, c, generator=g).to(cuda_device, dtype)
                 for h, w, c in HRNET_PYRAMIDS["W32"]]
        scales = None
    tokens = torch.randn(4, 5, 17, 4 * hd, generator=g).to(
        cuda_device, torch.bfloat16)
    ref = (torch.rand(4, 17, 2, generator=g) * 2 - 1).to(cuda_device)
    before = deformable.launches
    with torch.no_grad():
        out, plain = (b(tokens, ref, feats, feat_scales=scales)
                      for b in blocks)
    assert deformable.launches == before + 1
    err = (out.float() - plain.float()).abs().max().item()
    assert err <= 2e-2 * plain.float().abs().max().item()


# ---- the CPN's serving knobs: K10s (the fold stem), K10u (the s8 hop) -------

def _stem_case(g, dev, dtype, batch, h=256, w=192):
    """The fold stem's operands, by default at the served width (256x192
    frames): a random conv1 (he-scaled 7x7 weights, BN scale and bias), its
    int8 weights and its bias map (``raw`` on the offset image, as the CPN
    makes it)."""
    conv = backbone_common.ConvBN(3, 64, 7, 2, True, dtype, device=dev,
                                  int8=True)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(64, 3, 7, 7, generator=g) * 0.1)
        conv.scale.copy_(torch.rand(64, generator=g) + 0.5)
        conv.bias.copy_(torch.randn(64, generator=g) * 0.1)
    kq, ws, scale, bias = (t.detach() for t in conv.packed())
    off = (128.0 - torch.tensor(augment.CPN_PIXEL_MEAN)) / 255.0
    with torch.inference_mode():
        bias_map = conv(off.to(dev).expand(1, h, w, 3), raw=True)
    frames = torch.randint(0, 256, (batch, h, w, 3), dtype=torch.uint8,
                           generator=g).to(dev)
    return frames, (kq, ws, scale, bias, bias_map, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [1, 64])
def test_k10s_matches_plain_version(cuda_device, batch, dtype):
    """K10s, the fold stem on raw uint8 frames: equal to its plain version
    bit for bit, border rows and columns included, on random frames and on
    all-0 and all-255 ones (the s8 extremes -128 and 127), one launch a
    call."""
    g = torch.Generator().manual_seed(batch)
    frames, rest = _stem_case(g, cuda_device, dtype, batch)
    for f in (frames, torch.zeros_like(frames), torch.full_like(frames, 255)):
        before = int8_conv.launches_stem
        out = int8_conv.stem_conv(f, *rest)
        assert int8_conv.launches_stem == before + 1
        ref = int8_conv.stem_conv_reference(f, *rest)
        assert out.shape == (batch, 128, 96, 64) and out.dtype == dtype
        assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", [(8, 6), (16, 12), (32, 24)])
def test_k10u_matches_plain_version(cuda_device, hw, dtype):
    """K10u, the s8 top-down hop at the three hops of a 256x192 request
    (batch 64, 256 channels): equal to its plain version bit for bit, one
    launch a call."""
    g = torch.Generator().manual_seed(hw[0])
    h, w = hw
    q = torch.randint(-127, 128, (64, h, w, 256), dtype=torch.int8,
                      generator=g).to(cuda_device)
    lat = torch.randn(64, 2 * h, 2 * w, 256, generator=g).to(cuda_device,
                                                             dtype)
    ua = torch.tensor(7.3, device=cuda_device)
    before = int8_conv.launches_topdown
    out = int8_conv.topdown(q, ua, lat, dtype)
    assert int8_conv.launches_topdown == before + 1
    ref = int8_conv.topdown_reference(q, ua, lat, dtype)
    assert out.dtype == dtype
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 37, 64), (2, 16, 32), (2, 1, 64),
                                   (1, 1, 32)])
def test_k10s_edge_shapes(cuda_device, shape, dtype):
    """K10s away from the served width: an odd frame height (the last
    output row's window runs past the frame), the narrowest frame (W 32:
    one 16-pixel tile) and one-row frames (H 1: every output row starts an
    image): equal to its plain version bit for bit, one launch a call."""
    batch, h, w = shape
    g = torch.Generator().manual_seed(h * w)
    frames, rest = _stem_case(g, cuda_device, dtype, batch, h, w)
    for f in (frames, torch.full_like(frames, 255)):
        before = int8_conv.launches_stem
        out = int8_conv.stem_conv(f, *rest)
        assert int8_conv.launches_stem == before + 1
        ref = int8_conv.stem_conv_reference(f, *rest)
        assert out.shape == (batch, (h + 1) // 2, w // 2, 64)
        assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("hwc", [(1, 1, 8), (5, 3, 24), (2, 7, 16)])
def test_k10u_edge_shapes(cuda_device, hwc, batch, dtype):
    """K10u away from the served hops: a 1x1 source (both taps folded into
    one), odd sizes and channel counts that are not a multiple of 16
    (8-byte staging, channel groups that do not fill a warp): equal to its
    plain version bit for bit, one launch a call."""
    h, w, c = hwc
    g = torch.Generator().manual_seed(h * 100 + w * 10 + batch)
    q = torch.randint(-127, 128, (batch, h, w, c), dtype=torch.int8,
                      generator=g).to(cuda_device)
    lat = torch.randn(batch, 2 * h, 2 * w, c, generator=g).to(cuda_device,
                                                              dtype)
    ua = torch.tensor(5.1, device=cuda_device)
    before = int8_conv.launches_topdown
    out = int8_conv.topdown(q, ua, lat, dtype)
    assert int8_conv.launches_topdown == before + 1
    ref = int8_conv.topdown_reference(q, ua, lat, dtype)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(8, 6), (16, 12), (32, 24)])
def test_k10_requantizes_without_relu_or_residual(cuda_device, hw):
    """K10 as the top-down up-convs run it: a bf16 input with its
    calibrated amax, 1x1 256 -> 256, the output requantized to int8 with
    no ReLU and no residual: equal to its plain version bit for bit."""
    g = torch.Generator().manual_seed(hw[1])
    x, kq, vecs, _ = _int8_conv_case(g, cuda_device, 64, *hw, 256, 256, 1,
                                     False)
    amax = torch.tensor(4.5, device=cuda_device)
    out_amax = torch.tensor(9.0, device=cuda_device)
    with torch.inference_mode():
        out = int8_conv.int8_conv(x, kq, *vecs, amax, 1, False,
                                  out_amax=out_amax)
        ref = int8_conv.int8_conv_reference(x, kq, *vecs, amax, 1, False,
                                            out_amax=out_amax)
    assert out.dtype == ref.dtype == torch.int8
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("knobs", [
    {"cpn_fold_normalize": True}, {"cpn_int8_topdown": True},
    {"cpn_fold_normalize": True, "cpn_int8_topdown": True}],
    ids=["fold", "topdown", "both"])
def test_knob_request_matches_plain_version(cuda_device, knobs, dtype):
    """One request (batch 2, 256x192 frames) of the CPN deploy graph with a
    serving knob, prepared by ``serve.prepare`` on its uint8 frames: K10s
    once (the fold) and K10u three times (the top-down); against the plain
    graph (``int8_impl="plain"``), which launches neither, the backbone's
    int8 maps and scales equal bit for bit."""
    from contextaware_poseformer_tpu_torch import config
    from contextaware_poseformer_tpu_torch.models.capf import backbone_maps

    cfg = config.deploy(config.preset("h36m_cpn"))
    cfg = replace(cfg, model=replace(cfg.model, backbone=replace(
        cfg.model.backbone, **knobs)))
    gen = torch.Generator().manual_seed(0)
    model = serve.build_model(cfg.model, dtype, cuda_device, gen)
    frames = torch.randint(0, 256, (2, 256, 192, 3), dtype=torch.uint8,
                           generator=gen)
    serve.prepare(model, [frames])
    plain = serve.build_model(cfg.model, dtype, cuda_device, gen)
    plain.load_state_dict(model.state_dict())
    plain.backbone.int8_impl = "plain"
    images = augment.serving_images(frames.to(cuda_device),
                                    cfg.model.backbone, dtype=dtype)
    counts = (int8_conv.launches_stem, int8_conv.launches_topdown)
    with torch.inference_mode():
        maps, scales = backbone_maps(model.backbone(images))
        grew = (int8_conv.launches_stem - counts[0],
                int8_conv.launches_topdown - counts[1])
        plain_maps, plain_scales = backbone_maps(plain.backbone(images))
    assert grew == (int("cpn_fold_normalize" in knobs),
                    3 * int("cpn_int8_topdown" in knobs))
    assert (int8_conv.launches_stem, int8_conv.launches_topdown) == (
        counts[0] + grew[0], counts[1] + grew[1])
    for a, b in zip(list(maps) + list(scales), list(plain_maps)
                    + list(plain_scales)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# the fp32 bodies of K2 and K3: the widths and rows they serve, the ragged
# rows around a tile, both LN eps values the lifter uses
K2_FP32_WIDTHS = (64, 96, 128, 320, 480, 640)
K2_FP32_ROWS = (1, 7, 63, 65, 1088, 4352, 5440)


def _k2_fp32_case(dev, d, rows, seed=0):
    g = torch.Generator().manual_seed(seed)

    def uniform(lo, hi, *shape):
        return (torch.rand(*shape, generator=g) * (hi - lo) + lo).to(dev)

    x = torch.randn(rows, d, generator=g).to(dev)
    return x, [uniform(0.5, 1.5, d), uniform(-0.1, 0.1, d),
               uniform(-1, 1, d, 2 * d) / d ** 0.5, uniform(-0.1, 0.1, 2 * d),
               uniform(-1, 1, 2 * d, d) / (2 * d) ** 0.5,
               uniform(-0.1, 0.1, d)]


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("rows", K2_FP32_ROWS)
@pytest.mark.parametrize("d", K2_FP32_WIDTHS)
def test_k2_fp32_at_every_width_and_ragged_rows(cuda_device, d, rows, eps):
    """K2's fp32 routes (fused to D = 128, two-phase above, each call's
    tiles from ``fused_mlp.plan``) against the plain version, within 1e-4
    of max|plain|, one launch counted a call."""
    x, p = _k2_fp32_case(cuda_device, d, rows, seed=d + rows)
    before = fused_mlp.launches
    with torch.inference_mode():
        out = fused_mlp.ln_mlp_residual_kernel(x, *p, eps)
        ref = fused_mlp.ln_mlp_reference(x, *p, eps)
    assert fused_mlp.launches == before + 1
    assert out.shape == ref.shape and out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), (
        err, fused_mlp.plan(torch.float32, d, 2 * d, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [37, 1088])
@pytest.mark.parametrize("n", [1, 2, 5, 7, 13, 17, 20])
@pytest.mark.parametrize("dtype, d", [
    (torch.float32, 32), (torch.float32, 64), (torch.float32, 96),
    (torch.float32, 128), (torch.bfloat16, 32)])
def test_k3_cuda_cores_at_every_width_and_token_count(cuda_device, dtype, d,
                                                      n, rows):
    """K3's CUDA-core body (fp32, and bf16 at D = 32, which the tensor
    cores are not built for), N from 1 to 20 tokens a row, against its
    plain version; fp32 parameters made outside inference mode."""
    assert small_attention.plan(dtype, n, d, 8).route == "cuda-core"
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(d * n + rows)
    x = torch.randn(rows, n, d, generator=g).to(cuda_device, dtype)
    w = [(torch.randn(*s, generator=g) * sc).to(cuda_device) for s, sc in (
        ((d, 3 * d), d ** -0.5), ((3 * d,), 0.1), ((d, d), d ** -0.5),
        ((d,), 0.1))]
    before = small_attention.launches
    with torch.inference_mode():
        out = small_attention.small_attention_kernel(x, *w, 8)
        ref = small_attention.attention_reference(x, *w, 8)
    assert small_attention.launches == before + 1
    assert out.shape == ref.shape and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_fp32_bodies_under_autograd_and_after_an_update(cuda_device):
    """K2's fp32 routes (fused at D = 128, two-phase at D = 640) and K3's
    CUDA-core body (fp32 at D = 128, and bf16 at D = 32, whose operands are
    cached fp32 copies) run under autograd with the plain versions' VJP
    (gradients within 1e-4 of autograd through the plain versions), and
    follow an in-place update of their parameters."""
    torch.manual_seed(0)
    cases = []
    for d, rows in ((128, 300), (640, 200)):
        x, p = _k2_fp32_case(cuda_device, d, rows)
        params = [torch.nn.Parameter(t) for t in p]
        cases.append((
            "K2", x, params,
            lambda x, ps: fused_mlp.ln_mlp_residual_kernel(x, *ps, 1e-6),
            lambda x, ps: fused_mlp.ln_mlp_reference(x, *ps, 1e-6),
            1e-4))
    for dtype, d in ((torch.float32, 128), (torch.bfloat16, 32)):
        g = torch.Generator().manual_seed(d)
        x = torch.randn(40, 5, d, generator=g).to(cuda_device, dtype)
        params = [torch.nn.Parameter((torch.randn(*s, generator=g) * sc).to(
            cuda_device)) for s, sc in (
            ((d, 3 * d), d ** -0.5), ((3 * d,), 0.1), ((d, d), d ** -0.5),
            ((d,), 0.1))]
        cases.append((
            "K3", x, params,
            lambda x, ps: small_attention.small_attention_kernel(x, *ps, 8),
            lambda x, ps: small_attention.attention_reference(x, *ps, 8),
            1e-4 if dtype == torch.float32 else 2e-2))
    for name, x, params, kernel, plain, tol in cases:
        if x.dtype == torch.float32:
            xg = x.clone().requires_grad_(True)
            grads = []
            for fn in (kernel, plain):
                out = fn(xg, params)
                out.backward(torch.ones_like(out))
                grads.append([t.grad.clone() for t in (xg, *params)])
                for t in (xg, *params):
                    t.grad = None
            for a, b in zip(*grads):
                err = (a - b).abs().max().item()
                assert err <= 1e-4 * b.abs().max().item(), (name, err)
        with torch.inference_mode():
            first = kernel(x, params)
        with torch.no_grad():
            for t in params:
                t.mul_(1.25)
        with torch.inference_mode():
            out, ref = kernel(x, params), plain(x, params)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item(), (name, err)
        assert not torch.equal(out, first), name


# K1's fp32 projected body (its own build): per level (H, W, C, Cout or None:
# gathered); the CPN and W48 border calls, W32's mixed call (level 0
# gathered in the projected build's blocks), narrow levels (the gate's C 8
# and Cout 8, C 4 -> Cout 4, W48's C 48), and outputs past one pass (36, 64)
K1_FP32_CALLS = {
    "CPN": tuple((h, w, 256, 32) for h, w in LEVELS),
    "W48": tuple((*d, 32) for d in HRNET_PYRAMIDS["W48"]),
    "W32 mixed": tuple((*d, 32 if d[2] > 32 else None)
                       for d in HRNET_PYRAMIDS["W32"]),
    "narrow": ((16, 12, 4, 4), (8, 6, 8, 8), (8, 6, 48, 8)),
    "wide Cout": ((8, 6, 64, 36), (16, 12, 128, 64)),
}


def _k1_fp32_call(dev, levels, points, batch, g, scaled=False):
    """fp32 maps, border points (batch, L, points, 2) and the levels'
    projections as parameters; the narrow call leaves its first level's
    bias out, and ``scaled`` gives every projected level a scale."""
    maps = [torch.randn(batch, h, w, c, generator=g).to(dev)
            for h, w, c, _ in levels]
    pts = (torch.rand(batch, len(levels), points, 2, generator=g) * 3
           - 1.5).to(dev)
    projs = [None if o is None else torch.nn.Parameter(
        ((torch.rand(c, o, generator=g) * 2 - 1) / c ** 0.5).to(dev))
        for _, _, c, o in levels]
    biases = [None if o is None or (l == 0 and c == 4) else
              torch.nn.Parameter((torch.rand(o, generator=g) * 0.2
                                  - 0.1).to(dev))
              for l, (_, _, c, o) in enumerate(levels)]
    scales = [torch.tensor(0.75, device=dev) if scaled and o is not None
              else None for *_, o in levels]
    return maps, pts, projs, biases, scales


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("points", [1, 17, 31, 33, 300])
@pytest.mark.parametrize("call", sorted(K1_FP32_CALLS))
def test_k1_fp32_projection_at_ragged_shapes(cuda_device, call, points,
                                             batch):
    """K1's fp32 projected body against the plain version, level by level,
    at point counts that are not a multiple of its 64-point unit (1, 17,
    31, 33, 300), batch 1 and 3: 1e-4 of max|plain| (TF32 off; the kernel
    sums in another order); one launch a call. The narrow call runs with a
    scale on every projected level."""
    g = torch.Generator().manual_seed(points * 7 + batch)
    maps, pts, projs, biases, scales = _k1_fp32_call(
        cuda_device, K1_FP32_CALLS[call], points, batch, g,
        scaled=call == "narrow")
    before = deformable.launches
    with torch.inference_mode():
        outs = deformable.sample_points_multi(maps, pts, "border", True,
                                              projs, biases, scales)
        refs = deformable.sample_points_multi_reference(
            maps, pts, "border", True, projs, biases, scales)
    assert deformable.launches == before + 1
    for o, r, (*_, c, cout) in zip(outs, refs, K1_FP32_CALLS[call]):
        assert o.dtype == torch.float32
        assert o.shape == r.shape == (batch, points, cout or c)
        err = (o - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), (c, cout, err)


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["CPN", "W32 mixed", "wide Cout"])
def test_k1_fp32_projection_under_autograd(cuda_device, call):
    """Under autograd the forward is K1's fp32 projected body and the
    backward the plain version's VJP (the JAX ``_multi_proj_bwd``): the
    samples within 1e-4 of max|plain|, the gradients of the points, maps,
    W and b within 1e-4 of autograd through the plain version."""
    g = torch.Generator().manual_seed(5)
    maps, pts, projs, biases, _ = _k1_fp32_call(
        cuda_device, K1_FP32_CALLS[call], 33, 3, g)
    maps = [f.requires_grad_(True) for f in maps]
    pts.requires_grad_(True)
    leaves = [pts, *maps, *(t for t in projs + biases if t is not None)]
    results = []
    before = deformable.launches
    for fn in (deformable.sample_points_multi,
               deformable.sample_points_multi_reference):
        outs = fn(maps, pts, "border", True, projs, biases)
        up = [torch.randn(o.shape, generator=torch.Generator().manual_seed(
            l)).to(cuda_device) for l, o in enumerate(outs)]
        torch.autograd.backward(outs, up)
        results.append(([o.detach() for o in outs],
                        [t.grad.clone() for t in leaves]))
        for t in leaves:
            t.grad = None
    assert deformable.launches == before + 1
    (outs, grads), (refs, want) = results
    for a, b in zip(outs + grads, refs + want):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (call, err)


@pytest.mark.cuda
@pytest.mark.parametrize("amax", [0.5, 4.0, 9.25])
def test_window_forms_bit_for_bit(cuda_device, amax):
    """The window-shift probe's two forms (an address offset, a 3-word
    shift) equal ``window_matmul_reference`` bit for bit, amax 0.5 (most
    lanes clipped to +-127), 4 (the probe's) and 9.25; one launch each."""
    from contextaware_poseformer_tpu_torch.probes import window

    g = torch.Generator().manual_seed(int(amax * 4))
    xf = (torch.randn(window.M, window.LANES, generator=g) * 2).to(
        cuda_device)
    wv = torch.randint(-127, 128, (window.K, window.N), generator=g,
                       dtype=torch.int8).to(cuda_device)
    a = torch.tensor(amax, device=cuda_device)
    want = window.window_matmul_reference(xf, wv, a)
    for form, words in (("offset", False), ("words", True)):
        before = window.launches[form]
        assert torch.equal(window.window_matmul(xf, wv, a, words), want)
        assert window.launches[form] == before + 1
