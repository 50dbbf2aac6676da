"""The float convolutions' epilogue (``ops/conv_epilogue.py``,
``ops/csrc/conv_epilogue.cu``): the BN affine, the residual add and the
ReLU in one pass, bit for bit the chain of ``addcmul``, add and ``relu``
it replaces, and the block tails that hand it their residual.

The CPU tests hold the plain version, the wrapper's refusals, the launch
plan, the graphs' calls and the card's smoke run's count of them; the
tests marked ``cuda`` hold the kernel against the plain version on the
card and skip without one. This file imports no JAX, so it also runs on
a GPU machine that has none:

    python -m pytest --noconftest tests/test_torch_conv_epilogue.py -q
"""

import importlib.util
from collections import Counter
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from contextaware_poseformer_tpu_torch import config, deploy_numerics, serve
from contextaware_poseformer_tpu_torch.models import backbone_common
from contextaware_poseformer_tpu_torch.models import cpn as cpn_module
from contextaware_poseformer_tpu_torch.models.cpn import CPN
from contextaware_poseformer_tpu_torch.models.hrnet import HRNet
from contextaware_poseformer_tpu_torch.ops import (
    conv_epilogue,
    int8_conv,
    layer1_chain,
)

FLOATS = (torch.bfloat16, torch.float32)
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
TAILS = [(False, False), (False, True), (True, False), (True, True)]


def _operands(shape, dtype, device="cpu", seed=0):
    """(y, scale, bias, residual) with the values that test the chain's
    edges: channel 0 of y, bias and residual -0 (the affine and the sum
    are -0 there), NaN and +-inf in y, a negative scale."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    y = torch.randn(shape, generator=g, device=device).to(dtype)
    r = torch.randn(shape, generator=g, device=device).to(dtype)
    scale = (torch.rand(c, generator=g, device=device) + 0.5).to(dtype)
    bias = (torch.randn(c, generator=g, device=device) * 0.1).to(dtype)
    scale[c // 2] = -scale[c // 2]
    y[..., 0], bias[0], r[..., 0] = -0.0, -0.0, -0.0
    flat = y.view(-1)
    flat[1::97] = float("nan")
    flat[2::101] = float("inf")
    flat[3::103] = -float("inf")
    return y, scale, bias, r


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(BITS[a.dtype]), b.contiguous().view(BITS[b.dtype]))


# ---- CPU: the plain version, the refusals, the plan, the graphs ----------

@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("res,relu", TAILS)
def test_plain_version_is_the_chain(dtype, res, relu):
    """The plain version is ``addcmul`` -> add -> ``relu``, as ConvBN and
    the block tails ran them, NaN and -0 included."""
    y, scale, bias, r = _operands((2, 3, 5, 16), dtype)
    want = torch.addcmul(bias, y, scale)
    if res:
        want = want + r
    if relu:
        want = torch.relu(want)
    got = conv_epilogue.conv_epilogue(y, scale, bias, r if res else None,
                                      relu)
    assert _same_bits(got, want)
    assert torch.isnan(got).any()
    if relu:  # relu(-0) as torch gives it, in channel 0
        assert _same_bits(got[..., 0], torch.relu(torch.full_like(
            got[..., 0], -0.0)))


def test_conv_bn_float_path_takes_a_residual():
    """A float ConvBN's ``residual`` and ``relu`` give the old tail
    ``relu(conv(x) + residual)``; an int8 residual or output still needs
    an int8 route."""
    g = torch.Generator().manual_seed(1)
    conv = backbone_common.ConvBN(8, 16, 3, 1, False, torch.float32)
    conv.reset_parameters(g)
    with torch.no_grad():
        conv.scale.uniform_(0.5, 1.5, generator=g)
        conv.bias.normal_(0, 0.1, generator=g)
    x = torch.randn(2, 6, 5, 8, generator=g)
    r = torch.randn(2, 6, 5, 16, generator=g)
    with torch.no_grad():
        old = torch.relu(conv(x) + r)
        assert torch.equal(conv(x, residual=r, relu=True), old)
        with pytest.raises(ValueError, match="int8 route"):
            conv(x, residual=(r.to(torch.int8), torch.tensor(1.0)))
        with pytest.raises(ValueError, match="int8 route"):
            conv(x, out_amax=torch.tensor(1.0))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel's wrapper raises before it launches on a dtype it does
    not take, a shape that is not NHWC or whose vectors or residual do not
    match, a non-dense tensor, and a tensor off the card."""
    y, scale, bias, r = _operands((2, 4, 3, 16), torch.float32)
    run = conv_epilogue.conv_epilogue_kernel
    with pytest.raises(TypeError, match="takes"):
        run(y.half(), scale.half(), bias.half())
    with pytest.raises(TypeError, match="takes"):
        run(y.to(torch.int8), scale, bias)
    with pytest.raises(ValueError, match="NHWC"):
        run(y[0], scale, bias)
    with pytest.raises(TypeError, match="scale and bias"):
        run(y, scale[:8], bias)
    with pytest.raises(TypeError, match="scale and bias"):
        run(y, scale.bfloat16(), bias)
    with pytest.raises(TypeError, match="residual"):
        run(y, scale, bias, r[:1])
    with pytest.raises(TypeError, match="residual"):
        run(y, scale, bias, r.bfloat16())
    with pytest.raises(ValueError, match="dense"):
        run(y.transpose(1, 2), scale, bias)
    with pytest.raises(ValueError, match="dense"):
        run(y, scale, bias, r.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        run(y, scale, bias, r)


def _walk(p, pixels, c):
    """The vectors each thread of the vector body takes (the .cu's
    ``t + k * stride``, k < UNROLL): {vector: [(thread, channel group)]}."""
    groups = c // p.width
    vecs = pixels * groups
    seen = {}
    for t in range(p.stride):
        for k in range(conv_epilogue.UNROLL):
            i = t + k * p.stride
            if i < vecs:
                seen.setdefault(i, []).append((t, t % groups))
    return seen, groups, vecs


@pytest.mark.parametrize("pixels,c,itemsize", [
    (30, 16, 2), (30, 16, 4), (7, 64, 2), (1000, 8, 2), (3, 256, 4),
    (513, 24, 2), (4, 48, 2)])
def test_plan_walks_every_vector_once_on_its_channel_group(pixels, c,
                                                           itemsize):
    """Each 16-byte vector is taken by exactly one thread, and that
    thread's vectors all belong to one channel group (so it loads one
    group's scale and bias): the vector index mod the groups a pixel is
    the thread's group."""
    p = conv_epilogue.plan(pixels, c, itemsize)
    assert p.width == 16 // itemsize
    assert p.blocks * conv_epilogue.THREADS >= p.stride
    seen, groups, vecs = _walk(p, pixels, c)
    assert p.stride % groups == 0
    assert sorted(seen) == list(range(vecs))
    for i, takers in seen.items():
        assert len(takers) == 1 and takers[0][1] == i % groups


@pytest.mark.parametrize("b,h,w,c,itemsize", [
    (512, 64, 48, 32, 2),  # HRNet-W32 branch 0
    (512, 32, 24, 64, 2),  # branch 1
    (512, 128, 96, 64, 2),  # the stems (CPN; HRNet's conv1)
    (256, 64, 48, 256, 4),  # the fp32 CPN's layer1
    (256, 8, 6, 2048, 4),  # its layer4
])
def test_plan_at_the_served_shapes(b, h, w, c, itemsize):
    """At the main paths' shapes a thread takes UNROLL vectors, one pass:
    the grid is the tensor's vectors over UNROLL x THREADS blocks, tens of
    them for each of the card's 132 SMs."""
    p = conv_epilogue.plan(b * h * w, c, itemsize)
    groups = c * itemsize // 16
    assert p.width == 16 // itemsize and p.stride % groups == 0
    vecs = b * h * w * groups
    assert (conv_epilogue.UNROLL - 1) * p.stride < vecs
    assert conv_epilogue.UNROLL * p.stride >= vecs
    assert p.blocks == -(-p.stride // conv_epilogue.THREADS)
    assert p.blocks >= 20 * 132


def test_plan_takes_the_scalar_body_off_the_vector_grid():
    """C off the vector's multiple (bf16 20, either 3) or a tensor off a
    16-byte boundary: the scalar body, a thread a value."""
    for c, itemsize, aligned in ((20, 2, True), (3, 4, True), (3, 2, True),
                                 (64, 2, False)):
        p = conv_epilogue.plan(100, c, itemsize, aligned)
        assert p.width == 1 and p.stride == 100 * c
        assert p.blocks == -(-100 * c // conv_epilogue.THREADS)
    assert conv_epilogue.plan(100, 20, 4).width == 4  # fp32: 4 divides


def _stub_int8_kernels(monkeypatch):
    """K9, K10 and the quantizes as shape-only stubs (the meta device)."""
    def k10(x, kq, ws, sc, bi, amax, stride, relu, dtype=torch.bfloat16,
            impl="auto", residual=None, res_amax=None, out_amax=None):
        k = int8_conv._kernel_size(kq, x.shape[-1])
        ho = int8_conv.out_size(x.shape[1], k, stride)
        wo = int8_conv.out_size(x.shape[2], k, stride)
        k10.tails[(residual is not None, bool(relu))] += 1
        return torch.empty((x.shape[0], ho, wo, kq.shape[0]),
                           dtype=dtype if out_amax is None else torch.int8,
                           device=x.device)

    def k10p(x, amax):
        b, h, w, c = x.shape
        return torch.empty((b, (h + 1) // 2, (w + 1) // 2, c),
                           dtype=torch.int8, device=x.device)

    k10.tails = Counter()
    monkeypatch.setattr(int8_conv, "int8_conv", k10)
    monkeypatch.setattr(layer1_chain, "layer1_chain",
                        lambda x, a, blocks, impl="auto": torch.empty(
                            (*x.shape[:3], 256), dtype=torch.int8,
                            device=x.device))
    monkeypatch.setattr(int8_conv, "quantize_kernel",
                        lambda x, a, clamp, form="step": torch.empty(
                            x.shape, dtype=torch.int8, device=x.device))
    monkeypatch.setattr(int8_conv, "quant_max_pool_kernel", k10p)
    return k10.tails


# the float epilogues of a forward, by (residual, relu), and K10's tails
# with a residual: the W32 deploy graph's 64 float BasicBlocks end in
# (True, True), its 40 int8 ones in K10's; the fuse layers' chains hand
# their running sum to 8 float and 2 int8 tails (stage 3's i=2, stage 4's
# i=2 and i=3 of the two full modules). The CPN deploy graph's only float
# conv is its stem; its 22 stream bottlenecks end in K10 as before
GRAPH_TAILS = {
    "h36m_hrnet_32 deploy": (
        {(False, True): 79, (True, True): 64, (False, False): 41,
         (True, False): 8}, {(True, True): 40, (True, False): 2}),
    "h36m_cpn deploy": ({(False, True): 1}, {(True, True): 22}),
    "h36m_cpn train": (
        {(False, True): 49, (False, False): 13, (True, True): 22}, {}),
}


def _forward_on_meta(cfg, dtype, monkeypatch, frames=False):
    """One forward of ``cfg``'s backbone on the meta device (uint8 frames
    with ``frames``), every int8 kernel stubbed: its float epilogues by
    (residual, relu), each on the kernel's route ("auto"), and K10's calls
    by (residual, relu)."""
    tails_k10 = _stub_int8_kernels(monkeypatch)
    monkeypatch.setattr(cpn_module, "topdown",
                        lambda q, ua, lat, dt, impl="auto": torch.empty(
                            lat.shape, dtype=dt, device=lat.device))
    monkeypatch.setattr(
        cpn_module, "stem_conv",
        lambda f, kq, ws, sc, bi, bias_map, dt, impl="auto": torch.empty(
            (f.shape[0], (f.shape[1] + 1) // 2, (f.shape[2] + 1) // 2,
             kq.shape[0]), dtype=dt, device=f.device))
    calls = Counter()

    def counted(y, scale, bias, residual=None, relu=False, impl="auto"):
        assert impl == "auto"
        calls[(residual is not None, bool(relu))] += 1
        return torch.empty_like(y)

    monkeypatch.setattr(conv_epilogue, "conv_epilogue", counted)
    net = {"cpn": CPN, "hrnet": HRNet}[cfg.backbone.kind]
    backbone = net(cfg.backbone, dtype=dtype, device="meta")
    images = torch.empty(2, *cfg.image_shape, 3, device="meta",
                         dtype=torch.uint8 if frames else dtype)
    with torch.inference_mode():
        backbone(images)
    return calls, tails_k10


@pytest.mark.parametrize("graph", sorted(GRAPH_TAILS))
def test_graph_float_epilogues(graph, monkeypatch):
    """Every float conv of the three cells' backbones ends in one epilogue
    call (one launch on the card), the block tails with their residual and
    ReLU in it; shapes only, on the meta device."""
    name, kind = graph.split()
    if kind == "deploy":
        cfg, dtype = serve.deploy_config(name).model, torch.bfloat16
    else:
        cfg, dtype = config.preset(name).model, torch.float32
    calls, tails_k10 = _forward_on_meta(cfg, dtype, monkeypatch)
    floats, k10s = GRAPH_TAILS[graph]
    assert dict(calls) == floats
    assert {k: v for k, v in tails_k10.items() if k[0]} == k10s


def _chip_smoke():
    """The card's smoke run (``chip_smoke.py`` at the repo's root) as a
    module, for its launch tables."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _smoke_graphs(cs):
    """(graph, model config, backbone dtype, uint8 frames, the smoke run's
    epilogue launches a forward): a graph of each of its phases."""
    def knobbed(**knobs):
        cfg = serve.deploy_config("h36m_cpn").model
        return replace(cfg, backbone=replace(cfg.backbone, **knobs))

    bf16, f32 = torch.bfloat16, torch.float32
    quant = cs.QUANT_PER_REQUEST
    return {
        "h36m_cpn slice": (serve.slice_config("h36m_cpn").model, bf16,
                           False, cs.FLOAT_EPILOGUES["cpn"]),
        "h36m_hrnet_32 slice": (serve.slice_config("h36m_hrnet_32").model,
                                bf16, False, cs.FLOAT_EPILOGUES["hrnet"]),
        "h36m_cpn deploy": (serve.deploy_config("h36m_cpn").model, bf16,
                            False, cs.INT8_PER_REQUEST["cpn"]),
        "h36m_hrnet_48 deploy": (serve.deploy_config("h36m_hrnet_48").model,
                                 bf16, False, cs.INT8_PER_REQUEST["hrnet"]),
        "h36m_cpn static": (serve.quantize_config("h36m_cpn", "static").model,
                            bf16, False, quant["static"]["cpn"]),
        "h36m_hrnet_32 static": (
            serve.quantize_config("h36m_hrnet_32", "static").model, bf16,
            False, quant["static"]["hrnet"]),
        "h36m_cpn c128": (serve.quantize_config("h36m_cpn", "c128").model,
                          bf16, False, quant["c128"]["cpn"]),
        "h36m_hrnet_32 c128": (
            serve.quantize_config("h36m_hrnet_32", "c128").model, bf16,
            False, quant["c128"]["hrnet"]),
        "h36m_hrnet_32 fp32 deploy": (
            config.deploy(config.preset("h36m_hrnet_32")).model, f32, False,
            cs.FP32_PER_REQUEST["hrnet"]),
        "h36m_cpn fold+topdown": (
            knobbed(cpn_fold_normalize=True, cpn_int8_topdown=True), bf16,
            True, {**cs.INT8_PER_REQUEST["cpn"],
                   **cs.KNOB_PER_REQUEST["cpn_fold_normalize"]}),
        "mpi_3dhp_hrnet_32 train": (
            config.preset("mpi_3dhp_hrnet_32").model, f32, False,
            cs.TRAIN_RUNS[2][3]),
        "h36m_cpn tiny gate": (
            deploy_numerics._tiny_cfg("h36m_cpn").model, f32, False,
            cs.GATE_PRESETS["h36m_cpn"][0]),
        "h36m_hrnet_32 tiny gate": (
            deploy_numerics._tiny_cfg("h36m_hrnet_32").model, f32, False,
            cs.GATE_PRESETS["h36m_hrnet_32"][0]),
    }


SMOKE_GRAPHS = ["h36m_cpn slice", "h36m_hrnet_32 slice", "h36m_cpn deploy",
                "h36m_hrnet_48 deploy", "h36m_cpn static",
                "h36m_hrnet_32 static", "h36m_cpn c128", "h36m_hrnet_32 c128",
                "h36m_hrnet_32 fp32 deploy", "h36m_cpn fold+topdown",
                "mpi_3dhp_hrnet_32 train", "h36m_cpn tiny gate",
                "h36m_hrnet_32 tiny gate"]


@pytest.mark.parametrize("graph", SMOKE_GRAPHS)
def test_chip_smoke_counts_the_epilogues(graph, monkeypatch):
    """The card's smoke run holds every phase to the float epilogue's
    launches a forward from its tables: each equals the graph's float convs
    on the meta device (K9, K10, K10q, K10p, K10s and K10u stubbed), the
    folded stem's (uint8 frames into K10s) none."""
    cs = _chip_smoke()
    assert set(_smoke_graphs(cs)) == set(SMOKE_GRAPHS)
    cfg, dtype, frames, table = _smoke_graphs(cs)[graph]
    calls, _ = _forward_on_meta(cfg, dtype, monkeypatch, frames)
    assert sum(calls.values()) == table["conv_epilogue"]


# ---- the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    serve.configure_numerics()
    return torch.device("cuda")


# (case, batch, H, W, C): HRNet-W32's stem (conv1's output is also the CPN
# stem's) and branches 0 and 1 at batch 512; the fp32 CPN's bottleneck
# outputs of each ResNet layer at the training batch 256; C off 8 (bf16's
# scalar body; fp32's vector of 4) and off 4 (both scalar)
CARD_SHAPES = [
    ("W32 conv1 / CPN stem", 512, 128, 96, 64),
    ("W32 conv2", 512, 64, 48, 64),
    ("W32 branch 0", 512, 64, 48, 32),
    ("W32 branch 1", 512, 32, 24, 64),
    ("CPN layer1", 256, 64, 48, 256),
    ("CPN layer2", 256, 32, 24, 512),
    ("CPN layer3", 256, 16, 12, 1024),
    ("CPN layer4", 256, 8, 6, 2048),
    ("C 20", 3, 7, 9, 20),
    ("C 3", 2, 5, 7, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("case", CARD_SHAPES, ids=lambda c: c[0])
def test_kernel_equals_the_chain(cuda_device, case, dtype, monkeypatch):
    """The kernel against the plain version bit for bit, with and without
    a residual and a ReLU, NaN, +-inf and -0 included; in place into y
    through the dispatcher too."""
    _, b, h, w, c = case
    y, scale, bias, r = _operands((b, h, w, c), dtype, cuda_device)
    monkeypatch.setattr(conv_epilogue, "launches", 0)
    with torch.inference_mode():
        for res, relu in TAILS:
            rr = r if res else None
            want = conv_epilogue.conv_epilogue_reference(y, scale, bias, rr,
                                                         relu)
            got = conv_epilogue.conv_epilogue_kernel(y, scale, bias, rr,
                                                     relu)
            assert _same_bits(got, want), (res, relu)
            del got
            yy = y.clone()
            got = conv_epilogue.conv_epilogue(yy, scale, bias, rr, relu)
            assert got.data_ptr() == yy.data_ptr()
            assert _same_bits(got, want), (res, relu)
            del got, yy, want
    assert conv_epilogue.launches == 2 * len(TAILS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("res,relu", TAILS)
def test_kernel_under_autograd_gives_the_chains_gradients(
        cuda_device, dtype, res, relu, monkeypatch):
    """Where autograd records through an operand (an unfrozen backbone)
    the dispatcher still launches the kernel, into a fresh tensor (y left
    as it was, since the backward reads it), and its backward is the
    chain's: the output and the gradients of y, scale, bias and the
    residual equal the chain's under autograd bit for bit."""
    ops = [torch.nan_to_num(t, 0.0, 0.0, 0.0) for t in
           _operands((4, 16, 12, 24), dtype, cuda_device, seed=3)]
    g = torch.Generator(device=cuda_device).manual_seed(4)
    grad = torch.randn(ops[0].shape, generator=g, device=cuda_device
                       ).to(dtype)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in ops[:3 + res]]
        out = fn(*leaves[:3], leaves[3] if res else None, relu)
        out.backward(grad)
        return out.detach(), leaves[0].detach(), [t.grad for t in leaves]

    monkeypatch.setattr(conv_epilogue, "launches", 0)
    got, y_after, got_grads = run(conv_epilogue.conv_epilogue)
    assert conv_epilogue.launches == 1
    want, _, want_grads = run(conv_epilogue.conv_epilogue_reference)
    assert _same_bits(got, want)
    assert _same_bits(y_after, ops[0])
    assert len(got_grads) == 3 + res
    for a, b in zip(got_grads, want_grads):
        assert _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FLOATS)
def test_kernel_off_a_16_byte_boundary(cuda_device, dtype):
    """Tensors that start off a 16-byte boundary take the scalar body and
    equal the chain."""
    shape = (4, 16, 12, 32)
    y, scale, bias, r = _operands(shape, dtype, cuda_device)
    n = y.numel()
    ys = torch.empty(n + 1, dtype=dtype, device=cuda_device)[1:].view(shape)
    ys.copy_(y)
    assert ys.data_ptr() % 16
    with torch.inference_mode():
        want = conv_epilogue.conv_epilogue_reference(y, scale, bias, r, True)
        got = conv_epilogue.conv_epilogue_kernel(ys, scale, bias, r, True)
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("prefix,hw,c", [
    ("stage2.0.branches.0.0", (64, 48), 32),  # float convs
    ("stage3.0.branches.2.0", (16, 12), 128),  # wide: K10, dynamic
    ("stage4.0.branches.3.0", (8, 6), 256),
])
def test_basic_block_equals_the_old_tail(cuda_device, prefix, hw, c):
    """A BasicBlock of the W32 deploy graph, its tail in conv2's epilogue
    (the float pass, or K10's residual epilogue), equals
    ``relu(conv2(conv1(x)) + x)`` computed the old way: the plain chain
    after a float conv2, torch's add and ReLU after K10's conv2."""
    model = serve.build_serving_model(
        serve.deploy_config("h36m_hrnet_32"), cuda_device,
        generator=torch.Generator().manual_seed(0))
    bb = model.backbone
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.relu(torch.randn(16, *hw, c, generator=g, device=cuda_device)
                   ).to(torch.bfloat16)
    conv2 = getattr(bb, backbone_common.module_name(f"{prefix}.conv2"))
    with torch.inference_mode():
        new = bb._basic_block(x, prefix)
        if not conv2.int8:
            bb.int8_impl = "plain"
        y = bb._conv(f"{prefix}.conv1", x)
        old = torch.relu(bb._conv(f"{prefix}.conv2", y) + x)
        bb.int8_impl = "auto"
    assert _same_bits(new, old)
