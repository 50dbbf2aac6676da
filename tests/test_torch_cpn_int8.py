"""The port's CPN int8 deploy graph against the JAX package, on the CPU.

A small CPN (``cpn_layers=(1, 1, 1, 1)``, 64x64 frames, batch 2, as the
JAX package's ``tests/test_cpn.py`` cuts it) goes through both packages from
the same random flax weights; the port takes K10's and K1's plain versions
(CPU tensors). The JAX package serves under ``jit``, which turns a division
by a constant into a multiplication by its fp32 reciprocal (the ``/ 127``
of every activation scale), and prepares its serving state eagerly: its
``prepare_serving`` divides (``wscale``, the calibration histogram). The
port mirrors both; here the JAX calibration pass runs under ``jit`` (a
minute eagerly) and the quantized weights eagerly, conv by conv, as the
JAX ConvBN computes them.

Tolerances: the int8 arithmetic is held bit for bit on the same inputs
(ConvBN's calibrated-amax route, the int8 ResNet and refineNet bottlenecks
with both residual kinds and their requantizing epilogues, the quantized
stem and its int8 pool, the int8 maps' quantize and scales). Whole graphs
are not: their float ops (the stem, the narrow convs of the calibration
pass, the bilinear upsample) round at other points in the two frameworks,
~1e-7 relative in fp32. Where such a difference crosses an int8 rounding
boundary of a dynamic wide conv, the graphs part by one step and the
calibrated scales downstream by up to ~2% (4 of 9 seeds at these sizes);
the fp32 fixture's seed is one where none crosses, so the scales hold to
1e-5 relative (measured <= 3e-7) and the bridged serve backbone's int8
maps and scales to 1e-2 relative RMS (measured equal). The bf16 composite
holds to the float slice's 3e-2 on the joints; the int8 level's fused
projection (sample then project, against JAX's project then sample) to
1e-5 of max|JAX|, fp32 associativity.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.data import augment as jaug
from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu.models import backbone_common as jbc
from contextaware_poseformer_tpu.models.cpn import CPN as JCPN
from contextaware_poseformer_tpu.models.cpn import _quant_i8
from contextaware_poseformer_tpu.ops import deformable as jdeformable
from contextaware_poseformer_tpu_torch import config, serve
from contextaware_poseformer_tpu_torch.models import backbone_common as bc
from contextaware_poseformer_tpu_torch.models.bridge import (
    load_jax_variables,
    variables_from_jax,
)
from contextaware_poseformer_tpu_torch.models.cpn import CPN
from contextaware_poseformer_tpu_torch.models.init import init_parameters
from contextaware_poseformer_tpu_torch.ops import deformable, int8_conv

HW = (64, 64)
LAYERS = (1, 1, 1, 1)
PLAIN_KNOBS = dict(sampler="gather", attention="einsum",
                   attention_joint="einsum", mlp="einsum")
# int8 convolutions of the JAX CPN deploy graph at full width (ResNet-50
# 16 bottlenecks x 3 + 4 downsamples, 4 laterals, 3 up-convs, 6 refineNet
# bottlenecks x 4) and at LAYERS
FULL_INT8_CONVS, SMALL_INT8_CONVS = 83, 47


def _small(cfg, **backbone):
    """A deploy Config cut to test size."""
    b = replace(cfg.model.backbone, cpn_layers=LAYERS, **backbone)
    lifter = replace(cfg.model.lifter, embed_dim_ratio=32, depth=1)
    return replace(cfg, model=replace(cfg.model, image_shape=HW, backbone=b,
                                      lifter=lifter))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    """A JAX or numpy array as a torch tensor (bf16 through fp32)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _rel_rms(ours, theirs):
    d = np.asarray(ours, np.float64) - np.asarray(theirs, np.float64)
    t = np.asarray(theirs, np.float64)
    return float(np.sqrt(np.mean(d * d)) / np.sqrt(np.mean(t * t)))


def _random_params(shapes, rng):
    """Random flax params (numpy leaves): conv kernels he-scaled, Dense
    kernels U(+-1/sqrt(fan_in)), scales U(0.5, 1.5), biases and
    ``pos_embed`` N(0, 0.1)."""
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
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _qweights(params, like):
    """The "qweights" collection of tree structure ``like`` (shapes), each
    conv's ``wscale = max|k| / 127`` and ``round(k / wscale)`` in numpy
    fp32: the IEEE operations of the JAX ConvBN's eager quantization
    (``backbone_common.py:180-183``), at a fraction of its dispatch cost."""
    out = {}
    for name, sub in like.items():
        if "kernel_q" not in sub:
            out[name] = _qweights(params[name], sub)
            continue
        k32 = np.asarray(params[name]["kernel"], np.float32)
        ws = np.abs(k32).max(axis=(0, 1, 2)) / np.float32(127.0)
        out[name] = {"kernel_q": np.round(k32 / ws).astype(np.int8),
                     "wscale": ws}
    return out


def _port_backbone(cfg, dtype, tree):
    model = CPN(cfg, dtype=dtype)
    bc.to_storage(model, dtype)
    load_jax_variables(model, tree)
    return model


@pytest.fixture(scope="module")
def fp32_backbone():
    """The tiny fp32 CPN deploy backbone: random params, the JAX
    calibration pass's maps and scales, its quantized weights and the
    served (int8 maps, scales)."""
    jcfg = _small(jconfig.deploy(jconfig.preset("h36m_cpn"))).model.backbone
    cfg = _small(config.deploy(config.preset("h36m_cpn"))).model.backbone
    rng = np.random.RandomState(4)  # see the module docstring
    x = rng.randn(2, *HW, 3).astype(np.float32)
    jmodel = JCPN(cfg=jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, 3)))
    params = _random_params(shapes["params"], rng)
    zero = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        shapes["calib"])
    apply = jax.jit(jmodel.apply, static_argnames="mutable")
    maps, upd = apply({"params": params, "calib": zero}, x,
                      mutable=("calib",))
    variables = {"params": params, "calib": _np(upd["calib"])}
    qshapes = jax.eval_shape(
        lambda v, x: jmodel.apply(v, x, mutable=["qweights"]), variables,
        x)[1]["qweights"]
    variables["qweights"] = _qweights(params, qshapes)
    served = apply(variables, x)
    return dict(cfg=cfg, x=x, params=params, variables=variables,
                maps=[np.asarray(m) for m in maps],
                served=jax.tree.map(np.asarray, served))


@pytest.fixture(scope="module")
def deploy():
    """The tiny h36m_cpn deploy composite in bf16: random params, the JAX
    package's serving state on one calibration batch, and its served
    joints under ``jit``."""
    cfg = _small(serve.deploy_config("h36m_cpn"))
    jcfg = _small(jconfig.deploy(jconfig.preset("h36m_cpn")))
    jcfg = replace(jcfg, model=replace(jcfg.model, lifter=replace(
        jcfg.model.lifter, **PLAIN_KNOBS)))
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    calib = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    kp = rng.uniform(-1, 1, (2, 17, 2)).astype(np.float32)
    kpc = rng.uniform(0, HW[1], (2, 17, 2)).astype(np.float32)
    jmodel = JCAPF(cfg=jcfg.model, dtype=jnp.bfloat16)
    init_args = (jnp.zeros((1, *HW, 3), jnp.bfloat16), kp[:1], kpc[:1])
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *init_args)
    params = _random_params(shapes["params"], rng)
    # bf16 conv kernels, as the deploy graph holds them
    params["backbone"] = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        if a.ndim == 4 else a, params["backbone"])
    zero = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        shapes["calib"])

    def images(f):
        return jaug.serving_images(jnp.asarray(f), jcfg.model.backbone,
                                   dtype=jnp.bfloat16)

    backbone = JCPN(cfg=jcfg.model.backbone, dtype=jnp.bfloat16)
    _, upd = jax.jit(backbone.apply, static_argnames="mutable")(
        {"params": params["backbone"], "calib": zero["backbone"]},
        images(calib), mutable=("calib",))
    bb = {"params": params["backbone"], "calib": _np(upd["calib"])}
    qshapes = jax.eval_shape(
        lambda v, x: backbone.apply(v, x, mutable=["qweights"]), bb,
        images(calib))[1]["qweights"]
    prepared = {"params": params, "calib": {"backbone": bb["calib"]},
                "qweights": {"backbone": _qweights(params["backbone"],
                                                   qshapes)}}
    served = jax.jit(lambda v, f, a, b: jmodel.apply(v, images(f), a, b))(
        prepared, frames, kp, kpc)
    return dict(cfg=cfg, params=params, prepared=prepared, frames=frames,
                calib=calib, kp=kp, kpc=kpc,
                theirs=np.asarray(served, np.float32))


# ---- ConvBN's calibrated-amax route ----------------------------------------

@pytest.mark.parametrize("shape,features,ksize,stride,quantile", [
    ((2, 8, 6, 256), 128, 1, 1, 0.999),
    ((2, 8, 6, 128), 128, 3, 2, 1.0),
    ((2, 4, 4, 256), 256, 1, 1, 0.999),
])
def test_convbn_static_route_matches_jax(shape, features, ksize, stride,
                                         quantile):
    """``serve_static_amax`` on a wide conv: the calibration pass records
    the input's ``observed_amax`` in ``amax`` (bit for bit) and runs the
    dynamic route; serving quantizes with max(amax, 1e-12) / 127. The
    JAX leaf is ``calib/amax``, which the bridge carries."""
    rng = np.random.RandomState(sum(shape) + features)
    cin = shape[-1]
    jconv = jbc.ConvBN(features=features, kernel_size=ksize, stride=stride,
                       relu=True, dtype=jnp.bfloat16, quantize="serve",
                       calib_quantile=quantile, serve_static_amax=True)
    params = {
        "kernel": (rng.randn(ksize, ksize, cin, features)
                   * np.sqrt(2.0 / (ksize * ksize * cin))).astype(np.float32),
        "scale": rng.uniform(0.5, 1.5, features).astype(np.float32),
        "bias": (rng.randn(features) * 0.1).astype(np.float32),
    }
    x = jnp.asarray(np.maximum(rng.randn(*shape) * 2.0, 0), jnp.bfloat16)
    x2 = jnp.asarray(rng.randn(*shape) * 1.5, jnp.bfloat16)
    # the JAX package calibrates and quantizes its weights eagerly
    cal_out, upd = jconv.apply({"params": params}, x, mutable=["calib"])
    _, q = jconv.apply({"params": params, **upd}, x, mutable=["qweights"])
    variables = {"params": params, **_np(upd), **_np(q)}
    theirs = jax.jit(jconv.apply)(variables, x2)

    port = bc.ConvBN(cin, features, ksize, stride, True, torch.bfloat16,
                     int8=True, static=True, quantile=quantile)
    assert port.static and port.dynamic
    port.to_storage(torch.bfloat16)
    load_jax_variables(port, {"params": params, "calib": variables["calib"],
                              "qweights": variables["qweights"]})
    assert float(port.amax) == float(variables["calib"]["amax"])
    fresh = bc.ConvBN(cin, features, ksize, stride, True, torch.bfloat16,
                      int8=True, static=True, quantile=quantile)
    fresh.to_storage(torch.bfloat16)
    load_jax_variables(fresh, {"params": params})
    bc.prepare_int8_weights(fresh)
    with torch.no_grad():
        ours_cal = fresh(_t(x), calibrate=True)
        ours = fresh(_t(x2))
    assert fresh.amax.item() == float(variables["calib"]["amax"])
    np.testing.assert_array_equal(ours_cal.float().numpy(),
                                  np.asarray(cal_out, np.float32))
    assert ours.dtype == torch.bfloat16 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs, np.float32))


# ---- the int8 bottlenecks ---------------------------------------------------

class _JaxBlock(JCPN):
    """The JAX package's CPN applied to one int8 bottleneck."""

    kind: str = "resnet"
    prefix: str = ""
    planes: int = 64
    stride: int = 1
    downsample: bool = True
    quant_out: bool = True

    @nn.compact
    def __call__(self, xq, amax):
        if self.kind == "resnet":
            return self._resnet_bottleneck_i8(
                xq, amax, self.prefix, self.planes, self.stride,
                self.downsample, self.quant_out)
        return self._refine_bottleneck_i8(xq, amax, self.prefix,
                                          self.quant_out)


@pytest.mark.parametrize("kind,prefix,planes,stride,downsample,shape,out", [
    ("resnet", "resnet.layer1.0", 64, 1, True, (2, 8, 8, 64), True),
    ("resnet", "resnet.layer2.0", 128, 2, True, (2, 8, 8, 256), True),
    ("resnet", "resnet.layer2.1", 128, 1, False, (2, 4, 4, 512), True),
    ("refine", "refine_net.cascade.0.0", 128, 1, True, (2, 4, 4, 256), True),
    ("refine", "refine_net.cascade.0.0", 128, 1, True, (2, 4, 4, 256),
     False),
])
def test_int8_bottlenecks_match_jax(kind, prefix, planes, stride, downsample,
                                    shape, out):
    """One int8 bottleneck of the stream, bf16, on the same int8 input,
    parameters and calibrated scales: conv1 and conv2 requantize in K10's
    epilogue, conv3 adds the downsample's bf16 output or the dequantized
    int8 skip before the ReLU and requantizes (``out``) or returns bf16:
    equal to the JAX package's ``_resnet_bottleneck_i8`` /
    ``_refine_bottleneck_i8`` under ``jit``."""
    rng = np.random.RandomState(len(prefix) + shape[-1] + out)
    jcfg = replace(jconfig.deploy(jconfig.preset("h36m_cpn")).model.backbone,
                   cpn_layers=(1, 2, 1, 1))
    block = _JaxBlock(cfg=jcfg, dtype=jnp.bfloat16, kind=kind, prefix=prefix,
                      planes=planes, stride=stride, downsample=downsample,
                      quant_out=out)
    xq = jnp.asarray(rng.randint(-127, 128, shape), jnp.int8)
    amax = jnp.float32(4.0)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0), xq, amax)
    params = _random_params(shapes["params"], rng)
    calib = {k: np.float32(v) for k, v in zip(
        sorted(shapes["calib"]), (9.0, 6.0, 7.0))}  # out, t1, t2
    variables = {"params": params, "calib": calib,
                 "qweights": _qweights(params, jax.eval_shape(
                     lambda v: block.apply(v, xq, amax,
                                           mutable=["qweights"]),
                     {"params": params, "calib": calib})[1]["qweights"])}
    theirs, theirs_amax = jax.jit(block.apply)(variables, xq, amax)

    cfg = replace(config.deploy(config.preset("h36m_cpn")).model.backbone,
                  cpn_layers=(1, 2, 1, 1))
    model = CPN(cfg, dtype=torch.bfloat16)
    bc.to_storage(model, torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))
    own = model.state_dict()
    sd = variables_from_jax({"params": params, "calib": calib})
    assert set(sd) <= set(own)
    model.load_state_dict({**own, **sd})
    bc.prepare_int8_weights(model)
    with torch.no_grad():
        ours, ours_amax = model._bottleneck_i8(
            _t(xq), torch.tensor(4.0), prefix, downsample, out)
    if out:
        assert ours.dtype == torch.int8
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        assert ours_amax.item() == float(theirs_amax)
        frac = (ours.abs() == 127).float().mean().item()
        assert 0.0 <= frac < 0.5, frac
        assert bool((ours != 0).any())
    else:
        assert ours_amax is None and theirs_amax is None
        assert ours.dtype == torch.bfloat16
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(theirs, np.float32))


@pytest.mark.parametrize("point", ["stem_pool", "feature3"])
def test_stream_quantizers_match_jax(point):
    """The quantizes the stream runs outside K10, bit for bit under
    ``jit``: the stem output quantized before the max-pool, which runs on
    int8 (``cpn.py:243-245``), and the cascade-free /4 level's int8 map
    with its dequant scale ``amax / 127`` (``cpn.py:392-407``)."""
    from contextaware_poseformer_tpu.models.backbone_common import (
        max_pool_3x3_s2 as jpool,
    )

    rng = np.random.RandomState(11)
    if point == "stem_pool":
        x = jnp.asarray(np.maximum(rng.randn(2, 17, 13, 64) * 3, 0),
                        jnp.bfloat16)
        v = jnp.float32(6.3)
        theirs = jax.jit(lambda x, v: jpool(_quant_i8(
            x, jnp.maximum(v, 1e-12))))(x, v)
        ours = bc.max_pool_3x3_s2(int8_conv.quant(_t(x), torch.tensor(6.3)))
        assert ours.dtype == torch.int8 and ours.shape == (2, 9, 7, 64)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        return
    y = jnp.asarray(rng.randn(2, 16, 12, 256) * 2, jnp.bfloat16)
    v = jnp.float32(5.7)
    tq, ts = jax.jit(lambda y, v: (
        _quant_i8(y, jnp.maximum(v, 1e-12)),
        (jnp.maximum(v, 1e-12) / 127.0).astype(jnp.float32)))(y, v)
    a = torch.clamp(torch.tensor(5.7), min=1e-12)
    np.testing.assert_array_equal(int8_conv.quant(_t(y), a).numpy(),
                                  np.asarray(tq))
    assert int8_conv.dequant_step(a, clamp=False).item() == float(ts)


# ---- calibration, the bridged serving state, the composite ------------------

def test_calibration_pass_matches_jax(fp32_backbone):
    """The port's calibration pass against the JAX package's, fp32: the
    same scale names (the stream's ``*_amax`` and each wide conv's
    ``amax``), each to 1e-5 relative, the calibration maps to 1e-2
    relative RMS (see the module docstring)."""
    fb = fp32_backbone
    model = _port_backbone(fb["cfg"], torch.float32, {"params": fb["params"]})
    bc.prepare_int8_weights(model)
    with torch.no_grad():
        maps = model(torch.from_numpy(fb["x"]), calibrate=True)
    for lvl, (o, t) in enumerate(zip(maps, fb["maps"])):
        assert o.shape == t.shape and _rel_rms(o.numpy(), t) <= 1e-2, lvl
    ours = bc.calibration_buffers(model)
    theirs = {}
    for name, value in fb["variables"]["calib"].items():
        if isinstance(value, dict):  # a ConvBN's amax
            theirs[bc.module_name(name) + ".amax"] = float(value["amax"])
        else:
            theirs[bc.module_name(name)] = float(value)
    assert set(ours) == set(theirs) and len(ours) == 78
    for name, t in theirs.items():
        assert t > 0 and abs(ours[name].item() - t) <= 1e-5 * t, name


def test_serve_backbone_with_bridged_state_matches_jax(fp32_backbone):
    """The fp32 serve backbone with the JAX package's ``calib`` and
    ``qweights`` carried over by the bridge: int8 maps and their dequant
    scales per level to 1e-2 relative RMS."""
    fb = fp32_backbone
    model = _port_backbone(fb["cfg"], torch.float32, fb["variables"])
    with torch.no_grad():
        maps, scales = model(torch.from_numpy(fb["x"]))
    tmaps, tscales = fb["served"]
    for lvl in range(4):
        assert maps[lvl].dtype == torch.int8, lvl
        assert maps[lvl].shape == tmaps[lvl].shape, lvl
        assert _rel_rms(maps[lvl].numpy(), tmaps[lvl]) <= 1e-2, lvl
        assert abs(scales[lvl].item() - float(tscales[lvl])) <= (
            1e-2 * float(tscales[lvl])), lvl


def test_deploy_composite_matches_jax(deploy):
    """uint8 frames -> (2, 17, 3): the port's ``serve.prepare`` then
    ``serve.lift`` against the JAX package's serving state and ``apply``,
    bf16: relative RMS <= 3e-2; and the same from the JAX package's
    prepared variables bridged over."""
    d = deploy
    args = [torch.from_numpy(a) for a in (d["frames"], d["kp"], d["kpc"])]
    bridged = serve.build_serving_model(d["cfg"], "cpu",
                                        variables=d["prepared"])
    ours = serve.lift(bridged, *args)
    assert ours.shape == (2, 17, 3) and ours.dtype == torch.float32
    assert bool(torch.isfinite(ours).all())
    assert _rel_rms(ours.numpy(), d["theirs"]) <= 3e-2
    model = serve.build_serving_model(
        d["cfg"], "cpu", variables={"params": d["params"]})
    serve.prepare(model, [torch.from_numpy(d["calib"])])
    assert _rel_rms(serve.lift(model, *args).numpy(), d["theirs"]) <= 3e-2


# ---- K1's int8 level projection, the graph's int8 convs ---------------------

def test_int8_level_projection_matches_jax_gather():
    """K1's plain version projecting an int8 level (raw int8 taps, fp32
    blend, weights already scaled by the dequant scale) against the JAX
    gather route, which projects the int8 map first: float32 samples,
    within fp32 associativity."""
    rng = np.random.RandomState(12)
    maps = [rng.randint(-127, 128, (2, h, w, 64)).astype(np.int8)
            for h, w in ((4, 3), (8, 6))]
    pts = rng.uniform(-1.4, 1.4, (2, 2, 17, 4, 2)).astype(np.float32)
    scale = np.float32(0.037)
    projs = [(rng.uniform(-1, 1, (64, 16)) / 8).astype(np.float32) * scale
             for _ in maps]
    biases = [rng.randn(16).astype(np.float32) * 0.1 for _ in maps]
    theirs = jdeformable.sample_points_levels(
        [jnp.asarray(m) for m in maps], jnp.asarray(pts), "border", True,
        impl="gather", projs=[jnp.asarray(p) for p in projs],
        biases=[jnp.asarray(b) for b in biases])
    ours = deformable.sample_points_levels(
        [torch.from_numpy(m) for m in maps], torch.from_numpy(pts), "border",
        True, projs=[torch.from_numpy(p) for p in projs],
        biases=[torch.from_numpy(b) for b in biases])
    for o, t in zip(ours, theirs):
        t = np.asarray(t)
        assert o.dtype == torch.float32 and o.shape == t.shape
        assert np.abs(o.numpy() - t).max() <= 1e-5 * np.abs(t).max()


def _jax_int8_convs(jaxpr):
    """(int8, float) conv_general_dilated counts of a jaxpr, sub-jaxprs
    included."""
    n8 = nf = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            if eqn.invars[0].aval.dtype == jnp.int8:
                n8 += 1
            else:
                nf += 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    a, b = _jax_int8_convs(inner)
                    n8, nf = n8 + a, nf + b
    return n8, nf


def test_deploy_graph_runs_every_jax_int8_conv_through_k10(monkeypatch):
    """The JAX CPN deploy graph has 83 int8 convolutions at full width
    (every conv but the float stem; traced, not run) and 47 at
    ``cpn_layers=(1, 1, 1, 1)``; the port's served request calls K10's
    dispatcher exactly that often."""
    for layers, want in (((3, 4, 6, 3), FULL_INT8_CONVS),
                         (LAYERS, SMALL_INT8_CONVS)):
        jcfg = replace(jconfig.deploy(jconfig.preset("h36m_cpn")).model
                       .backbone, cpn_layers=layers)
        jm = JCPN(cfg=jcfg, dtype=jnp.bfloat16)
        hw = (256, 192) if layers != LAYERS else HW
        x = jax.ShapeDtypeStruct((1, *hw, 3), jnp.bfloat16)
        variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
        jaxpr = jax.make_jaxpr(jm.apply)(variables, x).jaxpr
        assert _jax_int8_convs(jaxpr) == (want, 1), layers
    calls = []
    real = int8_conv.int8_conv
    monkeypatch.setattr(int8_conv, "int8_conv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = _small(serve.deploy_config("h36m_cpn"))
    model = serve.build_serving_model(
        cfg, "cpu", generator=torch.Generator().manual_seed(0))
    frames = torch.randint(0, 256, (2, *HW, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    serve.prepare(model, [frames])
    calls.clear()
    out = serve.lift(model, frames, torch.zeros(2, 17, 2),
                     torch.full((2, 17, 2), 32.0))
    assert len(calls) == SMALL_INT8_CONVS
    assert bool(torch.isfinite(out).all())


def test_fp32_deploy_graph_runs_every_int8_conv_through_k10(monkeypatch):
    """The tiny deploy graph with an fp32 backbone
    (``serve.build_model(cfg, torch.float32, "cpu")``, as the JAX package
    serves it at ``use_bf16=False``): each of its 47 int8 convolutions
    reaches K10's dispatcher with ``dtype`` float32 and an int8 or fp32
    input, an fp32 residual where it has one, and the stream's
    quantizes reach ``quant`` (4 calls) and ``quant_max_pool_3x3_s2`` (1)
    with fp32 tensors; the poses are finite."""
    from contextaware_poseformer_tpu_torch.models import cpn as cpn_module

    calls, quants = [], []
    real = int8_conv.int8_conv

    def k10(x, kq, ws, sc, bi, amax, stride, relu, dtype=torch.bfloat16,
            impl="auto", residual=None, res_amax=None, out_amax=None):
        calls.append((x.dtype, dtype,
                      None if residual is None else residual.dtype))
        return real(x, kq, ws, sc, bi, amax, stride, relu, dtype, impl,
                    residual, res_amax, out_amax)

    def spy(name, fn):
        def run(x, amax, impl="auto"):
            quants.append((name, x.dtype))
            return fn(x, amax, impl)
        return run

    monkeypatch.setattr(int8_conv, "int8_conv", k10)
    for name in ("quant", "quant_max_pool_3x3_s2"):
        monkeypatch.setattr(cpn_module, name,
                            spy(name, getattr(cpn_module, name)))
    cfg = _small(serve.deploy_config("h36m_cpn"))
    model = serve.build_model(cfg.model, torch.float32, "cpu",
                              generator=torch.Generator().manual_seed(0))
    assert model.backbone.dtype == torch.float32
    frames = torch.randint(0, 256, (2, *HW, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    serve.prepare(model, [frames])
    calls.clear()
    quants.clear()
    out = serve.lift(model, frames, torch.zeros(2, 17, 2),
                     torch.full((2, 17, 2), 32.0))
    assert len(calls) == SMALL_INT8_CONVS
    assert {d for _, d, _ in calls} == {torch.float32}
    assert {x for x, _, _ in calls} == {torch.int8, torch.float32}
    # every block of the tiny graph has a downsample: no int8 skip
    assert {r for _, _, r in calls} == {None, torch.float32}
    assert sorted(quants) == [("quant", torch.float32)] * 4 + [
        ("quant_max_pool_3x3_s2", torch.float32)]
    assert bool(torch.isfinite(out).all())


def test_deploy_config_and_its_int8_convs():
    """``deploy_config("h36m_cpn")`` is ``deploy(preset("h36m_cpn"))``
    unchanged: static amax, the int8 stream and int8 maps; every conv but
    the stem carries int8 state, the 73 wide ones (both channel counts >=
    128) a calibrated ``amax``."""
    cfg = serve.deploy_config("h36m_cpn")
    assert cfg == config.deploy(config.preset("h36m_cpn"))
    b = cfg.model.backbone
    assert (b.quantize, b.serve_static_amax, b.cpn_int8_stream,
            b.cpn_int8_maps, b.cpn_native_pyramid) == (
        "serve", True, True, True, True)
    model = CPN(b, dtype=torch.bfloat16, device="meta")
    convs = dict(bc.int8_convs(model))
    assert len(convs) == FULL_INT8_CONVS and "resnet_conv1" not in convs
    static = [n for n, m in convs.items() if m.static]
    assert len(static) == sum(m.dynamic for m in convs.values()) == 73
    assert all(n.startswith(("resnet_layer2", "resnet_layer3",
                             "resnet_layer4", "global_net", "refine_net"))
               for n in static)
    # the two serving knobs build (tests/test_torch_cpn_knobs.py): the
    # fold makes the stem an int8 conv, the top-down adds its hops' scales
    fold = CPN(replace(b, cpn_fold_normalize=True), device="meta")
    assert len(bc.int8_convs(fold)) == FULL_INT8_CONVS + 1
    assert "resnet_conv1" in dict(bc.int8_convs(fold))
    hops = CPN(replace(b, cpn_int8_topdown=True), device="meta")
    assert len(bc.calibration_buffers(hops)) == len(
        bc.calibration_buffers(model)) + 3
    with pytest.raises(ValueError, match="int4"):
        CPN(replace(b, quantize="int4"), device="meta")


def test_prepare_calibrates_in_chunks_of_16(monkeypatch):
    """``serve.prepare`` cuts its frames into ``bench.py``'s calibration
    chunks of 16. The calibration histogram counts in fp32, as
    ``jnp.histogram`` does, so a bin stops at 2**24: on more zeros than
    that (one 64-frame batch's CPN stem output has ~25 M) the 0.999
    quantile never reaches its share and both packages return max / 2048
    (held here, bit for bit), which saturated the whole int8 stream."""
    x = np.zeros(2 ** 24 + 2 ** 20, np.float32)
    x[:4096] = np.linspace(0.5, 3.0, 4096, dtype=np.float32)
    theirs = np.float32(jbc.observed_amax(jnp.asarray(x), 0.999))
    ours = bc.observed_amax(torch.from_numpy(x), 0.999)
    assert ours.item() == theirs == np.float32(3.0) / 2048
    seen = []
    monkeypatch.setattr(serve, "prepare_serving", lambda model, example,
                        batches: seen.extend(b[0].shape[0] for b in batches))
    cfg = _small(serve.deploy_config("h36m_cpn"))
    model = serve.build_serving_model(
        cfg, "cpu", generator=torch.Generator().manual_seed(0))
    frames = torch.zeros(40, *HW, 3, dtype=torch.uint8)
    serve.prepare(model, [frames, frames[:3]])
    assert seen == [16, 16, 8, 3]
