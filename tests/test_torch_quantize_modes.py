"""The backbones' ``quantize="static"`` and ``"c128"`` graphs against the
JAX package, on the CPU.

A width-16 HRNet (one BasicBlock a branch, so its 16-channel branch takes
K10 at Cin 16) and the small CPN (``cpn_layers=(1, 1, 1, 1)``), 64x64
frames, fp32, from the same random flax weights, as
``serve.quantize_config`` builds them (the float slice with the mode set).
The JAX package prepares its serving state eagerly (``prepare_serving``:
the calibration pass, which under "static" runs every conv in float, and
the quantized weights) and serves under ``jit``; the port mirrors both and
takes K10's plain version (CPU tensors).

Tolerances: the int8 arithmetic is bit for bit on the same inputs: a
static ConvBN's calibrated ``amax``, its quantized weights and its served
output at Cin 16, 48 and 64, stride 1 and 2; K10's int32 accumulation at
Cin 16 and 48; every conv's quantized weights; and every int8 conv of each
graph on the inputs that the JAX package's served graph gives it
(``nn.intercept_methods``), up to the rounding of the float epilogue.
Whole graphs are not: their float ops round at other points in the two
frameworks (~1e-7 relative in fp32), so the calibrated scales of the float
calibration pass hold to 1e-5 relative (at quantile 1, the max; measured
<= 2.6e-6), and where a float difference crosses an int8 rounding
boundary the chained int8 convs carry the one-step difference on.
``tests/torch_quantize_readings.py`` reads each graph over 3 draws of the
weights x 6 of the input: where nothing crossed the maps agreed to
<= 1.4e-6 relative RMS a level; crossings came in 6, 1, 6 and 9 of 18
draws (HRNet static, HRNet c128, CPN static, CPN c128, whose dynamic scale
is the runtime max|x|) and parted the maps by up to 1.8e-2, 2.9e-3,
2.6e-2 and 4.0e-2. The maps are held to 1e-1 on every draw of ``DRAWS``.
"""

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.models import backbone_common as jbc
from contextaware_poseformer_tpu.models.cpn import CPN as JCPN
from contextaware_poseformer_tpu.models.hrnet import HRNet as JHRNet
from contextaware_poseformer_tpu_torch import config, serve
from contextaware_poseformer_tpu_torch.models import backbone_common as bc
from contextaware_poseformer_tpu_torch.models import bridge
from contextaware_poseformer_tpu_torch.models.cpn import CPN
from contextaware_poseformer_tpu_torch.models.hrnet import HRNet
from contextaware_poseformer_tpu_torch.ops import int8_conv

HW = (64, 64)
WIDTH = 16
CASES = [("hrnet", "static"), ("hrnet", "c128"), ("cpn", "static"),
         ("cpn", "c128")]
PRESET = {"hrnet": "h36m_hrnet_32", "cpn": "h36m_cpn"}
MAPS_REL_RMS = 1e-1
SCALE_RTOL = 1e-5
DRAWS = 3  # input draws a graph


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tiny graphs run op by op,
    and a pool of threads a test worker only contends with the other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(backbone, cfglib, kind, mode):
    """A slice backbone cut to test size, ``quantize=mode``, scales at
    the max (quantile 1)."""
    b = replace(backbone, quantize=mode, calib_quantile=1.0,
                serve_static_amax=False, cpn_int8_stream=False,
                cpn_int8_maps=False)
    if kind == "cpn":
        return replace(b, cpn_layers=(1, 1, 1, 1))
    c = tuple(WIDTH * 2 ** i for i in range(4))
    st = cfglib.HRNetStageConfig
    return replace(b, width=WIDTH, stage2=st(1, 2, (1, 1), c[:2]),
                   stage3=st(1, 3, (1, 1, 1), c[:3]),
                   stage4=st(1, 4, (1, 1, 1, 1), c))


def _configs(kind, mode):
    """(port backbone config, JAX backbone config), equal field by field."""
    ours = _cut(serve.quantize_config(PRESET[kind], mode).model.backbone,
                config, kind, mode)
    theirs = _cut(jconfig.deploy(jconfig.preset(PRESET[kind])).model.backbone,
                  jconfig, kind, mode)
    assert asdict(ours) == asdict(theirs)
    return ours, theirs


def _random_params(shapes, rng):
    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            v = rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:3]))
        elif "'scale'" in name:
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.randn(*s.shape) * 0.1
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_qweights(params, like):
    """The "qweights" collection shaped as ``like``, each kernel quantized
    eagerly from ``params`` as the JAX ConvBN does it
    (``backbone_common.py:179-183``, run by ``prepare_serving``)."""
    out = {}
    for name, sub in like.items():
        k32 = jnp.asarray(params[name]["kernel"], jnp.float32)
        ws = jnp.max(jnp.abs(k32), axis=(0, 1, 2)) / 127.0
        out[name] = {"kernel_q": np.asarray(
            jnp.round(k32 / ws).astype(jnp.int8)), "wscale": np.asarray(ws)}
        assert out[name]["kernel_q"].shape == sub["kernel_q"].shape
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_rms(ours, theirs):
    d = np.asarray(ours, np.float64) - np.asarray(theirs, np.float64)
    t = np.asarray(theirs, np.float64)
    return float(np.sqrt(np.mean(d * d)) / np.sqrt(np.mean(t * t)))


def _bf16(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def graph(request):
    """One graph: random params, the JAX package's prepared variables
    (calibrated on ``calib`` under "static", weights quantized eagerly) and
    its maps served under ``jit`` on each input draw of ``xs``."""
    kind, mode = request.param
    cfg, jcfg = _configs(kind, mode)
    rng = np.random.RandomState(4)
    xs = [rng.randn(2, *HW, 3).astype(np.float32) for _ in range(DRAWS)]
    calib = rng.randn(2, *HW, 3).astype(np.float32)
    jmodel = (JHRNet if kind == "hrnet" else JCPN)(cfg=jcfg,
                                                   dtype=jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, 3)))
    params = _random_params(shapes["params"], rng)
    variables = {"params": params}
    if mode == "static":
        _, upd = jax.jit(jmodel.apply, static_argnames="mutable")(
            variables, calib, mutable=("calib",))
        variables["calib"] = _np(upd["calib"])
    q_shapes = jax.eval_shape(
        lambda v, x: jmodel.apply(v, x, mutable=["qweights"]), variables,
        jnp.zeros((1, *HW, 3)))[1]["qweights"]
    variables["qweights"] = _jax_qweights(params, q_shapes)
    apply = jax.jit(jmodel.apply)
    return dict(kind=kind, mode=mode, cfg=cfg, xs=xs, x=xs[0], calib=calib,
                params=params, variables=variables, jmodel=jmodel,
                maps=[[np.asarray(m) for m in apply(variables, x)]
                      for x in xs])


def _port(graph, tree=None):
    model = (HRNet if graph["kind"] == "hrnet" else CPN)(graph["cfg"])
    bc.to_storage(model, torch.float32)
    bridge.load_jax_variables(model, tree or {"params": graph["params"]})
    return model.eval()


def _maps(model, x):
    with torch.no_grad():
        return [m.numpy() for m in model(torch.from_numpy(x))]


def test_calibration_and_weights_match_jax(graph):
    """The port's calibration pass (``calibrate_quantization``: every conv
    in float under "static") records the JAX package's scales, and
    ``prepare_int8_weights`` stores its quantized weights bit for bit, on
    the same convs; "c128" has no scales to record."""
    model = _port(graph)
    bc.prepare_int8_weights(model)
    qweights = graph["variables"]["qweights"]
    convs = dict(bc.int8_convs(model))
    assert set(convs) == {bc.module_name(n) for n in qweights}
    for name, leaves in qweights.items():
        conv = convs[bc.module_name(name)]
        kq = leaves["kernel_q"]
        np.testing.assert_array_equal(
            conv.kernel_q.numpy(),
            kq.transpose(3, 0, 1, 2).reshape(kq.shape[3], -1))
        np.testing.assert_array_equal(conv.wscale.numpy(), leaves["wscale"])
        assert conv.static == (graph["mode"] == "static")
    scales = bc.calibration_buffers(model)
    if graph["mode"] == "c128":
        assert not scales and "calib" not in graph["variables"]
        return
    bc.calibrate_quantization(model, [(torch.from_numpy(graph["calib"]),)])
    theirs = graph["variables"]["calib"]
    assert set(scales) == {f"{bc.module_name(n)}.amax" for n in theirs}
    for name, leaf in theirs.items():
        ours = scales[f"{bc.module_name(name)}.amax"].item()
        assert ours > 0
        np.testing.assert_allclose(ours, leaf["amax"], rtol=SCALE_RTOL)
    bc.check_calibrated(model)


def test_backbone_maps_match_jax(graph):
    """The port's maps from the JAX package's prepared variables (through
    the bridge) against the JAX package's served maps on every input draw:
    1e-1 relative RMS a level, the bound the module docstring derives.
    (Scales of the port's own calibration sit ~1e-6 from JAX's; they are
    held in ``test_calibration_and_weights_match_jax``.)"""
    model = _port(graph, graph["variables"])
    assert all(c.weights_ready for _, c in bc.int8_convs(model))
    for x, theirs in zip(graph["xs"], graph["maps"]):
        ours = _maps(model, x)
        assert len(ours) == len(theirs) == 4
        for level, (a, b) in enumerate(zip(ours, theirs)):
            assert a.shape == b.shape
            assert _rel_rms(a, b) < MAPS_REL_RMS, level


def _jax_int8_calls(graph, x):
    """Every call of an int8 ConvBN in the JAX package's served graph on
    ``x`` (under ``jit``, the captured tensors returned as outputs), by
    conv name: [(its input, its output)]."""
    names = set(graph["variables"]["qweights"])

    def served(variables, x):
        calls = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            m = context.module
            if (context.method_name == "__call__"
                    and isinstance(m, jbc.ConvBN) and m.name in names):
                calls.setdefault(m.name, []).append((args[0], out))
            return out

        with nn.intercept_methods(record):
            graph["jmodel"].apply(variables, x)
        return calls

    return _np(jax.jit(served)(graph["variables"], x))


@pytest.mark.parametrize("draw", range(2))
def test_int8_convs_match_jax_on_its_inputs(graph, draw):
    """Each int8 conv of the port's graph, given the input that the JAX
    package's served graph gives the same conv, returns that conv's output
    up to the rounding of the float epilogue (1e-5 of the conv's largest
    output; one int8 step of the input or the weights moves an output by
    ~1e-2 of it), for every int8 conv the graph runs: the quantization and
    the int8 accumulation are JAX's exactly."""
    model = _port(graph, graph["variables"])
    convs = dict(bc.int8_convs(model))
    calls = _jax_int8_calls(graph, graph["xs"][draw])
    assert set(calls) == set(graph["variables"]["qweights"])
    for name, seen in calls.items():
        conv = convs[bc.module_name(name)]
        for x, theirs in seen:
            with torch.no_grad():
                ours = conv(torch.from_numpy(np.array(x)))
            np.testing.assert_allclose(
                ours.numpy(), theirs, rtol=0,
                atol=1e-5 * np.abs(theirs).max(), err_msg=name)


def test_c128_serves_unprepared_as_prepared(graph):
    """"c128" quantizes each wide conv's weight on every call until
    ``prepare_int8_weights`` stores it: the two give the same maps, bit for
    bit, and a model loaded from the prepared state uses the stored weights
    ("static" needs its scales first: ``check_calibrated``)."""
    model = _port(graph)
    if graph["mode"] == "static":
        with pytest.raises(ValueError, match="uncalibrated"):
            bc.check_calibrated(model)
        return
    assert not any(c.weights_ready for _, c in bc.int8_convs(model))
    before = _maps(model, graph["x"])
    bc.prepare_int8_weights(model)
    assert all(c.weights_ready for _, c in bc.int8_convs(model))
    for a, b in zip(before, _maps(model, graph["x"])):
        np.testing.assert_array_equal(a, b)
    # the stored kernels travel with the state: a model loaded from the
    # prepared one's state_dict uses them
    loaded = _port(graph)
    loaded.load_state_dict(model.state_dict())
    assert all(c.weights_ready for _, c in bc.int8_convs(loaded))


def test_calib_round_trips_through_the_bridge(graph):
    """A calibrated "static" backbone's scales leave the port as the JAX
    package's ``calib`` tree (the same leaves at the same paths) and come
    back unchanged; "c128" carries no ``calib``."""
    model = _port(graph)
    if graph["mode"] == "static":
        bc.calibrate_quantization(model, [(torch.from_numpy(graph["calib"]),)])
    out = bridge.variables_to_jax(model)
    if graph["mode"] == "c128":
        assert set(out) == {"params"}
        return
    ours, theirs = _flat(out["calib"]), _flat(graph["variables"]["calib"])
    assert set(ours) == set(theirs)
    scales = bc.calibration_buffers(model)
    for name, b in scales.items():
        conv = name.rsplit(".", 1)[0]
        flax = getattr(model, conv).flax_name
        assert ours[f"['{flax}']['amax']"] == b.item()
    back = _port(graph, out)
    for name, b in bc.calibration_buffers(back).items():
        assert b.item() == scales[name].item()
    for k, v in _flat(bridge.variables_to_jax(back)["calib"]).items():
        assert v.tobytes() == ours[k].tobytes()


@pytest.mark.parametrize("cin,features,stride,quantile", [
    (16, 16, 1, 0.999), (16, 32, 2, 1.0), (48, 48, 1, 1.0),
    (48, 96, 2, 0.999), (64, 64, 2, 0.999)])
def test_static_convbn_matches_jax(cin, features, stride, quantile):
    """A ``quantize="static"`` 3x3 ConvBN in bf16 (W48's 48-channel branch
    and fuse convs, the width-16 test branch, the stem's 64->64 stride 2):
    the calibration pass records the input's ``observed_amax`` bit for bit
    and runs the float path; the weights quantize bit for bit; serving
    quantizes with max(amax, 1e-12) / 127 and K10's plain version gives the
    JAX package's int32 accumulation and bf16 output exactly."""
    rng = np.random.RandomState(cin + features + stride)
    jconv = jbc.ConvBN(features=features, kernel_size=3, stride=stride,
                       relu=True, dtype=jnp.bfloat16, quantize="static",
                       calib_quantile=quantile)
    params = {
        "kernel": (rng.randn(3, 3, cin, features)
                   * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
        "scale": rng.uniform(0.5, 1.5, features).astype(np.float32),
        "bias": (rng.randn(features) * 0.1).astype(np.float32),
    }
    x = jnp.asarray(np.maximum(rng.randn(2, 12, 10, cin) * 2.0, 0),
                    jnp.bfloat16)
    x2 = jnp.asarray(rng.randn(2, 12, 10, cin) * 1.5, jnp.bfloat16)
    _, upd = jconv.apply({"params": params}, x, mutable=["calib"])
    _, q = jconv.apply({"params": params, **upd}, x2, mutable=["qweights"])
    variables = {"params": params, **_np(upd), **_np(q)}
    theirs = jax.jit(jconv.apply)(variables, x2)

    port = bc.ConvBN(cin, features, 3, stride, True, torch.bfloat16,
                     int8=True, static=True, quantile=quantile,
                     float_calibration=True)
    assert port.static and not port.dynamic
    port.to_storage(torch.bfloat16)
    bridge.load_jax_variables(port, {"params": params})

    with torch.no_grad():
        cal = port(_bf16(x), calibrate=True)
        assert cal.dtype == torch.bfloat16  # the float path
        assert port.amax.item() == float(variables["calib"]["amax"])
        bc.prepare_int8_weights(port)
        ours = port(_bf16(x2))
    kq = variables["qweights"]["kernel_q"]
    np.testing.assert_array_equal(
        port.kernel_q.numpy(), kq.transpose(3, 0, 1, 2).reshape(features, -1))
    np.testing.assert_array_equal(port.wscale.numpy(),
                                  variables["qweights"]["wscale"])
    step = int8_conv.dequant_step(port.amax, clamp=True)
    xq = int8_conv.quantize_reference(_bf16(x2), port.amax)
    jstep = jax.jit(lambda a: jnp.maximum(a, 1e-12) / 127.0)(
        variables["calib"]["amax"])
    assert step.item() == float(jstep)
    jxq = jnp.clip(jnp.round(x2.astype(jnp.float32) / jstep), -127,
                   127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    acc = jax.lax.conv_general_dilated(
        jxq, jnp.asarray(kq), (stride, stride), [(1, 1)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(
        int8_conv.accumulate(xq, port.kernel_q, stride).numpy(),
        np.asarray(acc))
    assert ours.dtype == torch.bfloat16 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs, np.float32))
