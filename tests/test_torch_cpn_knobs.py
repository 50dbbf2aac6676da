"""The CPN deploy graph's two serving knobs, ``cpn_fold_normalize`` (raw
uint8 frames into an int8 stem, K10s) and ``cpn_int8_topdown`` (the s8
globalNet top-down hops, K10u), against the JAX package on the CPU.

The tiny CPN of ``tests/test_torch_cpn_int8.py`` (``cpn_layers=(1, 1, 1,
1)``, 64x64 frames, batch 2), inputs from a numpy seed. The port takes the
plain versions (CPU tensors); the JAX package serves under ``jit``, with
its quantized weights made eagerly, conv by conv, as its
``prepare_serving`` makes them.

Tolerances: int8 arithmetic bit for bit (the stem's int32 conv and affine,
the calibrated scales the knobs add, the bridged int8 weights); K10u's
plain version bit for bit in bf16 against the JAX hop (its two
interpolation matmuls sum two exact products a pass) and within 1 ulp in
fp32 (XLA's dot may fuse a product into the sum); the stem's bias map, the
conv of a constant image summed in another order, within 1 ulp of E; the
fp32 backbone's int8 maps and scales 1e-2 relative RMS, the composite's
joints 3e-2 relative RMS in bf16 (``tests/test_torch_cpn_int8.py``'s).
The bf16 composites are in ``tests/test_torch_cpn_knobs_serve.py``.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.data import augment as jaug
from contextaware_poseformer_tpu.models import backbone_common as jbc
from contextaware_poseformer_tpu.models.cpn import CPN as JCPN
from contextaware_poseformer_tpu.models.cpn import _quant_i8
from contextaware_poseformer_tpu_torch import config, serve
from contextaware_poseformer_tpu_torch.data import augment
from contextaware_poseformer_tpu_torch.models import backbone_common as bc
from contextaware_poseformer_tpu_torch.models import bridge
from contextaware_poseformer_tpu_torch.models.cpn import CPN
from contextaware_poseformer_tpu_torch.ops import int8_conv
from test_torch_cpn_int8 import (
    HW,
    _np,
    _qweights,
    _random_params,
    _rel_rms,
    _small,
)

FOLD = {"cpn_fold_normalize": True}
TOPDOWN = {"cpn_int8_topdown": True}
KNOBS = {"fold": FOLD, "topdown": TOPDOWN, "both": {**FOLD, **TOPDOWN}}
HOPS = tuple(f"global_net.topdown.{i}_amax" for i in range(3))


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = np.asarray(v)
    return out


def _ulp(x, dtype):
    """The unit in the last place of E (bf16 or fp32) at each |x|."""
    mant = 8 if dtype == torch.bfloat16 else 24
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(x)) - mant + 1)


def _stem_offset_conv(weight, hw):
    """conv of the normalization's offset image (1, H, W, 3) with an OIHW
    float64 ``weight`` (7x7, stride 2, zero padding 3), NHWC numpy."""
    off = (128.0 - np.asarray(augment.CPN_PIXEL_MEAN)) / 255.0
    image = torch.tensor(off, dtype=torch.float64).expand(1, *hw, 3)
    y = torch.nn.functional.conv2d(image.permute(0, 3, 1, 2), weight,
                                   stride=2, padding=3)
    return y.permute(0, 2, 3, 1).numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tiny graphs run op by op,
    and a pool of threads a test worker only contends with the other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fp32_both():
    """The tiny fp32 CPN deploy backbone with both knobs: random params,
    the JAX calibration pass on uint8 frames, its quantized weights (conv1
    among them: the fold feeds it uint8) and the served (int8 maps, scales)
    with conv1's two calls (the bias map, the int8 stem)."""
    jcfg = _small(jconfig.deploy(jconfig.preset("h36m_cpn")),
                  **KNOBS["both"]).model.backbone
    cfg = _small(config.deploy(config.preset("h36m_cpn")),
                 **KNOBS["both"]).model.backbone
    rng = np.random.RandomState(1)  # see test_calibration_matches_jax
    frames = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    jmodel = JCPN(cfg=jcfg, dtype=jnp.float32)
    # the trees' structure from the port (cheaper than tracing the JAX
    # init); the JAX apply refuses a missing parameter or scale
    shapes = bridge.variables_to_jax(CPN(cfg))
    params = _random_params(shapes["params"], rng)
    zero = jax.tree.map(np.zeros_like, shapes["calib"])
    apply = jax.jit(jmodel.apply,
                    static_argnames=("mutable", "capture_intermediates"))
    _, upd = apply({"params": params, "calib": zero}, frames,
                   mutable=("calib",))
    variables = {"params": params, "calib": _np(upd["calib"])}
    qshapes = jax.eval_shape(
        lambda v, x: jmodel.apply(v, x, mutable=["qweights"]), variables,
        frames)[1]["qweights"]
    variables["qweights"] = _qweights(params, qshapes)
    served, inter = apply(
        variables, frames, mutable=("intermediates",),
        capture_intermediates=lambda m, _: m.name == "resnet.conv1")
    stem = inter["intermediates"]["resnet.conv1"]["__call__"]
    return dict(cfg=cfg, frames=frames, params=params, variables=variables,
                served=jax.tree.map(np.asarray, served),
                stem=[np.asarray(s) for s in stem])


# ---- the serving input -----------------------------------------------------

@pytest.mark.parametrize("case,knobs,dtype", [
    ("fold", dict(quantize="serve", cpn_fold_normalize=True), torch.bfloat16),
    ("no knob", {}, torch.float32),
    ("fold without serve", dict(cpn_fold_normalize=True), torch.bfloat16),
])
def test_serving_images_dispatch_matches_jax(case, knobs, dtype):
    """``serving_images`` hands a CPN serve graph with the fold knob the raw
    uint8 frames themselves and normalizes for every other combination,
    equal to the JAX package's bit for bit (its ``test_cpn.py:377``)."""
    u8 = np.random.RandomState(0).randint(0, 256, (1, 8, 8, 3)).astype(
        np.uint8)
    x = torch.from_numpy(u8)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    ours = augment.serving_images(
        x, replace(config.cpn_backbone(), **knobs), dtype=dtype)
    theirs = jaug.serving_images(
        jnp.asarray(u8), replace(jconfig.cpn_backbone(), **knobs), dtype=jdt)
    if case == "fold":
        assert ours is x and theirs.dtype == jnp.uint8
        np.testing.assert_array_equal(np.asarray(theirs), u8)
        return
    assert ours.dtype == dtype
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs.astype(jnp.float32)))


# ---- K10s's plain version, the fold stem -----------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_reference_matches_float64_oracle(dtype):
    """K10s's plain version against a float64 oracle built from the conv's
    parameters and its int8 weight grid (the JAX package's
    ``test_cpn.py:312``): conv(u8 - 128 in RGB, kq) * wscale / 255 + conv of
    the offset image (128 - mean) / 255 under the same zero padding, then
    the affine and the ReLU; the border ring, where zero padding breaks
    translation invariance, as close as the interior. fp32 to rtol 1e-4,
    atol 1e-5 (the JAX test's); bf16 within the sum of its roundings'
    bounds, each 2^-8 of the value it rounds (bf16's unit roundoff)."""
    rng = np.random.RandomState(3)
    u8 = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    u8[0, :, :8] = 0  # saturated strips reach the border ring
    u8[1, :8] = 255
    conv = bc.ConvBN(3, 64, 7, 2, True, dtype, int8=True)
    k = rng.randn(7, 7, 3, 64) * np.sqrt(2.0 / 147)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        conv.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 64)))
        conv.bias.copy_(torch.from_numpy(rng.randn(64) * 0.1))
    kq, ws, scale, bias = (t.detach() for t in conv.packed())
    off = (128.0 - np.asarray(augment.CPN_PIXEL_MEAN)) / 255.0
    image = torch.tensor(off, dtype=torch.float32).expand(1, *HW, 3)
    with torch.no_grad():
        bias_map = conv(image, raw=True)
        out = int8_conv.stem_conv_reference(torch.from_numpy(u8), kq, ws,
                                            scale, bias, bias_map, dtype)

    def conv64(x, w):  # NHWC x, (O, 7, 7, I) w
        y = torch.nn.functional.conv2d(
            torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2),
            torch.from_numpy(np.ascontiguousarray(w)).permute(0, 3, 1, 2),
            stride=2, padding=3)
        return y.permute(0, 2, 3, 1).numpy()

    kq64 = kq.double().reshape(64, 7, 7, 3).numpy()
    s8 = (u8.astype(np.float64) - 128)[..., ::-1]
    sc, bi = scale.double().numpy(), bias.double().numpy()
    lin = conv64(s8, kq64) * ws.double().numpy() / 255.0 * sc
    cmap = conv64(np.broadcast_to(off, (1, *HW, 3)),
                  conv.weight.detach().double().permute(0, 2, 3, 1).numpy()
                  ) * sc
    oracle = np.maximum(lin + bi + cmap, 0.0)
    got = out.double().numpy()
    assert got.shape == oracle.shape == (2, 32, 32, 64)
    if dtype == torch.float32:
        tol = 1e-5 + 1e-4 * np.abs(oracle)
    else:
        # the sum of each bf16 rounding's bound (2^-8 of its value): the
        # accumulator, the folded scale, the product and the bias add; the
        # map's offset and weights (of its terms), its sum and its scale;
        # the last add
        terms = _stem_offset_conv(conv.weight.detach().double().abs(), HW)
        tol = 2.0 ** -8 * (5 * np.abs(lin) + 2 * np.abs(bi)
                           + 3 * np.abs(cmap) + 2 * terms * sc)
    ring = np.zeros(oracle.shape[1:3], bool)
    ring[:2], ring[-2:], ring[:, :2], ring[:, -2:] = True, True, True, True
    for part in (ring, ~ring):
        err = np.abs(got - oracle)[:, part]
        assert np.all(err <= tol[:, part]), float(err.max())


def test_fold_stem_matches_jax_in_fp32(fp32_both):
    """The port's fp32 fold stem (``CPN._fold_stem``, K10s's plain version)
    against the JAX package's two conv1 calls on the same params and
    qweights. XLA contracts the stem's affine into one FMA in fp32, where
    the port rounds twice (K10's epilogue, as torch computes it): ``ys``
    within 1.5 ulp of |acc * eff| + |bias|, one extra rounding (equal in
    ~71% of values); XLA
    sums the bias map's 147 fp32 terms in fp32, the port in float64: the
    map within 147 ulps of the terms' magnitude (the sum's error bound);
    the stem's output within both; its calibration statistic (max and the
    0.999 quantile) equal. In bf16 all of them are equal bit for bit
    (``tests/test_torch_cpn_knobs_serve.py``)."""
    fb = fp32_both
    model = CPN(fb["cfg"], dtype=torch.float32)
    bc.to_storage(model, torch.float32)
    bridge.load_jax_variables(model, fb["variables"])
    x = torch.from_numpy(fb["frames"])
    tmap, tys = (np.asarray(t, np.float64) for t in fb["stem"])
    kq, ws, scale, bias = (t.detach() for t in model.resnet_conv1.packed())
    with torch.no_grad():
        bias_map = model._stem_bias_map(*x.shape[1:3]).double().numpy()
        acc = int8_conv.stem_accumulate(x, kq)
        eff = scale * ws * int8_conv.STEM_STEP
        ys = (acc.float() * eff + bias).double().numpy()
        out = model._fold_stem(x)
    mag = (np.abs(acc.double().numpy() * eff.double().numpy())
           + np.abs(bias.double().numpy()))
    assert np.all(np.abs(ys - tys) <= 1.5 * _ulp(mag, torch.float32))
    w = model.resnet_conv1.weight.detach().double()
    terms = (_stem_offset_conv(w.abs(), x.shape[1:3])
             * np.abs(scale.double().numpy()))
    map_tol = 147 * 2.0 ** -24 * terms
    assert np.all(np.abs(bias_map - tmap) <= map_tol)
    theirs = np.maximum(tmap + tys, 0)
    tol = 1.5 * _ulp(mag, torch.float32) + map_tol + _ulp(theirs,
                                                          torch.float32)
    assert np.all(np.abs(out.double().numpy() - theirs) <= tol)
    for q in (1.0, 0.999):
        assert bc.observed_amax(out, q).item() == float(jbc.observed_amax(
            jnp.asarray(theirs, jnp.float32), q))


# ---- K10u's plain version, the s8 top-down hop -----------------------------

@pytest.mark.parametrize("size", [2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64])
def test_interp_table_is_the_served_jax_matrix(size):
    """``interp_table``'s taps and weights are exactly the nonzero entries
    of the JAX package's ``_linear_interp_matrix(2 n, n)`` as its ``jit``
    computes it (which differs from the eager matrix in fp32 at n >= 4),
    in bf16 and fp32."""
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        mat = np.asarray(jax.jit(lambda: jbc._linear_interp_matrix(
            2 * size, size, jdt).astype(jnp.float32))())
        idx, w = int8_conv.interp_table(2 * size, size, dtype)
        ours = np.zeros_like(mat)
        for o in range(2 * size):
            ours[o, idx[o, 0]] += w[o, 0]
            ours[o, idx[o, 1]] += w[o, 1]
        np.testing.assert_array_equal(ours, mat)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", [(2, 2), (4, 4), (8, 6), (16, 12), (32, 24)])
def test_topdown_reference_matches_jax_hop(hw, dtype):
    """K10u's plain version against the JAX package's hop under ``jit``,
    ``resize_bilinear_align_corners(_quant_i8(pre, ua).astype(E), (2h, 2w))
    * (ua / 127).astype(E) + lat`` (``cpn.py:289, 334-338``): bit for bit in
    bf16. In fp32 the products are not exact and XLA fuses products into
    its sums (FMA), where the port rounds each: within 4 ulps of the
    largest magnitude a term can reach, |lat| + 127 E(ua / 127) (measured:
    62-70% of values equal, at most ~1 such ulp)."""
    rng = np.random.RandomState(sum(hw))
    h, w = hw
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    pre = jnp.asarray(rng.randn(2, h, w, 16) * 3, jdt)
    lat = jnp.asarray(rng.randn(2, 2 * h, 2 * w, 16), jdt)
    ua = jnp.float32(np.abs(np.asarray(pre, np.float32)).max() * 0.8)

    def hop(pre, lat, ua):
        q = _quant_i8(pre, ua)
        up = jbc.resize_bilinear_align_corners(q.astype(jdt), (2 * h, 2 * w))
        return q, up * (ua / 127.0).astype(jdt) + lat

    q, theirs = jax.jit(hop)(pre, lat, ua)
    lat_t = torch.from_numpy(np.array(lat.astype(jnp.float32))).to(dtype)
    ours = int8_conv.topdown(torch.from_numpy(np.array(q)),
                             torch.tensor(float(ua)), lat_t, dtype)
    theirs = np.asarray(theirs.astype(jnp.float32))
    assert ours.dtype == dtype and ours.shape == theirs.shape
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(ours.float().numpy(), theirs)
    else:
        s = float(np.float32(ua) * np.float32(1 / 127))
        mag = np.abs(np.asarray(lat, np.float64)) + 127 * s
        assert np.all(np.abs(ours.numpy() - theirs) <= 4 * _ulp(mag, dtype))


# ---- calibration, the bridge, the backbone, the composite ------------------

def test_calibration_matches_jax(fp32_both):
    """The port's calibration pass on uint8 frames with both knobs against
    the JAX package's ``calibrate_quantization``, fp32: the same scale
    names (the three ``global_net.topdown.{i}_amax`` among them), every
    scale to 1e-5 relative (``tests/test_torch_cpn_int8.py``'s, on a seed
    where no float difference crosses an int8 rounding boundary of a
    dynamic wide conv: seeds 0, 4, 6, 9 and 10 of 12 cross), and
    ``resnet.in_amax`` (observed on the fold stem) and the hops' scales
    within 4 ulps: XLA contracts fp32 affines into FMAs that the port
    rounds twice (``test_fold_stem_matches_jax_in_fp32``), which moves a
    maximum by an ulp or two (measured 0-4 ulps over 12 seeds; in bf16
    ``resnet.in_amax`` is equal bit for bit,
    ``tests/test_torch_cpn_knobs_serve.py``)."""
    fb = fp32_both
    model = CPN(fb["cfg"], dtype=torch.float32)
    bc.to_storage(model, torch.float32)
    bridge.load_jax_variables(model, {"params": fb["params"]})
    bc.prepare_int8_weights(model)
    with torch.no_grad():
        model(torch.from_numpy(fb["frames"]), calibrate=True)
    ours = bc.calibration_buffers(model)
    theirs = {}
    for name, value in fb["variables"]["calib"].items():
        if isinstance(value, dict):  # a ConvBN's amax
            theirs[bc.module_name(name) + ".amax"] = np.float32(value["amax"])
        else:
            theirs[bc.module_name(name)] = np.float32(value)
    assert set(ours) == set(theirs) and len(ours) == 78 + len(HOPS)
    for name, t in theirs.items():
        got = np.float32(ours[name].item())
        assert t > 0 and abs(got - t) <= 1e-5 * t, name
        if name in ("resnet_in_amax", *map(bc.module_name, HOPS)):
            assert abs(got - t) <= 4 * _ulp(t, torch.float32), name


def test_bridge_carries_the_knobs_both_ways(fp32_both):
    """JAX-prepared variables with both knobs load into the port (params,
    ``calib`` with the hops' scales, ``qweights`` with the fold stem's conv1,
    checked against the port's own quantization), and
    ``variables_to_jax(qweights=True)`` gives the same ``calib`` and
    ``qweights`` trees back, bit for bit; without ``qweights=True`` none."""
    fb = fp32_both
    model = CPN(fb["cfg"], dtype=torch.float32)
    bc.to_storage(model, torch.float32)
    bridge.load_jax_variables(model, fb["variables"])
    assert model.resnet_conv1.weights_ready
    assert bool(model.serving_fingerprint.any())
    back = bridge.variables_to_jax(model, qweights=True)
    for coll in ("calib", "qweights"):
        ours, theirs = _flat(back[coll]), _flat(fb["variables"][coll])
        assert set(ours) == set(theirs), coll
        for k, v in theirs.items():
            assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k
    assert ("resnet.conv1", "kernel_q") in _flat(back["qweights"])
    assert {("global_net.topdown.0_amax",)} <= set(_flat(back["calib"]))
    assert "qweights" not in bridge.variables_to_jax(model)
    again = CPN(fb["cfg"], dtype=torch.float32)
    bc.to_storage(again, torch.float32)
    bridge.load_jax_variables(again, back)
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


def test_backbone_with_both_knobs_matches_jax(fp32_both):
    """The fp32 serve backbone with both knobs, the JAX package's ``calib``
    and ``qweights`` bridged over, on uint8 frames: int8 maps and their
    dequant scales per level to 1e-2 relative RMS; K10s and K10u's plain
    versions each called."""
    fb = fp32_both
    model = CPN(fb["cfg"], dtype=torch.float32)
    bc.to_storage(model, torch.float32)
    bridge.load_jax_variables(model, fb["variables"])
    calls = []
    real = (int8_conv.stem_conv_reference, int8_conv.topdown_reference)
    try:
        int8_conv.stem_conv_reference = lambda *a: calls.append("K10s") or \
            real[0](*a)
        int8_conv.topdown_reference = lambda *a: calls.append("K10u") or \
            real[1](*a)
        with torch.no_grad():
            maps, scales = model(torch.from_numpy(fb["frames"]))
    finally:
        int8_conv.stem_conv_reference, int8_conv.topdown_reference = real
    assert calls == ["K10s"] + ["K10u"] * 3
    tmaps, tscales = fb["served"]
    for lvl in range(4):
        assert maps[lvl].dtype == torch.int8, lvl
        assert maps[lvl].shape == tmaps[lvl].shape, lvl
        assert _rel_rms(maps[lvl].numpy(), tmaps[lvl]) <= 1e-2, lvl
        assert abs(scales[lvl].item() - float(tscales[lvl])) <= (
            1e-2 * float(tscales[lvl])), lvl


def test_prepare_and_streaming_reach_the_model_through_serving_images(
        monkeypatch):
    """``serve.prepare`` and ``StreamingLifter`` need no code of their own
    for the fold: both hand the model what ``serving_images`` gives, the
    raw uint8 frames for a fold graph."""
    from contextaware_poseformer_tpu_torch.models.streaming import (
        StreamingConfig,
        StreamingLifter,
    )

    cfg = _small(serve.deploy_config("h36m_cpn"), **KNOBS["both"])
    seen = []
    real = CPN.forward

    def forward(self, x, calibrate=False):
        seen.append((x.dtype, calibrate))
        return real(self, x, calibrate)

    monkeypatch.setattr(CPN, "forward", forward)
    frames = np.random.RandomState(5).randint(0, 256, (3, *HW, 3)).astype(
        np.uint8)
    model = serve.build_serving_model(
        cfg, "cpu", generator=torch.Generator().manual_seed(0))
    lifter = StreamingLifter(cfg.model, bridge.variables_to_jax(model),
                             StreamingConfig(batch_size=2), device="cpu")
    kp = np.random.RandomState(6).uniform(0, 60, (3, 17, 2)).astype(
        np.float32)
    centers = np.full((3, 2), 32.0, np.float32)
    scales = np.full((3, 2), 64 / 200, np.float32)
    lifter.prepare(frames, kp, (64, 64), centers, scales)
    poses = lifter.lift_batch(frames, kp, (64, 64), centers, scales)
    assert poses.shape == (3, 17, 3) and np.isfinite(poses).all()
    assert seen == [(torch.uint8, True)] + [(torch.uint8, False)] * 2


def test_knobs_build_in_bf16_and_fp32():
    """``CPN`` and ``ContextAwarePoseFormer`` build with either knob and
    both, in bf16 and fp32: the fold's conv1 carries int8 weights, the
    top-down adds its three scales to the stream's, and a uint8 input
    without the fold is refused."""
    from contextaware_poseformer_tpu_torch.models.capf import (
        ContextAwarePoseFormer,
    )

    base = config.deploy(config.preset("h36m_cpn")).model
    for name, knobs in KNOBS.items():
        for dtype in (torch.bfloat16, torch.float32):
            m = replace(base, backbone=replace(base.backbone, **knobs))
            model = ContextAwarePoseFormer(m, dtype=dtype, device="meta")
            convs = dict(bc.int8_convs(model.backbone))
            assert ("resnet_conv1" in convs) == ("fold" in name
                                                 or name == "both")
            hops = [bc.module_name(h) for h in HOPS]
            assert all(hasattr(model.backbone, h) == (name != "fold")
                       for h in hops)
    plain = CPN(_small(config.deploy(config.preset("h36m_cpn"))).model
                .backbone)
    with pytest.raises(TypeError, match="cpn_fold_normalize"):
        plain(torch.zeros((1, *HW, 3), dtype=torch.uint8))


def test_gate_reports_each_knob(monkeypatch):
    """``deploy_numerics.preset_gate`` on the tiny CPN evaluates, on the
    same trained weights, the deploy stack and the deploy stack with each
    knob (the JAX gate's ``tools/deploy_numerics.py:321-344``), each model
    holding the trained parameters, and reports each P1 under the keys it
    adds with its delta against fp32. One training step on 16 synthetic
    frames; the evaluations themselves (calibration and the flip-test P1)
    are the card's (``chip_smoke.py``'s gate phase): here ``_p1_mm``
    records each model and returns a P1 of its own."""
    from contextaware_poseformer_tpu_torch import deploy_numerics

    real_ds = deploy_numerics.SyntheticPoseDataset
    monkeypatch.setattr(
        deploy_numerics, "SyntheticPoseDataset",
        lambda size, **kw: real_ds(size=min(size, 16), **kw))
    evaluated = []

    def p1_mm(trainer, state):
        b = trainer.cfg.model.backbone
        evaluated.append(((b.quantize, b.cpn_fold_normalize,
                           b.cpn_int8_topdown), state.model))
        return 50.0 + len(evaluated)

    monkeypatch.setattr(deploy_numerics, "_p1_mm", p1_mm)
    row = deploy_numerics.preset_gate("h36m_cpn", steps_n=1, device="cpu")
    assert [k for k, _ in evaluated] == [
        ("none", False, False), ("serve", False, False),
        ("serve", True, False), ("serve", False, True)]
    trained = dict(evaluated[0][1].named_parameters())
    for _, model in evaluated[1:]:
        for k, p in model.named_parameters():
            assert torch.equal(trained[k].detach().to(p.dtype), p.detach()), k
    assert row["tiny_trained_fp32_p1_mm"] == 51.0
    assert row["tiny_trained_deploy_p1_mm"] == 52.0
    for short, p1k in zip(deploy_numerics.KNOBS, (53.0, 54.0)):
        assert row[f"tiny_trained_deploy_{short}_p1_mm"] == p1k
        assert row[f"tiny_trained_{short}_delta_mm"] == p1k - 51.0


def test_trace_budget_names_the_knobs_kernels():
    """``tools/trace_budget`` puts K10s in "backbone stem" and K10u in a
    bucket of its own by their kernels' names, whatever range launched
    them, and times the fold stem as "backbone stem"."""
    from contextaware_poseformer_tpu_torch.tools import trace_budget

    stem = "void (anonymous namespace)::stem_conv_kernel<__nv_bfloat16>(S)"
    hop = "void (anonymous namespace)::topdown_kernel<float>(signed char)"
    assert trace_budget.classify(stem, ["nn:<model>", "nn:backbone"]) == \
        "backbone stem"
    assert trace_budget.classify(hop, ["nn:backbone"]) == \
        "globalNet top-down (K10u)"
    assert (CPN, "_fold_stem", "fn:backbone stem") in [
        f for f in trace_budget.default_functions() if f[0] is CPN]
