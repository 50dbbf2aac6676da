"""The CPN deploy graph's serving knobs in the bf16 composite against the
JAX package on the CPU: ``serve.prepare`` (calibration on uint8 frames,
which ``serving_images`` hands a fold graph raw) and ``serve.lift`` with
``cpn_fold_normalize``, ``cpn_int8_topdown`` and both, on the tiny CPN of
``tests/test_torch_cpn_knobs.py``; the JAX package serves the port's
prepared variables (params, calib and qweights, bridged) under ``jit``.

Tolerances: the joints 3e-2 relative RMS (``tests/test_torch_cpn_int8.py``'s
bf16 whole-graph tolerance: the float convs and resizes round at other
points in the two frameworks); the bf16 fold stem (K10s's plain version:
its int8 conv and affine, the bias map, their sum) and its calibration
statistic bit for bit.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.data import augment as jaug
from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu.models import backbone_common as jbc
from contextaware_poseformer_tpu_torch import serve
from contextaware_poseformer_tpu_torch.models import backbone_common as bc
from contextaware_poseformer_tpu_torch.models import bridge
from contextaware_poseformer_tpu_torch.models.cpn import CPN
from contextaware_poseformer_tpu_torch.ops import int8_conv
from test_torch_cpn_int8 import (
    HW,
    PLAIN_KNOBS,
    _random_params,
    _rel_rms,
    _small,
)
from test_torch_cpn_knobs import KNOBS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tiny graphs run op by op,
    and a pool of threads a test worker only contends with the other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(KNOBS))
def composite(request):
    """The tiny h36m_cpn deploy composite in bf16 with a knob: the port
    built from random flax params and prepared by ``serve.prepare`` on
    uint8 frames, its variables (params, calib and qweights) bridged back
    to the JAX package, and the JAX package's served joints and stem on
    them under ``jit``."""
    knobs = KNOBS[request.param]
    cfg = _small(serve.deploy_config("h36m_cpn"), **knobs)
    jcfg = _small(jconfig.deploy(jconfig.preset("h36m_cpn")), **knobs)
    jcfg = replace(jcfg, model=replace(jcfg.model, lifter=replace(
        jcfg.model.lifter, **PLAIN_KNOBS)))
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    calib = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    kp = rng.uniform(-1, 1, (2, 17, 2)).astype(np.float32)
    kpc = rng.uniform(0, HW[1], (2, 17, 2)).astype(np.float32)
    jmodel = JCAPF(cfg=jcfg.model, dtype=jnp.bfloat16)
    # the params tree's structure from the port (cheaper than tracing the
    # JAX init); the JAX apply refuses a missing parameter
    shapes = bridge.variables_to_jax(serve.build_serving_model(
        cfg, "cpu", generator=torch.Generator().manual_seed(0)))
    params = _random_params(shapes["params"], rng)
    model = serve.build_serving_model(cfg, "cpu", variables={"params": params})
    serve.prepare(model, [torch.from_numpy(calib)])
    variables = bridge.variables_to_jax(model, qweights=True)

    def run(v, f, a, b):
        images = jaug.serving_images(f, jcfg.model.backbone,
                                     dtype=jnp.bfloat16)
        return jmodel.apply(
            v, images, a, b, mutable=("intermediates",),
            capture_intermediates=lambda m, _: m.name == "resnet.conv1")

    theirs, inter = jax.jit(run)(variables, frames, kp, kpc)
    stem = inter["intermediates"]["backbone"]["resnet.conv1"]["__call__"]
    return dict(name=request.param, cfg=cfg, model=model, params=params,
                variables=variables, frames=frames, calib=calib, kp=kp,
                kpc=kpc, theirs=np.asarray(theirs, np.float32),
                stem=[np.asarray(s.astype(jnp.float32)) for s in stem]
                if "cpn_fold_normalize" in knobs else [])


def test_composite_with_each_knob_matches_jax(composite):
    """uint8 frames -> (2, 17, 3) through ``serve.prepare`` (on uint8
    frames: with the fold ``serving_images`` hands them over raw) and
    ``serve.lift``, bf16, with each knob and both: against the JAX
    package's composite on the port's prepared variables (params, calib,
    qweights) under ``jit``, relative RMS <= 3e-2; a model loaded from those
    variables serves the same joints bit for bit. With the fold, its stem
    against the JAX package's (``_check_fold_stem``)."""
    c = composite
    args = [torch.from_numpy(a) for a in (c["frames"], c["kp"], c["kpc"])]
    ours = serve.lift(c["model"], *args)
    assert ours.shape == (2, 17, 3) and bool(torch.isfinite(ours).all())
    assert _rel_rms(ours.numpy(), c["theirs"]) <= 3e-2
    loaded = serve.build_serving_model(c["cfg"], "cpu",
                                       variables=c["variables"])
    assert torch.equal(serve.lift(loaded, *args), ours)
    if c["stem"]:
        _check_fold_stem(c)


def _check_fold_stem(c):
    """The port's bf16 fold stem (``CPN._fold_stem``, K10s's plain version)
    against the JAX package's two conv1 calls in the served composite, on
    the same bridged variables: the int8 stem ``ys`` (the int32 conv and
    the affine in bf16), the bias map and the stem's output bit for bit,
    and so the calibration statistic on it (``resnet.in_amax``'s, max and
    the 0.999 quantile)."""
    tree = {k: v["backbone"] for k, v in c["variables"].items()}
    model = CPN(c["cfg"].model.backbone, dtype=torch.bfloat16)
    bc.to_storage(model, torch.bfloat16)
    bridge.load_jax_variables(model, tree)
    x = torch.from_numpy(c["frames"])
    kq, ws, scale, bias = (t.detach() for t in model.resnet_conv1.packed())
    tmap, tys = c["stem"]
    with torch.no_grad():
        bias_map = model._stem_bias_map(*x.shape[1:3])
        eff = (scale * ws * int8_conv.STEM_STEP).to(torch.bfloat16)
        ys = (int8_conv.stem_accumulate(x, kq).to(torch.bfloat16) * eff
              + bias.to(torch.bfloat16))
        out = model._fold_stem(x)
    np.testing.assert_array_equal(ys.float().numpy(), tys)
    np.testing.assert_array_equal(bias_map.float().numpy(), tmap)
    theirs = jnp.maximum(jnp.asarray(tmap, jnp.bfloat16)
                         + jnp.asarray(tys, jnp.bfloat16), 0)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(theirs.astype(jnp.float32)))
    for q in (1.0, 0.999):
        assert bc.observed_amax(out, q).item() == float(
            jbc.observed_amax(theirs, q))
