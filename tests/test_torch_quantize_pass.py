"""The CPN int8 stream's quantizes on the CPU: K10q's two forms and K10p.

The port quantizes a bf16 tensor to int8 with one kernel, K10q
(``ops/csrc/int8_conv.cu``), in two forms: the step form of K10's float
inputs, ``round(x / step)`` with ``step = max(amax, 1e-12) * fl32(1/127)``
(``models/backbone_common.py:192-203`` in the JAX package), and the scale
form of the CPN stream, ``round(fp32(x) * (127 / max(amax, 1e-12)))``
(``_quant_i8``, ``models/cpn.py:43-51``). K10p computes the stream's stem,
``max_pool_3x3_s2(_quant_i8(x, amax))`` (``cpn.py:241-244``), in one pass.
The kernels run only on the card (``tests/test_torch_cuda.py`` holds them
against their plain versions on every bf16 pattern); these tests hold the
plain versions against the JAX package under ``jit`` bit for bit, the
wrappers' refusals, K10p's plan and the CPN's calls of the dispatchers.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu.models.backbone_common import (
    max_pool_3x3_s2 as jax_max_pool_3x3_s2,
)
from contextaware_poseformer_tpu.models.cpn import _quant_i8
from contextaware_poseformer_tpu_torch import serve
from contextaware_poseformer_tpu_torch.models import backbone_common as bc
from contextaware_poseformer_tpu_torch.models import cpn
from contextaware_poseformer_tpu_torch.ops import _build, int8_conv


@jax.jit
def _jax_scale_form(x, amax):
    # the stream's quantize: the calibrated amax clamped as cpn.py:241 does
    return _quant_i8(x, jnp.maximum(amax, 1e-12))


@jax.jit
def _jax_step_form(x, amax):
    # backbone_common.py:195-200, a calibrated amax (serve_static_amax)
    step = jnp.maximum(amax, 1e-12) / 127.0
    return jnp.clip(jnp.round(x.astype(jnp.float32) / step), -127,
                    127).astype(jnp.int8)


@jax.jit
def _jax_stem(x, amax):
    return jax_max_pool_3x3_s2(_quant_i8(x, jnp.maximum(amax, 1e-12)))


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _scale_case(case):
    """(bf16 values, amax) of one scale-form case."""
    rng = np.random.RandomState(3)
    if case == "half steps":
        # 127 / amax = 16 exactly: (k + 0.5) / 16 lies halfway
        amax = 127 / 16
        x = np.concatenate([(np.arange(-40, 40) + 0.5) / 16,
                            rng.randn(48) * 3])
    elif case == "1e-12 clamp":
        # amax 0 clamps to 1e-12: values of 1e-14 land on +-1.27 steps
        amax = 0.0
        x = np.concatenate([rng.randn(96) * 1e-14, [0.0] * 16, [1e-11] * 16])
    elif case == "saturation":
        amax = 2.5
        x = np.concatenate([rng.randn(96) * 8, [1e30, -1e30, 2.5, -2.5,
                                                 2.6, -2.6] + [0.0] * 26])
    else:  # "amax 2^k"
        k = int(case.split("^")[1])
        amax = 2.0 ** k
        x = np.concatenate([rng.randn(112) * amax / 2,
                            (np.arange(16) - 7.5) * amax / 127])
    return _bf16(x.reshape(2, 4, 16)), np.float32(amax)


@pytest.mark.parametrize("case", ["half steps", "1e-12 clamp", "saturation",
                                  "amax 2^-7", "amax 2^0", "amax 2^5",
                                  "amax 2^12"])
def test_quant_on_the_cpu_matches_quant_i8(case):
    """``quant`` on a CPU tensor (its plain version) equals the JAX
    package's ``_quant_i8`` bit for bit: values on exact half steps (ties
    to even), the 1e-12 clamp of a zero amax, saturation past +-127, and
    amax at powers of two."""
    x, amax = _scale_case(case)
    ours = int8_conv.quant(x, torch.tensor(amax))
    theirs = _jax_scale_form(_jax(x), jnp.float32(amax))
    assert ours.dtype == torch.int8 and ours.shape == x.shape
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert torch.equal(int8_conv.quant(x, torch.tensor(amax), impl="plain"),
                       ours)
    if case == "half steps":
        ties = ours.reshape(-1)[:80].tolist()
        assert ties[38:42] == [-2, 0, 0, 2]  # -1.5, -0.5, 0.5, 1.5 steps
    if case == "saturation":
        assert set(ours.reshape(-1)[96:102].tolist()) == {127, -127}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stem_plain_version_matches_jax_on_nan_inf_and_zeros(dtype):
    """K10p's plain version on NaN, +-inf and +-0 (the first five values
    one each, a twentieth of the rest each) equals the JAX package's stem
    bit for bit, in bf16 and fp32: a NaN quantizes to 0, as +0 does, so a
    window of NaN and negative values pools to 0 (the kernel must pool a
    NaN as +0, not skip it)."""
    rng = np.random.RandomState(12)
    x = rng.randn(2, 15, 11, 16).astype(np.float32) * 3
    pick = rng.randint(0, 20, x.shape)
    pick.reshape(-1)[:5] = np.arange(5)
    for i, v in enumerate((np.nan, np.inf, -np.inf, 0.0, -0.0)):
        x = np.where(pick == i, np.float32(v), x)
    x[0, :3, :3, 0] = -3.0  # a window of one NaN among negative values
    x[0, 1, 1, 0] = np.nan
    amax = np.float32(4.1)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ours = int8_conv.quant_max_pool_3x3_s2(xt, torch.tensor(amax))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    theirs = np.asarray(jax.jit(lambda v, a: jax_max_pool_3x3_s2(
        _quant_i8(v, jnp.maximum(a, 1e-12))))(xj, jnp.float32(amax)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert ours[0, 0, 0, 0].item() == 0  # max(quant(NaN) = 0, -93)


@pytest.mark.parametrize("shape", [(2, 16, 12, 16), (2, 15, 11, 32)])
def test_quant_max_pool_plain_version_matches_jax(shape):
    """K10p's plain version (the port's own int8 pool of the quantized
    tensor) equals the JAX package's ``max_pool_3x3_s2(_quant_i8(x, a))``
    and the port's ``max_pool_3x3_s2(quant(x, a))`` bit for bit, at an even
    and an odd (ragged) H and W."""
    rng = np.random.RandomState(sum(shape))
    x = _bf16(np.maximum(rng.randn(*shape) * 3, -1.0))
    amax = np.float32(4.1)
    a = torch.tensor(amax)
    ours = int8_conv.quant_max_pool_3x3_s2(x, a)
    b, h, w, c = shape
    assert ours.dtype == torch.int8
    assert ours.shape == (b, (h + 1) // 2, (w + 1) // 2, c)
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(_jax_stem(_jax(x), jnp.float32(amax))))
    assert torch.equal(ours, bc.max_pool_3x3_s2(int8_conv.quant(x, a)))
    assert torch.equal(int8_conv.quant_max_pool_3x3_s2(x, a, impl="plain"),
                       ours)
    assert bool((ours == 127).any()) and bool((ours < 0).any())


def test_step_and_scale_forms_round_a_value_differently():
    """Why K10q has two forms: ``x / (amax * fl32(1/127))`` (K10's float
    inputs) and ``x * fl32(127 / amax)`` (the stream) round differently for
    some values, and each form matches its own JAX expression there, so
    neither can stand in for the other. A bf16 value lands near a half
    step of either only for a few amax values (one in ~400 drawn at random
    between 0.01 and 1000); this is one, found by such a search: -123.5
    rounds to -83 steps one way and -82 the other."""
    amax = np.float32(190.11514282226562)
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    x = x[torch.isfinite(x.float()) & (x.float().abs() <= float(amax))]
    step = int8_conv.quantize_reference(x, torch.tensor(amax))
    scale = int8_conv.quant(x, torch.tensor(amax))
    differ = torch.nonzero(step != scale).flatten()
    assert differ.numel() == 2  # -123.5 and +123.5
    v = x[differ[:1]]
    assert v.float().item() == -123.5
    assert (step[differ[:1]].item(), scale[differ[:1]].item()) == (-83, -82)
    theirs_step = _jax_step_form(_jax(v), jnp.float32(amax))
    theirs_scale = _jax_scale_form(_jax(v), jnp.float32(amax))
    assert step[differ[:1]].item() == int(np.asarray(theirs_step)[0])
    assert scale[differ[:1]].item() == int(np.asarray(theirs_scale)[0])
    assert int(np.asarray(theirs_step)[0]) != int(np.asarray(theirs_scale)[0])
    # one step apart at most: the two roundings part only at half steps
    assert (step.int() - scale.int()).abs().max().item() == 1


def _bf16_buffer(n):
    return torch.zeros(n, dtype=torch.bfloat16)


@pytest.mark.parametrize("entry", ["K10q step", "K10q scale", "K10p"])
@pytest.mark.parametrize("fault", ["cpu tensor", "float32", "float16",
                                   "float64", "numel", "misaligned"])
def test_kernel_entries_raise_and_never_fall_back(entry, fault, monkeypatch):
    """The kernels' wrappers raise, and never fall back to the plain
    version, for a tensor on the CPU (bf16, or fp32: an fp32 input passes
    the dtype check and stops at the device check), a float16 or float64
    input, a size the kernel does not take (K10q: a numel not a multiple
    of 16; K10p: C not a multiple of 16) and a start off a 16-byte
    boundary; nothing launches and no launch is counted."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    a = torch.tensor(3.0)
    if fault == "cpu tensor":
        x, err, match = _bf16_buffer(64), ValueError, "CUDA"
    elif fault == "float32":
        x, err, match = torch.zeros(64), ValueError, "CUDA"
    elif fault in ("float16", "float64"):
        x, err, match = (torch.zeros(64, dtype=getattr(torch, fault)),
                         TypeError, "bf16 or fp32")
    elif fault == "numel":
        x, err, match = _bf16_buffer(24), ValueError, "16"
    else:
        x, err, match = _bf16_buffer(65)[1:], ValueError, "16-byte"
    if entry == "K10p":
        x = x.reshape(1, 2, 1, -1) if fault != "misaligned" else \
            x.reshape(1, 1, 4, 16)

        def call():
            return int8_conv.quant_max_pool_kernel(x, a)
    else:
        form = entry.split()[1]

        def call():
            return int8_conv.quantize_kernel(x, a, True, form=form)
    before = (int8_conv.launches_quantize, int8_conv.launches_quant_pool)
    with pytest.raises(err, match=match):
        call()
    assert (int8_conv.launches_quantize,
            int8_conv.launches_quant_pool) == before


def _k10_operands(x_dtype, dtype=torch.bfloat16, residual=None):
    """A small K10 call (NHWC 1x4x4x16, 1x1 conv to 8 channels) on the
    CPU with ``x`` of ``x_dtype`` and the epilogue in ``dtype``."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randint(-127, 128, (1, 4, 4, 16), generator=g,
                       dtype=torch.int8) if x_dtype == torch.int8
         else torch.randn(1, 4, 4, 16, generator=g).to(x_dtype))
    kq = torch.randint(-127, 128, (8, 16), generator=g, dtype=torch.int8)
    vecs = [torch.rand(8, generator=g) + 0.5 for _ in range(3)]
    kw = {} if residual is None else {"residual": torch.zeros(
        1, 4, 4, 8, dtype=residual)}
    return (x, kq, *vecs, torch.tensor(3.0), 1, True, dtype), kw


@pytest.mark.parametrize("fault", [
    "float16 epilogue", "float64 epilogue", "float16 x", "float64 x",
    "bf16 x, fp32 epilogue", "fp16 residual", "fp32 x on the cpu",
    "int8 x, fp32 epilogue on the cpu"])
def test_k10_entry_raises_and_never_falls_back(fault, monkeypatch):
    """K10's wrapper refuses an epilogue dtype other than bf16 or fp32, an
    ``x`` or residual in another float dtype than the epilogue's, and, once
    an fp32 call passes those checks, a CPU tensor; nothing launches and no
    launch is counted (K10 or its quantize pass)."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    f32 = torch.float32
    x_dtype, dtype, res, err, match = {
        "float16 epilogue": (torch.float16, torch.float16, None, TypeError,
                             "bf16 or fp32"),
        "float64 epilogue": (torch.int8, torch.float64, None, TypeError,
                             "bf16 or fp32"),
        "float16 x": (torch.float16, f32, None, TypeError, "x must be"),
        "float64 x": (torch.float64, f32, None, TypeError, "x must be"),
        "bf16 x, fp32 epilogue": (torch.bfloat16, f32, None, TypeError,
                                  "x must be"),
        "fp16 residual": (f32, f32, torch.float16, TypeError, "residual"),
        "fp32 x on the cpu": (f32, f32, f32, ValueError, "CUDA"),
        "int8 x, fp32 epilogue on the cpu": (torch.int8, f32, torch.int8,
                                             ValueError, "CUDA"),
    }[fault]
    args, kw = _k10_operands(x_dtype, dtype, res)
    if res == torch.int8:
        kw["res_amax"] = torch.tensor(2.0)
    before = (int8_conv.launches, int8_conv.launches_quantize)
    with pytest.raises(err, match=match):
        int8_conv.int8_conv_kernel(*args, **kw)
    assert (int8_conv.launches, int8_conv.launches_quantize) == before


def test_dispatchers_raise_off_the_cpu_and_the_card():
    """The dispatchers take the plain version only for a CPU tensor or
    ``impl="plain"``: a tensor on another device (meta here) goes to the
    kernel, which refuses it; an unknown ``impl`` raises."""
    x = torch.zeros(2, 4, 4, 16, dtype=torch.bfloat16, device="meta")
    a = torch.tensor(1.0, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        int8_conv.quant(x, a)
    with pytest.raises(ValueError, match="CUDA"):
        int8_conv.quant_max_pool_3x3_s2(x, a)
    assert int8_conv.quant(x, a, impl="plain").device.type == "meta"
    for fn in (int8_conv.quant, int8_conv.quant_max_pool_3x3_s2):
        with pytest.raises(ValueError, match="impl"):
            fn(x, a, impl="kernel")


@pytest.mark.parametrize("shape,rows", [
    ((64, 128, 96, 64), 1),  # the main path's stem: 3 rows of 12 KB staged
    ((2, 16, 12, 16), 8),    # the whole image in one block
    ((2, 15, 11, 32), 8),
    ((1, 64, 512, 64), 1),   # a row of 64 KB: one strip of 3 rows
])
def test_quant_pool_plan(shape, rows):
    """K10p's plan: the most output rows a block whose 2 rows + 1 input
    rows fit ``POOL_SMEM``, at least one; what the C entry stages fits a
    block's shared memory, and a row too wide for three is refused."""
    b, h, w, c = shape
    assert int8_conv.quant_pool_rows(h, w, c) == rows
    staged = min(2 * rows + 1, h) * w * c * 2
    assert staged <= _build.SMEM_LIMIT
    assert staged <= int8_conv.POOL_SMEM or rows == 1
    with pytest.raises(ValueError, match="three rows"):
        int8_conv.quant_pool_rows(64, 2048, 64)


@pytest.mark.parametrize("shape,rows", [
    ((64, 128, 96, 64), 1),  # the fp32 stem: 3 rows of 24 KB, past 48 KB
    ((2, 16, 12, 16), 8),    # the whole image in one block, 12 KB
    ((2, 15, 11, 32), 8),
    ((1, 64, 256, 64), 1),   # a row of 64 KB: one strip of 3 rows
])
def test_quant_pool_plan_fp32(shape, rows):
    """K10p's plan for an fp32 input (4 bytes a value): at the stem one
    output row a block, whose three input rows (72 KB) pass ``POOL_SMEM``
    and fit the block's opt-in limit; the whole of a small image in one
    block; a row too wide for three refused at fp32 where bf16 fits."""
    b, h, w, c = shape
    assert int8_conv.quant_pool_rows(h, w, c, 4) == rows
    staged = min(2 * rows + 1, h) * w * c * 4
    assert staged <= _build.SMEM_LIMIT
    assert staged <= int8_conv.POOL_SMEM or rows == 1
    if shape[0] == 64:
        assert staged == 72 * 1024 > int8_conv.POOL_SMEM
        assert int8_conv.quant_pool_rows(h, w, c) == 1  # bf16: 36 KB
    int8_conv.quant_pool_rows(64, 384, 64)  # bf16: 3 x 48 KB fit
    with pytest.raises(ValueError, match="three rows"):
        int8_conv.quant_pool_rows(64, 384, 64, 4)


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_cpn_stream_calls_the_dispatchers(impl, monkeypatch):
    """The CPN int8 stream's quantizes go through the two dispatchers with
    the model's ``int8_impl``: K10p once a request (the stem) and K10q's
    scale form four times (the three cascades' inputs and the int8 /4
    map); with the up-convs' three step-form passes inside K10, a card
    request launches K10q 7 times and K10p once."""
    cfg = serve.deploy_config("h36m_cpn")
    hw = (64, 64)
    cfg = replace(cfg, model=replace(
        cfg.model, image_shape=hw,
        backbone=replace(cfg.model.backbone, cpn_layers=(1, 1, 1, 1)),
        lifter=replace(cfg.model.lifter, embed_dim_ratio=32, depth=1)))
    model = serve.build_serving_model(
        cfg, "cpu", generator=torch.Generator().manual_seed(0))
    frames = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    serve.prepare(model, [frames])
    model.backbone.int8_impl = impl
    calls = []

    def spy(name, fn):
        def run(x, amax, impl_arg="auto"):
            calls.append((name, tuple(x.shape), x.dtype, impl_arg))
            return fn(x, amax, impl_arg)
        return run

    monkeypatch.setattr(cpn, "quant", spy("quant", cpn.quant))
    monkeypatch.setattr(cpn, "quant_max_pool_3x3_s2", spy(
        "pool", cpn.quant_max_pool_3x3_s2))
    up_convs = []
    real = int8_conv.int8_conv

    def conv(x, *args, **kw):
        if x is not None and x.dtype == torch.bfloat16:
            up_convs.append(tuple(x.shape))
        return real(x, *args, **kw)

    monkeypatch.setattr(int8_conv, "int8_conv", conv)
    serve.lift(model, frames, torch.zeros(2, 17, 2),
               torch.full((2, 17, 2), 32.0))
    assert [c[0] for c in calls] == ["pool", "quant", "quant", "quant",
                                     "quant"]
    assert {c[3] for c in calls} == {impl}
    assert all(c[2] == torch.bfloat16 and c[1][-1] % 16 == 0
               for c in calls)
    assert calls[0][1] == (2, 32, 32, 64)  # the stem's output, pooled
    assert len(up_convs) == 3  # K10's bf16 inputs: the step form
