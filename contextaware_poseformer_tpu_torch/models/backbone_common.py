"""Backbone building blocks: folded-BN convolution and resize ops, NHWC.

Port of ``contextaware_poseformer_tpu/models/backbone_common.py``: ``ConvBN``
(54-227) with its float path and every int8 route of the three quantize
modes (``"c128"``: dynamic wide convs; ``"static"``: calibrated scales on
the 3x3 convs with both channel counts >= 16 and on the wide convs;
``"serve"``: the dynamic wide convs, their calibrated amax under
``serve_static_amax``, ``x_quant`` and ``packed``), ``observed_amax``
(31-51), ``add_upsampled_nearest`` (235-246),
``resize_bilinear_align_corners`` (249-280), ``max_pool_3x3_s2``
(389-412), and the serving state of 283-386 (``calibrate_quantization``,
``prepare_int8_weights``, ``check_calibrated``, a parameter fingerprint and
``check_serving_fresh``). ConvBN's ``raw`` output (``scale * conv(x)``,
112-115 and 222-223) gives the CPN's ``cpn_fold_normalize`` stem its bias
map.

Tensors are NHWC at every function here. Each op runs on the NCHW-shaped
``permute`` view of its input, which for an NHWC-contiguous tensor is
PyTorch's ``channels_last`` layout, so convolutions, pooling and resizes
run as channels-last kernels and hand back NHWC-contiguous results without
a layout copy.
"""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F
from torch import nn

from contextaware_poseformer_tpu_torch.models import init
from contextaware_poseformer_tpu_torch.ops import conv_epilogue, int8_conv
from contextaware_poseformer_tpu_torch.ops.int8_conv import f32_const

WIDE = 128  # both channel counts at least this: the dynamic int8 route
HIST_BINS = 2048  # observed_amax's histogram


def module_name(torch_prefix: str) -> str:
    """Torch parameter prefix (the flax module name, such as
    ``resnet.layer1.0.conv1``) -> the backbone's module name
    (``resnet_layer1_0_conv1``); ``models/bridge.py`` maps flax names by
    the same rule."""
    return torch_prefix.replace(".", "_")


def add_conv(parent: nn.Module, torch_prefix: str, conv: nn.Module) -> None:
    """Register a backbone conv under ``module_name(torch_prefix)`` and keep
    its flax name as ``conv.flax_name`` (``bridge.variables_to_jax``)."""
    conv.flax_name = torch_prefix
    parent.add_module(module_name(torch_prefix), conv)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def is_calib_name(name: str) -> bool:
    """True for a calibrated activation scale's buffer (the JAX package's
    "calib" collection): a ConvBN's ``amax`` or a block's ``*_amax``."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf == "amax" or leaf.endswith("_amax")


def observed_amax(x: torch.Tensor, quantile: float = 1.0) -> torch.Tensor:
    """Calibration statistic of an int8 activation scale (fp32, 0-dim):
    max|x| for ``quantile >= 1``, else the upper edge of the first of 2048
    histogram bins over [0, max|x|] whose cumulative share reaches
    ``quantile``. Equal to the JAX package's bit for bit: the edges are
    ``jnp.linspace``'s (``max * (i / 2048)`` in fp32, the last edge ``max``
    itself), a value goes to the bin of the last edge <= it (``searchsorted``
    side right, the last edge inclusive), and the counts are fp32 as
    ``jnp.histogram`` accumulates them (a bin stops at 2**24), summed in
    order."""
    ax = x.float().abs().reshape(-1)
    m = ax.max()
    if quantile >= 1.0:
        return m
    step = torch.arange(HIST_BINS, dtype=torch.float32,
                        device=ax.device) / HIST_BINS
    edges = torch.cat([m * step, m[None]])
    idx = torch.searchsorted(edges, ax, right=True)
    idx = torch.where(ax == m, HIST_BINS, idx)
    counts = torch.bincount(idx, minlength=HIST_BINS + 2)[1:HIST_BINS + 1]
    hist = counts.clamp(max=2 ** 24).float().cpu()  # in-order cumsum
    cum = torch.cumsum(hist, 0) / f32_const(float(ax.numel()), hist)
    first = torch.argmax((cum >= f32_const(quantile, hist)).to(torch.uint8))
    return ((first + 1).float() * m.cpu() / HIST_BINS).to(ax.device)


def observe(buf: torch.Tensor, t: torch.Tensor, quantile: float) -> None:
    """Fold ``observed_amax(t, quantile)`` into the scale buffer ``buf`` by
    max, in place (the JAX package's ``calib`` update)."""
    buf.copy_(torch.maximum(buf, observed_amax(t, quantile)))


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """OIHW float weight -> (kernel_q (O, kh*kw*I) int8 with K ordered
    (kh, kw, I), wscale (O,) fp32): ``wscale = max|k| / 127`` per output
    channel and ``kernel_q = round(k / wscale)``, in fp32, as the JAX
    package's ConvBN computes them (``backbone_common.py:180-183``)."""
    k32 = weight.detach().float()
    wscale = torch.div(k32.abs().amax(dim=(1, 2, 3)), f32_const(127.0, k32))
    kq = torch.round(k32 / wscale[:, None, None, None]).to(torch.int8)
    return kq.permute(0, 2, 3, 1).reshape(weight.shape[0], -1).contiguous(), \
        wscale


class ConvBN(nn.Module):
    """Conv2d (no bias) + folded frozen BatchNorm + optional ReLU, NHWC:
    ``y = conv(x, weight) * scale + bias``, all in ``dtype``.

    ``weight`` is OIHW (PyTorch's layout; the flax kernel is HWIO), padding
    (k - 1) // 2 on both sides.

    ``int8=True`` (a conv that the JAX package runs in int8 under its
    quantize mode) adds the buffers ``kernel_q`` ((O, kh*kw*I) int8) and
    ``wscale`` ((O,) fp32), filled by ``prepare_int8_weights``; such a conv
    keeps its parameters in fp32 (``to_storage``), since its int8 state and
    its folded dequant scale derive from them. Until they are filled
    (``weights_ready``), each call quantizes the weight itself, to the same
    values (the JAX package's ConvBN without a ``qweights`` collection,
    ``backbone_common.py:185-188``). It runs the int8 convolution K10
    (``ops/int8_conv.py``), its epilogue in ``dtype`` (bf16, or fp32 for a
    backbone built in fp32, as the JAX package's ConvBN runs it in
    ``self.dtype``; K10 and its quantize pass K10q have both forms on the
    card):

    - with ``x_quant=(xq, amax)``: the caller's int8 tensor and its
      calibrated max|value|;
    - on a float ``x`` with ``static=True``: quantized with its calibrated
      max|x|, the buffer ``amax``; the calibration pass (``calibrate=True``)
      folds the input's ``observed_amax(x, quantile)`` into it, then runs
      the float path (``float_calibration``, ``quantize="static"``) or the
      dynamic route (the wide convs of ``serve_static_amax``), as the JAX
      package's does (``backbone_common.py:143-156``);
    - on a float ``x`` when both channel counts are >= 128 and the conv is
      not static (``dynamic``): quantized with its runtime max|x|;
    - any other float call takes the float path (the layer1 convs of the
      HRNet deploy graph while calibrating).

    Every route takes a ``residual`` added before the ReLU and ``relu``
    overriding the conv's own (a block tail ``relu(conv(...) + residual)``
    as one call): a float tensor, or on an int8 route also an int8
    ``(xq, amax)`` pair dequantized in the epilogue. An int8 route also
    takes ``out_amax``, which requantizes the output to int8 (the CPN int8
    stream's fused epilogues). The float path ends in one pass of
    ``ops/conv_epilogue.py`` (the affine, the residual, the ReLU; in place
    on the convolution's output, or into a fresh tensor where autograd
    records, as for an unfrozen backbone, with the chain's VJP as its
    backward), or in its plain chain of ``addcmul``, add and ``relu`` off
    the card and under ``impl="plain"``; both give the same bits.

    ``raw=True`` returns the linear part of the float path, ``scale *
    conv(x)`` in ``dtype`` with no bias or ReLU (the JAX package's
    ``raw``): the CPN's fold-normalize stem evaluates its conv on the
    constant offset image with it (``models/cpn.py``). The conv is summed
    in float64 from the ``dtype`` operands and rounded to fp32, then to
    ``dtype`` (XLA sums a bf16 conv in fp32 and rounds once); it runs once
    per parameter state, so its cost does not matter.
    """

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, relu: bool = False, dtype=torch.float32,
                 device=None, int8: bool = False, static: bool = False,
                 quantile: float = 1.0, float_calibration: bool = False):
        super().__init__()
        self.stride = stride
        self.padding = (kernel_size - 1) // 2
        self.relu = relu
        self.dtype = dtype
        self.int8 = int8
        wide = in_ch >= WIDE and features >= WIDE
        self.static = int8 and static and (wide or float_calibration)
        self.float_calibration = self.static and float_calibration
        self.dynamic = int8 and wide and not self.float_calibration
        self.quantile = quantile
        # kernel_q/wscale hold the weight's quantization (set by
        # prepare_int8_weights, and by loading a state whose wscale is
        # filled: a prepared model's, or the "qweights" collection)
        self.weights_ready = False
        self.weight = nn.Parameter(torch.empty(
            features, in_ch, kernel_size, kernel_size, device=device))
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        if int8:
            self.register_buffer("kernel_q", torch.zeros(
                features, kernel_size * kernel_size * in_ch,
                dtype=torch.int8, device=device))
            self.register_buffer("wscale", torch.zeros(
                features, dtype=torch.float32, device=device))
            self.register_load_state_dict_post_hook(_loaded_weights_ready)
        if self.static:
            self.register_buffer("amax", torch.zeros(
                (), dtype=torch.float32, device=device))

    def reset_parameters(self, generator) -> None:
        init.he_normal_(self.weight, generator)
        init.ones_(self.scale)
        init.zeros_(self.bias)

    def to_storage(self, dtype) -> None:
        """Store the parameters for serving: in ``dtype`` (fp32 for an int8
        conv), the weight channels-last."""
        dt = torch.float32 if self.int8 else dtype
        with torch.no_grad():
            for p in (self.weight, self.scale, self.bias):
                fmt = (torch.channels_last if p.dim() == 4
                       else torch.preserve_format)
                p.data = p.data.to(dtype=dt, memory_format=fmt)

    def packed(self):
        """(kernel_q, wscale, scale, bias): the pieces an int8 chain
        assembles itself (the JAX package's ``packed=True``); the weight
        quantized on the spot until ``prepare_int8_weights`` stored it."""
        if self.weights_ready:
            kq, ws = self.kernel_q, self.wscale
        else:
            kq, ws = quantize_weight(self.weight)
        return kq, ws, self.scale, self.bias

    def forward(self, x, x_quant=None, impl: str = "auto",
                calibrate: bool = False, residual=None, out_amax=None,
                relu=None, raw: bool = False):
        """``impl="plain"`` runs the plain versions of K10 and of the float
        epilogue on any device (the card's comparison path); "auto" takes
        the kernels on a CUDA tensor and the plain versions on a CPU
        one."""
        relu = self.relu if relu is None else relu
        if raw:
            return self._raw(x)
        if x_quant is not None:
            xin, amax = x_quant
        elif self.static and not calibrate:
            xin, amax = x, self.amax
        elif self.static and self.float_calibration:
            observe(self.amax, x, self.quantile)
            return self._float(x, residual, out_amax, relu, impl)
        elif self.dynamic:
            if self.static:
                observe(self.amax, x, self.quantile)
            xin, amax = x, None
        else:
            return self._float(x, residual, out_amax, relu, impl)
        res, res_amax = (residual if isinstance(residual, tuple)
                         else (residual, None))
        return int8_conv.int8_conv(xin, *self.packed(), amax, self.stride,
                                   relu, self.dtype, impl, res, res_amax,
                                   out_amax)

    def _raw(self, x):
        dt = self.dtype
        y = F.conv2d(_nchw(x.to(dt)).double(), self.weight.to(dt).double(),
                     stride=self.stride, padding=self.padding)
        y = _nhwc(y).contiguous().float().to(dt)
        return y * self.scale.to(dt)

    def _float(self, x, residual, out_amax, relu, impl):
        if out_amax is not None or isinstance(residual, tuple):
            raise ValueError("ConvBN: an int8 output or an int8 residual "
                             "needs an int8 route")
        dt = self.dtype
        y = _nhwc(F.conv2d(_nchw(x.to(dt)), self.weight.to(dt),
                           stride=self.stride, padding=self.padding))
        # a channels-last convolution's output: dense NHWC, and fresh, so
        # the epilogue's kernel may write into it
        return conv_epilogue.conv_epilogue(
            y, self.scale.to(dt), self.bias.to(dt), residual, relu, impl)


def _loaded_weights_ready(conv: ConvBN, incompatible_keys) -> None:
    """After ``load_state_dict``: the stored kernels travel with the
    state, so a loaded conv uses them when they were filled (a zero
    ``wscale`` is an unprepared state)."""
    conv.weights_ready = bool(conv.wscale.any())


def int8_route(cfg, cin: int, cout: int, ksize: int,
               serve_chain: bool = False) -> dict:
    """The int8 arguments of a backbone ConvBN under ``cfg.quantize``, as
    the JAX package's ConvBN picks its route (``backbone_common.py:130-142``):
    ``"c128"`` the wide convs (both channel counts >= 128), dynamic;
    ``"static"`` those and the 3x3 convs with both counts >= 16, each with
    a calibrated scale, calibrated in float; ``"serve"`` the wide convs
    (with a calibrated scale under ``serve_static_amax``) and the convs of
    an int8 chain (``serve_chain``: HRNet's layer1 and transition1, every
    conv of the CPN's int8 stream), which take the chain's int8 input."""
    wide = cin >= WIDE and cout >= WIDE
    if cfg.quantize == "c128":
        return {"int8": wide}
    if cfg.quantize == "static":
        on = wide or (ksize == 3 and cin >= 16 and cout >= 16)
        return {"int8": on, "static": on, "float_calibration": True}
    if cfg.quantize == "serve":
        return {"int8": wide or serve_chain,
                "static": cfg.serve_static_amax}
    return {}


def int8_convs(module: nn.Module):
    """The int8 ConvBNs of ``module``, by name."""
    return [(n, m) for n, m in module.named_modules()
            if isinstance(m, ConvBN) and m.int8]


def to_storage(module: nn.Module, dtype) -> None:
    """``ConvBN.to_storage`` for every conv of a backbone."""
    for m in module.modules():
        if isinstance(m, ConvBN):
            m.to_storage(dtype)


def prepare_int8_weights(module: nn.Module) -> None:
    """Fill ``kernel_q``/``wscale`` of every int8 conv from its weight
    (``quantize_weight``) and mark them ready. The JAX package does this
    with one forward pass in the "qweights" collection; the values are the
    same. Re-run after any change to the backbone's parameters."""
    with torch.no_grad():
        for _, m in int8_convs(module):
            kq, ws = quantize_weight(m.weight)
            m.kernel_q.copy_(kq)
            m.wscale.copy_(ws)
            m.weights_ready = True


def calibrate_quantization(module: nn.Module, batches) -> None:
    """Fold the activation scales of ``batches`` (tuples whose first item
    is a batch of normalized images) into a backbone's calibration buffers
    by max, in place: one calibration pass (``forward(x, calibrate=True)``)
    a batch, as the JAX package's ``calibrate_quantization``
    (``backbone_common.py:283-297``) runs one with ``mutable=["calib"]``.
    Under ``quantize="static"`` the pass runs every conv in float; under
    ``"serve"`` the dynamic wide convs in int8."""
    with torch.no_grad():
        for batch in batches:
            module(batch[0], calibrate=True)


def calibration_buffers(module: nn.Module) -> dict[str, torch.Tensor]:
    """The calibrated activation scales of a backbone (``is_calib_name``),
    by name."""
    return {n: b for n, b in module.named_buffers() if is_calib_name(n)}


def check_calibrated(module: nn.Module) -> None:
    """Raise unless every calibrated scale (``quantize="serve"``'s and
    ``"static"``'s, ``calibration_buffers``) is finite and positive: an
    uncalibrated (zero) scale saturates every activation to +-127 without
    an error (the JAX package's ``check_calibrated``, 371-386)."""
    bad = [n for n, b in calibration_buffers(module).items()
           if not bool(torch.isfinite(b).all() and (b > 0).all())]
    if bad:
        raise ValueError("uncalibrated or degenerate activation scales "
                         f"{bad[:5]}: run models.capf.prepare_serving first")


def params_fingerprint(module: nn.Module) -> torch.Tensor:
    """16-byte (uint8) sha256 of every parameter's name, shape, dtype and
    bytes: the identity of the parameters an int8 state was prepared
    from."""
    h = hashlib.sha256()
    for name, p in sorted(module.named_parameters()):
        t = p.detach().cpu()
        h.update(f"{name}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy())
    return torch.frombuffer(bytearray(h.digest()[:16]), dtype=torch.uint8)


def stamp_fingerprint(module: nn.Module) -> None:
    with torch.no_grad():
        module.serving_fingerprint.copy_(params_fingerprint(module))


def check_serving_fresh(module: nn.Module) -> None:
    """Raise if the backbone's int8 state was prepared for other parameters
    than it holds now (pre-quantized kernels do not follow a later change
    of the weights). A no-op before the first ``prepare_serving``."""
    stamp = module.serving_fingerprint.cpu()
    if not bool(stamp.any()):
        return
    if not torch.equal(stamp, params_fingerprint(module)):
        raise ValueError(
            "stale serving state: the int8 weights and calibration were "
            "prepared for other backbone parameters than the model holds. "
            "Re-run models.capf.prepare_serving() after a parameter change "
            "(on a freshly built model).")


def add_upsampled_nearest(acc: torch.Tensor, y: torch.Tensor,
                          factor: int) -> torch.Tensor:
    """acc + nearest-upsample(y, factor) on NHWC (torch nn.Upsample(
    scale_factor=factor, mode='nearest')), without materialising the
    upsampled tensor: ``y`` is broadcast over the (factor, factor) blocks of
    a blocked view of ``acc``. Each output element is one addition, so the
    result equals the add of the repeated tensor bit for bit."""
    b, hh, ww, c = acc.shape
    f = factor
    blocked = acc.reshape(b, hh // f, f, ww // f, f, c)
    return (blocked + y[:, :, None, :, None, :]).reshape(b, hh, ww, c)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: tuple[int, int]) -> torch.Tensor:
    """torch nn.Upsample(mode='bilinear', align_corners=True) on NHWC."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    return _nhwc(F.interpolate(_nchw(x), size=tuple(out_hw), mode="bilinear",
                               align_corners=True))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel=3, stride=2, padding=1) on NHWC (padding never
    wins: every window holds at least 4 real pixels). An int8 tensor pools
    through bf16, which holds every int8 value exactly, so the result is
    the int8 pool's (PyTorch's integer max-pool overflows an index check
    at these sizes on the CPU)."""
    if x.dtype == torch.int8:
        return max_pool_3x3_s2(x.to(torch.bfloat16)).to(torch.int8)
    return _nhwc(F.max_pool2d(_nchw(x), 3, 2, 1))
