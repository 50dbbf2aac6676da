"""CPN backbone: ResNet-50 + globalNet (FPN) + refineNet, NHWC, frozen BN.

Port of ``contextaware_poseformer_tpu/models/cpn.py`` (43-412):

  ResNet-50 -> [x4 2048@/32, x3 1024@/16, x2 512@/8, x1 256@/4]
  globalNet: 1x1 lateral (256ch) per level + top-down x2 bilinear
             (align_corners) upsample, then a 1x1 conv (reference order)
  refineNet: per level a cascade of 3-i Bottleneck(128->256) blocks, then a
             bilinear resize to /4, or with ``cpn_native_pyramid`` no resize:
             maps at /32, /16, /8 and /4

Returns four 256-channel NHWC maps, deepest first.

``quantize="serve"`` (the deploy graph, ``config.deploy``) runs every conv
with both channel counts >= 128 in int8 (K10, ``ops/int8_conv.py``), with
the input's calibrated amax under ``serve_static_amax``, runs globalNet's
1x1 up-convs before their x2 upsample (they commute: ``cpn.py:297-342``),
and with ``cpn_int8_stream`` the int8 residual stream (``cpn.py:66-181,
227-259``): the stem output quantized and max-pooled in one pass (K10p: the
pool of the quantized tensor, ``cpn.py:241-244``); every ResNet and
refineNet bottleneck on int8 tensors with static calibrated scales, conv1
and conv2 requantizing their outputs in K10's epilogue, conv3 adding the
residual (the downsample conv's output, run first, or the int8 skip) and
requantizing the block output; the laterals on the int8 stage outputs; each
cascade's input quantized by K10q's scale form. With ``cpn_int8_maps`` (and
the native pyramid) the backbone returns ``(int8 maps, dequant scales)``
(``cpn.py:347-412``). ``forward(x, calibrate=True)`` is the JAX package's
calibration pass: the per-conv serve graph (wide convs dynamic int8, the
rest in float) observing every scale the stream and the static convs use.
``quantize="c128"`` runs the wide convs in dynamic int8 and the rest as the
float graph; ``quantize="static"`` runs every conv but the stem that is 3x3
with both channel counts >= 16, or wide, in int8 with a calibrated scale
each (K10 per conv), and calibrates on the float graph. The int8 stream,
the int8 maps, ``serve_static_amax`` and the up-convs before their upsample
act only under ``"serve"`` (``cpn.py:79,98,191,297``).

Two more serving knobs, off in ``deploy``, act under ``"serve"``:

- ``cpn_fold_normalize`` (``cpn.py:190-225``): the model takes raw uint8
  BGR frames (``data/augment.serving_images`` hands them over unchanged)
  and folds the normalization into the stem: the frame as s8 (``u8 ^
  0x80``) through an int8 conv1 (its ``kernel_q``/``wscale`` in the flax
  order, filled by ``prepare_int8_weights``), the 1/255 of the
  normalization in its dequant step, and the constant offset
  (128 - mean) / 255 as a bias map, the conv of the offset image under the
  same zero padding (ConvBN's ``raw`` output, batch 1): K10s
  (``ops/int8_conv.stem_conv``), ``relu(ys + bias_map)``. A float input
  still takes the float stem. The map is made once per parameter state
  (tied to the serving fingerprint, ``_build.cached_operand``).
- ``cpn_int8_topdown`` (``cpn.py:297-342``, with the int8 stream): each
  globalNet up-conv requantizes its output in K10's epilogue with the
  hop's calibrated ``global_net.topdown.{i}_amax`` (observed on the
  up-conv's output while calibrating), and K10u (``ops/int8_conv.topdown``)
  upsamples the s8 tensor x2 and adds it, dequantized, to the next
  lateral in one pass.

Conv modules are named after the torch parameter prefixes with dots turned
into underscores (``resnet.layer1.0.conv1`` -> ``resnet_layer1_0_conv1``);
so are the calibration buffers (``resnet.layer1.0.t1_amax`` ->
``resnet_layer1_0_t1_amax``); ``models/bridge.py`` maps the flax names.
"""

from __future__ import annotations

import torch
from torch import nn

from contextaware_poseformer_tpu_torch.config import BackboneConfig
from contextaware_poseformer_tpu_torch.data.augment import CPN_PIXEL_MEAN
from contextaware_poseformer_tpu_torch.models.backbone_common import (
    ConvBN,
    add_conv,
    int8_route,
    max_pool_3x3_s2,
    module_name,
    observe,
    resize_bilinear_align_corners,
)
from contextaware_poseformer_tpu_torch.ops import _build
from contextaware_poseformer_tpu_torch.ops.int8_conv import (
    dequant_step,
    quant,
    quant_max_pool_3x3_s2,
    stem_conv,
    topdown,
)

RESNET50_LAYERS = (3, 4, 6, 3)
LATERAL_CH = 256
REFINE_PLANES = 128  # refineNet Bottleneck expansion = 2
_PLANES = (64, 128, 256, 512)


def calib_names(cfg: BackboneConfig) -> tuple[str, ...]:
    """The int8 stream's calibrated scales (``cpn.py:103-181, 229-233,
    309-313, 365-370``): the pre-pool stem, each block's t1/t2/out, each
    cascade's input, with ``cpn_int8_topdown`` each top-down hop's and,
    with ``cpn_int8_maps``, the cascade-free /4 level."""
    names = ["resnet.in_amax"]
    blocks = [f"resnet.layer{li + 1}.{b}"
              for li, n in enumerate(cfg.cpn_layers) for b in range(n)]
    blocks += [f"refine_net.cascade.{i}.{k}" for i in range(3)
               for k in range(3 - i)]
    names += [f"{p}.{t}_amax" for p in blocks for t in ("t1", "t2", "out")]
    names += [f"refine_net.cascade.{i}.in_amax" for i in range(3)]
    if cfg.cpn_int8_topdown:
        names += [f"global_net.topdown.{i}_amax" for i in range(3)]
    if cfg.cpn_int8_maps:
        names.append("refine_net.feature3_amax")
    return tuple(names)


class CPN(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.kind != "cpn":
            raise ValueError(f"CPN with a {cfg.kind!r} backbone config")
        if cfg.quantize not in ("none", "c128", "static", "serve"):
            raise ValueError(f"CPN quantize={cfg.quantize!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.serve = cfg.quantize == "serve"
        self.stream = self.serve and cfg.cpn_int8_stream
        self.int8_maps = (self.stream and cfg.cpn_int8_maps
                          and cfg.cpn_native_pyramid)
        # uint8 frames into the int8 stem (K10s); the s8 top-down hops
        # (K10u), which need the stream's calibration
        self.fold = self.serve and cfg.cpn_fold_normalize
        self.int8_topdown = self.stream and cfg.cpn_int8_topdown
        # "plain" runs the plain versions of K10, of the stream's quantizes
        # (K10q's scale form, K10p), of K10s and of K10u on any device (the
        # card's comparison path)
        self.int8_impl = "auto"

        def conv(name, cin, cout, ks, stride, relu):
            # the stem takes no quantize mode (the JAX package builds it
            # without one): float, or with the fold its int8 weights for
            # uint8 frames; with the stream every other conv runs in int8
            route = ({"int8": self.fold} if name == "resnet.conv1" else
                     int8_route(cfg, cin, cout, ks, self.stream))
            add_conv(self, name, ConvBN(
                cin, cout, ks, stride, relu, dtype, device=device,
                quantile=cfg.calib_quantile, **route))

        conv("resnet.conv1", 3, 64, 7, 2, True)
        cin = 64
        for li, (p, blocks) in enumerate(zip(_PLANES, cfg.cpn_layers)):
            for b in range(blocks):
                pre = f"resnet.layer{li + 1}.{b}"
                stride = 2 if (li and not b) else 1
                conv(f"{pre}.conv1", cin, p, 1, 1, True)
                conv(f"{pre}.conv2", p, p, 3, stride, True)
                conv(f"{pre}.conv3", p, 4 * p, 1, 1, False)
                if b == 0:
                    conv(f"{pre}.downsample.0", cin, 4 * p, 1, stride, False)
                cin = 4 * p
        for i, c in enumerate(4 * p for p in _PLANES[::-1]):
            conv(f"global_net.laterals.{i}.0", c, LATERAL_CH, 1, 1, True)
            if i != 3:
                conv(f"global_net.upsamples.{i}.1", LATERAL_CH, LATERAL_CH,
                     1, 1, False)
        for i in range(4):
            for k in range(3 - i):
                pre = f"refine_net.cascade.{i}.{k}"
                conv(f"{pre}.conv1", LATERAL_CH, REFINE_PLANES, 1, 1, True)
                conv(f"{pre}.conv2", REFINE_PLANES, REFINE_PLANES, 3, 1, True)
                conv(f"{pre}.conv3", REFINE_PLANES, 2 * REFINE_PLANES, 1, 1,
                     False)
                conv(f"{pre}.downsample.0", LATERAL_CH, 2 * REFINE_PLANES, 1,
                     1, False)
        # the stream's calibrated scales, by their flax names
        self.calib_flax_names = ({module_name(n): n for n in calib_names(cfg)}
                                 if self.stream else {})
        for n in self.calib_flax_names:
            self.register_buffer(n, torch.zeros(
                (), dtype=torch.float32, device=device))
        if cfg.quantize != "none":
            self.register_buffer("serving_fingerprint", torch.zeros(
                16, dtype=torch.uint8, device=device))

    def _conv(self, name: str, x, calibrate=False, **kw) -> torch.Tensor:
        return getattr(self, module_name(name))(
            x, impl=self.int8_impl, calibrate=calibrate, **kw)

    def _amax(self, name: str) -> torch.Tensor:
        """A calibrated scale, clamped to >= 1e-12 as the stream uses it."""
        return torch.clamp(getattr(self, module_name(name)), min=1e-12)

    def _observe(self, name: str, t: torch.Tensor) -> None:
        observe(getattr(self, module_name(name)), t, self.cfg.calib_quantile)

    def _stem_bias_map(self, h: int, w: int) -> torch.Tensor:
        """The fold stem's bias map (1, ceil(h/2), ceil(w/2), 64) in the
        backbone's dtype: conv1's ``raw`` output on the constant offset
        image (128 - mean) / 255 of (1, h, w, 3) (``cpn.py:216-222``), under
        the conv's zero padding, so its border ring is the offset's own.
        Made once per parameter state: cached on the serving fingerprint
        and conv1's parameters (``_build.cached_operand``)."""
        conv1 = self.resnet_conv1

        def make(_):
            mean = torch.tensor(CPN_PIXEL_MEAN, dtype=torch.float32)
            off = (torch.tensor(128.0) - mean) / torch.tensor(255.0)
            image = off.to(conv1.weight.device).expand(1, h, w, 3)
            return conv1(image, raw=True)

        tag = ("stem bias map", h, w, self.dtype,
               conv1.weight._version, conv1.weight.data_ptr(),
               conv1.scale._version, conv1.scale.data_ptr())
        return _build.cached_operand(self.serving_fingerprint, tag, make)

    def _fold_stem(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 BGR frames -> the stem's output (``cpn.py:205-223``):
        K10s, ``relu(E(int8 conv1 of the s8 frames) + bias map)``."""
        kq, ws, scale, bias = self.resnet_conv1.packed()
        bias_map = self._stem_bias_map(frames.shape[1], frames.shape[2])
        return stem_conv(frames, kq, ws, scale, bias, bias_map, self.dtype,
                         self.int8_impl)

    def _bottleneck(self, x, prefix, downsample, calibrate=False):
        """A float bottleneck: ResNet's (torchvision-style, stride on
        conv2) or refineNet's (planes 128, expansion 2, downsample always
        present). The calibration pass observes the stream's scales (only
        the stream registers them)."""
        observing = calibrate and self.stream
        y = self._conv(f"{prefix}.conv1", x, calibrate)
        if observing:
            self._observe(f"{prefix}.t1_amax", y)
        y = self._conv(f"{prefix}.conv2", y, calibrate)
        if observing:
            self._observe(f"{prefix}.t2_amax", y)
        residual = (self._conv(f"{prefix}.downsample.0", x, calibrate)
                    if downsample else x)
        # conv3 adds the residual and takes the ReLU in its epilogue
        out = self._conv(f"{prefix}.conv3", y, calibrate, residual=residual,
                         relu=True)
        if observing:
            self._observe(f"{prefix}.out_amax", out)
        return out

    def _bottleneck_i8(self, xq, amax, prefix, downsample, quant_out):
        """A bottleneck on an int8 ``(xq, amax)`` pair (``cpn.py:123-181``):
        returns the int8 output and its amax, or with ``quant_out=False``
        (the float output, None). The downsample runs before conv3, whose
        epilogue adds it (or the dequantized skip) before the ReLU."""
        t1, t2 = self._amax(f"{prefix}.t1_amax"), self._amax(f"{prefix}.t2_amax")
        y = self._conv(f"{prefix}.conv1", None, x_quant=(xq, amax),
                       out_amax=t1)
        y = self._conv(f"{prefix}.conv2", None, x_quant=(y, t1), out_amax=t2)
        res = (self._conv(f"{prefix}.downsample.0", None, x_quant=(xq, amax))
               if downsample else (xq, amax))
        out_a = self._amax(f"{prefix}.out_amax") if quant_out else None
        out = self._conv(f"{prefix}.conv3", None, x_quant=(y, t2),
                         residual=res, relu=True, out_amax=out_a)
        return out, out_a

    def forward(self, x: torch.Tensor, calibrate: bool = False):
        """x: (N, H, W, 3) normalized, or with ``cpn_fold_normalize`` raw
        uint8 BGR frames -> 4 NHWC maps of 256 channels, deepest first;
        with the int8 maps ``(maps, scales)``: int8 maps and their fp32
        dequant scales. ``calibrate=True`` (``quantize="serve"`` or
        ``"static"``): the calibration pass, which updates the scale
        buffers in place."""
        if calibrate and self.cfg.quantize not in ("serve", "static"):
            raise ValueError("calibrate=True needs quantize='serve' or "
                             "'static'")
        stream = self.stream and not calibrate
        int8_maps = self.int8_maps and stream
        if x.dtype == torch.uint8:
            if not self.fold:
                raise TypeError(
                    "CPN: uint8 frames need cpn_fold_normalize under "
                    "quantize='serve'; normalize them first "
                    "(data.augment.serving_images)")
            x = self._fold_stem(x)
        else:
            x = self._conv("resnet.conv1", x)
        if calibrate and self.stream:
            # the pre-pool stem: the pool commutes with the monotone
            # quantize, so the pooled int8 tensor is quant(pool(x))
            self._observe("resnet.in_amax", x)
        feats = []  # [x1 /4, x2 /8, x3 /16, x4 /32]; int8 pairs (stream)
        if stream:
            amax = self._amax("resnet.in_amax")
            x = quant_max_pool_3x3_s2(x, amax, self.int8_impl)  # K10p
            for li, blocks in enumerate(self.cfg.cpn_layers):
                for b in range(blocks):
                    x, amax = self._bottleneck_i8(
                        x, amax, f"resnet.layer{li + 1}.{b}", b == 0, True)
                feats.append((x, amax))
        else:
            x = max_pool_3x3_s2(x)
            for li, blocks in enumerate(self.cfg.cpn_layers):
                for b in range(blocks):
                    x = self._bottleneck(
                        x, f"resnet.layer{li + 1}.{b}", b == 0, calibrate)
                feats.append(x)
        res_out = feats[::-1]

        global_fms = []
        up = hop = None
        for i in range(4):
            lat_name = f"global_net.laterals.{i}.0"
            lat = (self._conv(lat_name, None, x_quant=res_out[i]) if stream
                   else self._conv(lat_name, res_out[i], calibrate))
            if i == 0:
                feature = lat
            elif hop is not None:  # K10u: upsample, dequantize, add
                feature = topdown(*hop, lat, self.dtype, self.int8_impl)
            else:
                feature = lat + up
            global_fms.append(feature)
            if i != 3:
                _, h, w, _ = feature.shape
                up_name = f"global_net.upsamples.{i}.1"
                hop_amax = f"global_net.topdown.{i}_amax"
                if self.int8_topdown and stream:
                    # the up-conv requantizes its output in K10's epilogue
                    ua = self._amax(hop_amax)
                    hop = (self._conv(up_name, feature, out_amax=ua), ua)
                elif self.serve:  # the 1x1 conv before the upsample
                    pre = self._conv(up_name, feature, calibrate)
                    if calibrate and self.int8_topdown:
                        self._observe(hop_amax, pre)
                    up = resize_bilinear_align_corners(pre, (2 * h, 2 * w))
                else:
                    up = self._conv(up_name, resize_bilinear_align_corners(
                        feature, (2 * h, 2 * w)), calibrate)

        out_hw = tuple(global_fms[-1].shape[1:3])
        refine_fms, scales = [], []
        for i in range(4):
            y = global_fms[i]
            n_blocks = 3 - i
            pre = f"refine_net.cascade.{i}"
            if calibrate and self.stream and n_blocks:
                self._observe(f"{pre}.in_amax", y)
            if calibrate and self.stream and self.cfg.cpn_int8_maps \
                    and not n_blocks:
                self._observe(f"refine_net.feature{i}_amax", y)
            yq = ya = None
            if stream and n_blocks:
                ya = self._amax(f"{pre}.in_amax")
                yq = quant(y, ya, self.int8_impl)
                for k in range(n_blocks):
                    last = k == n_blocks - 1
                    out, out_a = self._bottleneck_i8(
                        yq, ya, f"{pre}.{k}", True,
                        (not last) or int8_maps)
                    if out_a is None:
                        y = out
                    else:
                        yq, ya = out, out_a
            else:
                for k in range(n_blocks):
                    y = self._bottleneck(y, f"{pre}.{k}", True, calibrate)
            if int8_maps and not n_blocks:
                ya = self._amax(f"refine_net.feature{i}_amax")
                yq = quant(y, ya, self.int8_impl)
            if not self.cfg.cpn_native_pyramid:
                y = resize_bilinear_align_corners(y, out_hw)
            if int8_maps:
                refine_fms.append(yq)
                scales.append(dequant_step(ya, clamp=False))
            else:
                refine_fms.append(y)
        if int8_maps:
            return refine_fms, scales
        return refine_fms
