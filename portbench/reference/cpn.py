"""CPN backbone (arXiv:1711.07319), plain: ResNet-50 -> globalNet ->
refineNet, convolutions with their BatchNorm folded into a per-channel
scale and bias, NCHW float32.

Three modes of one graph:

- ``float``: every convolution in float; globalNet upsamples x2 (bilinear,
  corners aligned) and then runs its 1x1 conv; refineNet resizes each level
  to /4 unless the configuration keeps the native pyramid.
- ``calib``: the calibration pass of the int8 deploy graph. globalNet runs
  its 1x1 conv before the upsample (they commute); a convolution with both
  channel counts >= 128 quantizes its input by its own max|x|; the rest run
  in float. It records the statistic of every tensor the int8 stream
  quantizes, folded by max over the calibration batches.
- ``serve``: the int8 residual stream. The stem's output, max-pooled, is
  quantized; every bottleneck runs on integers: conv1 and conv2 requantize
  their outputs, conv3 adds the residual (the downsample conv's output, or
  the dequantized skip) before its ReLU and requantizes the block output;
  the laterals read the quantized stage outputs; globalNet's 1x1 convs
  quantize their float input with its calibrated scale; each refineNet
  cascade's input is quantized, and the maps handed on are integers with a
  step each (the level without a cascade quantized on its own).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.quant import (
    observed_amax,
    quantize,
    quantize_weight,
    step_of,
)

PLANES = (64, 128, 256, 512)
WIDE = 128


def conv_names(layers, lateral=256, refine=128):
    """(name, cin, cout, kernel, stride) of every convolution, in order."""
    out = [("resnet.conv1", 3, 64, 7, 2)]
    cin = 64
    for li, (p, blocks) in enumerate(zip(PLANES, layers)):
        for b in range(blocks):
            pre = f"resnet.layer{li + 1}.{b}"
            stride = 2 if (li and not b) else 1
            out += [(f"{pre}.conv1", cin, p, 1, 1),
                    (f"{pre}.conv2", p, p, 3, stride),
                    (f"{pre}.conv3", p, 4 * p, 1, 1)]
            if b == 0:
                out.append((f"{pre}.downsample.0", cin, 4 * p, 1, stride))
            cin = 4 * p
    for i, c in enumerate(4 * p for p in PLANES[::-1]):
        out.append((f"global_net.laterals.{i}.0", c, lateral, 1, 1))
        if i != 3:
            out.append((f"global_net.upsamples.{i}.1", lateral, lateral, 1,
                        1))
    for i in range(4):
        for k in range(3 - i):
            pre = f"refine_net.cascade.{i}.{k}"
            out += [(f"{pre}.conv1", lateral, refine, 1, 1),
                    (f"{pre}.conv2", refine, refine, 3, 1),
                    (f"{pre}.conv3", refine, 2 * refine, 1, 1),
                    (f"{pre}.downsample.0", lateral, 2 * refine, 1, 1)]
    return out


def resize(x, hw):
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=True)


class CPN:
    """``params``: the benchmark's state dict (``backbone.<conv>.weight``,
    ``.scale``, ``.bias`` with the conv's dots as underscores);
    ``cfg``: the configuration's ``backbone`` section. ``levels``: 127, or
    7 for the int4 control. ``scales``: the calibration statistics that
    ``calib`` records and ``serve`` reads."""

    def __init__(self, params, cfg, levels=127, prefix="backbone."):
        self.params = params
        self.cfg = cfg
        self.levels = levels
        self.prefix = prefix
        self.layers = tuple(cfg["resnet_layers"])
        self.native = bool(cfg["native_pyramid"])
        self.quantile = float(cfg.get("calib_quantile", 1.0))
        self.geometry = {n: (ci, co, k, s) for n, ci, co, k, s in
                         conv_names(self.layers)}
        self._qweights = {}
        self.scales = {}
        self.mode = "float"
        self.record = None  # a list: each int8 convolution's shapes

    # -- parameters ---------------------------------------------------------
    def _p(self, name, leaf):
        return self.params[f"{self.prefix}{name.replace('.', '_')}.{leaf}"]

    def _qweight(self, name):
        if name not in self._qweights:
            self._qweights[name] = quantize_weight(
                self._p(name, "weight").float(), self.levels)
        return self._qweights[name]

    # -- convolutions -------------------------------------------------------
    def conv(self, name, x, relu):
        """A convolution on a float input, as the mode runs it."""
        cin, cout, k, stride = self.geometry[name]
        wide = cin >= WIDE and cout >= WIDE
        if self.mode == "calib" and wide and name != "resnet.conv1":
            step = step_of(x.abs().amax(), self.levels)
            return self.conv_int(name, quantize(x, step, self.levels), step,
                                 relu)
        w = self._p(name, "weight").float()
        y = F.conv2d(x, w, stride=stride, padding=(k - 1) // 2)
        y = torch.addcmul(self._p(name, "bias").float()[:, None, None], y,
                          self._p(name, "scale").float()[:, None, None])
        return torch.relu(y) if relu else y

    def conv_int(self, name, xq, step, relu, residual=None, out_step=None,
                 x_float=False, res_int=False):
        """A convolution of integers ``xq`` at ``step``: the exact integer
        products, then the step, the weights' steps and the folded BN;
        ``residual`` (float) added before the ReLU; ``out_step``
        requantizes the output. ``x_float`` (the input was quantized from
        a float tensor) and ``res_int`` (the residual is a dequantized
        integer skip) only describe the operands to ``record``."""
        _, _, k, stride = self.geometry[name]
        wq, wstep = self._qweight(name)
        acc = F.conv2d(xq, wq, stride=stride, padding=(k - 1) // 2)
        if self.record is not None:
            res = (None if residual is None else
                   "int" if res_int else "float")
            self.record.append((name, tuple(xq.shape), tuple(acc.shape),
                                not x_float, out_step is not None, res))
        mult = self._p(name, "scale").float() * wstep * step
        y = (acc * mult[:, None, None]
             + self._p(name, "bias").float()[:, None, None])
        if residual is not None:
            y = y + residual
        if relu:
            y = torch.relu(y)
        if out_step is None:
            return y
        return quantize(y, out_step, self.levels)

    # -- calibration --------------------------------------------------------
    def observe(self, name, t):
        a = observed_amax(t, self.quantile)
        old = self.scales.get(name)
        self.scales[name] = a if old is None else torch.maximum(old, a)

    def step(self, name):
        return step_of(self.scales[name], self.levels)

    # -- blocks -------------------------------------------------------------
    def block(self, x, pre, downsample):
        calib = self.mode == "calib"
        y = self.conv(f"{pre}.conv1", x, True)
        if calib:
            self.observe(f"{pre}.t1", y)
        y = self.conv(f"{pre}.conv2", y, True)
        if calib:
            self.observe(f"{pre}.t2", y)
        y = self.conv(f"{pre}.conv3", y, False)
        res = self.conv(f"{pre}.downsample.0", x, False) if downsample else x
        out = torch.relu(y + res)
        if calib:
            self.observe(f"{pre}.out", out)
        return out

    def block_int(self, xq, step, pre, downsample, quant_out):
        """A bottleneck on integers: (integers, step) out, or the float
        output with ``quant_out`` False."""
        s1, s2 = self.step(f"{pre}.t1"), self.step(f"{pre}.t2")
        y = self.conv_int(f"{pre}.conv1", xq, step, True, out_step=s1)
        y = self.conv_int(f"{pre}.conv2", y, s1, True, out_step=s2)
        res = (self.conv_int(f"{pre}.downsample.0", xq, step, False)
               if downsample else xq * step)
        so = self.step(f"{pre}.out") if quant_out else None
        out = self.conv_int(f"{pre}.conv3", y, s2, True, residual=res,
                            out_step=so, res_int=not downsample)
        return (out, so) if quant_out else (out, None)

    # -- the graph ----------------------------------------------------------
    def __call__(self, images_nchw, mode="float"):
        """Normalized images (N, 3, H, W) -> four 256-channel maps, deepest
        first (float32; ``serve`` dequantizes the integer maps with their
        steps, which the sampler's linearity allows)."""
        self.mode = mode
        calib, serve = mode == "calib", mode == "serve"
        x = self.conv("resnet.conv1", images_nchw, True)
        if calib:
            self.observe("resnet.in", x)
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        if serve:
            step = self.step("resnet.in")
            x = quantize(x, step, self.levels)
        for li, blocks in enumerate(self.layers):
            for b in range(blocks):
                pre = f"resnet.layer{li + 1}.{b}"
                if serve:
                    x, step = self.block_int(x, step, pre, b == 0, True)
                else:
                    x = self.block(x, pre, b == 0)
            feats.append((x, step) if serve else x)
        res_out = feats[::-1]

        global_fms, up = [], None
        for i in range(4):
            lat_name = f"global_net.laterals.{i}.0"
            lat = (self.conv_int(lat_name, *res_out[i], True) if serve
                   else self.conv(lat_name, res_out[i], True))
            feature = lat if i == 0 else lat + up
            global_fms.append(feature)
            if i == 3:
                continue
            hw = (2 * feature.shape[2], 2 * feature.shape[3])
            up_name = f"global_net.upsamples.{i}.1"
            if mode == "float":
                up = self.conv(up_name, resize(feature, hw), False)
                continue
            if calib:
                self.observe(up_name, feature)
                pre = self.conv(up_name, feature, False)
            else:
                s = self.step(up_name)
                pre = self.conv_int(up_name, quantize(feature, s,
                                                      self.levels), s, False,
                                    x_float=True)
            up = resize(pre, hw)

        out_hw = tuple(global_fms[-1].shape[2:])
        maps = []
        for i in range(4):
            y = global_fms[i]
            n_blocks = 3 - i
            pre = f"refine_net.cascade.{i}"
            if calib:
                self.observe(f"{pre}.in" if n_blocks else
                             f"refine_net.feature{i}", y)
            if serve:
                s = self.step(f"{pre}.in" if n_blocks else
                              f"refine_net.feature{i}")
                y = quantize(y, s, self.levels)
                for k in range(n_blocks):
                    y, s = self.block_int(y, s, f"{pre}.{k}", True, True)
                y = y * s
            else:
                for k in range(n_blocks):
                    y = self.block(y, f"{pre}.{k}", True)
            if not self.native:
                y = resize(y, out_hw)
            maps.append(y)
        return maps
