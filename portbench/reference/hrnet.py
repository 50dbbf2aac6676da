"""HRNet (arXiv:1902.09212), plain: the pose network's four multi-scale
maps, convolutions with their BatchNorm folded into a per-channel scale and
bias, NCHW float32.

  stem (two stride-2 3x3 convs) -> layer1 (four 64-plane bottlenecks, the
  first with a 1x1 downsample to 256) -> transition1 -> stage2 (1 module,
  2 branches) -> transition2 -> stage3 (4 modules, 3 branches)
  -> transition3 -> stage4 (3 modules, 4 branches, the last fusing level 0
  only)

Each module runs its branches' BasicBlocks, then fuses: out_i = relu(sum
over j of x_j brought to level i), a 1x1 conv and a nearest upsample from a
coarser level, a chain of stride-2 3x3 convs from a finer one, summed in
ascending j. The maps handed on are the last module's fused level 0 and,
as levels 1-3, stage4's first module's branch outputs before its fuse (the
published network's forward hands on the list its first module rewrote).

Modes:

- ``float``: every convolution in float.
- ``calib``: the calibration pass of the int8 deploy graph: layer1 in
  float, recording the statistic of its input, of each block's two inner
  activations and of each block's output; the rest as ``serve`` runs it.
- ``serve``: layer1 on integers (its input quantized, each conv's output
  requantized after its ReLU, each block's output requantized after the
  residual and ReLU); transition1 reads layer1's integers; every other
  convolution with both channel counts >= 128 quantizes its input by its
  own max|x|; the rest run in float.
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

STEM = 64
PLANES = 64
WIDE = 128


def stage_convs(name, stage, num_modules, multi_scale_output):
    """(name, cin, cout, kernel, stride, relu) of a stage's convolutions."""
    ch, nb = stage["channels"], stage["branches"]
    out = []
    for m in range(num_modules):
        pre = f"{name}.{m}"
        last = m == num_modules - 1
        for i in range(nb):
            for b in range(stage["blocks"][i]):
                bp = f"{pre}.branches.{i}.{b}"
                out += [(f"{bp}.conv1", ch[i], ch[i], 3, 1, True),
                        (f"{bp}.conv2", ch[i], ch[i], 3, 1, False)]
        for i in range(nb if (multi_scale_output or not last) else 1):
            for j in range(nb):
                if j > i:
                    out.append((f"{pre}.fuse_layers.{i}.{j}.0", ch[j], ch[i],
                                1, 1, False))
                for k in range(i - j):
                    tail = k == i - j - 1
                    out.append((f"{pre}.fuse_layers.{i}.{j}.{k}.0", ch[j],
                                ch[i] if tail else ch[j], 3, 2, not tail))
    return out


def conv_names(cfg):
    """(name, cin, cout, kernel, stride, relu) of every convolution."""
    s2, s3, s4 = cfg["stage2"], cfg["stage3"], cfg["stage4"]
    out = [("conv1", 3, STEM, 3, 2, True), ("conv2", STEM, STEM, 3, 2, True)]
    for b in range(4):
        cin = STEM if b == 0 else 4 * PLANES
        out += [(f"layer1.{b}.conv1", cin, PLANES, 1, 1, True),
                (f"layer1.{b}.conv2", PLANES, PLANES, 3, 1, True),
                (f"layer1.{b}.conv3", PLANES, 4 * PLANES, 1, 1, False)]
        if b == 0:
            out.append(("layer1.0.downsample.0", cin, 4 * PLANES, 1, 1,
                        False))
    out += [("transition1.0.0", 4 * PLANES, s2["channels"][0], 3, 1, True),
            ("transition1.1.0.0", 4 * PLANES, s2["channels"][1], 3, 2, True)]
    out += stage_convs("stage2", s2, s2["modules"], True)
    out.append(("transition2.2.0.0", s2["channels"][-1], s3["channels"][2],
                3, 2, True))
    out += stage_convs("stage3", s3, s3["modules"], True)
    out.append(("transition3.3.0.0", s3["channels"][-1], s4["channels"][3],
                3, 2, True))
    out += stage_convs("stage4", s4, s4["modules"], False)
    return out


class HRNet:
    """``params``: the benchmark's state dict; ``cfg``: the configuration's
    ``backbone`` section; ``levels``: 127, or 7 for the int4 control."""

    def __init__(self, params, cfg, levels=127, prefix="backbone."):
        self.params = params
        self.cfg = cfg
        self.levels = levels
        self.prefix = prefix
        self.quantile = float(cfg.get("calib_quantile", 1.0))
        self.geometry = {n: (ci, co, k, s, r) for n, ci, co, k, s, r in
                         conv_names(cfg)}
        self._qweights = {}
        self.scales = {}
        self.mode = "float"
        self.record = None  # a list: each int8 convolution's shapes

    def _p(self, name, leaf):
        return self.params[f"{self.prefix}{name.replace('.', '_')}.{leaf}"]

    def _qweight(self, name):
        if name not in self._qweights:
            self._qweights[name] = quantize_weight(
                self._p(name, "weight").float(), self.levels)
        return self._qweights[name]

    def observe(self, name, t):
        a = observed_amax(t, self.quantile)
        old = self.scales.get(name)
        self.scales[name] = a if old is None else torch.maximum(old, a)

    def step(self, name):
        return step_of(self.scales[name], self.levels)

    def conv(self, name, x, relu=None):
        """A convolution on a float input, as the mode runs it."""
        cin, cout, k, stride, own_relu = self.geometry[name]
        relu = own_relu if relu is None else relu
        if (self.mode != "float" and cin >= WIDE and cout >= WIDE):
            step = step_of(x.abs().amax(), self.levels)
            return self.conv_int(name, quantize(x, step, self.levels), step,
                                 relu, x_float=True)
        y = F.conv2d(x, self._p(name, "weight").float(), stride=stride,
                     padding=(k - 1) // 2)
        y = torch.addcmul(self._p(name, "bias").float()[:, None, None], y,
                          self._p(name, "scale").float()[:, None, None])
        return torch.relu(y) if relu else y

    def conv_int(self, name, xq, step, relu, x_float=False, chain=False):
        """A convolution of integers ``xq`` at ``step`` (float output).
        ``x_float`` and ``chain`` (layer1, one fused kernel in the program)
        only describe it to ``record``."""
        _, _, k, stride, _ = self.geometry[name]
        wq, wstep = self._qweight(name)
        acc = F.conv2d(xq, wq, stride=stride, padding=(k - 1) // 2)
        if self.record is not None and not chain:
            self.record.append((name, tuple(xq.shape), tuple(acc.shape),
                                not x_float, False, None))
        mult = self._p(name, "scale").float() * wstep * step
        y = (acc * mult[:, None, None]
             + self._p(name, "bias").float()[:, None, None])
        return torch.relu(y) if relu else y

    def layer1(self, x):
        if self.mode == "serve":
            return self.layer1_int(x)
        calib = self.mode == "calib"
        if calib:
            self.observe("layer1.in", x)
        for b in range(4):
            pre = f"layer1.{b}"
            y = self.conv(f"{pre}.conv1", x)
            if calib:
                self.observe(f"{pre}.t1", y)
            y = self.conv(f"{pre}.conv2", y)
            if calib:
                self.observe(f"{pre}.t2", y)
            y = self.conv(f"{pre}.conv3", y)
            res = self.conv("layer1.0.downsample.0", x) if b == 0 else x
            x = torch.relu(y + res)
            if calib:
                self.observe(f"{pre}.out", x)
        return x

    def layer1_int(self, x):
        """(integers, step) of layer1's output."""
        lv = self.levels
        s = self.step("layer1.in")
        xq = quantize(x, s, lv)
        for b in range(4):
            pre = f"layer1.{b}"
            s1, s2 = self.step(f"{pre}.t1"), self.step(f"{pre}.t2")
            y = self.conv_int(f"{pre}.conv1", xq, s, True, chain=True)
            y = self.conv_int(f"{pre}.conv2", quantize(y, s1, lv), s1, True,
                              chain=True)
            y = self.conv_int(f"{pre}.conv3", quantize(y, s2, lv), s2, False,
                              chain=True)
            res = (self.conv_int("layer1.0.downsample.0", xq, s, False,
                                 chain=True) if b == 0 else xq * s)
            s = self.step(f"{pre}.out")
            xq = quantize(torch.relu(y + res), s, lv)
        return xq, s

    def fuse(self, outs, pre, num_out):
        fused = []
        for i in range(num_out):
            acc = None
            for j, x in enumerate(outs):
                if j > i:
                    y = self.conv(f"{pre}.fuse_layers.{i}.{j}.0", x)
                    f = 2 ** (j - i)
                    b, c, h, w = acc.shape
                    acc = (acc.reshape(b, c, h // f, f, w // f, f)
                           + y[:, :, :, None, :, None]).reshape(b, c, h, w)
                    continue
                y = x
                for k in range(i - j):
                    y = self.conv(f"{pre}.fuse_layers.{i}.{j}.{k}.0", y)
                acc = y if acc is None else acc + y
            fused.append(torch.relu(acc))
        return fused

    def stage(self, xs, name, multi_scale_output):
        st = self.cfg[name]
        first = None
        for m in range(st["modules"]):
            pre = f"{name}.{m}"
            outs = []
            for i, y in enumerate(xs):
                for b in range(st["blocks"][i]):
                    bp = f"{pre}.branches.{i}.{b}"
                    y = torch.relu(self.conv(f"{bp}.conv2",
                                             self.conv(f"{bp}.conv1", y)) + y)
                outs.append(y)
            if first is None:
                first = outs
            last = m == st["modules"] - 1
            xs = self.fuse(outs, pre, len(outs) if (multi_scale_output
                                                    or not last) else 1)
        return xs, first

    def __call__(self, images_nchw, mode="float"):
        """Normalized images (N, 3, H, W) -> four float maps, finest
        first."""
        self.mode = mode
        x = self.conv("conv2", self.conv("conv1", images_nchw))
        x = self.layer1(x)
        if mode == "serve":
            xq, s = x
            xs = [self.conv_int(n, xq, s, True) for n in
                  ("transition1.0.0", "transition1.1.0.0")]
        else:
            xs = [self.conv("transition1.0.0", x),
                  self.conv("transition1.1.0.0", x)]
        ys, _ = self.stage(xs, "stage2", True)
        ys, _ = self.stage([*ys, self.conv("transition2.2.0.0", ys[-1])],
                           "stage3", True)
        ys, first = self.stage([*ys, self.conv("transition3.3.0.0", ys[-1])],
                               "stage4", False)
        return [ys[0], first[1], first[2], first[3]]
