"""HRNet-W32/W48 backbone, NHWC, frozen BN, four multi-scale maps.

Port of the float graph of ``contextaware_poseformer_tpu/models/hrnet.py``
(40-384; reference PoseHighResolutionNet, pose_hrnet.py:312-501):

  stem (2x stride-2 3x3 conv) -> layer1 (4x Bottleneck-64, the first with a
  1x1 downsample to 256) -> transition1 -> stage2 (1 module, 2 branches)
  -> transition2 -> stage3 (4 modules, 3 branches)
  -> transition3 -> stage4 (3 modules, 4 branches, last module single-output)

Returns four NHWC maps, finest first: the fused level-0 output of the LAST
stage-4 module and, as levels 1-3, the FIRST stage-4 module's pre-fuse
branch outputs: the reference's HRModule.forward mutates its input list in
place (pose_hrnet.py:289-290), so its ``x_list`` at pose_hrnet.py:501
aliases them. Shapes for 256x192 input: (64,48,C), (32,24,2C), (16,12,4C),
(8,6,8C). ``hrnet_stage4_truncate`` runs only stage-4 module 0 (levels 1-3
unchanged, level 0 that module's fused output) and builds only its
parameters.

``quantize="serve"`` (the deploy graph, ``hrnet.py:71-228, 324-346``) runs
layer1 end to end in int8 with static calibrated scales (``_layer1_int8``:
``layer1_impl="pallas"`` through the fused kernel K9, "xla" as a chain of
per-conv int8 convolutions K10), feeds transition1 the int8 tensor
directly, and runs every conv with both channel counts >= 128 as a dynamic
int8 convolution (K10); with ``serve_static_amax`` the wide convs quantize
with their input's calibrated amax instead (``hrnet.py:49``, the ConvBN's
``calib/amax``). ``forward(x, calibrate=True)`` is the JAX package's
calibration pass: it records the layer1 activation scales while layer1 runs
in float, and the static convs' input scales while they run dynamic (the
wide convs stay int8), so the observed scales describe that graph.
``quantize="c128"`` runs only the wide convs in dynamic int8, the rest as
the float graph; ``quantize="static"`` runs every 3x3 conv with both
channel counts >= 16 (the stem's conv2, layer1's conv2s, the transitions,
the branch BasicBlocks and the stride-2 fuse convs) and the wide 1x1s in
int8 with a calibrated scale each (K10 per conv; layer1 as float
bottlenecks around its int8 conv2s, so K9 is not used), and its
calibration pass runs the float graph. ``layer1_impl`` and
``serve_static_amax`` act only under ``"serve"``, as in the JAX package.
Conv modules are named after the flax names with dots turned into underscores
(``stage2.0.branches.0.0.conv1`` -> ``stage2_0_branches_0_0_conv1``), as in
``models/cpn.py``; so are the calibration buffers (``layer1.in_amax`` ->
``layer1_in_amax``).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from contextaware_poseformer_tpu_torch.config import (
    BackboneConfig,
    HRNetStageConfig,
)
from contextaware_poseformer_tpu_torch.models import backbone_common
from contextaware_poseformer_tpu_torch.models.backbone_common import (
    ConvBN,
    add_conv,
    add_upsampled_nearest,
    module_name,
)
from contextaware_poseformer_tpu_torch.ops import int8_conv, layer1_chain

STEM_CH = 64
LAYER1_PLANES = 64  # Bottleneck expansion 4 -> 256
# the calibrated activation scales of the int8 layer1 (the JAX package's
# "calib" collection under quantize="serve")
CALIB_NAMES = ("layer1.in_amax",) + tuple(
    f"layer1.{b}.{t}_amax" for b in range(4) for t in ("t1", "t2", "out"))


def _build_stage(conv, name: str, stage: HRNetStageConfig, num_modules: int,
                 multi_scale_output: bool) -> None:
    """Declare one stage's convs through ``conv(name, cin, cout, ks, stride,
    relu)``: each module's branch BasicBlocks and fuse layers (the last
    module of a single-output stage fuses level 0 only)."""
    chans = list(stage.num_channels)
    nb = stage.num_branches
    for m in range(num_modules):
        prefix = f"{name}.{m}"
        last = m == num_modules - 1
        for i in range(nb):
            for b in range(stage.num_blocks[i]):
                pre = f"{prefix}.branches.{i}.{b}"
                conv(f"{pre}.conv1", chans[i], chans[i], 3, 1, True)
                conv(f"{pre}.conv2", chans[i], chans[i], 3, 1, False)
        num_out = nb if (multi_scale_output or not last) else 1
        for i in range(num_out):
            for j in range(nb):
                if j > i:
                    conv(f"{prefix}.fuse_layers.{i}.{j}.0", chans[j],
                         chans[i], 1, 1, False)
                for k in range(i - j):  # j < i: a stride-2 chain
                    tail = k == i - j - 1
                    conv(f"{prefix}.fuse_layers.{i}.{j}.{k}.0", chans[j],
                         chans[i] if tail else chans[j], 3, 2, not tail)


class HRNet(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.kind != "hrnet":
            raise ValueError(f"HRNet with a {cfg.kind!r} backbone config")
        if cfg.quantize not in ("none", "c128", "static", "serve"):
            raise ValueError(f"HRNet quantize={cfg.quantize!r}")
        if cfg.layer1_impl not in ("xla", "pallas"):
            raise ValueError(f"layer1_impl {cfg.layer1_impl!r}")
        for stage in (cfg.stage2, cfg.stage3, cfg.stage4):
            if stage.block != "BASIC":
                raise ValueError(f"HRNet stage block {stage.block!r}: only "
                                 "BASIC branches exist in the reference")
        self.cfg = cfg
        self.dtype = dtype
        self.serve = cfg.quantize == "serve"
        # "plain" runs K9's and K10's plain versions on any device (the
        # card's comparison path, as the lifter's plain knobs)
        self.int8_impl = "auto"
        self._calibrating = False  # set by forward(calibrate=True)
        self.stage4_modules = (1 if cfg.hrnet_stage4_truncate
                               else cfg.stage4.num_modules)

        def conv(name, cin, cout, ks, stride, relu):
            add_conv(self, name, ConvBN(
                cin, cout, ks, stride, relu, dtype, device=device,
                quantile=cfg.calib_quantile,
                **backbone_common.int8_route(
                    cfg, cin, cout, ks, name.startswith(
                        ("layer1.", "transition1.")))))

        conv("conv1", 3, STEM_CH, 3, 2, True)
        conv("conv2", STEM_CH, STEM_CH, 3, 2, True)
        p = LAYER1_PLANES
        for b in range(4):
            cin = STEM_CH if b == 0 else 4 * p
            conv(f"layer1.{b}.conv1", cin, p, 1, 1, True)
            conv(f"layer1.{b}.conv2", p, p, 3, 1, True)
            conv(f"layer1.{b}.conv3", p, 4 * p, 1, 1, False)
            if b == 0:
                conv("layer1.0.downsample.0", cin, 4 * p, 1, 1, False)
        c2, c3, c4 = (list(s.num_channels)
                      for s in (cfg.stage2, cfg.stage3, cfg.stage4))
        conv("transition1.0.0", 4 * p, c2[0], 3, 1, True)
        conv("transition1.1.0.0", 4 * p, c2[1], 3, 2, True)
        _build_stage(conv, "stage2", cfg.stage2, cfg.stage2.num_modules, True)
        conv("transition2.2.0.0", c2[-1], c3[2], 3, 2, True)
        _build_stage(conv, "stage3", cfg.stage3, cfg.stage3.num_modules, True)
        conv("transition3.3.0.0", c3[-1], c4[3], 3, 2, True)
        _build_stage(conv, "stage4", cfg.stage4, self.stage4_modules, False)
        # the backbone's own calibrated scales, by their flax names
        self.calib_flax_names = ({module_name(n): n for n in CALIB_NAMES}
                                 if self.serve else {})
        for n in self.calib_flax_names:
            self.register_buffer(n, torch.zeros(
                (), dtype=torch.float32, device=device))
        if cfg.quantize != "none":
            self.register_buffer("serving_fingerprint", torch.zeros(
                16, dtype=torch.uint8, device=device))

    def _conv(self, name: str, x, **kw) -> torch.Tensor:
        return getattr(self, module_name(name))(
            x, impl=self.int8_impl, calibrate=self._calibrating, **kw)

    def _amax(self, name: str) -> torch.Tensor:
        return getattr(self, module_name(name))

    def _layer1_calibrate(self, x):
        """The calibration pass's layer1: float bottlenecks, each calibrated
        tensor's ``observed_amax`` folded into its buffer by max."""
        def observe(name, t):
            backbone_common.observe(self._amax(name), t,
                                    self.cfg.calib_quantile)

        observe("layer1.in_amax", x)
        for b in range(4):
            y = self._conv(f"layer1.{b}.conv1", x)
            observe(f"layer1.{b}.t1_amax", y)
            y = self._conv(f"layer1.{b}.conv2", y)
            observe(f"layer1.{b}.t2_amax", y)
            res = self._conv("layer1.0.downsample.0", x) if b == 0 else x
            x = self._conv(f"layer1.{b}.conv3", y, residual=res, relu=True)
            observe(f"layer1.{b}.out_amax", x)
        return x

    def _layer1_int8(self, x):
        """layer1 at inference: (int8 (B, H, W, 256), its calibrated amax),
        through K9 ("pallas") or the per-conv chain ("xla": K10 convs,
        K10q's scale form for the quantizes)."""
        blocks = []
        for b in range(4):
            pre = f"layer1.{b}"
            blk = {c: getattr(self, module_name(f"{pre}.{c}")).packed()
                   for c in ("conv1", "conv2", "conv3")}
            blk["downsample"] = (self.layer1_0_downsample_0.packed()
                                 if b == 0 else None)
            for t in ("t1", "t2", "out"):
                blk[t] = self._amax(f"{pre}.{t}_amax")
            blocks.append(blk)
        if self.cfg.layer1_impl == "pallas":
            if self.dtype != torch.bfloat16:
                raise ValueError("layer1_impl='pallas' computes the bf16 "
                                 f"epilogues of the deploy graph; backbone "
                                 f"dtype is {self.dtype}")
            xq = layer1_chain.layer1_chain(x, self.layer1_in_amax, blocks,
                                           self.int8_impl)
        else:
            xq = layer1_chain.layer1_int8_chain(
                x, self.layer1_in_amax, blocks,
                functools.partial(int8_conv.int8_conv, impl=self.int8_impl),
                functools.partial(int8_conv.quant, impl=self.int8_impl))
        return xq, self.layer1_3_out_amax

    def _basic_block(self, x, prefix):
        # BasicBlock (pose_hrnet.py:66-95); stage branches never downsample.
        # The tail relu(conv2(y) + x) is conv2's own epilogue: the float
        # epilogue pass, or K10's on a wide int8 conv
        y = self._conv(f"{prefix}.conv1", x)
        return self._conv(f"{prefix}.conv2", y, residual=x, relu=True)

    def _bottleneck(self, x, prefix, downsample):
        # Bottleneck, expansion 4 (pose_hrnet.py:98-136); conv3 adds the
        # residual and takes the ReLU in its epilogue
        y = self._conv(f"{prefix}.conv1", x)
        y = self._conv(f"{prefix}.conv2", y)
        residual = self._conv(f"{prefix}.downsample.0", x) if downsample else x
        return self._conv(f"{prefix}.conv3", y, residual=residual, relu=True)

    def _fuse(self, outs, prefix, num_out):
        """out_i = relu(sum_j path_ij(x_j)) (pose_hrnet.py:225-303), summed in
        the JAX package's order: j ascending, so j < i chains first, then the
        identity term, then the upsampled j > i terms. A chain's last conv
        adds the running sum in its epilogue (``y + acc``, the bits of
        ``acc + y``)."""
        fused = []
        for i in range(num_out):
            acc = None
            for j in range(len(outs)):
                if j > i:
                    y = self._conv(f"{prefix}.fuse_layers.{i}.{j}.0", outs[j])
                    acc = add_upsampled_nearest(acc, y, 2 ** (j - i))
                    continue
                if j == i:
                    acc = outs[j] if acc is None else acc + outs[j]
                    continue
                y = outs[j]
                for k in range(i - j):
                    tail = k == i - j - 1
                    y = self._conv(f"{prefix}.fuse_layers.{i}.{j}.{k}.0", y,
                                   residual=acc if tail else None)
                acc = y
            fused.append(torch.relu(acc))
        return fused

    def _stage(self, xs, name, stage, num_modules, multi_scale_output):
        """Returns (final outputs, FIRST module's pre-fuse branch outputs)."""
        first = None
        for m in range(num_modules):
            prefix = f"{name}.{m}"
            outs = []
            for i, y in enumerate(xs):
                for b in range(stage.num_blocks[i]):
                    y = self._basic_block(y, f"{prefix}.branches.{i}.{b}")
                outs.append(y)
            if first is None:
                first = outs
            last = m == num_modules - 1
            num_out = len(outs) if (multi_scale_output or not last) else 1
            xs = self._fuse(outs, prefix, num_out)
        return xs, first

    def forward(self, x: torch.Tensor,
                calibrate: bool = False) -> list[torch.Tensor]:
        """x: (N, H, W, 3) normalized -> 4 NHWC maps, finest first.
        ``calibrate=True`` (``quantize="serve"`` or ``"static"``): the
        calibration pass, which updates the scale buffers in place."""
        self._calibrating = calibrate
        try:
            return self._forward(x, calibrate)
        finally:
            self._calibrating = False

    def _forward(self, x, calibrate):
        cfg = self.cfg
        x = self._conv("conv1", x)
        x = self._conv("conv2", x)
        if self.serve and calibrate:
            x = self._layer1_calibrate(x)
        elif self.serve:
            x = self._layer1_int8(x)
        else:
            x = self._bottleneck(x, "layer1.0", downsample=True)
            for b in range(1, 4):
                x = self._bottleneck(x, f"layer1.{b}", downsample=False)
        if isinstance(x, tuple):  # the int8 layer1 output and its amax
            xs = [self._conv("transition1.0.0", None, x_quant=x),
                  self._conv("transition1.1.0.0", None, x_quant=x)]
        else:
            xs = [self._conv("transition1.0.0", x),
                  self._conv("transition1.1.0.0", x)]
        ys, _ = self._stage(xs, "stage2", cfg.stage2,
                            cfg.stage2.num_modules, True)
        # transition2/3: existing branches pass through; one new stride-2
        # branch from the last one (pose_hrnet.py:484)
        xs = [*ys, self._conv("transition2.2.0.0", ys[-1])]
        ys, _ = self._stage(xs, "stage3", cfg.stage3,
                            cfg.stage3.num_modules, True)
        xs = [*ys, self._conv("transition3.3.0.0", ys[-1])]
        ys, first = self._stage(xs, "stage4", cfg.stage4,
                                self.stage4_modules, False)
        return [ys[0], first[1], first[2], first[3]]
