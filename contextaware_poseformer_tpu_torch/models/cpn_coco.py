"""CPN with its COCO heads and live BatchNorm: the 2D detector's trainer.

Port of ``contextaware_poseformer_tpu/models/cpn_coco.py:64-265``:

  ResNet-50 -> globalNet (laterals, x2 top-down upsamples, predict heads)
  -> refineNet (cascades, final_predict head), every BatchNorm live
  (``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``, whose semantics the JAX
  package's ``BatchNormLive`` copies: the biased batch variance normalizes,
  the unbiased one, n/(n-1) with n = N*H*W, updates the running variance).

Heads (reference globalNet.py:46-59, refineNet.py:64-70): a predict head is
Conv1x1+BN+ReLU, Conv3x3->K (no bias), a bilinear resize to the output size
(align_corners=True), BN(K); final_predict is a refine Bottleneck
(1024->128->256), Conv3x3->K, BN(K).

The model computes channels-last (NHWC in memory, NCHW in shape): the NHWC
input is viewed as NCHW without a copy, and the heads come back as
contiguous NHWC tensors, the JAX package's order, which the losses and the
decode read. Modules are
named after the torch parameter prefixes with dots turned into underscores
(``backbone_common.add_conv``; each keeps its dotted flax name as
``flax_name``); ``models/bridge.py`` (``cpn_coco_from_jax``,
``cpn_coco_to_jax``) carries the JAX package's flat ``{params,
batch_stats}`` tree across.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from contextaware_poseformer_tpu_torch.config import BackboneConfig
from contextaware_poseformer_tpu_torch.models import init
from contextaware_poseformer_tpu_torch.models.backbone_common import (
    add_conv,
    max_pool_3x3_s2,
    module_name,
    resize_bilinear_align_corners,
)

RESNET50_LAYERS = (3, 4, 6, 3)
LATERAL_CH = 256
REFINE_PLANES = 128
_PLANES = (64, 128, 256, 512)

# torch BatchNorm2d defaults (the reference uses them throughout)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # new_running = (1 - m) * running + m * batch


def _batch_norm(features: int, device=None) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM,
                          device=device)


def conv_init_(weight: torch.Tensor, generator) -> None:
    """The reference head init, normal(0, sqrt(2 / (kh * kw * out)))
    (globalNet.py:19-23; the JAX package's variance_scaling(2, fan_out,
    normal)), on an OIHW weight."""
    std = math.sqrt(2.0 / (weight.shape[0] * weight.shape[2]
                           * weight.shape[3]))
    v = torch.empty(weight.shape).normal_(0.0, std, generator=generator)
    init.fill_(weight, v)


class ConvBNLive(nn.Module):
    """Conv2d (no bias) + live BatchNorm + optional ReLU (NCHW-shaped): the
    training-mode counterpart of ``backbone_common.ConvBN`` (which folds a
    frozen BN). The BN is the ``bn`` child, as in the JAX module."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 relu: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            cout, cin, kernel_size, kernel_size, device=device))
        self.bn = _batch_norm(cout, device)
        self.stride = stride
        self.padding = (kernel_size - 1) // 2
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(F.conv2d(x, self.weight, stride=self.stride,
                             padding=self.padding))
        return F.relu(y) if self.relu else y


def _pool(x: torch.Tensor) -> torch.Tensor:
    """``max_pool_3x3_s2`` on an NCHW-shaped tensor: the helper takes NHWC,
    and both permutes are views (no copy)."""
    return max_pool_3x3_s2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``resize_bilinear_align_corners`` on an NCHW-shaped tensor, as
    ``_pool``."""
    return resize_bilinear_align_corners(
        x.permute(0, 2, 3, 1), out_hw).permute(0, 3, 1, 2)


class CPNCoco(nn.Module):
    """CPN50 + the COCO keypoint heads, live BN, fp32.

    ``forward(x: (N, H, W, 3) normalized RGB)`` ->
        (global_outs: 4 x (N, Ho, Wo, K) deepest level first,
         refine_out:      (N, Ho, Wo, K)),
    NHWC, with (Ho, Wo) = (H/4, W/4) (cpn/config.py output_shape
    64x48 for 256x192 input); ``with_fms=True`` also returns the four
    refine maps (N, Ho, Wo, 256). ``train()`` / ``eval()`` select batch or
    running statistics."""

    def __init__(self, cfg: BackboneConfig, num_class: int = 17,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.num_class = num_class

        def conv(name, cin, cout, ks, stride, relu):
            add_conv(self, name, ConvBNLive(cin, cout, ks, stride, relu,
                                            device))

        def bottleneck(pre, cin, planes, expand, stride, downsample):
            conv(f"{pre}.conv1", cin, planes, 1, 1, True)
            conv(f"{pre}.conv2", planes, planes, 3, stride, True)
            conv(f"{pre}.conv3", planes, expand * planes, 1, 1, False)
            if downsample:
                conv(f"{pre}.downsample.0", cin, expand * planes, 1, stride,
                     False)

        def head(pre, cin):
            # the bias-free Conv3x3->K (flax leaf "<pre>.kernel") and BN(K)
            add_conv(self, pre, nn.Conv2d(cin, num_class, 3, padding=1,
                                          bias=False, device=device))

        conv("resnet.conv1", 3, 64, 7, 2, True)
        cin = 64
        for li, (p, blocks) in enumerate(zip(_PLANES, cfg.cpn_layers)):
            for b in range(blocks):
                bottleneck(f"resnet.layer{li + 1}.{b}", cin, p, 4,
                           2 if (li and not b) else 1, b == 0)
                cin = 4 * p
        for i, c in enumerate(4 * p for p in _PLANES[::-1]):
            conv(f"global_net.laterals.{i}.0", c, LATERAL_CH, 1, 1, True)
            if i != 3:
                conv(f"global_net.upsamples.{i}.1", LATERAL_CH, LATERAL_CH,
                     1, 1, False)
            conv(f"global_net.predict.{i}.0", LATERAL_CH, LATERAL_CH, 1, 1,
                 True)
            head(f"global_net.predict.{i}.3", LATERAL_CH)
            add_conv(self, f"global_net.predict.{i}.5",
                     _batch_norm(num_class, device))
        for i in range(4):
            for k in range(3 - i):
                bottleneck(f"refine_net.cascade.{i}.{k}", LATERAL_CH,
                           REFINE_PLANES, 2, 1, True)
        bottleneck("refine_net.final_predict.0", 4 * LATERAL_CH,
                   REFINE_PLANES, 2, 1, True)
        head("refine_net.final_predict.1", 2 * REFINE_PLANES)
        add_conv(self, "refine_net.final_predict.2",
                 _batch_norm(num_class, device))
        self.to(memory_format=torch.channels_last)

    def m(self, name: str) -> nn.Module:
        return getattr(self, module_name(name))

    def _bottleneck(self, x, pre, downsample):
        y = self.m(f"{pre}.conv1")(x)
        y = self.m(f"{pre}.conv2")(y)
        y = self.m(f"{pre}.conv3")(y)
        res = self.m(f"{pre}.downsample.0")(x) if downsample else x
        return F.relu(y + res)

    def forward(self, x: torch.Tensor, with_fms: bool = False):
        # an NHWC tensor is already channels-last: a view, no copy
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = _pool(self.m("resnet.conv1")(x))
        feats = []
        for li, blocks in enumerate(self.cfg.cpn_layers):
            for b in range(blocks):
                x = self._bottleneck(x, f"resnet.layer{li + 1}.{b}", b == 0)
            feats.append(x)
        res_out = feats[::-1]  # deepest first
        out_hw = (res_out[0].shape[2] * 8, res_out[0].shape[3] * 8)  # /4

        global_fms, global_outs, up = [], [], None
        for i in range(4):
            lat = self.m(f"global_net.laterals.{i}.0")(res_out[i])
            feature = lat if i == 0 else lat + up
            global_fms.append(feature)
            if i != 3:
                h, w = feature.shape[2:]
                up = self.m(f"global_net.upsamples.{i}.1")(
                    _resize(feature, (2 * h, 2 * w)))
            p = f"global_net.predict.{i}"
            y = self.m(f"{p}.3")(self.m(f"{p}.0")(feature))
            global_outs.append(self.m(f"{p}.5")(_resize(y, out_hw)))

        refine_fms = []
        for i in range(4):
            y = global_fms[i]
            for k in range(3 - i):
                y = self._bottleneck(y, f"refine_net.cascade.{i}.{k}", True)
            refine_fms.append(_resize(y, out_hw))
        y = self._bottleneck(torch.cat(refine_fms, dim=1),
                             "refine_net.final_predict.0", True)
        refine_out = self.m("refine_net.final_predict.2")(
            self.m("refine_net.final_predict.1")(y))

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        outs = ([nhwc(g) for g in global_outs], nhwc(refine_out))
        if with_fms:
            return (*outs, [nhwc(f) for f in refine_fms])
        return outs


def init_weights(model: CPNCoco, generator: torch.Generator) -> None:
    """Random weights from ``generator`` (a CPU generator), in module
    order: every conv ``conv_init_``, every BN scale 1 and bias 0 with
    fresh running statistics (mean 0, variance 1)."""
    for m in model.modules():
        if isinstance(m, ConvBNLive):
            conv_init_(m.weight, generator)
        elif isinstance(m, nn.Conv2d):
            conv_init_(m.weight, generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
