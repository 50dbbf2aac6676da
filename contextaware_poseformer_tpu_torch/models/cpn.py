"""CPN backbone: ResNet-50 + globalNet (FPN) + refineNet, NHWC, frozen BN.

Port of the float branches of ``contextaware_poseformer_tpu/models/cpn.py``
(54-412):

  ResNet-50 -> [x4 2048@/32, x3 1024@/16, x2 512@/8, x1 256@/4]
  globalNet: 1x1 lateral (256ch) per level + top-down x2 bilinear
             (align_corners) upsample, then a 1x1 conv (reference order)
  refineNet: per level a cascade of 3-i Bottleneck(128->256) blocks, then a
             bilinear resize to /4, or with ``cpn_native_pyramid`` no resize:
             maps at /32, /16, /8 and /4

Returns four 256-channel NHWC maps, deepest first. The int8 serving stack
(``quantize="serve"``, ``cpn_int8_stream``, ``cpn_int8_maps``,
``cpn_fold_normalize``, ``cpn_int8_topdown``) is not ported; the
constructor refuses it.

Conv modules are named after the torch parameter prefixes with dots turned
into underscores (``resnet.layer1.0.conv1`` -> ``resnet_layer1_0_conv1``);
``models/bridge.py`` maps the flax names.
"""

from __future__ import annotations

import torch
from torch import nn

from contextaware_poseformer_tpu_torch.config import BackboneConfig
from contextaware_poseformer_tpu_torch.models.backbone_common import (
    ConvBN,
    max_pool_3x3_s2,
    module_name,
    resize_bilinear_align_corners,
)

RESNET50_LAYERS = (3, 4, 6, 3)
LATERAL_CH = 256
REFINE_PLANES = 128  # refineNet Bottleneck expansion = 2
_PLANES = (64, 128, 256, 512)


class CPN(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.kind != "cpn":
            raise ValueError(f"CPN with a {cfg.kind!r} backbone config")
        if cfg.quantize != "none" or cfg.cpn_fold_normalize:
            raise NotImplementedError(
                f"CPN quantize={cfg.quantize!r}: the CPN int8 serving stack "
                "(int8 wide convs, serve_static_amax, cpn_int8_stream, "
                "cpn_int8_maps and K1's int8-map input; ROADMAP 5a) and "
                "cpn_fold_normalize are not ported; use quantize='none'")
        self.cfg = cfg
        self.dtype = dtype

        def conv(name, cin, cout, ks, stride, relu):
            self.add_module(module_name(name), ConvBN(
                cin, cout, ks, stride, relu, dtype, device=device))

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

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, module_name(name))(x)

    def _resnet_bottleneck(self, x, prefix, downsample):
        # torchvision-style: stride on conv2
        y = self._conv(f"{prefix}.conv1", x)
        y = self._conv(f"{prefix}.conv2", y)
        y = self._conv(f"{prefix}.conv3", y)
        residual = self._conv(f"{prefix}.downsample.0", x) if downsample else x
        return torch.relu(y + residual)

    def _refine_bottleneck(self, x, prefix):
        # planes 128, expansion 2, downsample always present, stride 1
        y = self._conv(f"{prefix}.conv1", x)
        y = self._conv(f"{prefix}.conv2", y)
        y = self._conv(f"{prefix}.conv3", y)
        return torch.relu(y + self._conv(f"{prefix}.downsample.0", x))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (N, H, W, 3) normalized -> 4 NHWC maps of 256 channels,
        deepest first."""
        x = max_pool_3x3_s2(self._conv("resnet.conv1", x))
        feats = []  # [x1 /4, x2 /8, x3 /16, x4 /32]
        for li, blocks in enumerate(self.cfg.cpn_layers):
            for b in range(blocks):
                x = self._resnet_bottleneck(
                    x, f"resnet.layer{li + 1}.{b}", downsample=b == 0)
            feats.append(x)
        res_out = feats[::-1]

        global_fms = []
        up = None
        for i in range(4):
            lat = self._conv(f"global_net.laterals.{i}.0", res_out[i])
            feature = lat if i == 0 else lat + up
            global_fms.append(feature)
            if i != 3:
                _, h, w, _ = feature.shape
                up = self._conv(
                    f"global_net.upsamples.{i}.1",
                    resize_bilinear_align_corners(feature, (2 * h, 2 * w)),
                )

        out_hw = tuple(global_fms[-1].shape[1:3])
        refine_fms = []
        for i in range(4):
            y = global_fms[i]
            for k in range(3 - i):
                y = self._refine_bottleneck(y, f"refine_net.cascade.{i}.{k}")
            if not self.cfg.cpn_native_pyramid:
                y = resize_bilinear_align_corners(y, out_hw)
            refine_fms.append(y)
        return refine_fms
