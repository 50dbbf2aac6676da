"""Backbone building blocks: folded-BN convolution and resize ops, NHWC.

Port of ``contextaware_poseformer_tpu/models/backbone_common.py``: the float
branch of ``ConvBN`` (54-227, float path 214-227),
``add_upsampled_nearest`` (235-246), ``resize_bilinear_align_corners``
(249-280) and ``max_pool_3x3_s2`` (389-412). The int8 modes (``quantize``
other than "none") are not ported.

Tensors are NHWC at every function here. Each op runs on the NCHW-shaped
``permute`` view of its input, which for an NHWC-contiguous tensor is
PyTorch's ``channels_last`` layout, so convolutions, pooling and resizes
run as channels-last kernels and hand back NHWC-contiguous results without
a layout copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from contextaware_poseformer_tpu_torch.models import init


def module_name(torch_prefix: str) -> str:
    """Torch parameter prefix (the flax module name, such as
    ``resnet.layer1.0.conv1``) -> the backbone's module name
    (``resnet_layer1_0_conv1``); ``models/bridge.py`` maps flax names by
    the same rule."""
    return torch_prefix.replace(".", "_")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvBN(nn.Module):
    """Conv2d (no bias) + folded frozen BatchNorm + optional ReLU, NHWC:
    ``y = conv(x, weight) * scale + bias``, all in ``dtype``.

    ``weight`` is OIHW (PyTorch's layout; the flax kernel is HWIO), padding
    (k - 1) // 2 on both sides."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, relu: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.stride = stride
        self.padding = (kernel_size - 1) // 2
        self.relu = relu
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_ch, kernel_size, kernel_size, device=device))
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator) -> None:
        init.he_normal_(self.weight, generator)
        init.ones_(self.scale)
        init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = _nhwc(F.conv2d(_nchw(x.to(dt)), self.weight.to(dt),
                           stride=self.stride, padding=self.padding))
        y = torch.addcmul(self.bias.to(dt), y, self.scale.to(dt))
        return torch.relu(y) if self.relu else y


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
    wins: every window holds at least 4 real pixels)."""
    return _nhwc(F.max_pool2d(_nchw(x), 3, 2, 1))
