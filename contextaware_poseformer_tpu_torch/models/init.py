"""Seeded parameter initialisation: the flax initializers of the JAX package
in PyTorch.

Counterparts: ``torch_linear_kernel_init`` / ``torch_linear_bias_init``
(``models/layers.py:24-37``), the zero and radial sampling-offset inits of
the deformable block (``models/lifter.py:42-57, 112-125``), the zero
``pos_embed`` (``lifter.py:270-272``) and the conv ``he_normal`` with unit
BN scale and zero bias (``models/backbone_common.py:121-127``).

Values are drawn on the CPU from an explicit ``torch.Generator`` and copied
to the parameter's device, so one seed gives the same weights on every
device. JAX's and PyTorch's generators differ: tests that compare the two
packages carry weights across with ``models/bridge.py`` instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# flax's truncated-normal stddev correction (variance_scaling, truncated at
# two standard deviations)
_TRUNC_STD = 0.87962566103423978


def fill_(param: torch.Tensor, value: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(value.to(param.dtype))


def uniform_(param: torch.Tensor, bound: float, generator) -> None:
    v = torch.empty(param.shape).uniform_(-bound, bound, generator=generator)
    fill_(param, v)


def zeros_(param: torch.Tensor) -> None:
    with torch.no_grad():
        param.zero_()


def ones_(param: torch.Tensor) -> None:
    with torch.no_grad():
        param.fill_(1.0)


def he_normal_(weight: torch.Tensor, generator) -> None:
    """flax ``he_normal`` on an OIHW conv weight (fan_in = I * kh * kw)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    v = torch.empty(weight.shape)
    nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    fill_(weight, v)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Give every parameter of ``model`` its flax-initializer value, drawn
    from ``generator`` (a CPU generator) in module order."""
    if generator.device.type != "cpu":
        raise ValueError("init_parameters draws on the CPU: pass a CPU "
                         "torch.Generator")
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
