"""Operation counts of the benchmark's reference model, and the int8
convolutions' least time.

FLOPs a frame (or a training sample) are counted on the ``meta`` device
(shapes only) at batch 8, by XLA's per-op rules, over the reference's
float graph: the same work whatever kernel the program runs it on. The
counter is a rewritten copy of the program's
``contextaware_poseformer_tpu_torch/tools/model_flops.py`` (``XlaRules``):
a convolution 2 FLOPs a multiply-add of every tap inside its input, a
matmul 2 M N K (an ``addmm``'s bias one more an output), a pointwise op
one an output element, a reduction one an input element it folds;
transcendental ops and copies none; composite ops decomposed first.

The int8 roofline takes each int8 convolution of the reference's deploy
graph at the served batch: its input, weights (and their per-channel
scales) and output bytes, once each, at the peak bandwidth; its valid
multiply-adds at the peak int8 rate; the larger of the two, summed over
the convolutions.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench.reference.model import Model, param_specs

BATCH = 8


@functools.cache
def peaks() -> dict:
    """The card's published peaks (``peaks.json``)."""
    return json.loads(Path(__file__).with_name("peaks.json").read_text())


def _valid_taps(size, k, stride, pad, dil, out):
    return sum(0 <= o * stride - pad + j * dil < size
               for o in range(out) for j in range(k))


def conv_flops(x_shape, w_shape, stride, padding, dilation, out_shape):
    """2 FLOPs a multiply-add of every tap inside the input (NC... input,
    OI... kernel)."""
    taps = math.prod(
        _valid_taps(x_shape[2 + d], w_shape[2 + d], stride[d], padding[d],
                    dilation[d], out_shape[2 + d])
        for d in range(len(x_shape) - 2))
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


class XlaRules(TorchDispatchMode):
    """Counts the FLOPs of the ATen ops run under it (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    @staticmethod
    @functools.cache
    def tables():
        from torch._decomp import core_aten_decompositions, get_decompositions

        aten = torch.ops.aten
        decomp = {**core_aten_decompositions(), **get_decompositions([
            aten.gelu, aten.native_layer_norm, aten._softmax,
            aten.upsample_bilinear2d])}
        heavy = {aten.convolution, aten.mm, aten.bmm, aten.addmm}
        free = {aten.exp, aten.erf, aten.rsqrt, aten.tanh, aten.pow,
                aten.clone, aten._to_copy, aten.copy_}
        reductions = {aten.sum, aten.amax, aten.mean}
        return decomp, heavy, free, reductions

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        aten = torch.ops.aten
        decomp, heavy, free, reductions = self.tables()
        op = func.overloadpacket
        if op not in heavy and func in decomp:
            with self:
                out = decomp[func](*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        first = out[0] if isinstance(out, (tuple, list)) else out
        n_out = first.numel() if isinstance(first, torch.Tensor) else 0
        if op is aten.convolution:
            x, w, bias, stride, padding, dilation = args[:6]
            flops = conv_flops(x.shape, w.shape, stride, padding, dilation,
                               out.shape) + (n_out if bias is not None else 0)
        elif op in heavy:
            a = args[1] if op is aten.addmm else args[0]
            flops = 2 * n_out * a.shape[-1] + (n_out if op is aten.addmm
                                               else 0)
        elif op in free:
            flops = 0
        elif torch.Tag.pointwise in func.tags:
            flops = n_out
        elif op in reductions:
            flops = args[0].numel() - (0 if op is aten.mean else n_out)
        elif op is aten.var_mean:
            flops = 3 * args[0].numel()
        elif op is aten.max_pool2d_with_indices:
            flops = n_out * (math.prod(args[1]) - 1)
        else:
            flops = 0
        self.flops += flops
        return out


def _meta_params(cfg, train):
    params = {n: torch.empty(s, device="meta") for n, s, _ in
              param_specs(cfg)}
    if train:
        for n, p in params.items():
            if n.startswith("lifter."):
                p.requires_grad_(True)
    return params


def gflops_per_item(cfg, train: bool = False, batch: int = BATCH) -> float:
    """GFLOPs a frame of the reference's float graph of ``cfg``, or with
    ``train`` a training sample (the frozen backbone's forward, the
    lifter's forward and backward of a mean-square loss)."""
    params = _meta_params(cfg, train)
    model = Model(cfg, params)
    # the lifter's own parameter dict keeps the leaves (no float() copy)
    model.lifter.p = {k[len("lifter."):]: v for k, v in params.items()
                      if k.startswith("lifter.")}
    h, w = cfg["image_shape"]
    images = torch.zeros(batch, 3, h, w, device="meta")
    kp = torch.zeros(batch, cfg["lifter"]["num_joints"], 2, device="meta")
    rules = XlaRules()
    with rules:
        with torch.no_grad():
            maps = model.backbone(images, "float")
        if train:
            model.lifter(kp, kp, maps).square().mean().backward()
        else:
            with torch.no_grad():
                model.lifter(kp, kp, maps)
    return rules.flops / batch / 1e9


def int8_conv_least_s(cfg, batch: int) -> float:
    """The least time (s) of the int8 convolutions of one request of
    ``batch`` frames of ``cfg``'s deploy graph (module docstring)."""
    params = _meta_params(cfg, False)
    model = Model(cfg, params)
    backbone = model.backbone
    calls = []
    backbone.record = calls
    backbone.scales = _MetaScales()
    h, w = cfg["image_shape"]
    with torch.no_grad():
        backbone(torch.zeros(batch, 3, h, w, device="meta"), "serve")
    float_bytes = torch.tensor([], dtype=getattr(
        torch, cfg["precision"]["backbone"])).element_size()
    total = 0.0
    for name, x_shape, out_shape, x_int, out_int, res in calls:
        cin, cout, k, stride = backbone.geometry[name][:4]
        pad = (k - 1) // 2
        ops = conv_flops(x_shape, (cout, cin, k, k), (stride, stride),
                         (pad, pad), (1, 1), out_shape)
        n_in, n_out = math.prod(x_shape), math.prod(out_shape)
        nbytes = (n_in * (1 if x_int else float_bytes)
                  + cout * cin * k * k + 3 * 4 * cout
                  + n_out * (1 if out_int else float_bytes)
                  + {None: 0, "int": n_out, "float": n_out * float_bytes}[res])
        total += max(nbytes / peaks()["hbm_bytes_per_s"],
                     ops / peaks()["int8_ops_per_s"])
    return total


class _MetaScales(dict):
    """Calibration scales on the meta device: any name reads a scalar."""

    def __getitem__(self, name):
        return torch.ones((), device="meta")
