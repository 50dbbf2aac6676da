"""Per-preset model FLOPs of the port, counted by XLA's per-op rules.

The port's counterpart of the JAX package's ``tools/model_flops.py`` (XLA's
cost analysis there). It counts the PARITY graph of each configuration
(fp32, the gather sampler, einsum attention and MLP, no quantization): the
model's mathematical work, the right MFU numerator whichever route serves
it. The hand-written CUDA ops are invisible to a count of ATen's ops, so a
count taken on the card's kernel route would come out short. The count runs
on the ``meta`` device (shapes only: no memory, no arithmetic) at batch 8
and is divided by the batch (the model is batch-linear).

Each ATen op is counted as XLA's ``HloCostAnalysis`` counts its HLO
counterpart: a convolution 2 FLOPs a multiply-add of every tap that lands
inside its input (padding taps are not work), a matmul 2 M N K (an
``addmm``'s bias add one more an output element), a pointwise op one an
output element, a reduction one an input element it folds; transcendental
ops (exp, erf, rsqrt, tanh, ...) and data movement count none. Composite
ops (``addcmul``, GELU, layer norm, softmax, bilinear resize) are first
decomposed into their primitive ATen ops (``torch._decomp``), as XLA counts
the primitive HLO ops they lower to. ``tests/test_torch_tools.py`` holds
every convolution and matmul of every preset equal to XLA's count of the
same op, and a tiny model's whole count within 1% of XLA's cost analysis
of the same JAX graph before optimization.

The JAX package's ``FLOPS.json`` is XLA's count of its OPTIMIZED graph, in
which a producer's elementwise work (the folded BatchNorm's affine, ReLU) is
recomputed in every fusion that consumes it, and counted each time: there
the convolutions and matmuls agree with this count to the FLOP, and the
elementwise work is several times this count's (``PERF.md`` gives the
readings). So this count stays below ``FLOPS.json`` by that recomputation,
1.9-4.2% a preset; ``against_jax`` reports the difference.

Writes ``FLOPS_torch.json`` at the repo root (``FLOPS.json`` stays the JAX
package's)::

  {name: {"gflops_per_frame": ..., "train_gflops_per_frame": ...}}

for the five presets (``train_gflops_per_frame``: a training step, the
frozen backbone's forward and the lifter's forward and backward). A
preset's deploy graph (``serve.deploy_config``) runs the same convolutions
and Linears (its knobs change precision and routes), and h36m_cpn's skips
the refineNet's output resizes (its native pyramid): count it with
``count(deploy_config(name).model)``. MFU is
frames/s x FLOPs a frame over the card's peak (``PEAK_FLOPS``, the
H100 SXM dense figures ``chip_smoke.py`` uses: bf16 for serving, fp32 for
fp32 training)::

  python -m contextaware_poseformer_tpu_torch.tools.model_flops
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import math
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "FLOPS_torch.json"
BATCH = 8
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense


def parity_model_config(model_cfg):
    """``model_cfg`` as the parity graph: fp32 everywhere, the gather
    sampler, einsum attention and MLP, no quantization (the topology, the
    CPN's pyramid included, stays)."""
    lifter = dataclasses.replace(
        model_cfg.lifter, sampler="gather", attention="einsum",
        attention_joint="einsum", mlp="einsum", compute_dtype="float32",
        sampler_pre_project=False)
    backbone = dataclasses.replace(
        model_cfg.backbone, quantize="none", cpn_int8_stream=False,
        cpn_int8_maps=False, serve_static_amax=False)
    return dataclasses.replace(model_cfg, lifter=lifter, backbone=backbone,
                               compute_dtype="float32")


def _inputs(model_cfg, batch, device):
    h, w = model_cfg.image_shape
    return (torch.zeros(batch, h, w, 3, device=device),
            torch.zeros(batch, 17, 2, device=device),
            torch.zeros(batch, 17, 2, device=device))


def _valid_taps(size: int, k: int, stride: int, pad: int, dil: int,
                out: int) -> int:
    """(output position, kernel tap) pairs of one spatial dimension whose
    input index lies inside the input (XLA's count: no padding taps)."""
    return sum(0 <= o * stride - pad + j * dil < size
               for o in range(out) for j in range(k))


def conv_flops(x_shape, w_shape, stride, padding, dilation,
               out_shape) -> int:
    """2 FLOPs a multiply-add of every tap inside the input of a
    convolution (NC... input, OI... kernel, any group count)."""
    taps = math.prod(
        _valid_taps(x_shape[2 + d], w_shape[2 + d], stride[d], padding[d],
                    dilation[d], out_shape[2 + d])
        for d in range(len(x_shape) - 2))
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


class XlaRules(TorchDispatchMode):
    """A dispatch mode that counts the FLOPs of the ATen ops run under it
    by XLA's per-op rules (the module docstring): ``flops`` by the scope
    ``count`` sets (a top-level module's name, else "other"), and every
    convolution and matmul by its geometry in ``heavy``: ``{(op, shapes and
    parameters): [calls, FLOPs a call]}``."""

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()
        self.heavy = {}
        self.scope = "other"

    @staticmethod
    @functools.cache
    def tables():
        """(decompositions, heavy ops, transcendental ops, copies,
        reductions) as XLA's rules sort them."""
        from torch._decomp import core_aten_decompositions, get_decompositions

        aten = torch.ops.aten
        decomp = {**core_aten_decompositions(), **get_decompositions([
            aten.gelu, aten.native_layer_norm, aten._softmax,
            aten.upsample_bilinear2d])}
        heavy = {aten.convolution, aten.mm, aten.bmm, aten.addmm}
        # of the ops the presets run
        transcendental = {aten.exp, aten.erf, aten.rsqrt, aten.tanh,
                          aten.pow}
        moves = {aten.clone, aten._to_copy, aten.copy_}
        reductions = {aten.sum, aten.amax, aten.mean}
        return decomp, heavy, transcendental, moves, reductions

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        aten = torch.ops.aten
        decomp, heavy, transcendental, moves, reductions = self.tables()
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
            x, w, bias, stride, padding, dilation, transposed = args[:7]
            if transposed:
                raise NotImplementedError("model_flops: no rule for a "
                                          "transposed convolution")
            key = ("convolution", tuple(x.shape), tuple(w.shape),
                   tuple(stride), tuple(padding), tuple(dilation), args[8],
                   bias is not None)
            flops = conv_flops(x.shape, w.shape, stride, padding, dilation,
                               out.shape) + (n_out if bias is not None else 0)
        elif op in heavy:
            add = op is aten.addmm
            a = args[1] if add else args[0]
            key = (str(op).split(".")[-1],) + tuple(
                tuple(t.shape) for t in args[:3 if add else 2])
            flops = 2 * n_out * a.shape[-1] + (n_out if add else 0)
        else:
            key = None
            if op in transcendental or op in moves:
                flops = 0
            elif torch.Tag.pointwise in func.tags:
                flops = n_out
            elif op in reductions:  # a mean also divides its outputs
                flops = args[0].numel() - (0 if op is aten.mean else n_out)
            elif op is aten.var_mean:
                flops = 3 * args[0].numel()  # mean, square, sum
            elif op is aten.max_pool2d_with_indices:
                flops = n_out * (math.prod(args[1]) - 1)
            else:
                flops = 0
        if key is not None:
            self.heavy.setdefault(key, [0, flops])[0] += 1
        self.flops[self.scope] += flops
        return out


def count(model_cfg, batch: int = BATCH, device="meta",
          train: bool = False, rules: XlaRules | None = None) -> dict:
    """GFLOPs a frame of ``model_cfg``'s parity graph: the forward, or
    with ``train`` a training step (the frozen backbone's forward, the
    lifter's forward and backward); also each top-level module's share of
    the forward (``by_module``; the backward and the loss go to "other").
    ``rules`` (a fresh ``XlaRules`` by default) keeps each op's count."""
    from contextaware_poseformer_tpu_torch.models.capf import (
        ContextAwarePoseFormer,
    )

    cfg = parity_model_config(model_cfg)
    model = ContextAwarePoseFormer(cfg, dtype=torch.float32, device=device)
    model.backbone.requires_grad_(False)
    args = _inputs(cfg, batch, device)
    rules = XlaRules() if rules is None else rules

    def enter(name):
        def hook(*_):
            rules.scope = name
        return hook

    def leave(*_):
        rules.scope = "other"

    hooks = [h for name, child in model.named_children() for h in (
        child.register_forward_pre_hook(enter(name)),
        child.register_forward_hook(leave))]
    try:
        with rules:
            if train:
                model(*args).square().mean().backward()
            else:
                with torch.no_grad():
                    model(*args)
    finally:
        for h in hooks:
            h.remove()
    by_module = {k: v / batch / 1e9 for k, v in rules.flops.items()}
    return {"gflops_per_frame": sum(rules.flops.values()) / batch / 1e9,
            "by_module": by_module}


def count_preset(name: str, device="meta") -> dict:
    """``FLOPS_torch.json``'s row of preset ``name``."""
    from contextaware_poseformer_tpu_torch import config

    model_cfg = config.preset(name).model
    return {name: round(count(model_cfg, device=device, train=train)
                        ["gflops_per_frame"], 3)
            for name, train in (("gflops_per_frame", False),
                                ("train_gflops_per_frame", True))}


def count_all(device="meta") -> dict:
    """``FLOPS_torch.json``'s content: every preset."""
    from contextaware_poseformer_tpu_torch import config

    return {name: count_preset(name, device) for name in config.PRESETS}


def mfu(gflops_per_frame: float, frames_per_s: float,
        dtype: str = "bfloat16") -> float:
    """The share of the card's peak (``PEAK_FLOPS[dtype]``) that
    ``frames_per_s`` frames of ``gflops_per_frame`` each use."""
    return gflops_per_frame * 1e9 * frames_per_s / PEAK_FLOPS[dtype]


def load(path=OUT) -> dict:
    with open(path) as f:
        return json.load(f)


def against_jax(counts: dict, path=REPO / "FLOPS.json") -> dict:
    """Each preset's forward count over the JAX package's ``FLOPS.json``,
    less one. Raises where it is above: XLA's optimized graph counts the
    same ops as this count and recomputes some elementwise ones, so it
    can only count more."""
    theirs = load(path)
    dev = {k: counts[k]["gflops_per_frame"] / theirs[k]["gflops_per_frame"]
           - 1 for k in theirs}
    above = {k: v for k, v in dev.items() if v > 0}
    if above:
        raise AssertionError(f"GFLOP/frame above FLOPS.json by {above}")
    return dev


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="meta",
                   help="where to count (default meta: shapes only)")
    p.add_argument("--no-write", action="store_true",
                   help="print the counts without writing FLOPS_torch.json")
    args = p.parse_args(argv)
    out = count_all(args.device)
    for name, row in out.items():
        fwd = row["gflops_per_frame"]
        print(f"{name}: {row} | 100% MFU: "
              f"{PEAK_FLOPS['bfloat16'] / (fwd * 1e9):,.0f} frames/s bf16, "
              f"{PEAK_FLOPS['float32'] / (fwd * 1e9):,.0f} fp32", flush=True)
    if not args.no_write:
        with open(OUT, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {OUT}")
    return out


if __name__ == "__main__":
    main()
