"""Carry the JAX package's flax variables into the port's modules.

The port names its parameters after the flax tree, so the mapping is a rule,
not a table: a flax path ``params/<a>/<b>/.../<leaf>`` becomes the state-dict
key ``<a>.<b>. ... .<leaf>`` with

- the ``dense`` level of every ``Linear`` dropped (flax ``Linear`` wraps an
  ``nn.Dense`` named ``dense``; the port's ``Linear`` holds the parameters);
- dots inside a flax module or variable name (the CPN's torch-prefix names
  such as ``resnet.layer1.0.conv1``, HRNet's ``layer1.in_amax``) turned
  into underscores (``models/cpn.py``, ``models/hrnet.py``);
- a 4-D conv ``kernel`` (HWIO) renamed ``weight`` and transposed to OIHW.

Dense kernels stay (in, out), LayerNorm ``scale``/``bias`` and ``pos_embed``
map as they are. The int8 serving collections of ``quantize="serve"`` land
on the backbone's buffers by the same rule: ``calib`` (a ConvBN's ``amax``
and the blocks' ``*_amax`` scales, ``backbone_common.is_calib_name``) as
they are, ``qweights`` ``kernel_q`` (HWIO int8) as the port's
(O, kh*kw*I) layout and ``wscale`` as it is. ``qmeta`` (the JAX package's
own fingerprint) is not copied: the loaded ``qweights`` must instead equal
what the port's ``prepare_int8_weights`` gives from the loaded parameters,
and the port then stamps its own fingerprint. Accounting is strict, in the
manner of ``contextaware_poseformer_tpu/models/convert.py``'s ``_Consumer``:
every flax leaf must land on a tensor of the same shape and every parameter
(and, for a collection the tree carries, every buffer of it) must be
assigned, otherwise loading raises. A collection the tree does not carry
leaves its buffers at zero: the model then needs ``prepare_serving``.
Reference torch checkpoints reach the port through ``convert.py`` first
(``convert_composite`` gives the flax params tree). ``variables_to_jax``
is the inverse on the parameters and the calibrated scales: the port's
model as a flax-layout ``params`` tree, the shapes tree
``convert.convert_conv_backbone`` takes (a backbone conv keeps its dotted
flax name as ``flax_name``), and its ``calib`` collection.

The COCO detector (``models/cpn_coco.py``) has its own pair,
``cpn_coco_from_jax`` and ``cpn_coco_to_jax``, for the JAX package's flat
``{params, batch_stats}`` tree of ``CPNCoco``.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from contextaware_poseformer_tpu_torch.models.backbone_common import (
    calibration_buffers,
    int8_convs,
    is_calib_name,
    quantize_weight,
    stamp_fingerprint,
)
from contextaware_poseformer_tpu_torch.models.layers import Linear

SERVING = ("calib", "qweights")  # the int8 serving collections
IGNORED = ("qmeta",)  # the JAX package's fingerprint of its own params


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[tuple]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _collection(key: str) -> str:
    """The flax collection a state-dict key of the port belongs to."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf in ("kernel_q", "wscale"):
        return "qweights"
    if is_calib_name(key):
        return "calib"
    if leaf == "serving_fingerprint":
        return "qmeta"
    return "params"


def variables_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax variables (``params`` and optionally ``calib``/``qweights``,
    numpy leaves) -> state dict."""
    extra = sorted(set(tree) - {"params", *SERVING, *IGNORED})
    if extra or "params" not in tree:
        raise ValueError(
            f"expected flax variables with a 'params' collection and "
            f"optionally {SERVING}; got {sorted(tree)}")
    sd: dict[str, torch.Tensor] = {}
    for coll in ("params", *SERVING):
        for path, leaf in _leaves(tree.get(coll, {})):
            arr = np.asarray(leaf)
            if arr.dtype.name == "bfloat16":  # ml_dtypes arrays, bf16 jax
                arr = arr.astype(np.float32)
            parts = [p.replace(".", "_") for p in path if p != "dense"]
            if parts[-1] == "kernel" and arr.ndim == 4:
                parts[-1] = "weight"
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif parts[-1] == "kernel_q":  # HWIO -> (O, kh*kw*I)
                arr = arr.transpose(3, 0, 1, 2).reshape(arr.shape[3], -1)
            key = ".".join(parts)
            if _collection(key) != coll:
                raise ValueError(f"flax {coll} leaf {'/'.join(path)} maps to "
                                 f"{key!r}, which is not a {coll} tensor")
            if key in sd:
                raise ValueError(f"two flax leaves map to {key!r}")
            sd[key] = torch.tensor(arr)  # a copy: flax leaves may be read-only
    return sd


def variables_to_jax(model: nn.Module) -> dict[str, Any]:
    """The parameters of ``model`` as flax variables ``{"params": tree}``
    with numpy fp32 leaves, and its calibrated activation scales, if it has
    any, as ``"calib"``: the inverse of ``variables_from_jax`` on those two
    collections. A ``Linear``'s parameters gain the ``dense`` level, a
    backbone conv takes its flax name (``flax_name``), its 4-D ``weight``
    becomes the HWIO ``kernel`` and its ``amax`` stays ``amax``; a
    backbone's own scales take their flax names (``calib_flax_names``).
    The int8 weights are not carried (``prepare_serving`` makes them from
    the parameters)."""
    tree: dict[str, Any] = {"params": {}, "calib": {}}

    def put(coll, path, leaf, arr):
        node = tree[coll]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.array(arr)  # a contiguous copy (0-dim stays 0-dim)

    def walk(module, path):
        if isinstance(module, Linear):
            path = path + ("dense",)
        for leaf, p in module.named_parameters(recurse=False):
            arr = p.detach().to("cpu", torch.float32).numpy()
            if leaf == "weight" and arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)  # -> HWIO
            put("params", path, leaf, arr)
        names = getattr(module, "calib_flax_names", {})
        for leaf, b in module.named_buffers(recurse=False):
            if is_calib_name(leaf):
                put("calib", path, names.get(leaf, leaf),
                    b.detach().to("cpu", torch.float32).numpy())
        for name, child in module.named_children():
            walk(child, path + (getattr(child, "flax_name", name),))

    walk(model, ())
    if not tree["calib"]:
        del tree["calib"]
    return tree


def load_jax_variables(model: nn.Module, tree: Mapping[str, Any]) -> None:
    """Load flax variables into ``model`` (a ``ContextAwarePoseFormer``,
    ``PoseLifter``, ``CPN`` or ``HRNet``), converting to each tensor's
    dtype, device and memory format. Raises on any leftover, missing or
    misshapen key, and on loaded ``qweights`` that the loaded parameters do
    not give."""
    sd = variables_from_jax(tree)
    own = model.state_dict()
    carried = {"params", *(c for c in SERVING if c in tree)}
    wanted = {k for k in own if _collection(k) in carried}
    missing = sorted(wanted - set(sd))
    unused = sorted(set(sd) - set(own))
    misshapen = sorted(k for k in set(sd) & set(own)
                       if tuple(sd[k].shape) != tuple(own[k].shape))
    empty = [c for c in SERVING if c in tree
             and not any(_collection(k) == c for k in own)]
    if empty:
        raise ValueError(f"flax variables carry {empty}, but "
                         f"{type(model).__name__} holds no int8 serving "
                         "state (quantize='none')")
    if missing or unused or misshapen:
        raise ValueError(
            f"flax variables do not match {type(model).__name__}: "
            f"unassigned tensors {missing[:10]}, unconsumed flax leaves "
            f"{unused[:10]}, shape mismatches {misshapen[:10]}")
    if "qweights" in carried:
        stale = []
        for name, conv in int8_convs(model):
            pre = f"{name}." if name else ""
            kq, ws = quantize_weight(sd[pre + "weight"])
            if not (torch.equal(kq, sd[pre + "kernel_q"])
                    and torch.equal(ws, sd[pre + "wscale"])):
                stale.append(name)
        if stale:
            raise ValueError(
                f"stale qweights: {stale[:5]} do not equal the int8 "
                "kernels of the loaded parameters; re-run the JAX "
                "package's prepare_serving, or load params alone and run "
                "models.capf.prepare_serving")
    full = {k: (sd[k] if k in sd else torch.zeros_like(v))
            for k, v in own.items()}
    model.load_state_dict(full, strict=True)
    if "qweights" not in carried:
        return
    for m in model.modules():
        # a backbone is servable once its collections are loaded: the
        # qweights, and the calib of a mode that calibrates (c128 has none)
        if hasattr(m, "serving_fingerprint") and (
                "calib" in carried or not calibration_buffers(m)):
            stamp_fingerprint(m)


def cpn_coco_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's ``CPNCoco`` variables (its flat ``params`` and
    ``batch_stats`` trees, keyed by dotted torch-prefix names; numpy
    leaves) -> the state dict of the port's ``CPNCoco``. Three kinds of
    entry: a ``ConvBNLive`` (``{kernel, bn: {scale, bias}}``, its running
    statistics under ``batch_stats[name]["bn"]``), a bare head conv
    (``"<name>.kernel"``) and a standalone BN (``{scale, bias}``); kernels
    HWIO -> OIHW, BN scale/bias/mean/var -> weight/bias/running_mean/
    running_var, and ``num_batches_tracked`` (which the JAX tree lacks and
    ``momentum`` makes unused) 0. ``load_state_dict`` (strict) then checks
    that every tensor was given."""
    if sorted(variables) != ["batch_stats", "params"]:
        raise ValueError("expected CPNCoco variables {params, batch_stats}; "
                         f"got {sorted(variables)}")
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def bn(key, p, s):
        sd[f"{key}.weight"] = torch.tensor(np.asarray(p["scale"], np.float32))
        sd[f"{key}.bias"] = torch.tensor(np.asarray(p["bias"], np.float32))
        sd[f"{key}.running_mean"] = torch.tensor(
            np.asarray(s["mean"], np.float32))
        sd[f"{key}.running_var"] = torch.tensor(
            np.asarray(s["var"], np.float32))
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def kernel(key, arr):
        sd[f"{key}.weight"] = torch.tensor(
            np.asarray(arr, np.float32).transpose(3, 2, 0, 1))

    for name, leaf in params.items():
        key = name.replace(".", "_")
        if not isinstance(leaf, Mapping):  # "<name>.kernel": a head conv
            if not name.endswith(".kernel"):
                raise ValueError(f"unexpected CPNCoco leaf {name!r}")
            kernel(key.removesuffix("_kernel"), leaf)
        elif "bn" in leaf:
            kernel(key, leaf["kernel"])
            bn(f"{key}.bn", leaf["bn"], stats[name]["bn"])
        else:
            bn(key, leaf, stats[name])
    unused = sorted(set(stats) - set(params))
    if unused:
        raise ValueError(f"batch_stats without params: {unused[:10]}")
    return sd


def cpn_coco_to_jax(model: nn.Module) -> dict[str, Any]:
    """The inverse of ``cpn_coco_from_jax``: the port's ``CPNCoco`` as the
    JAX package's ``{params, batch_stats}`` tree (numpy fp32 leaves), the
    structure ``convert.convert_cpn_coco`` takes as its target."""
    from contextaware_poseformer_tpu_torch.models.cpn_coco import ConvBNLive

    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    def bn(m):
        return ({"scale": arr(m.weight), "bias": arr(m.bias)},
                {"mean": arr(m.running_mean), "var": arr(m.running_var)})

    for child in model.children():
        name = child.flax_name
        if isinstance(child, ConvBNLive):
            p, s = bn(child.bn)
            params[name] = {"kernel": arr(child.weight).transpose(2, 3, 1, 0),
                            "bn": p}
            stats[name] = {"bn": s}
        elif isinstance(child, nn.Conv2d):
            params[f"{name}.kernel"] = arr(child.weight).transpose(2, 3, 1, 0)
        else:
            params[name], stats[name] = bn(child)
    return {"params": params, "batch_stats": stats}
