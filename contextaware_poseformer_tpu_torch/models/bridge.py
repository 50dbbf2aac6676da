"""Carry the JAX package's flax variables into the port's modules.

The port names its parameters after the flax tree, so the mapping is a rule,
not a table: a flax path ``params/<a>/<b>/.../<leaf>`` becomes the state-dict
key ``<a>.<b>. ... .<leaf>`` with

- the ``dense`` level of every ``Linear`` dropped (flax ``Linear`` wraps an
  ``nn.Dense`` named ``dense``; the port's ``Linear`` holds the parameters);
- dots inside a flax module name (the CPN's torch-prefix names such as
  ``resnet.layer1.0.conv1``) turned into underscores (``models/cpn.py``);
- a 4-D conv ``kernel`` (HWIO) renamed ``weight`` and transposed to OIHW.

Dense kernels stay (in, out), LayerNorm ``scale``/``bias`` and ``pos_embed``
map as they are. Accounting is strict, in the manner of
``contextaware_poseformer_tpu/models/convert.py``'s ``_Consumer``: every
flax leaf must land on a parameter of the same shape and every parameter
must be assigned, otherwise loading raises. Collections other than
``params`` (the int8 ``calib``/``qweights`` state) are not ported and raise.
Reference torch checkpoints reach the port through ``convert.py`` first
(``convert_composite`` gives the flax params tree).
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[tuple]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def variables_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax variables ``{"params": ...}`` with numpy leaves -> state dict."""
    extra = sorted(set(tree) - {"params"})
    if extra or "params" not in tree:
        raise ValueError(
            f"expected flax variables with exactly a 'params' collection; "
            f"got {sorted(tree)} (int8 serving collections are not ported)")
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree["params"]):
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":  # ml_dtypes arrays from bf16 jax
            arr = arr.astype(np.float32)
        parts = [p.replace(".", "_") for p in path if p != "dense"]
        if parts[-1] == "kernel" and arr.ndim == 4:
            parts[-1] = "weight"
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        key = ".".join(parts)
        if key in sd:
            raise ValueError(f"two flax leaves map to {key!r}")
        sd[key] = torch.tensor(arr)  # a copy: flax leaves may be read-only
    return sd


def load_jax_variables(model: nn.Module, tree: Mapping[str, Any]) -> None:
    """Load flax variables into ``model`` (a ``ContextAwarePoseFormer``,
    ``PoseLifter`` or ``CPN``), converting to each parameter's dtype,
    device and memory format. Raises on any leftover, missing or misshapen
    key."""
    sd = variables_from_jax(tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unused = sorted(set(sd) - set(own))
    misshapen = sorted(k for k in set(sd) & set(own)
                       if tuple(sd[k].shape) != tuple(own[k].shape))
    if missing or unused or misshapen:
        raise ValueError(
            f"flax variables do not match {type(model).__name__}: "
            f"unassigned parameters {missing[:10]}, unconsumed flax leaves "
            f"{unused[:10]}, shape mismatches {misshapen[:10]}")
    model.load_state_dict(sd, strict=True)
