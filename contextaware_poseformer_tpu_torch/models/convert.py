"""Torch-checkpoint -> flax-params conversion with frozen-BN folding: the
port's copy of ``contextaware_poseformer_tpu/models/convert.py``. The port
loads the flax-layout tree it gives through ``models/bridge.py``.

Covers the reference's checkpoint families:
- COCO-pretrained HRNet-W32/48 backbones (loaded strict=False because the
  model drops final_layer — train.py:292-296, pose_hrnet.py:362-368);
- COCO-pretrained CPN (ResNet50+globalNet+refineNet; key-renamed strict load,
  train.py:298-302);
- trained CA_PF checkpoints "best_epoch_{backbone}.bin" with `module.`-prefixed
  DDP keys (train.py:307-314) and 3DHP `no_refine_*.pth` state dicts.

BN folding is exact because the backbone always runs eval-mode BN
(train.py:146-148): scale = gamma/sqrt(var+eps), bias = beta - mean*scale.

All converters do strict key accounting: every torch key must be consumed or
explicitly skipped, so a structural mismatch fails loudly instead of silently
producing a half-initialized model.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np

BN_EPS = 1e-5  # torch BatchNorm2d default


def load_torch_state_dict(
    path: str, allow_pickle: bool = False
) -> dict[str, np.ndarray]:
    """Load a .pth/.bin/.tar checkpoint into a flat numpy state dict.

    Defaults to `weights_only=True` (tensors only — arbitrary-pickle
    checkpoints can execute code on load). Legacy checkpoints that pickle
    non-tensor objects need an explicit `allow_pickle=True` opt-in.
    """
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    out = {}
    for k, v in obj.items():
        k = k.removeprefix("module.")
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
    return out


class _Consumer:
    """State-dict view that tracks which keys have been used."""

    def __init__(self, sd: Mapping[str, np.ndarray]):
        self.sd = dict(sd)
        self.used: set[str] = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"missing torch key: {key}")
        self.used.add(key)
        return np.asarray(self.sd[key])

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self, skip_patterns: tuple[str, ...] = ()) -> list[str]:
        rest = []
        for k in self.sd:
            if k in self.used:
                continue
            if any(re.match(p, k) for p in skip_patterns):
                continue
            if k.endswith("num_batches_tracked"):
                continue
            rest.append(k)
        return sorted(rest)


def _bn_name_for_conv(conv_name: str) -> str:
    """Torch name of the BN paired with a conv, by HRNet/CPN convention:
    '...convN' -> '...bnN'; otherwise the next index in the Sequential."""
    head, _, base = conv_name.rpartition(".")
    if base.startswith("conv"):
        return f"{head}.bn{base[4:]}" if head else f"bn{base[4:]}"
    assert base.isdigit(), conv_name
    return f"{head}.{int(base) + 1}" if head else str(int(base) + 1)


def fold_conv_bn(c: _Consumer, conv_name: str) -> dict[str, np.ndarray]:
    """(conv.weight, bn.{weight,bias,mean,var}) -> {kernel HWIO, scale, bias}."""
    w = c.take(f"{conv_name}.weight")  # OIHW
    kernel = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)  # HWIO
    bn = _bn_name_for_conv(conv_name)
    gamma = c.take(f"{bn}.weight").astype(np.float64)
    beta = c.take(f"{bn}.bias").astype(np.float64)
    mean = c.take(f"{bn}.running_mean").astype(np.float64)
    var = c.take(f"{bn}.running_var").astype(np.float64)
    scale = gamma / np.sqrt(var + BN_EPS)
    bias = beta - mean * scale
    out = {
        "kernel": kernel,
        "scale": scale.astype(np.float32),
        "bias": bias.astype(np.float32),
    }
    if c.has(f"{conv_name}.bias"):  # convs in these nets are bias-free, but be safe
        out["bias"] = (out["bias"] + c.take(f"{conv_name}.bias")).astype(np.float32)
    return out


def _linear(c: _Consumer, name: str, use_bias: bool = True) -> dict[str, np.ndarray]:
    out = {"kernel": c.take(f"{name}.weight").T.astype(np.float32)}
    if use_bias:
        out["bias"] = c.take(f"{name}.bias").astype(np.float32)
    return {"dense": out}


def _layer_norm(c: _Consumer, name: str) -> dict[str, np.ndarray]:
    return {
        "scale": c.take(f"{name}.weight").astype(np.float32),
        "bias": c.take(f"{name}.bias").astype(np.float32),
    }


# ---------------------------------------------------------------------------
# HRNet / CPN backbones: our param trees are FLAT {torch_conv_prefix: ConvBN}
# ---------------------------------------------------------------------------


def convert_conv_backbone(
    state_dict: Mapping[str, np.ndarray],
    flax_params: Mapping[str, Any],
    skip_patterns: tuple[str, ...] = (r"final_layer\.",),
    strict: bool = True,
) -> dict[str, Any]:
    """Convert any folded-conv backbone whose flax names are torch prefixes.

    `flax_params` supplies the target structure (e.g. from jax.eval_shape of
    model.init); each top-level entry is a ConvBN named by its torch prefix.
    """
    c = _Consumer(state_dict)
    out: dict[str, Any] = {}
    for name, leaf in flax_params.items():
        folded = fold_conv_bn(c, name)
        for pname, val in folded.items():
            expected = leaf[pname].shape
            if tuple(val.shape) != tuple(expected):
                raise ValueError(
                    f"{name}.{pname}: torch gives {val.shape}, model wants {expected}"
                )
        out[name] = folded
    leftovers = c.unused(skip_patterns)
    if strict and leftovers:
        raise ValueError(f"unconsumed torch keys: {leftovers[:10]}...")
    return out


# ---------------------------------------------------------------------------
# Lifter (PoseTransformer)
# ---------------------------------------------------------------------------


def _block(c: _Consumer, name: str, qkv_bias: bool = True) -> dict[str, Any]:
    return {
        "norm1": _layer_norm(c, f"{name}.norm1"),
        "attn": {
            "qkv": _linear(c, f"{name}.attn.qkv", use_bias=qkv_bias),
            "proj": _linear(c, f"{name}.attn.proj"),
        },
        "norm2": _layer_norm(c, f"{name}.norm2"),
        "mlp": {
            "fc1": _linear(c, f"{name}.mlp.fc1"),
            "fc2": _linear(c, f"{name}.mlp.fc2"),
        },
    }


def convert_lifter(
    state_dict: Mapping[str, np.ndarray],
    depth: int,
    levels: int = 4,
    use_deformable: bool = True,
    prefix: str = "",
    strict: bool = True,
) -> dict[str, Any]:
    """PoseTransformer state dict -> PoseLifter params.

    Key map (reference pose_dformer.py:164-208):
      coord_embed, feat_embed.{l}, Spatial_pos_embed, context_blocks.{i}.*,
      res_blocks.{i}.*, joint_blocks.{i}.*, head.{0,1}.
    """
    if prefix:
        state_dict = {
            k.removeprefix(prefix): v
            for k, v in state_dict.items()
            if k.startswith(prefix)
        }
    c = _Consumer(state_dict)
    out: dict[str, Any] = {
        "coord_embed": _linear(c, "coord_embed"),
        "pos_embed": c.take("Spatial_pos_embed").astype(np.float32),
        "head_norm": _layer_norm(c, "head.0"),
        "head": _linear(c, "head.1"),
    }
    for l in range(levels):
        out[f"feat_embed_{l}"] = _linear(c, f"feat_embed.{l}")
    for i in range(depth):
        out[f"res_block_{i}"] = _block(c, f"res_blocks.{i}")
        out[f"joint_block_{i}"] = _block(c, f"joint_blocks.{i}")
        if use_deformable:
            name = f"context_blocks.{i}"
            out[f"context_block_{i}"] = {
                "norm1": _layer_norm(c, f"{name}.norm1"),
                "norm2": _layer_norm(c, f"{name}.norm2"),
                "attention_weights": _linear(c, f"{name}.attention_weights"),
                "sampling_offsets": _linear(c, f"{name}.sampling_offsets"),
                "mlp": {
                    "fc1": _linear(c, f"{name}.mlp.fc1"),
                    "fc2": _linear(c, f"{name}.mlp.fc2"),
                },
                **{
                    f"embed_proj_{l}": _linear(c, f"{name}.embed_proj.{l}")
                    for l in range(levels)
                },
            }
    leftovers = c.unused()
    if strict and leftovers:
        raise ValueError(f"unconsumed lifter keys: {leftovers[:10]}...")
    return out


BACKBONE_SKIPS = {
    "hrnet": (r"final_layer\.",),
    "cpn": (r"global_net\.predict\.", r"refine_net\.final_predict\."),
}


def _unfold_conv_bn(c: _Consumer, conv_name: str):
    """(conv.weight, sibling BN) -> ConvBNLive {params, batch_stats} pair
    for the live-BN COCO trainer (models/cpn_coco.py) — BN kept UNfolded."""
    w = c.take(f"{conv_name}.weight")  # OIHW
    bn = _bn_name_for_conv(conv_name)
    params = {
        "kernel": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),
        "bn": {
            "scale": c.take(f"{bn}.weight").astype(np.float32),
            "bias": c.take(f"{bn}.bias").astype(np.float32),
        },
    }
    stats = {
        "bn": {
            "mean": c.take(f"{bn}.running_mean").astype(np.float32),
            "var": c.take(f"{bn}.running_var").astype(np.float32),
        }
    }
    return params, stats


def convert_cpn_coco(
    state_dict: Mapping[str, np.ndarray],
    flax_variables: Mapping[str, Any],
    strict: bool = True,
) -> dict[str, Any]:
    """Torch CPN50 COCO checkpoint -> CPNCoco {params, batch_stats}.

    `flax_variables` supplies the target structure (jax.eval_shape of
    CPNCoco.init). Three entry kinds in the flat param tree:
    - ConvBNLive modules ({kernel, bn:{scale,bias}}): conv + sibling torch BN
    - bare head-conv leaves ("....kernel"): bias-free Conv3x3->K
    - standalone BatchNormLive modules ({scale,bias}): the post-upsample BNs
    Every torch key must be consumed (strict) — the COCO checkpoint carries
    exactly this surface (mvn/models/cpn/train.py load path)."""
    c = _Consumer(state_dict)
    out_p: dict[str, Any] = {}
    out_s: dict[str, Any] = {}
    for name, leaf in flax_variables["params"].items():
        if isinstance(leaf, Mapping) and "bn" in leaf:
            out_p[name], out_s[name] = _unfold_conv_bn(c, name)
        elif not isinstance(leaf, Mapping):
            assert name.endswith(".kernel"), name
            torch_name = name[: -len(".kernel")]
            w = c.take(f"{torch_name}.weight")
            out_p[name] = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)
        else:  # standalone BatchNormLive
            out_p[name] = {
                "scale": c.take(f"{name}.weight").astype(np.float32),
                "bias": c.take(f"{name}.bias").astype(np.float32),
            }
            out_s[name] = {
                "mean": c.take(f"{name}.running_mean").astype(np.float32),
                "var": c.take(f"{name}.running_var").astype(np.float32),
            }
    def _shapes(tree):
        if isinstance(tree, Mapping):
            return {k: _shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    for name, leaf in out_p.items():
        want = flax_variables["params"][name]
        if _shapes(leaf) != _shapes(want):
            raise ValueError(
                f"{name}: torch {_shapes(leaf)} != model {_shapes(want)}"
            )
    leftovers = c.unused()
    if strict and leftovers:
        raise ValueError(f"unconsumed torch keys: {leftovers[:10]}...")
    return {"params": out_p, "batch_stats": out_s}


def convert_composite(
    state_dict: Mapping[str, np.ndarray],
    backbone_params: Mapping[str, Any],
    depth: int,
    levels: int = 4,
    use_deformable: bool = True,
    backbone_kind: str = "hrnet",
) -> dict[str, Any]:
    """CA_PF checkpoint {backbone.*, volume_net.*} -> {backbone, lifter}."""
    backbone_sd = {
        k.removeprefix("backbone."): v
        for k, v in state_dict.items()
        if k.startswith("backbone.")
    }
    return {
        "backbone": convert_conv_backbone(
            backbone_sd, backbone_params,
            skip_patterns=BACKBONE_SKIPS[backbone_kind],
        ),
        "lifter": convert_lifter(
            state_dict,
            depth=depth,
            levels=levels,
            use_deformable=use_deformable,
            prefix="volume_net.",
        ),
    }
