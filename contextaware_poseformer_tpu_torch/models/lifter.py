"""PoseLifter: the context-aware lifting transformer.

Port of ``contextaware_poseformer_tpu/models/lifter.py:42-332``. Token layout
per joint: 1 coordinate token + one token per feature level, each of width
``embed_dim_ratio``:

  coord embed + per-level reference-point sampling (zeros padding)
  -> deformable context blocks (border padding, optional)
  -> res blocks over the level axis (5 tokens)
  -> joint blocks over the joint axis (17 tokens, width 5 * ratio)
  -> LayerNorm (fp32, eps 1e-5) + Linear head -> (b, joints, 3)

Training: ``forward(..., deterministic=False, generator=g)`` turns on the
token dropout after the position embedding and the stochastic depth of every
block, ``linspace(0, drop_path_rate, depth)`` per block kind
(``lifter.py:244-326``); ``g`` is a ``torch.Generator`` on the maps' device.

Feature maps are NHWC; int8 maps (the CPN deploy graph's
``cpn_int8_maps``) come with one dequant scale a level, which the lifter
folds into its sampling consumers (``lifter.py:160-181, 256-262``). Under a
bf16 ``compute_dtype`` the residual stream,
``coord_embed``, ``feat_embed_*``, ``embed_proj_*``, qkv/proj and fc1/fc2
compute in bf16; ``attention_weights``, ``sampling_offsets`` and ``head``
have no dtype and compute in fp32, as do the LayerNorm outputs and the
deformable softmax. ``sampler_precision`` is a TPU matrix-unit setting: the
CUDA sampler always blends in fp32.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from contextaware_poseformer_tpu_torch.config import LifterConfig
from contextaware_poseformer_tpu_torch.models import init
from contextaware_poseformer_tpu_torch.models.layers import (
    Block,
    Dropout,
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    _dtype,
    apply_ln_mlp_residual,
)
from contextaware_poseformer_tpu_torch.ops.deformable import (
    kernel_can_preproject,
    sample_points_levels,
)


def _offset_bias_init(num_heads: int, num_samples: int) -> np.ndarray:
    """Radial sampling-offset bias (pose_dformer.py:103-111): head h points
    in direction 2*pi*h/num_heads, normalized to unit Linf, scaled
    0.01*(s+1). Flat (nh * ns * 2,) float32."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)  # (nh, 2)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = 0.01 * np.tile(grid[:, None, :], (1, num_samples, 1))
    grid = grid * (np.arange(num_samples, dtype=np.float64) + 1.0)[None, :, None]
    return grid.reshape(-1).astype(np.float32)


def _dequant(samples: torch.Tensor, scale) -> torch.Tensor:
    """Raw samples of an int8 map times its dequant scale, in the samples'
    dtype (no-op without a scale)."""
    return samples if scale is None else samples * scale.to(samples.dtype)


class DeformableBlock(nn.Module):
    """Deformable context extraction (pose_dformer.py:82-141).

    For each joint, level and head: softmax weights and tanh offsets over
    ``num_samples`` samples from the level token; the level's map is sampled
    at ref + offset (border padding), each sample projected to head_dim by
    the level's ``embed_proj``, and the weighted sum added to the residual;
    then LN + MLP. The coordinate token x0 is left out of the update but
    added into the norm input. LayerNorm eps is 1e-5 (torch's default: the
    reference builds this block without the 1e-6 partial).

    ``pre_project``: run ``embed_proj`` inside the sampler for the levels
    where ``kernel_can_preproject`` holds (exact in border mode). The fused
    MLP (K2) is taken only while drop-path is inactive."""

    def __init__(self, dim: int, feature_dims: Sequence[int],
                 num_heads: int = 4, num_samples: int = 4,
                 mlp_ratio: float = 2.0, sampler_impl: str = "auto",
                 dtype=None, ln_dtype=torch.float32,
                 mlp_impl: str = "einsum", pre_project: bool = False,
                 drop_path: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_samples = num_samples
        self.sampler_impl = sampler_impl
        self.mlp_impl = mlp_impl
        self.pre_project = pre_project
        nh, ns = num_heads, num_samples
        head_dim = dim // nh
        self.norm1 = LayerNorm(dim, 1e-5, ln_dtype, device=device)
        self.attention_weights = Linear(dim, nh * ns, zero_init=True,
                                        device=device)
        self.sampling_offsets = Linear(
            dim, 2 * nh * ns, zero_init=True,
            bias_values=_offset_bias_init(nh, ns), device=device)
        self.levels = len(feature_dims)
        for l, c in enumerate(feature_dims):
            self.add_module(f"embed_proj_{l}",
                            Linear(c, head_dim, dtype=dtype, device=device))
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, 1e-5, ln_dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype, device=device)
        self.drop_path2 = DropPath(drop_path)

    def embed_proj(self, l: int) -> Linear:
        return getattr(self, f"embed_proj_{l}")

    def sampling(self, tokens: torch.Tensor, ref: torch.Tensor):
        """The attention weights (b, L, p, nh, ns), softmaxed, and the
        sampling points in the packed layout (b, L, p, 2 * nh * ns), rows
        (sample, xy), of ``tokens`` (b, L + 1, p, dim) around ``ref``."""
        b, lp1, p, _ = tokens.shape
        levels = lp1 - 1
        nh, ns = self.num_heads, self.num_samples
        h = self.norm1(tokens[:, 1:] + tokens[:, :1])
        weights = torch.softmax(
            self.attention_weights(h).reshape(b, levels, p, nh, ns), dim=-1)
        offsets = self.sampling_offsets(h)  # (b, L, p, 2*nh*ns) packed
        # tanh and the ref add in the packed layout
        packed = torch.tanh(offsets) + ref[:, None].repeat(1, levels, 1,
                                                           nh * ns)
        return weights, packed

    def pool(self, features: Sequence[torch.Tensor], pos: torch.Tensor,
             weights: torch.Tensor, feat_scales=None) -> torch.Tensor:
        """The pooled context (b, L, p, dim) of points ``pos`` (b, L, p,
        nh * ns, 2): the sampler (with ``embed_proj`` inside it where
        ``pre_project`` allows), ``embed_proj`` on the other levels, and
        the weighted sum over each head's samples. ``feat_scales``: the
        int8 maps' dequant scales, handed to the sampler with the
        in-sampler projection's kernel, which scales the product before the
        bias (sampling and projecting are linear; the JAX lifter folds the
        scale into the kernel instead), else applied to the raw samples
        (``lifter.py:160-181``)."""
        b, levels, p = weights.shape[:3]
        nh, ns = self.num_heads, self.num_samples
        head_dim = self.embed_proj(0).kernel.shape[1]
        pre = [
            self.pre_project
            and kernel_can_preproject(*features[l].shape[1:], head_dim,
                                      features[l].dtype)
            for l in range(levels)
        ]
        projs = [self.embed_proj(l) for l in range(levels)]
        scales = [None] * levels if feat_scales is None else feat_scales
        raw = sample_points_levels(
            features, pos, padding_mode="border", align_corners=True,
            impl=self.sampler_impl,
            projs=[pr.kernel if pr_on else None
                   for pr, pr_on in zip(projs, pre)],
            biases=[pr.bias if pr_on else None
                    for pr, pr_on in zip(projs, pre)],
            scales=[s if pr_on else None for s, pr_on in zip(scales, pre)],
        )  # level l: (b, p, nh*ns, C_l or head_dim)
        sampled = torch.stack(
            [raw[l] if pre[l] else projs[l](_dequant(raw[l], scales[l]))
             for l in range(levels)],
            dim=1,
        ).reshape(b, levels, p, nh, ns, head_dim)
        pooled = torch.einsum("blphs,blphsd->blphd",
                              weights.to(sampled.dtype), sampled)
        return pooled.reshape(b, levels, p, nh * head_dim)

    def forward(self, tokens: torch.Tensor, ref: torch.Tensor,
                features: Sequence[torch.Tensor], deterministic: bool = True,
                generator=None, feat_scales=None) -> torch.Tensor:
        b, lp1, p, _ = tokens.shape
        x0, x = tokens[:, :1], tokens[:, 1:]
        weights, packed = self.sampling(tokens, ref)
        pos = packed.reshape(b, lp1 - 1, p, -1, 2)  # a view: no copy
        pooled = self.pool(features, pos, weights, feat_scales).to(x.dtype)
        x = x + self.drop_path1(pooled, deterministic, generator)
        if self.mlp_impl == "fused" and not self.drop_path2.active(
                deterministic):
            x = apply_ln_mlp_residual(x, self.norm2, self.mlp)
        else:
            h = self.mlp(self.norm2(x), deterministic, generator)
            x = x + self.drop_path2(h, deterministic, generator)
        return torch.cat([x0, x], dim=1)


class PoseLifter(nn.Module):
    """The lifting net. ``cfg.use_deformable`` selects the H36M (True) or
    3DHP (False) variant; ``feature_dims`` are the backbone's per-level
    channels. Parameter names follow the flax tree (``models/bridge.py``)."""

    def __init__(self, cfg: LifterConfig, feature_dims: Sequence[int],
                 device=None):
        super().__init__()
        if cfg.levels != len(feature_dims):
            raise ValueError(f"{cfg.levels} levels, feature_dims "
                             f"{feature_dims}")
        self.cfg = cfg
        d = cfg.embed_dim_ratio
        levels = cfg.levels
        dtype = _dtype(cfg.compute_dtype)
        ln_dtype = getattr(torch, cfg.ln_dtype)
        self.coord_embed = Linear(cfg.in_chans, d, dtype=dtype, device=device)
        for l, c in enumerate(feature_dims):
            self.add_module(f"feat_embed_{l}",
                            Linear(c, d, dtype=dtype, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, levels + 1, cfg.num_joints, d, device=device))
        self.pos_drop = Dropout(cfg.drop_rate)
        # stochastic depth 0 -> drop_path_rate over each kind's blocks
        # (pose_dformer.py:187)
        dpr = [float(r) for r in
               np.linspace(0.0, cfg.drop_path_rate, cfg.depth)]
        for i in range(cfg.depth if cfg.use_deformable else 0):
            self.add_module(f"context_block_{i}", DeformableBlock(
                d, feature_dims, num_heads=cfg.deform_heads,
                num_samples=cfg.deform_samples, mlp_ratio=cfg.mlp_ratio,
                sampler_impl=cfg.sampler, dtype=dtype, ln_dtype=ln_dtype,
                mlp_impl=cfg.mlp, pre_project=cfg.sampler_pre_project,
                drop_path=dpr[i], device=device,
            ))
        for kind, dim, impl in (
            ("res", d, cfg.attention),
            ("joint", d * (levels + 1), cfg.attention_joint),
        ):
            for i in range(cfg.depth):
                self.add_module(f"{kind}_block_{i}", Block(
                    dim, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                    dtype=dtype, ln_dtype=ln_dtype, attn_impl=impl,
                    mlp_impl=cfg.mlp, drop_rate=cfg.drop_rate,
                    attn_drop_rate=cfg.attn_drop_rate, drop_path=dpr[i],
                    device=device,
                ))
        self.head_norm = LayerNorm(d * (levels + 1), 1e-5, torch.float32,
                                   device=device)
        self.head = Linear(d * (levels + 1), 3, device=device)

    def reset_parameters(self, generator) -> None:
        del generator
        init.zeros_(self.pos_embed)

    def _blocks(self, kind: str):
        n = self.cfg.depth
        if kind == "context" and not self.cfg.use_deformable:
            n = 0
        return [getattr(self, f"{kind}_block_{i}") for i in range(n)]

    def forward(self, keypoints_2d: torch.Tensor, ref: torch.Tensor,
                features: Sequence[torch.Tensor], deterministic: bool = True,
                generator=None, feat_scales=None) -> torch.Tensor:
        """keypoints_2d (b, J, 2) full-frame normalized coords; ref (b, J, 2)
        crop coords in [-1, 1]; features: the backbone's NHWC maps in its
        order, one per ``feature_dims`` entry (HRNet finest first, CPN's
        native pyramid deepest first); int8 maps come with ``feat_scales``,
        one fp32 dequant scale a level.
        ``deterministic=False`` draws dropout and drop-path masks from
        ``generator``."""
        cfg = self.cfg
        b, p, _ = keypoints_2d.shape
        d = cfg.embed_dim_ratio
        levels = cfg.levels
        if len(features) != levels:
            raise ValueError(f"{len(features)} feature maps for {levels} "
                             "levels")
        x = self.coord_embed(keypoints_2d)  # (b, p, d)
        ref_pts = ref[:, None].expand(b, levels, p, 2)
        ref_samples = sample_points_levels(
            features, ref_pts, padding_mode="zeros", align_corners=True,
            impl=cfg.sampler,
        )  # level l: (b, p, C_l)
        if feat_scales is not None:  # the 17-point samples of int8 maps
            ref_samples = [_dequant(r, s)
                           for r, s in zip(ref_samples, feat_scales)]
        tokens = torch.stack(
            [x] + [getattr(self, f"feat_embed_{l}")(ref_samples[l])
                   for l in range(levels)],
            dim=1,
        )  # (b, levels+1, p, d)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        tokens = self.pos_drop(tokens, deterministic, generator)
        for blk in self._blocks("context"):
            tokens = blk(tokens, ref, features, deterministic, generator,
                         feat_scales)
        # per-joint attention over the level axis
        t = tokens.transpose(1, 2).reshape(b * p, levels + 1, d)
        for blk in self._blocks("res"):
            t = blk(t, deterministic, generator)
        # cross-joint attention on the concatenated level tokens
        t = t.reshape(b, p, (levels + 1) * d)
        for blk in self._blocks("joint"):
            t = blk(t, deterministic, generator)
        return self.head(self.head_norm(t))
