"""The context-aware lifting transformer (arXiv:2311.03312), plain, float32.

Per joint one coordinate token and one token per feature level:

  coordinate embed + each level's map sampled at the joint (zeros padding)
  -> deformable context blocks: per level and head, softmax weights and
     tanh offsets of ``samples`` points around the joint, the map sampled
     there (border padding), projected to the head's width, weighted and
     summed into the level token; then LayerNorm + MLP
  -> blocks over the level axis (levels + 1 tokens a joint)
  -> blocks over the joint axis (tokens of width (levels + 1) * ratio)
  -> LayerNorm + linear head -> (b, joints, 3)

Training draws stochastic depth from a ``torch.Generator``: one
``rand((rows, 1, ...))`` a drop-path in the order the blocks run, each
block kind's rates spaced from 0 to ``drop_path_rate``; a rate of 0 draws
nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sample(fmap, points, padding):
    """Bilinear samples of ``fmap`` (N, C, H, W) at ``points`` (N, P, 2), xy
    in [-1, 1] with the corners aligned -> (N, P, C). ``padding``: "zeros"
    (taps outside the map read 0) or "border" (the point is clamped onto
    the map)."""
    n, c, h, w = fmap.shape
    x = (points[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (points[..., 1] + 1.0) * 0.5 * (h - 1)
    if padding == "border":
        zero = x.new_tensor(0.0)
        x = torch.minimum(torch.maximum(x, zero), x.new_tensor(w - 1.0))
        y = torch.minimum(torch.maximum(y, zero), y.new_tensor(h - 1.0))
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    flat = fmap.reshape(n, c, h * w).transpose(1, 2)  # (N, HW, C)

    def tap(yi, xi, weight):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * torch.where(inside, weight, 0.0)[..., None]

    return (tap(y0, x0, (1 - fy) * (1 - fx))
            + tap(y0, x0 + 1, (1 - fy) * fx)
            + tap(y0 + 1, x0, fy * (1 - fx))
            + tap(y0 + 1, x0 + 1, fy * fx))


class Lifter:
    """``params``: the benchmark's state dict (``lifter.*``); ``cfg``: the
    configuration's ``lifter`` section; ``image_hw``: the crop's size."""

    def __init__(self, params, cfg, image_hw, prefix="lifter."):
        self.p = {k[len(prefix):]: v for k, v in params.items()
                  if k.startswith(prefix)}
        self.cfg = cfg
        self.image_hw = tuple(image_hw)
        self.generator = None
        self.rates = [float(r) for r in np.linspace(
            0.0, cfg.get("drop_path_rate", 0.0), cfg["depth"])]

    def linear(self, name, x):
        return x @ self.p[f"{name}.kernel"] + self.p[f"{name}.bias"]

    def norm(self, name, x, eps):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.scale"],
                            self.p[f"{name}.bias"], eps)

    def drop_path(self, x, rate):
        if self.generator is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), device=x.device))

    def mlp(self, name, x):
        return self.linear(f"{name}.fc2", F.gelu(self.linear(f"{name}.fc1",
                                                               x)))

    def attention(self, name, x, heads):
        b, n, d = x.shape
        qkv = self.linear(f"{name}.qkv", x)
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, d // heads)
                   for i in range(3))
        a = torch.einsum("bnhd,bmhd->bhnm", q, k) * (d // heads) ** -0.5
        o = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(a, -1), v)
        return self.linear(f"{name}.proj", o.reshape(b, n, d))

    def block(self, name, x, rate):
        h = self.attention(f"{name}.attn", self.norm(f"{name}.norm1", x, 1e-6),
                           self.cfg["num_heads"])
        x = x + self.drop_path(h, rate)
        h = self.mlp(f"{name}.mlp", self.norm(f"{name}.norm2", x, 1e-6))
        return x + self.drop_path(h, rate)

    def context_block(self, name, tokens, ref, maps, rate):
        b, lp1, p, d = tokens.shape
        levels = lp1 - 1
        nh, ns = self.cfg["deform_heads"], self.cfg["deform_samples"]
        x0, x = tokens[:, :1], tokens[:, 1:]
        h = self.norm(f"{name}.norm1", x + x0, 1e-5)
        weights = torch.softmax(self.linear(f"{name}.attention_weights", h)
                                .reshape(b, levels, p, nh, ns), dim=-1)
        pos = (torch.tanh(self.linear(f"{name}.sampling_offsets", h))
               .reshape(b, levels, p, nh * ns, 2) + ref[:, None, :, None, :])
        pooled = []
        for lvl in range(levels):
            s = sample(maps[lvl], pos[:, lvl].reshape(b, -1, 2), "border")
            s = self.linear(f"{name}.embed_proj_{lvl}", s)
            s = s.reshape(b, p, nh, ns, -1)
            pooled.append(torch.einsum("bphs,bphsd->bphd",
                                       weights[:, lvl], s).reshape(b, p, -1))
        x = x + self.drop_path(torch.stack(pooled, 1), rate)
        hh = self.mlp(f"{name}.mlp", self.norm(f"{name}.norm2", x, 1e-5))
        x = x + self.drop_path(hh, rate)
        return torch.cat([x0, x], 1)

    def __call__(self, kp2d, kp2d_crop, maps, generator=None):
        """kp2d (b, J, 2) full-frame normalized; kp2d_crop (b, J, 2) crop
        pixels; maps: NCHW float maps in the backbone's order ->
        (b, J, 3)."""
        cfg = self.cfg
        self.generator = generator
        h, w = self.image_hw
        half = torch.tensor([w // 2, h // 2], dtype=torch.float32,
                            device=kp2d.device)
        ref = kp2d_crop / half - 1.0
        b, p, _ = kp2d.shape
        levels = len(maps)
        tokens = torch.stack(
            [self.linear("coord_embed", kp2d)]
            + [self.linear(f"feat_embed_{lvl}", sample(maps[lvl], ref,
                                                       "zeros"))
               for lvl in range(levels)], dim=1) + self.p["pos_embed"]
        depth = cfg["depth"]
        if cfg.get("use_deformable", True):
            for i in range(depth):
                tokens = self.context_block(f"context_block_{i}", tokens,
                                            ref, maps, self.rates[i])
        d = tokens.shape[-1]
        t = tokens.transpose(1, 2).reshape(b * p, levels + 1, d)
        for i in range(depth):
            t = self.block(f"res_block_{i}", t, self.rates[i])
        t = t.reshape(b, p, (levels + 1) * d)
        for i in range(depth):
            t = self.block(f"joint_block_{i}", t, self.rates[i])
        return self.linear("head", self.norm("head_norm", t, 1e-5))
