"""Bilinear point sampling from NHWC feature maps, plain PyTorch.

Port of ``contextaware_poseformer_tpu/ops/grid_sample.py:37-102``. Torch's
``F.grid_sample`` semantics on a flat point set instead of a 2D grid:

- ``align_corners=True``:  x_pix = (x + 1)/2 * (W - 1)
- ``align_corners=False``: x_pix = ((x + 1) * W - 1)/2
- ``border``: the coordinate is clamped to [0, size-1] before the floor;
- ``zeros``: an out-of-bounds tap contributes zero (its weight is kept, so a
  blend that is partly outside shrinks toward zero).

The blend runs in fp32 and rounds once to the map's dtype. An int8 map's
samples are raw quantized numbers and stay float32, as the JAX gather's
(``grid_sample.py:58-63``); the caller owns the dequant scale.

Gradients follow ``jax.grad`` of the JAX version: the border clamp is a
min of a max, whose gradient at an exact edge is the 0.5 tie of
``jnp.clip`` (``Tensor.clamp`` would give 1 there).
"""

from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _clip(v: torch.Tensor, top: float) -> torch.Tensor:
    """``jnp.clip(v, 0, top)`` with its gradient: 0.5 at an exact edge."""
    return torch.minimum(torch.maximum(v, v.new_tensor(0.0)),
                         v.new_tensor(float(top)))


def sample_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the gather's samples of a map of ``dtype``: the map's
    own, float32 for int8."""
    return torch.float32 if dtype == torch.int8 else dtype


def grid_sample_points(
    features: torch.Tensor,
    points: torch.Tensor,
    *,
    padding_mode: str = "zeros",
    align_corners: bool = True,
) -> torch.Tensor:
    """Sample ``features`` (N, H, W, C) at ``points`` (N, ..., 2), xy in
    [-1, 1] (x indexes W, y indexes H). Returns (N, ..., C) in
    ``sample_dtype(features.dtype)``."""
    return sample_points_fp32(
        features, points, padding_mode=padding_mode,
        align_corners=align_corners,
    ).to(sample_dtype(features.dtype))


def sample_points_fp32(
    features: torch.Tensor,
    points: torch.Tensor,
    *,
    padding_mode: str = "zeros",
    align_corners: bool = True,
) -> torch.Tensor:
    """``grid_sample_points`` before the final rounding: fp32 samples."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode!r}")
    n, h, w, c = features.shape
    batch_shape = points.shape[:-1]
    pts = points.reshape(n, -1, 2).float()
    x = _unnormalize(pts[..., 0], w, align_corners)
    y = _unnormalize(pts[..., 1], h, align_corners)
    if padding_mode == "border":
        x = _clip(x, w - 1)
        y = _clip(y, h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = features.reshape(n, h * w, c)

    def corner(yi, xi, weight):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # (n, p)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals.float() * torch.where(inside, weight, 0.0)[..., None]

    out = (
        corner(y0i, x0i, (1 - wy) * (1 - wx))
        + corner(y0i, x0i + 1, (1 - wy) * wx)
        + corner(y0i + 1, x0i, wy * (1 - wx))
        + corner(y0i + 1, x0i + 1, wy * wx)
    )
    return out.reshape(*batch_shape, c)
