"""Device-side batch preparation: normalization, root-centering, flip
augmentation, test-time flip and occlusion.

Port of ``contextaware_poseformer_tpu/data/augment.py`` (37-203): ``Batch``,
``normalize_images`` (HRNet: ImageNet mean/std; CPN: pixel mean) and
``serving_images``, ``root_center``, ``flip_batch``, ``train_augment``,
``flip_test_inputs``, ``flip_test_merge``, ``erase_regions`` and
``gamma_correct``.

Every function is shape-preserving and runs on the tensors' device. The
train-time flip is one coin per BATCH, as in the reference, drawn from an
explicit ``torch.Generator`` on that device and applied with ``torch.where``
so that the host never waits for it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CPN_PIXEL_MEAN = (122.7717, 115.9465, 102.9801)  # RGB, /255 at use


class Batch(NamedTuple):
    """One device batch. images are float NHWC; keypoints_3d root-relative."""

    images: torch.Tensor  # (b, H, W, 3)
    keypoints_3d: torch.Tensor  # (b, J, 3)
    keypoints_2d: torch.Tensor  # (b, J, 2) full-frame normalized
    keypoints_2d_crop: torch.Tensor  # (b, J, 2) crop pixels


def normalize_images(images_u8_bgr: torch.Tensor, backbone_kind: str,
                     dtype=torch.float32) -> torch.Tensor:
    """(b, H, W, 3) uint8 BGR -> normalized float RGB in ``dtype``; the
    normalization math runs in fp32."""
    x = images_u8_bgr.flip(-1).float()  # BGR -> RGB
    if backbone_kind == "hrnet":
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        return ((x / 255.0 - mean) / std).to(dtype)
    if backbone_kind == "cpn":
        mean = torch.tensor(CPN_PIXEL_MEAN, device=x.device) / 255.0
        return (x / 255.0 - mean).to(dtype)
    raise ValueError(backbone_kind)


def serving_images(images_u8_bgr: torch.Tensor, backbone_cfg,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Model-input images for a serving graph (``augment.py:68-85``): the
    raw uint8 BGR frames unchanged for a CPN that folds the normalization
    into its stem (``cpn_fold_normalize`` under ``quantize="serve"``: the
    int8 stem K10s reads them), else ``normalize_images`` in ``dtype``."""
    if (backbone_cfg.kind == "cpn" and backbone_cfg.quantize == "serve"
            and backbone_cfg.cpn_fold_normalize):
        return images_u8_bgr
    return normalize_images(images_u8_bgr, backbone_cfg.kind, dtype=dtype)


def root_center(keypoints_3d: torch.Tensor, root_idx: int) -> torch.Tensor:
    """Subtract the root joint and zero it (utils.py:52-53)."""
    out = keypoints_3d - keypoints_3d[..., root_idx:root_idx + 1, :]
    out[..., root_idx, :] = 0.0
    return out


def _perm(flip_perm, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(flip_perm), dtype=torch.long,
                           device=device)


def _negate_x(t: torch.Tensor) -> torch.Tensor:
    sign = torch.ones(t.shape[-1], dtype=t.dtype, device=t.device)
    sign[0] = -1.0
    return t * sign


def flip_batch(images, keypoints_3d, keypoints_2d, keypoints_2d_crop,
               flip_perm, crop_width: int) -> tuple:
    """Horizontal flip of every stream (utils.py:55-65): image width axis
    reversed; x of normalized 2D negated; crop x -> (W - x - 1); 3D x
    negated; left/right joints swapped everywhere."""
    perm = _perm(flip_perm, keypoints_2d.device)
    crop = keypoints_2d_crop.clone()
    crop[..., 0] = crop_width - keypoints_2d_crop[..., 0] - 1.0
    return (images.flip(2), _negate_x(keypoints_3d)[..., perm, :],
            _negate_x(keypoints_2d)[..., perm, :], crop[..., perm, :])


def train_augment(generator: torch.Generator, batch: Batch, flip_perm,
                  crop_width: int) -> Batch:
    """Batch-level random flip with probability 0.5 (utils.py:55: one coin
    per batch), the coin drawn from ``generator`` on the batch's device."""
    do_flip = torch.rand((), generator=generator,
                         device=batch.images.device) < 0.5
    flipped = flip_batch(*batch, flip_perm, crop_width)
    return Batch(*(torch.where(do_flip, f, a)
                   for a, f in zip(batch, flipped)))


def flip_test_inputs(batch: Batch, flip_perm, crop_width: int) -> Batch:
    """The flipped model inputs for flip-test evaluation (utils.py:67-78);
    the 3D ground truth passes through unflipped."""
    images_f, _, kp2d_f, crop_f = flip_batch(*batch, flip_perm, crop_width)
    return Batch(images_f, batch.keypoints_3d, kp2d_f, crop_f)


def flip_test_merge(pred: torch.Tensor, pred_flip: torch.Tensor,
                    flip_perm) -> torch.Tensor:
    """Un-flip the flipped prediction and average (train.py:170-181)."""
    perm = _perm(flip_perm, pred.device)
    return 0.5 * (pred + _negate_x(pred_flip)[..., perm, :])


def erase_regions(images: torch.Tensor, centers: torch.Tensor,
                  size: int = 70, use_mean: bool = True) -> torch.Tensor:
    """Occlusion augmentation (mvn/utils/img.py:179-198): square regions of
    side ``size + 1`` around ``centers`` (b, K, 2) xy pixels are replaced by
    the region's mean (or zero); off-image centers are skipped."""
    b, h, w, _ = images.shape
    ys = torch.arange(h, device=images.device)[None, :, None]
    xs = torch.arange(w, device=images.device)[None, None, :]
    out = images
    half = size // 2
    for k in range(centers.shape[1]):
        cx = torch.floor(centers[:, k, 0]).long()[:, None, None]
        cy = torch.floor(centers[:, k, 1]).long()[:, None, None]
        valid = (cx >= 0) & (cy >= 0) & (cx < w) & (cy < h)
        mask = ((xs >= cx - half) & (xs <= cx + half)
                & (ys >= cy - half) & (ys <= cy + half) & valid)[..., None]
        if use_mean:
            msum = torch.where(mask, out, 0.0).sum(dim=(1, 2), keepdim=True)
            mcount = mask.sum(dim=(1, 2), keepdim=True).clamp(min=1)
            fill = msum / mcount
        else:
            fill = torch.zeros_like(out[:, :1, :1])
        out = torch.where(mask, fill, out)
    return out


def gamma_correct(images: torch.Tensor, gamma) -> torch.Tensor:
    """Gamma transform on [0, 255] or [0, 1] images (img.py:200-206
    gamma_trans, without the uint8 lookup table)."""
    scale = torch.where(images.max() > 2.0, 255.0, 1.0)
    x = (images / scale).clamp(0.0, 1.0)
    return torch.pow(x, gamma) * scale
