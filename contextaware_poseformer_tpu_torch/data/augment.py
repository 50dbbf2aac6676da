"""Serving-input preparation: raw uint8 BGR frames -> normalized RGB.

Port of the CPN branch of ``contextaware_poseformer_tpu/data/augment.py:46-85``
(``normalize_images`` and ``serving_images``). The HRNet normalization and
the training-time augmentation of that module (flip, root-centering, erase)
come with the HRNet and training slices.
"""

from __future__ import annotations

import torch

CPN_PIXEL_MEAN = (122.7717, 115.9465, 102.9801)  # RGB, /255 at use


def normalize_images(images_u8_bgr: torch.Tensor, backbone_kind: str,
                     dtype=torch.float32) -> torch.Tensor:
    """(b, H, W, 3) uint8 BGR -> normalized float RGB in ``dtype``; the
    normalization math runs in fp32."""
    if backbone_kind != "cpn":
        raise NotImplementedError(
            f"{backbone_kind!r} normalization is not ported; only CPN")
    x = images_u8_bgr.flip(-1).float()  # BGR -> RGB
    mean = torch.tensor(CPN_PIXEL_MEAN, device=x.device) / 255.0
    return (x / 255.0 - mean).to(dtype)


def serving_images(images_u8_bgr: torch.Tensor, backbone_cfg,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Model-input images for a serving graph. The JAX package's
    ``cpn_fold_normalize`` (raw frames into an int8 stem) belongs to the
    int8 stack, which is not ported; such a config is refused."""
    if backbone_cfg.kind == "cpn" and backbone_cfg.cpn_fold_normalize:
        raise NotImplementedError("cpn_fold_normalize is not ported")
    return normalize_images(images_u8_bgr, backbone_cfg.kind, dtype=dtype)
