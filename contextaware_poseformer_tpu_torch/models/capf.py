"""ContextAwarePoseFormer: the composite single-frame 3D pose model.

Port of ``contextaware_poseformer_tpu/models/capf.py:31-153``:
frozen 2D backbone (HRNet or CPN, by ``cfg.backbone.kind``) -> four NHWC
feature maps -> context-aware lifter -> root-relative 3D joints
(b, joints, 3); with ``cpn_int8_maps`` the maps are int8 and the lifter
takes their dequant scales. With ``cfg.backbone.frozen`` (every preset)
the backbone runs under ``torch.no_grad()`` and its maps are detached, the
counterpart of the JAX package's stop-gradient (``capf.py:136-139``): no gradient reaches
the conv stack and none of its activations are kept for a backward.
``prepare_serving`` makes an int8 (``quantize`` "c128", "static" or
"serve") model servable.
"""

from __future__ import annotations

import torch
from torch import nn

from contextaware_poseformer_tpu_torch.config import ModelConfig
from contextaware_poseformer_tpu_torch.models.backbone_common import (
    calibrate_quantization,
    check_calibrated,
    check_serving_fresh,
    prepare_int8_weights,
    stamp_fingerprint,
)
from contextaware_poseformer_tpu_torch.models.cpn import CPN
from contextaware_poseformer_tpu_torch.models.hrnet import HRNet
from contextaware_poseformer_tpu_torch.models.lifter import PoseLifter


def crop_coords_to_grid(kpts_crop: torch.Tensor,
                        image_shape: tuple[int, int]) -> torch.Tensor:
    """Crop-pixel keypoints -> [-1, 1] grid coords (conpose.py:34-35):
    divide by the integer halves (W//2, H//2), then subtract 1."""
    h, w = image_shape
    half = torch.tensor([w // 2, h // 2], dtype=kpts_crop.dtype,
                        device=kpts_crop.device)
    return kpts_crop / half - 1.0


def backbone_maps(out):
    """A backbone's output -> (maps, dequant scales or None): with
    ``cpn_int8_maps`` the CPN hands over ``(int8 maps, scales)``
    (``capf.py:128-135``)."""
    return out if isinstance(out, tuple) else (out, None)


def lifter_maps(features, compute_dtype: str):
    """The maps as the lifter takes them: in its compute dtype (a no-op
    when the bf16 backbone meets a bf16 lifter); int8 maps stay int8, their
    values raw quantized numbers (``capf.py:140-148``)."""
    dtype = getattr(torch, compute_dtype)
    return [f if f.dtype == torch.int8 else f.to(dtype) for f in features]


def prepare_serving(model: "ContextAwarePoseFormer", example_args,
                    batches=None) -> "ContextAwarePoseFormer":
    """Make an int8 model servable, in place: store the int8 kernels of
    every int8 conv from its weights (``prepare_int8_weights``); for
    ``quantize="serve"`` and ``"static"`` also run the calibration pass over
    ``batches`` (tuples whose first item is a batch of normalized images,
    as ``model`` takes them; default ``[example_args]``; use real frames
    for deployment) and check every calibrated scale; then stamp the
    fingerprint of the backbone parameters they were prepared from. Raises
    if the model's int8 state was prepared for other parameters
    (``check_serving_fresh``). A no-op for a float model. Only the backbone
    holds int8 state, so only it runs.

    Port of ``capf.py:43-100``. The JAX package calibrates first and then
    stores the kernels; its calibration pass quantizes the wide convs'
    kernels on the fly to the same values, so the order does not matter."""
    backbone = model.backbone
    quant = model.cfg.backbone.quantize
    if quant == "none":
        return model
    check_serving_fresh(backbone)
    prepare_int8_weights(backbone)
    if quant in ("serve", "static"):
        batches = list(batches) if batches is not None else []
        calibrate_quantization(backbone, batches or [example_args])
        check_calibrated(backbone)
    stamp_fingerprint(backbone)
    return model


class ContextAwarePoseFormer(nn.Module):
    """``dtype`` is the backbone compute dtype (bf16 for serving)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        backbones = {"hrnet": HRNet, "cpn": CPN}
        if cfg.backbone.kind not in backbones:
            raise ValueError(f"unknown backbone kind: {cfg.backbone.kind}")
        self.cfg = cfg
        self.backbone = backbones[cfg.backbone.kind](
            cfg.backbone, dtype=dtype, device=device)
        self.lifter = PoseLifter(cfg.lifter, cfg.backbone.feature_dims,
                                 device=device)

    def forward(self, images: torch.Tensor, keypoints_2d: torch.Tensor,
                keypoints_2d_crop: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        """images (b, H, W, 3) normalized; keypoints_2d (b, J, 2) full-frame
        normalized; keypoints_2d_crop (b, J, 2) crop pixels.
        ``deterministic=False`` (training) draws the lifter's dropout and
        drop-path masks from ``generator``."""
        ref = crop_coords_to_grid(keypoints_2d_crop, self.cfg.image_shape)
        if self.cfg.backbone.frozen:
            with torch.no_grad():
                features, feat_scales = backbone_maps(self.backbone(images))
                features = [f.detach() for f in features]
        else:
            features, feat_scales = backbone_maps(self.backbone(images))
        features = lifter_maps(features, self.cfg.lifter.compute_dtype)
        return self.lifter(keypoints_2d, ref, features, deterministic,
                           generator, feat_scales=feat_scales)
