"""Serving entry point of the port: uint8 frames -> (b, 17, 3) 3D joints.

Port of the ``lift`` closure of ``bench.py:197-300`` (the JAX package's
serving graph): in-graph normalization of raw BGR frames, the backbone
(HRNet or CPN), then the PoseLifter.

``slice_config(name)`` is ``deploy(preset(name))`` with the backbone's int8
stack switched off (``quantize="none"``, no static amax, no int8 stream or
maps): the bf16 backbone (for CPN with the native-resolution pyramid) and
the bf16 lifter with the fused sampler, attention and MLP kernels. Every
preset serves: ``h36m_hrnet_32`` (the default model), ``h36m_hrnet_48``,
``h36m_cpn``, ``mpi_3dhp_hrnet_32`` and ``mpi_3dhp_hrnet_48``.

Usage::

    cfg = slice_config("h36m_hrnet_32")
    model = build_serving_model(cfg, "cuda",
                                generator=torch.Generator().manual_seed(0))
    joints = lift(model, frames_u8, kp2d, kp2d_crop)   # (b, 17, 3) fp32
"""

from __future__ import annotations

from dataclasses import replace

import torch

from contextaware_poseformer_tpu_torch.config import Config, deploy, preset
from contextaware_poseformer_tpu_torch.data import augment
from contextaware_poseformer_tpu_torch.models.bridge import load_jax_variables
from contextaware_poseformer_tpu_torch.models.capf import (
    ContextAwarePoseFormer,
)
from contextaware_poseformer_tpu_torch.models.init import init_parameters


def slice_config(name: str = "h36m_cpn") -> Config:
    """The ported serving configuration of preset ``name`` (see the module
    docstring)."""
    cfg = deploy(preset(name))
    backbone = replace(
        cfg.model.backbone, quantize="none", serve_static_amax=False,
        cpn_int8_stream=False, cpn_int8_maps=False,
    )
    return replace(cfg, model=replace(cfg.model, backbone=backbone))


def configure_numerics() -> None:
    """Full fp32 wherever the serving graph computes in fp32: TF32 off for
    both cuDNN convolutions (PyTorch's default is on) and cuBLAS matmuls
    (default off). The JAX reference runs fp32 at full precision too."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_serving_model(cfg: Config, device, generator=None,
                        variables=None) -> ContextAwarePoseFormer:
    """An inference-ready ``ContextAwarePoseFormer`` on ``device``.

    Weights come from ``variables`` (flax variables with numpy leaves, via
    ``models/bridge.py``) or, when there are none, from ``generator`` (a
    seeded CPU ``torch.Generator``, flax initializers). The backbone is
    stored in its compute dtype and in channels-last layout."""
    if variables is None and generator is None:
        raise ValueError("build_serving_model needs variables or a generator")
    configure_numerics()
    dtype = getattr(torch, cfg.model.compute_dtype)
    model = ContextAwarePoseFormer(cfg.model, dtype=dtype, device=device)
    model.backbone.to(dtype=dtype, memory_format=torch.channels_last)
    if variables is not None:
        load_jax_variables(model, variables)
    else:
        init_parameters(model, generator)
    return model.eval().requires_grad_(False)


def lift(model: ContextAwarePoseFormer, frames_u8: torch.Tensor,
         kp2d: torch.Tensor, kp2d_crop: torch.Tensor) -> torch.Tensor:
    """Serve one request: frames (b, H, W, 3) uint8 BGR, kp2d (b, 17, 2)
    full-frame normalized, kp2d_crop (b, 17, 2) crop pixels -> (b, 17, 3)
    fp32 root-relative joints. Inputs move to the model's device."""
    dev = model.lifter.head.kernel.device
    with torch.inference_mode():
        images = augment.serving_images(
            frames_u8.to(dev, non_blocking=True), model.cfg.backbone,
            dtype=model.backbone.dtype,
        )
        return model(images, kp2d.to(dev), kp2d_crop.to(dev))
