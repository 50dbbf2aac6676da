"""Serving entry point of the port: uint8 frames -> (b, 17, 3) 3D joints.

Port of the ``lift`` closure of ``bench.py:197-300`` (the JAX package's
serving graph): in-graph normalization of raw BGR frames, the backbone
(HRNet or CPN), then the PoseLifter.

Two serving configurations of a preset:

- ``deploy_config(name)``, the int8 deploy graph: ``deploy(preset(name))``.
  For ``h36m_cpn`` (``bench.py``'s default path) the bf16 CPN with the
  calibrated int8 wide convs (``serve_static_amax``), the int8 residual
  stream (``cpn_int8_stream``) and int8 pyramid maps (``cpn_int8_maps``),
  every int8 conv through K10 and the maps through K1's int8 input; for the
  four HRNet presets (``h36m_hrnet_32``, the default model,
  ``h36m_hrnet_48``, ``mpi_3dhp_hrnet_32``, ``mpi_3dhp_hrnet_48``) with
  ``layer1_impl="pallas"``: the bf16 HRNet with the int8 layer1 (K9) and
  int8 wide convs (K10). Either with the bf16 lifter and its fused sampler,
  attention and MLP kernels. It needs ``prepare``/``prepare_serving``
  (calibration and int8 weights) before it serves.
- ``slice_config(name)``, any preset: ``deploy(preset(name))`` with the
  backbone's int8 stack switched off (``quantize="none"``, no static amax,
  no int8 stream or maps): the bf16 backbone (for CPN with the
  native-resolution pyramid) and the same lifter.
- ``quantize_config(name, mode)``: that slice with the backbone's other
  int8 modes, ``"static"`` (a calibrated scale on every 3x3 conv with both
  channel counts >= 16 and on the wide convs, each through K10) or
  ``"c128"`` (the wide convs in dynamic int8), calibrated at the 0.999
  quantile as ``deploy`` sets it. ``"static"`` needs ``prepare``;
  ``"c128"`` serves without it, quantizing its weights each call until
  ``prepare`` stores them.

Usage::

    cfg = deploy_config("h36m_cpn")
    model = build_serving_model(cfg, "cuda",
                                generator=torch.Generator().manual_seed(0))
    prepare(model, [calibration_frames_u8])             # int8 configs only
    joints = lift(model, frames_u8, kp2d, kp2d_crop)    # (b, 17, 3) fp32
"""

from __future__ import annotations

from dataclasses import replace

import torch

from contextaware_poseformer_tpu_torch.config import Config, deploy, preset
from contextaware_poseformer_tpu_torch.data import augment
from contextaware_poseformer_tpu_torch.models.backbone_common import (
    to_storage,
)
from contextaware_poseformer_tpu_torch.models.bridge import load_jax_variables
from contextaware_poseformer_tpu_torch.models.capf import (
    ContextAwarePoseFormer,
    prepare_serving,
)
from contextaware_poseformer_tpu_torch.models.init import init_parameters
from contextaware_poseformer_tpu_torch.utils.profiling import span


CALIB_CHUNK = 16  # frames a calibration pass takes (bench.py's chunks)


def slice_config(name: str = "h36m_cpn") -> Config:
    """The ported serving configuration of preset ``name`` (see the module
    docstring)."""
    cfg = deploy(preset(name))
    backbone = replace(
        cfg.model.backbone, quantize="none", serve_static_amax=False,
        cpn_int8_stream=False, cpn_int8_maps=False,
    )
    return replace(cfg, model=replace(cfg.model, backbone=backbone))


def deploy_config(name: str = "h36m_hrnet_32") -> Config:
    """The int8 deploy graph of preset ``name`` (see the module
    docstring)."""
    return deploy_graph(preset(name))


def quantize_config(name: str, mode: str) -> Config:
    """``slice_config(name)`` with the backbone's ``quantize`` set to
    ``mode`` ("static" or "c128") and ``calib_quantile=0.999``, as
    ``deploy`` calibrates (see the module docstring)."""
    if mode not in ("static", "c128"):
        raise ValueError(f"quantize_config: mode {mode!r} (static or c128)")
    cfg = slice_config(name)
    return replace(cfg, model=replace(cfg.model, backbone=replace(
        cfg.model.backbone, quantize=mode, calib_quantile=0.999)))


def deploy_graph(cfg: Config) -> Config:
    """The int8 deploy graph of any configuration: ``deploy(cfg)``, with an
    HRNet's layer1 through K9 (``layer1_impl="pallas"``)."""
    cfg = deploy(cfg)
    backbone = cfg.model.backbone
    if backbone.kind != "hrnet":
        return cfg
    return replace(cfg, model=replace(cfg.model, backbone=replace(
        backbone, layer1_impl="pallas")))


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
    stored in its compute dtype and in channels-last layout (its int8
    convs keep fp32 parameters). An int8 configuration then needs
    ``prepare`` unless ``variables`` carry its ``calib`` and ``qweights``
    collections."""
    return build_model(cfg.model, getattr(torch, cfg.model.compute_dtype),
                       device, generator, variables)


def build_model(model_cfg, dtype, device, generator=None,
                variables=None) -> ContextAwarePoseFormer:
    """``build_serving_model`` for a ``ModelConfig`` with the backbone's
    compute ``dtype`` given."""
    if variables is None and generator is None:
        raise ValueError("build_serving_model needs variables or a generator")
    configure_numerics()
    model = ContextAwarePoseFormer(model_cfg, dtype=dtype, device=device)
    to_storage(model.backbone, dtype)
    if variables is not None:
        load_jax_variables(model, variables)
    else:
        init_parameters(model, generator)
    return model.eval().requires_grad_(False)


def prepare(model: ContextAwarePoseFormer, frames_batches) -> None:
    """Quantize an int8 model's weights and, for ``quantize="serve"`` and
    ``"static"``, calibrate it (``models.capf.prepare_serving``) on
    batches of uint8 BGR frames
    (b, H, W, 3), normalized as ``lift`` normalizes them, each cut into
    chunks of ``CALIB_CHUNK`` frames as ``bench.py`` calibrates: the
    calibration histogram counts in fp32 as ``jnp.histogram`` does, and a
    bin stops at 2**24, which a larger chunk's zeros reach (the CPN stem
    output, 786,432 values a frame, about half of them ReLU zeros, does at
    43 frames and then yields a scale of max/2048). A no-op for a float
    model."""
    dev = model.lifter.head.kernel.device
    with torch.no_grad():
        batches = [(augment.serving_images(
            f[i:i + CALIB_CHUNK].to(dev), model.cfg.backbone,
            dtype=model.backbone.dtype),)
            for f in frames_batches for i in range(0, len(f), CALIB_CHUNK)]
    prepare_serving(model, None, batches)


def lift(model: ContextAwarePoseFormer, frames_u8: torch.Tensor,
         kp2d: torch.Tensor, kp2d_crop: torch.Tensor) -> torch.Tensor:
    """Serve one request: frames (b, H, W, 3) uint8 BGR, kp2d (b, 17, 2)
    full-frame normalized, kp2d_crop (b, 17, 2) crop pixels -> (b, 17, 3)
    fp32 root-relative joints. Inputs move to the model's device."""
    dev = model.lifter.head.kernel.device
    with torch.inference_mode():
        frames = frames_u8.to(dev, non_blocking=True)
        with span("capf.serve.normalize"):
            images = augment.serving_images(
                frames, model.cfg.backbone, dtype=model.backbone.dtype)
        return model(images, kp2d.to(dev), kp2d_crop.to(dev))
