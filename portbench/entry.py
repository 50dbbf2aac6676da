"""The program's side of a configuration: its configuration object, built
by the public entry that the configuration file names, with the file's
sizes written into it, and the model built from the benchmark's weights.

The program is imported here, inside functions, never at import time: the
harness checks the modules a run loaded.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

# configuration file key -> the program's LifterConfig field
LIFTER_KEYS = ("num_joints", "in_chans", "embed_dim_ratio", "levels",
               "depth", "num_heads", "mlp_ratio", "deform_heads",
               "deform_samples", "use_deformable", "drop_path_rate")


def program_config(cfg):
    """The program's ``Config`` of configuration file ``cfg``."""
    entry = cfg["entry"]
    pc = getattr(importlib.import_module(entry["module"]),
                 entry["build"])(entry["preset"])
    bb, lf = cfg["backbone"], cfg["lifter"]
    if bb["kind"] == "cpn":
        backbone = dataclasses.replace(
            pc.model.backbone, cpn_layers=tuple(bb["resnet_layers"]),
            cpn_native_pyramid=bool(bb["native_pyramid"]))
    else:
        stages = {n: dataclasses.replace(
            getattr(pc.model.backbone, n), **stage_fields(bb[n]))
            for n in ("stage2", "stage3", "stage4")}
        backbone = dataclasses.replace(pc.model.backbone, **stages)
    lifter = dataclasses.replace(pc.model.lifter,
                                 **{k: lf[k] for k in LIFTER_KEYS})
    model = dataclasses.replace(pc.model, backbone=backbone, lifter=lifter,
                                image_shape=tuple(cfg["image_shape"]))
    return dataclasses.replace(pc, model=model)


def stage_fields(stage) -> dict:
    """An HRNet stage of the configuration file as the program's
    ``HRNetStageConfig`` fields."""
    return {"num_modules": stage["modules"],
            "num_branches": stage["branches"],
            "num_blocks": tuple(stage["blocks"]),
            "num_channels": tuple(stage["channels"])}


def load_weights(model, params) -> None:
    """Copy the benchmark's weights into ``model`` in place (each tensor
    keeps the program's dtype and layout); every parameter must be named."""
    missing, unexpected = model.load_state_dict(params, strict=False)
    names = {n for n, _ in model.named_parameters()}
    if unexpected or names & set(missing):
        raise ValueError(f"weights do not fit the program's model: missing "
                         f"{sorted(names & set(missing))[:5]}, unexpected "
                         f"{sorted(unexpected)[:5]}")


def serving_model(pc, params, device):
    """The program's inference-ready model of ``pc`` with the benchmark's
    weights, as ``serve.build_serving_model`` builds it but without its
    own initialization, which the weights replace."""
    from contextaware_poseformer_tpu_torch import serve
    from contextaware_poseformer_tpu_torch.models.backbone_common import (
        to_storage,
    )
    from contextaware_poseformer_tpu_torch.models.capf import (
        ContextAwarePoseFormer,
    )

    serve.configure_numerics()
    dtype = getattr(torch, pc.model.compute_dtype)
    model = ContextAwarePoseFormer(pc.model, dtype=dtype, device=device)
    to_storage(model.backbone, dtype)
    load_weights(model, params)
    return model.eval().requires_grad_(False)
