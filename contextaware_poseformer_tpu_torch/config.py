"""Typed configuration tree: the port's copy of
``contextaware_poseformer_tpu/config.py``.

A frozen dataclass tree with the backbone presets as data, ``deploy`` (the
serving numerics), ``preset_or_deploy`` and a YAML overlay. The copy is
plain: ``preset(name)``, ``deploy(preset(name))`` and ``load_config`` give
the same trees as the JAX package (``tests/test_torch_copies.py``). Knobs
that only the JAX package reads (the int8 serving stack, the TPU layer1
kernel) are kept so that the trees stay equal; the port refuses them where
a model would need them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any, Mapping, Sequence


# ---------------------------------------------------------------------------
# Backbones
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HRNetStageConfig:
    """One HRNet stage (reference: ContextPose/mvn/utils/cfg.py:43-66)."""

    num_modules: int
    num_branches: int
    num_blocks: Sequence[int]
    num_channels: Sequence[int]
    block: str = "BASIC"  # "BASIC" | "BOTTLENECK"


@dataclass(frozen=True)
class BackboneConfig:
    """2D-pose backbone producing 4 multi-scale feature maps.

    kind: "hrnet" (pose_hrnet.py) or "cpn" (networks/network.py).
    For HRNet the returned levels have `feature_dims = (C, 2C, 4C, 8C)` at
    resolutions (64x48, 32x24, 16x12, 8x6); for CPN all four refine maps are
    256ch @ 64x48 (reference conpose.py:16-20, pose_dformer.py:177-180).
    """

    kind: str = "hrnet"
    width: int = 32  # HRNet base channels C (32|48); unused for CPN
    num_joints: int = 17
    frozen: bool = True  # reference: fix_weights=True (human36m.yaml:21)
    # int8 serving stack of the JAX package: "none" | "c128" | "static" |
    # "serve" (the port runs "none", and "serve" for HRNet)
    quantize: str = "none"
    # activation-scale calibration statistic of the int8 stack
    calib_quantile: float = 1.0
    # quantize="serve": calibrated static amax for the wide int8 convs
    serve_static_amax: bool = False
    # layer1 under quantize="serve": "xla" (per-conv int8) or "pallas" (the
    # fused chain, K9 in the port)
    layer1_impl: str = "xla"
    # CPN only: hand the lifter the native-resolution pyramid (/32../4)
    # instead of four /4 maps; a measured-accuracy deployment trade, not
    # bit parity with the reference graph
    cpn_native_pyramid: bool = False
    # CPN only, quantize="serve": int8 tensor stream between blocks
    cpn_int8_stream: bool = False
    # CPN only: int8 pyramid maps into the lifter sampler
    cpn_int8_maps: bool = False
    # CPN only, quantize="serve": image normalization folded into the stem
    cpn_fold_normalize: bool = False
    # CPN only: int8 read side of the globalNet top-down stream
    cpn_int8_topdown: bool = False
    # HRNet only: run stage4 with only its first module. Levels 1-3 are
    # already the first stage-4 module's pre-fuse branch outputs (the
    # reference's in-place-mutation quirk, pose_hrnet.py:289-290,501), so
    # only level0 changes: module 0's fused output instead of module 2's.
    # An accuracy-gated deployment trade; default False keeps the reference.
    hrnet_stage4_truncate: bool = False
    # CPN ResNet stage depths (torchvision resnet50 = (3, 4, 6, 3)); only
    # shrunk by tests/accuracy probes — checkpoints require the default.
    cpn_layers: tuple[int, ...] = (3, 4, 6, 3)
    stage2: HRNetStageConfig = HRNetStageConfig(1, 2, (4, 4), (32, 64))
    stage3: HRNetStageConfig = HRNetStageConfig(4, 3, (4, 4, 4), (32, 64, 128))
    stage4: HRNetStageConfig = HRNetStageConfig(
        3, 4, (4, 4, 4, 4), (32, 64, 128, 256)
    )

    @property
    def feature_dims(self) -> tuple[int, ...]:
        if self.kind == "cpn":
            return (256, 256, 256, 256)
        w = self.width
        return (w, 2 * w, 4 * w, 8 * w)

    @property
    def feature_strides(self) -> tuple[int, ...]:
        if self.kind == "cpn":
            if self.cpn_native_pyramid:
                return (32, 16, 8, 4)  # deepest first (refine_fms order)
            return (4, 4, 4, 4)
        return (4, 8, 16, 32)


def _hrnet_stages(width: int) -> dict[str, HRNetStageConfig]:
    c = (width, 2 * width, 4 * width, 8 * width)
    return dict(
        stage2=HRNetStageConfig(1, 2, (4, 4), c[:2]),
        stage3=HRNetStageConfig(4, 3, (4, 4, 4), c[:3]),
        stage4=HRNetStageConfig(3, 4, (4, 4, 4, 4), c),
    )


# ---------------------------------------------------------------------------
# Lifting network
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LifterConfig:
    """PoseTransformer lifting net (reference pose_dformer.py:144-208).

    `embed_dim_ratio` is the per-level token dim; the joint-token dim is
    `embed_dim_ratio * (levels + 1)`. `use_deformable=False` selects the
    MPI-INF-3DHP variant which skips the deformable context blocks
    (ContextPose_mpi/model/pose_dformer.py:174-261).
    """

    num_joints: int = 17
    in_chans: int = 2
    embed_dim_ratio: int = 128
    levels: int = 4
    depth: int = 4
    num_heads: int = 8
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.2
    use_deformable: bool = True
    deform_heads: int = 4  # reference pose_dformer.py:202
    deform_samples: int = 4
    # feature sampling: "gather" (the plain version), "fused" (the kernel),
    # "auto" (the kernel for CUDA tensors, the plain version on the CPU)
    sampler: str = "auto"
    # matrix-unit precision of the JAX package's fused sampler; the CUDA
    # sampler always blends in fp32
    sampler_precision: str = "highest"
    # lifter compute dtype ("float32" for parity/training; "bfloat16" for
    # deployment). Params, softmax and the output head stay float32.
    compute_dtype: str = "float32"
    # LayerNorm statistics dtype of the transformer blocks
    ln_dtype: str = "float32"
    # res-block (level-axis, 5-token) attention: "einsum" or "fused"
    attention: str = "einsum"
    # joint-block (17-token) attention: "einsum" or "grouped"
    attention_joint: str = "einsum"
    # block MLP: "einsum" or "fused" (one LN+MLP+residual kernel)
    mlp: str = "einsum"
    # DeformableBlock: project each level inside the sampler when C_l >
    # head_dim (exact in border mode: the bilinear weights sum to 1)
    sampler_pre_project: bool = False

    @property
    def embed_dim(self) -> int:
        return self.embed_dim_ratio * (self.levels + 1)


# ---------------------------------------------------------------------------
# Model / data / training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = BackboneConfig()
    lifter: LifterConfig = LifterConfig()
    # (height, width) of the cropped input frame; reference uses 256x192
    # everywhere (cfg.py:19 image_shape [192,256] stored as [W,H]).
    image_shape: tuple[int, int] = (256, 192)
    # backbone compute dtype ("bfloat16" for serving; "float32" for parity)
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "human36m"  # "human36m" | "mpi_inf_3dhp"
    root: str = "data/h36m/images"
    train_labels_path: str = "data/h36m/h36m_train.pkl"
    val_labels_path: str = "data/h36m/h36m_validation.pkl"
    # 3DHP npz paths (ContextPose_mpi/common/load_data_3dhp_mae.py)
    train_npz: str = "data/3dhp/data_train_3dhp.npz"
    test_npz: str = "data/3dhp/data_test_3dhp.npz"
    num_prefetch: int = 2
    num_workers: int = 8
    # packed raw-frame stores (data/frame_store.py); "" = off
    train_frame_store: str = ""
    val_frame_store: str = ""


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 512
    lr: float = 6.4e-4  # human36m.yaml:57 (HRNet); 3.2e-4 for CPN
    lr_decay: float = 0.99  # exponential per-epoch (train.py:410-412)
    weight_decay: float = 0.1  # AdamW (train.py:345)
    n_epochs: int = 60
    flip_aug: bool = True  # random horizontal flip (datasets/utils.py:55-65)
    # occlusion augmentation: erase squares around random joints
    # (config.train.erase + img.py:179-198; off by default like the reference)
    erase_aug: bool = False
    erase_size: int = 70
    erase_joints: int = 2
    flip_test: bool = True  # test-time flip averaging (train.py:170-181)
    seed: int = 0
    loss: str = "MPJPE"
    grad_clip: float = 0.0
    # 3DHP-style step decay: lr *= lr_decay_large every large_decay_epoch
    large_decay_epoch: int = 0
    lr_decay_large: float = 0.5


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes: data = batch sharding; model reserved for sharding
    the lifter's head/level axis."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    name: str = "h36m_hrnet_32"
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()
    logdir: str = "logs"


# ---------------------------------------------------------------------------
# Presets (replacing imperative mutation at train.py:266-277 and
# run_3dhp.py:219-235)
# ---------------------------------------------------------------------------


def hrnet_backbone(width: int) -> BackboneConfig:
    return BackboneConfig(kind="hrnet", width=width, **_hrnet_stages(width))


def cpn_backbone() -> BackboneConfig:
    return BackboneConfig(kind="cpn", width=256)


def preset(name: str) -> Config:
    """Named experiment presets.

    h36m_{hrnet_32,hrnet_48,cpn}: Human3.6M training recipe (CPN-detected 2D,
    deformable context blocks on).
    mpi_3dhp_{hrnet_32,hrnet_48}: MPI-INF-3DHP recipe (GT 2D, no deformable
    blocks, root joint 14, embed_dim_ratio 64/96).
    """
    if name == "h36m_hrnet_32":
        return Config(
            name=name,
            model=ModelConfig(
                backbone=hrnet_backbone(32),
                lifter=LifterConfig(embed_dim_ratio=128),
            ),
        )
    if name == "h36m_hrnet_48":
        return Config(
            name=name,
            model=ModelConfig(
                backbone=hrnet_backbone(48),
                lifter=LifterConfig(embed_dim_ratio=128),
            ),
        )
    if name == "h36m_cpn":
        return Config(
            name=name,
            model=ModelConfig(
                backbone=cpn_backbone(),
                lifter=LifterConfig(embed_dim_ratio=128),
            ),
            train=TrainConfig(batch_size=256, lr=3.2e-4),
        )
    if name in ("mpi_3dhp_hrnet_32", "mpi_3dhp_hrnet_48"):
        width = 32 if name.endswith("32") else 48
        # run_3dhp.py:232 overrides embed_dim_ratio 64 for hrnet_32;
        # common/cfg.py:82 default 96 for hrnet_48.
        ratio = 64 if width == 32 else 96
        return Config(
            name=name,
            model=ModelConfig(
                backbone=hrnet_backbone(width),
                lifter=LifterConfig(embed_dim_ratio=ratio, use_deformable=False),
            ),
            data=DataConfig(dataset="mpi_inf_3dhp"),
            train=TrainConfig(
                batch_size=160,
                lr=7e-4,
                lr_decay=0.97,
                large_decay_epoch=80,
                lr_decay_large=0.5,
                n_epochs=60,
            ),
        )
    raise KeyError(f"unknown preset: {name!r}")


def deploy(cfg: Config) -> Config:
    """Switch a preset to deployment numerics (inference serving): bf16
    backbone and lifter stream, the fused sampler with in-kernel projection,
    fused attention and LN/MLP kernels, and the JAX package's int8 serving
    stack (``quantize="serve"`` and, for CPN, the native pyramid, static
    amax, int8 stream and int8 maps). The port serves it for HRNet
    (``serve.deploy_config``) and, with the int8 stack switched off, for
    every preset (``serve.slice_config``)."""
    is_cpn = cfg.model.backbone.kind == "cpn"
    return replace(
        cfg,
        model=replace(
            cfg.model,
            compute_dtype="bfloat16",
            backbone=replace(
                cfg.model.backbone, quantize="serve", calib_quantile=0.999,
                cpn_native_pyramid=is_cpn,
                serve_static_amax=is_cpn,
                cpn_int8_stream=is_cpn,
                cpn_int8_maps=is_cpn,
            ),
            lifter=replace(
                cfg.model.lifter,
                compute_dtype="bfloat16",
                sampler_precision="default",
                attention="fused",
                attention_joint="grouped",
                mlp="fused",
                sampler_pre_project=True,
            ),
        ),
    )


def preset_or_deploy(name: str) -> Config:
    """preset(name), or deploy(preset(base)) for names ending in '_deploy'."""
    if name.endswith("_deploy"):
        return deploy(preset(name[: -len("_deploy")]))
    return preset(name)


PRESETS = (
    "h36m_hrnet_32",
    "h36m_hrnet_48",
    "h36m_cpn",
    "mpi_3dhp_hrnet_32",
    "mpi_3dhp_hrnet_48",
)


# ---------------------------------------------------------------------------
# YAML overlay (capability parity with update_config, cfg.py:166-181; unknown
# keys raise, matching the reference's update_dict contract)
# ---------------------------------------------------------------------------


def _overlay(obj: Any, updates: Mapping[str, Any]) -> Any:
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot overlay onto non-dataclass {type(obj)}")
    names = {f.name for f in dataclasses.fields(obj)}
    kwargs: dict[str, Any] = {}
    for key, value in updates.items():
        if key not in names:
            raise KeyError(f"{key!r} does not exist in {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            kwargs[key] = _overlay(current, value)
        else:
            kwargs[key] = value
    return replace(obj, **kwargs)


def load_config(path: str, base: Config | None = None) -> Config:
    """Load a YAML experiment file on top of a preset or default Config."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = base
    if cfg is None:
        cfg = preset(raw.pop("preset")) if "preset" in raw else Config()
    else:
        raw.pop("preset", None)
    return _overlay(cfg, raw)
