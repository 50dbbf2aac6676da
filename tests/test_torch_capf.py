"""The port's serving slice end to end, its weight bridge, its import free
of JAX and of the JAX package, and its smoke script's behaviour without a
GPU.

The slice is ``serve.slice_config()`` cut to test size (64x64 frames, CPN
stages (1,1,1,1), lifter embed 32, depth 1) and run from uint8 frames to
(2, 17, 3) in both packages from the same random flax weights. The JAX
side runs its Pallas kernels in interpret mode.
"""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_oracle
from contextaware_poseformer_tpu.config import deploy, preset
from contextaware_poseformer_tpu.data import augment as jaug
from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu.models import convert
from contextaware_poseformer_tpu.models.capf import (
    crop_coords_to_grid as jax_crop_coords_to_grid,
)
from contextaware_poseformer_tpu_torch import serve
from contextaware_poseformer_tpu_torch.data import augment
from contextaware_poseformer_tpu_torch.models.bridge import (
    load_jax_variables,
    variables_from_jax,
)
from contextaware_poseformer_tpu_torch.models.capf import (
    ContextAwarePoseFormer,
    crop_coords_to_grid,
)

REPO = Path(__file__).resolve().parents[1]
HW = (64, 64)
PLAIN_KNOBS = dict(sampler="gather", attention="einsum",
                   attention_joint="einsum", mlp="einsum")


def _small(cfg, dtype):
    """slice_config() at test size, in ``dtype`` (backbone and lifter)."""
    lifter = replace(cfg.model.lifter, embed_dim_ratio=32, depth=1,
                     compute_dtype=dtype)
    if dtype == "float32":
        lifter = replace(lifter, sampler_precision="highest")
    model = replace(
        cfg.model, image_shape=HW, compute_dtype=dtype, lifter=lifter,
        backbone=replace(cfg.model.backbone, cpn_layers=(1, 1, 1, 1)),
    )
    return replace(cfg, model=model)


def _requests(rng, b=2):
    frames = rng.randint(0, 256, (b, *HW, 3)).astype(np.uint8)
    kp = rng.uniform(-1, 1, (b, 17, 2)).astype(np.float32)
    kpc = rng.uniform(0, HW[1], (b, 17, 2)).astype(np.float32)
    return frames, kp, kpc


def _random_variables(model, rng, *args):
    """Flax variables of ``model`` with every leaf drawn from numpy; the tree
    comes from ``jax.eval_shape`` (no init compile). Conv kernels are
    he-scaled, Dense kernels U(+-1/sqrt(fan_in)), scales U(0.5, 1.5), biases
    and ``pos_embed`` N(0, 0.1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name and len(s.shape) == 4:
            v = rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:3]))
        elif "'kernel'" in name:
            v = rng.uniform(-1, 1, s.shape) / np.sqrt(s.shape[0])
        elif "'scale'" in name:
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.randn(*s.shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def flax_variables():
    """Random composite variables of the test-size slice (numpy leaves),
    in the tree of the plain knobs (the same tree as the kernels' knobs)."""
    cfg = _small(serve.slice_config(), "float32").model
    model = JCAPF(cfg=replace(cfg, lifter=replace(cfg.lifter, **PLAIN_KNOBS)))
    rng = np.random.RandomState(0)
    frames, kp, kpc = _requests(rng, 1)
    return _random_variables(model, rng, jnp.zeros((1, *HW, 3)), kp, kpc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_matches_jax(flax_variables, dtype):
    """fp32: max abs error <= 1e-3 x output RMS (measured 3.4e-6).
    bf16 (backbone and lifter): relative RMS <= 3e-2 (measured 1.5e-2; the
    two frameworks round to bf16 at different points)."""
    cfg = _small(serve.slice_config(), dtype)
    jcfg = replace(cfg.model,
                   lifter=replace(cfg.model.lifter, sampler="fused_interpret"))
    jdtype = jnp.dtype(dtype)
    jmodel = JCAPF(cfg=jcfg, dtype=jdtype)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(x, jdtype)
        if x.ndim == 4 and "backbone" in jax.tree_util.keystr(path)
        else jnp.asarray(x), flax_variables)
    frames, kp, kpc = _requests(np.random.RandomState(1))

    @jax.jit
    def jax_lift(p, frames, kp, kpc):
        images = jaug.serving_images(frames, jcfg.backbone, dtype=jdtype)
        return jmodel.apply(p, images, kp, kpc)

    theirs = np.asarray(jax_lift(params, frames, kp, kpc), np.float32)
    model = serve.build_serving_model(cfg, "cpu", variables=flax_variables)
    ours = serve.lift(model, *map(torch.from_numpy, (frames, kp, kpc)))
    assert ours.shape == (2, 17, 3) and ours.dtype == torch.float32
    ours = ours.numpy()
    rms = np.sqrt(np.mean(theirs ** 2))
    if dtype == "float32":
        assert np.abs(ours - theirs).max() <= 1e-3 * rms
    else:
        assert np.sqrt(np.mean((ours - theirs) ** 2)) <= 3e-2 * rms


def _reference_lifter_sd(p, depth, levels):
    """A reference (pose_dformer.py) lifter state dict from flax params: the
    inverse of convert_lifter's mapping."""
    sd = {}

    def lin(name, q):
        sd[f"{name}.weight"] = np.asarray(q["dense"]["kernel"]).T
        sd[f"{name}.bias"] = np.asarray(q["dense"]["bias"])

    def ln(name, q):
        sd[f"{name}.weight"] = np.asarray(q["scale"])
        sd[f"{name}.bias"] = np.asarray(q["bias"])

    lin("coord_embed", p["coord_embed"])
    sd["Spatial_pos_embed"] = np.asarray(p["pos_embed"])
    ln("head.0", p["head_norm"])
    lin("head.1", p["head"])
    for l in range(levels):
        lin(f"feat_embed.{l}", p[f"feat_embed_{l}"])
    for i in range(depth):
        for kind in ("res", "joint"):
            q = p[f"{kind}_block_{i}"]
            name = f"{kind}_blocks.{i}"
            ln(f"{name}.norm1", q["norm1"])
            ln(f"{name}.norm2", q["norm2"])
            lin(f"{name}.attn.qkv", q["attn"]["qkv"])
            lin(f"{name}.attn.proj", q["attn"]["proj"])
            lin(f"{name}.mlp.fc1", q["mlp"]["fc1"])
            lin(f"{name}.mlp.fc2", q["mlp"]["fc2"])
        q = p[f"context_block_{i}"]
        name = f"context_blocks.{i}"
        ln(f"{name}.norm1", q["norm1"])
        ln(f"{name}.norm2", q["norm2"])
        for sub in ("attention_weights", "sampling_offsets"):
            lin(f"{name}.{sub}", q[sub])
        lin(f"{name}.mlp.fc1", q["mlp"]["fc1"])
        lin(f"{name}.mlp.fc2", q["mlp"]["fc2"])
        for l in range(levels):
            lin(f"{name}.embed_proj.{l}", q[f"embed_proj_{l}"])
    return sd


def test_bridge_loads_a_converted_reference_checkpoint(flax_variables):
    """reference torch state dict -> convert.convert_composite -> bridge:
    every leaf lands once, conv kernels return to the checkpoint's OIHW,
    Dense kernels stay (in, out), and the state dict round-trips."""
    rng = np.random.RandomState(2)
    params = flax_variables["params"]
    sd = {f"backbone.{k}": v for k, v in torch_oracle.random_state_dict_for(
        params["backbone"], rng).items()}
    sd.update({f"volume_net.{k}": v
               for k, v in _reference_lifter_sd(params["lifter"], 1, 4).items()})
    tree = {"params": convert.convert_composite(
        sd, params["backbone"], depth=1, levels=4, backbone_kind="cpn")}

    cfg = _small(serve.slice_config(), "float32").model
    model = ContextAwarePoseFormer(cfg)
    load_jax_variables(model, tree)
    state = model.state_dict()
    expected = variables_from_jax(tree)
    assert set(state) == set(expected)
    for key, value in expected.items():
        assert torch.equal(state[key], value), key
    np.testing.assert_array_equal(
        state["backbone.resnet_layer1_0_conv2.weight"].numpy(),
        sd["backbone.resnet.layer1.0.conv2.weight"])
    np.testing.assert_array_equal(
        state["lifter.joint_block_0.attn.qkv.kernel"].numpy(),
        sd["volume_net.joint_blocks.0.attn.qkv.weight"].T)


def test_bridge_accounting_is_strict(flax_variables):
    cfg = _small(serve.slice_config(), "float32").model
    model = ContextAwarePoseFormer(cfg)
    params = flax_variables["params"]
    extra = {"params": {**params, "stray": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(ValueError, match="stray"):
        load_jax_variables(model, extra)
    lifter = dict(params["lifter"])
    del lifter["head"]
    with pytest.raises(ValueError, match="lifter.head"):
        load_jax_variables(model, {"params": {**params, "lifter": lifter}})
    with pytest.raises(ValueError, match="calib"):
        load_jax_variables(model, {**flax_variables, "calib": {}})


def test_slice_config_and_int8_refusal():
    cfg = serve.slice_config()
    b, lif = cfg.model.backbone, cfg.model.lifter
    assert (b.kind, b.quantize, b.cpn_native_pyramid) == ("cpn", "none", True)
    assert not (b.serve_static_amax or b.cpn_int8_stream or b.cpn_int8_maps)
    assert (cfg.model.compute_dtype, lif.compute_dtype) == ("bfloat16",) * 2
    assert (lif.attention, lif.attention_joint, lif.mlp) == (
        "fused", "grouped", "fused")
    assert lif.sampler_pre_project and lif.sampler == "auto"
    # both int8 deploy graphs are ported (tests/test_torch_int8.py,
    # tests/test_torch_cpn_int8.py), and so are the CPN's two serving knobs
    # (tests/test_torch_cpn_knobs.py): each builds
    cpn = ContextAwarePoseFormer(deploy(preset("h36m_cpn")).model,
                                 device="meta")
    assert cpn.backbone.serve and cpn.backbone.stream
    assert cpn.backbone.int8_maps
    assert not (cpn.backbone.fold or cpn.backbone.int8_topdown)
    for knob, flag in (("cpn_fold_normalize", "fold"),
                       ("cpn_int8_topdown", "int8_topdown")):
        model = deploy(preset("h36m_cpn")).model
        model = replace(model, backbone=replace(model.backbone,
                                                **{knob: True}))
        built = ContextAwarePoseFormer(model, device="meta")
        assert getattr(built.backbone, flag), knob
    deployed = ContextAwarePoseFormer(deploy(preset("h36m_hrnet_32")).model,
                                      device="meta")
    assert deployed.backbone.serve
    hrnet = serve.slice_config("h36m_hrnet_32").model
    assert (hrnet.backbone.kind, hrnet.backbone.quantize) == ("hrnet", "none")
    ContextAwarePoseFormer(hrnet, device="meta")


def test_serving_inputs_match_jax():
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (2, 8, 6, 3)).astype(np.uint8)
    cfg = serve.slice_config().model.backbone
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        ours = augment.serving_images(torch.from_numpy(frames), cfg, dtype)
        theirs = jaug.serving_images(jnp.asarray(frames), cfg, jdtype)
        np.testing.assert_array_equal(
            ours.float().numpy(), np.asarray(theirs, np.float32))
    kpc = rng.uniform(0, 192, (2, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(
        crop_coords_to_grid(torch.from_numpy(kpc), (256, 192)).numpy(),
        np.asarray(jax_crop_coords_to_grid(jnp.asarray(kpc), (256, 192))),
        rtol=1e-6, atol=1e-6)


_JAX_FREE = """
import pkgutil, sys, importlib
import torch
import contextaware_poseformer_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from dataclasses import replace
from contextaware_poseformer_tpu_torch import serve
cfg = serve.slice_config()
cfg = replace(cfg, model=replace(
    cfg.model, image_shape=(64, 64),
    backbone=replace(cfg.model.backbone, cpn_layers=(1, 1, 1, 1)),
    lifter=replace(cfg.model.lifter, embed_dim_ratio=32, depth=1)))
model = serve.build_serving_model(cfg, "cpu",
                                  generator=torch.Generator().manual_seed(0))
out = serve.lift(model, torch.zeros(2, 64, 64, 3, dtype=torch.uint8),
                 torch.zeros(2, 17, 2), torch.full((2, 17, 2), 32.0))
assert out.shape == (2, 17, 3) and bool(torch.isfinite(out).all())
# the CPN int8 deploy graph: calibration, int8 stream and maps
dcfg = serve.deploy_config("h36m_cpn")
dcfg = replace(dcfg, model=replace(
    dcfg.model, image_shape=(64, 64),
    backbone=replace(dcfg.model.backbone, cpn_layers=(1, 1, 1, 1)),
    lifter=replace(dcfg.model.lifter, embed_dim_ratio=32, depth=1)))
dmodel = serve.build_serving_model(dcfg, "cpu",
                                   generator=torch.Generator().manual_seed(0))
frames = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(1))
serve.prepare(dmodel, [frames])
out = serve.lift(dmodel, frames, torch.zeros(2, 17, 2),
                 torch.full((2, 17, 2), 32.0))
assert out.shape == (2, 17, 3) and bool(torch.isfinite(out).all())
# the training path: every module, one step and one flip-test batch
train_modules = [
    "contextaware_poseformer_tpu_torch.data.pipeline",
    "contextaware_poseformer_tpu_torch.train.losses",
    "contextaware_poseformer_tpu_torch.train.metrics",
    "contextaware_poseformer_tpu_torch.train.steps",
    "contextaware_poseformer_tpu_torch.train.checkpoint",
    "contextaware_poseformer_tpu_torch.train.loop",
    "contextaware_poseformer_tpu_torch.train.train_h36m",
]
assert all(m in sys.modules for m in train_modules), train_modules
from contextaware_poseformer_tpu_torch.config import preset
from contextaware_poseformer_tpu_torch.data.synthetic import (
    SyntheticPoseDataset,
)
from contextaware_poseformer_tpu_torch.train.loop import Trainer
tcfg = preset("h36m_cpn")
tcfg = replace(tcfg, model=replace(
    tcfg.model, image_shape=(64, 64),
    backbone=replace(tcfg.model.backbone, cpn_layers=(1, 1, 1, 1)),
    lifter=replace(tcfg.model.lifter, embed_dim_ratio=32, depth=1)),
    train=replace(tcfg.train, batch_size=2),
    data=replace(tcfg.data, num_workers=1))
ds = SyntheticPoseDataset(size=4, image_shape=(64, 64))
trainer = Trainer(tcfg, ds, ds, "cpu")
state = trainer.init_state(0)
m = trainer.train_epoch(state, 0, max_steps=1)
summary, _ = trainer.evaluate(state, max_batches=1)
assert state.step == 1 and m["steps"] == 1, m
# one small HRNet request (stage 4 of two modules, one block a branch)
from contextaware_poseformer_tpu_torch.config import HRNetStageConfig as S
hcfg = serve.slice_config("h36m_hrnet_32")
hcfg = replace(hcfg, model=replace(
    hcfg.model, image_shape=(64, 64),
    backbone=replace(hcfg.model.backbone, width=8,
                     stage2=S(1, 2, (1, 1), (8, 16)),
                     stage3=S(1, 3, (1, 1, 1), (8, 16, 32)),
                     stage4=S(2, 4, (1, 1, 1, 1), (8, 16, 32, 64))),
    lifter=replace(hcfg.model.lifter, embed_dim_ratio=32, depth=1)))
hmodel = serve.build_serving_model(hcfg, "cpu",
                                   generator=torch.Generator().manual_seed(0))
out = serve.lift(hmodel, torch.zeros(2, 64, 64, 3, dtype=torch.uint8),
                 torch.zeros(2, 17, 2), torch.full((2, 17, 2), 32.0))
assert out.shape == (2, 17, 3) and bool(torch.isfinite(out).all())
# the same small HRNet as a "static" serve, prepared, and through the
# streaming lifter (its weights as JAX-format variables)
from contextaware_poseformer_tpu_torch.models import bridge, streaming
scfg = replace(hcfg.model, backbone=replace(hcfg.model.backbone,
                                            quantize="static"))
smodel = serve.build_model(scfg, torch.float32, "cpu",
                           generator=torch.Generator().manual_seed(0))
serve.prepare(smodel, [frames])
out = serve.lift(smodel, frames, torch.zeros(2, 17, 2),
                 torch.full((2, 17, 2), 32.0))
assert out.shape == (2, 17, 3) and bool(torch.isfinite(out).all())
import numpy as np
lifter = streaming.StreamingLifter(
    scfg, bridge.variables_to_jax(hmodel),
    streaming.StreamingConfig(batch_size=2, use_bf16=False), device="cpu")
rng = np.random.RandomState(0)
args = (rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8),
        rng.uniform(100, 900, (3, 17, 2)), (1000, 1000),
        np.full((3, 2), 500.0), np.full((3, 2), 1.0))
lifter.prepare(*args)
poses = lifter.lift_batch(*args)
assert poses.shape == (3, 17, 3) and np.isfinite(poses).all()
# the COCO detector: one train step and one flip-test batch of the tiny
# model; the data-parallel modules (their import above)
from contextaware_poseformer_tpu_torch.train import train_coco
assert "contextaware_poseformer_tpu_torch.parallel.dryrun" in sys.modules
out = train_coco.main(["--synthetic", "--tiny", "--device", "cpu",
                       "--epochs", "1", "--steps-per-epoch", "1",
                       "--batch", "2"])
maps = train_coco.eval_step(out["model"], torch.zeros(1, 64, 64, 3), True)
assert maps.shape == (1, 16, 16, 17) and bool(torch.isfinite(maps).all())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax")
             or m == "contextaware_poseformer_tpu"
             or m.startswith("contextaware_poseformer_tpu."))
assert not bad, bad
print("port ok")
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_FREE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "port ok" in proc.stdout


def test_chip_smoke_fails_without_a_gpu():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
