"""Checkpoint loading in the port against the JAX package, on the CPU:
``bridge.variables_to_jax`` (the port's model as a flax-layout tree, the
shapes tree ``convert`` takes) and the CLIs' ``--backbone-ckpt`` and
``--model-ckpt`` on synthetic reference-style torch state dicts (no
checkpoint is downloaded). Tolerance of a loaded model's output against the
JAX package's for the same state dict: max abs error <= 1e-3 of the JAX
output's RMS (fp32)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_oracle
from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu.models import convert as jconvert
from contextaware_poseformer_tpu.train import train_h36m as jtrain_h36m
from contextaware_poseformer_tpu_torch import deploy_numerics
from contextaware_poseformer_tpu_torch.models import bridge
from contextaware_poseformer_tpu_torch.models.capf import (
    ContextAwarePoseFormer,
)
from contextaware_poseformer_tpu_torch.train import train_h36m
from test_convert import _torch_sd_from_flax

REPO = Path(__file__).resolve().parents[1]
HW = (64, 64)


def jax_tiny_cfg(name):
    """``_tiny_cfg`` of the JAX package's gate (``tools/`` is not a
    package: loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "jax_deploy_numerics", REPO / "tools" / "deploy_numerics.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._tiny_cfg(name)


def _shapes(model_cfg):
    x = (jnp.zeros((1, *model_cfg.image_shape, 3)), jnp.zeros((1, 17, 2)),
         jnp.zeros((1, 17, 2)))
    return jax.eval_shape(JCAPF(cfg=model_cfg).init, jax.random.PRNGKey(0),
                          *x)["params"]


def _random_tree(shapes, rng):
    return jax.tree.map(
        lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32), shapes)


def _equal_trees(a, b, path=()):
    assert sorted(a) == sorted(b), (path, sorted(set(a) ^ set(b))[:5])
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k], path + (k,))
        else:
            assert a[k].dtype == np.float32, path + (k,)
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(path + (k,)))


@pytest.mark.parametrize("name", jconfig.PRESETS)
def test_variables_to_jax_round_trips(name):
    """Every preset's structure at the gate's tiny size: the port's model
    loaded from a random flax tree gives that tree back exactly (every
    path, with the backbone convs' dotted flax names and the ``dense``
    levels, every value), and ``variables_from_jax`` of it is the model's
    own state dict."""
    cfg = deploy_numerics._tiny_cfg(name)
    params = _random_tree(_shapes(jax_tiny_cfg(name).model),
                          np.random.RandomState(0))
    model = ContextAwarePoseFormer(cfg.model)
    bridge.load_jax_variables(model, {"params": params})
    back = bridge.variables_to_jax(model)
    assert list(back) == ["params"]
    _equal_trees(back["params"], jax.tree.map(np.asarray, params))
    sd = model.state_dict()
    again = bridge.variables_from_jax(back)
    assert again.keys() == {k for k in sd if not k.endswith(
        ("_amax", ".amax", "kernel_q", "wscale", "serving_fingerprint"))}
    for k, v in again.items():
        assert torch.equal(v, sd[k]), k


_CPN_OVERLAY = """
model: {image_shape: [64, 64], backbone: {cpn_layers: [1, 1, 1, 1]},
        lifter: {embed_dim_ratio: 32, depth: 1}}
train: {batch_size: 2}
"""


def _cli_args(tmp_path, name):
    """The CLI arguments of a small model of preset ``name``: HRNet by
    ``--tiny``, the CPN by a ``--config`` overlay."""
    if name == "h36m_cpn":
        path = tmp_path / "small.yaml"
        path.write_text(_CPN_OVERLAY)
        extra = ["--config", str(path)]
    else:
        extra = ["--tiny", "--batch-size", "2"]
    return ["--preset", name, "--synthetic", "--device", "cpu",
            "--eval", "--eval-batches", "1", "--logdir",
            str(tmp_path / "run"), *extra]


def _save(tmp_path, sd):
    """A reference-style checkpoint: DDP ``module.`` keys under
    ``state_dict``."""
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    return str(path)


def _outputs(state, jcfg, params, rng):
    """(port output, JAX output) of the loaded model and the JAX model with
    ``params`` on the same normalized images and keypoints."""
    images = rng.randn(2, *HW, 3).astype(np.float32)
    kpc = rng.uniform(4, HW[1] - 4, (2, 17, 2)).astype(np.float32)
    kp = (kpc / 32 - 1).astype(np.float32)
    with torch.no_grad():
        ours = state.model(*map(torch.from_numpy, (images, kp, kpc))).numpy()
    theirs = np.asarray(jax.jit(JCAPF(cfg=jcfg.model).apply)(
        {"params": params}, images, kp, kpc))
    return ours, theirs


def _jax_config(tmp_path, name):
    args = jtrain_h36m.build_argparser().parse_args(
        [a for a in _cli_args(tmp_path, name) if a not in ("--device", "cpu")])
    return jtrain_h36m.make_config(args)


@pytest.mark.parametrize("name", ["h36m_hrnet_32", "h36m_cpn"])
def test_backbone_ckpt_matches_jax(tmp_path, name):
    """``--backbone-ckpt`` on a synthetic COCO-style backbone state dict
    (conv weights and BN statistics for every conv of the model, plus a
    head the loader skips: HRNet's ``final_layer``, the CPN's predict
    heads): the loaded backbone folds BN as JAX's ``load_backbone`` does,
    stays frozen and channels-last, and the whole model gives the JAX
    model's output with the same backbone and the port's lifter."""
    rng = np.random.RandomState(1)
    jcfg = _jax_config(tmp_path, name)
    flat = _shapes(jcfg.model)["backbone"]
    sd = torch_oracle.random_state_dict_for(flat, rng)
    head = ("final_layer.weight" if name != "h36m_cpn"
            else "global_net.predict.0.conv1.weight")
    sd[head] = rng.randn(17, 8, 1, 1).astype(np.float32)
    _, state, _ = train_h36m.main(_cli_args(tmp_path, name)
                                  + ["--backbone-ckpt", _save(tmp_path, sd)])
    conv = next(m for m in state.model.backbone.modules()
                if hasattr(m, "flax_name"))
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    assert not any(p.requires_grad
                   for p in state.model.backbone.parameters())
    params = bridge.variables_to_jax(state.model)["params"]
    params["backbone"] = jconvert.convert_conv_backbone(
        sd, flat, skip_patterns=jconvert.BACKBONE_SKIPS[
            jcfg.model.backbone.kind])
    ours, theirs = _outputs(state, jcfg, params, rng)
    assert ours.shape == theirs.shape == (2, 17, 3)
    assert np.abs(ours - theirs).max() <= 1e-3 * np.sqrt(np.mean(theirs ** 2))


def test_model_ckpt_matches_jax(tmp_path):
    """``--model-ckpt`` on a synthetic trained CA_PF state dict
    (``backbone.*`` convs with BN statistics and HRNet's skipped
    ``final_layer``, ``volume_net.*`` in the reference lifter's names, as
    ``tests/test_convert.py`` builds them) for the ``--tiny`` HRNet: the
    port's model equals JAX's ``convert_composite`` of the same dict."""
    rng = np.random.RandomState(2)
    name = "h36m_hrnet_32"
    jcfg = _jax_config(tmp_path, name)
    shapes = _shapes(jcfg.model)
    flat = shapes["backbone"]
    lc = jcfg.model.lifter
    lifter = jax.tree.map(np.asarray, _random_tree(shapes["lifter"], rng))
    sd = {f"backbone.{k}": v
          for k, v in torch_oracle.random_state_dict_for(flat, rng).items()}
    sd["backbone.final_layer.weight"] = rng.randn(17, 8, 1, 1).astype(
        np.float32)
    sd.update({f"volume_net.{k}": v for k, v in _torch_sd_from_flax(
        lifter, lc.depth, lc.levels, lc.use_deformable).items()})
    _, state, _ = train_h36m.main(_cli_args(tmp_path, name)
                                  + ["--model-ckpt", _save(tmp_path, sd)])
    params = jconvert.convert_composite(
        sd, flat, depth=lc.depth, levels=lc.levels,
        use_deformable=lc.use_deformable, backbone_kind="hrnet")
    ours, theirs = _outputs(state, jcfg, params, rng)
    assert np.abs(ours - theirs).max() <= 1e-3 * np.sqrt(np.mean(theirs ** 2))
