"""The port's own copies of the JAX package's framework-neutral modules
(config, skeleton, geometry, synthetic and H36M data) give the same results
bit for bit, and no module of the port, nor ``chip_smoke.py``, imports the
JAX package."""

import ast
import pickle
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.data import h36m as jh36m
from contextaware_poseformer_tpu.data import synthetic as jsynthetic
from contextaware_poseformer_tpu.utils import geometry as jgeometry
from contextaware_poseformer_tpu.utils import skeleton as jskeleton
from contextaware_poseformer_tpu_torch import config
from contextaware_poseformer_tpu_torch.data import h36m, synthetic
from contextaware_poseformer_tpu_torch.utils import geometry, skeleton

REPO = Path(__file__).resolve().parents[1]
JAX_PACKAGE = "contextaware_poseformer_tpu"


@pytest.mark.parametrize("name", jconfig.PRESETS)
def test_presets_and_deploy_equal_the_jax_package(name):
    assert config.PRESETS == jconfig.PRESETS
    assert asdict(config.preset(name)) == asdict(jconfig.preset(name))
    assert asdict(config.deploy(config.preset(name))) == asdict(
        jconfig.deploy(jconfig.preset(name)))
    assert asdict(config.preset_or_deploy(name + "_deploy")) == asdict(
        jconfig.preset_or_deploy(name + "_deploy"))
    ours, theirs = config.preset(name).model, jconfig.preset(name).model
    assert ours.backbone.feature_dims == theirs.backbone.feature_dims
    assert ours.backbone.feature_strides == theirs.backbone.feature_strides
    assert ours.lifter.embed_dim == theirs.lifter.embed_dim


def test_load_config_equals_the_jax_package(tmp_path):
    path = tmp_path / "exp.yaml"
    path.write_text(
        "preset: h36m_hrnet_48\n"
        "model: {image_shape: [128, 96], backbone: {hrnet_stage4_truncate: "
        "true}, lifter: {depth: 2, sampler: gather}}\n"
        "train: {batch_size: 8, lr: 1.0e-4}\n")
    assert asdict(config.load_config(str(path))) == asdict(
        jconfig.load_config(str(path)))
    base = config.deploy(config.preset("h36m_cpn"))
    jbase = jconfig.deploy(jconfig.preset("h36m_cpn"))
    assert asdict(config.load_config(str(path), base=base)) == asdict(
        jconfig.load_config(str(path), base=jbase))
    path.write_text("model: {lifter: {no_such_knob: 1}}\n")
    with pytest.raises(KeyError, match="no_such_knob"):
        config.load_config(str(path))


def test_skeleton_equals_the_jax_package():
    for name in ("NUM_JOINTS", "H36M_ROOT", "MPI3DHP_ROOT",
                 "H36M_JOINTS_LEFT", "H36M_JOINTS_RIGHT",
                 "MPI3DHP_JOINTS_LEFT", "MPI3DHP_JOINTS_RIGHT",
                 "H36M_ACTION_NAMES"):
        assert getattr(skeleton, name) == getattr(jskeleton, name), name
    for name in ("H36M_FLIP_PERM", "MPI3DHP_FLIP_PERM"):
        ours, theirs = getattr(skeleton, name), getattr(jskeleton, name)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("root_idx,num_seqs", [(0, 1), (14, 3)])
def test_synthetic_dataset_equals_the_jax_package(root_idx, num_seqs):
    kw = dict(size=6, image_shape=(32, 24), seed=3, root_idx=root_idx,
              num_seqs=num_seqs)
    ours = synthetic.SyntheticPoseDataset(**kw)
    theirs = jsynthetic.SyntheticPoseDataset(**kw)
    assert ours.shard(1, 2) == theirs.shard(1, 2)
    assert len(ours) == len(theirs) == 3
    assert ours.seq_names == theirs.seq_names
    for name in ("joints_3d", "joints_2d", "joints_2d_crop", "action_idx",
                 "seq_idx"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours.load_image(i),
                                      theirs.load_image(i))


def test_geometry_equals_the_jax_package():
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)
    for center, scale, inv in (((25.0, 20.0), (0.2, 0.25), False),
                               ((10.5, 31.0), (0.13, 0.17), True)):
        ours = geometry.get_affine_transform(center, scale, (24, 32), inv=inv)
        theirs = jgeometry.get_affine_transform(center, scale, (24, 32),
                                                inv=inv)
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(
            geometry.warp_affine_bilinear(image, ours, (24, 32)),
            jgeometry.warp_affine_bilinear(image, theirs, (24, 32)))


def _labels(n, rng):
    return [{
        "joints_3d": rng.randn(17, 3), "joints_2d_cpn": rng.randn(17, 2),
        "joints_2d_cpn_crop": rng.uniform(0, 24, (17, 2)),
        "center": rng.uniform(10, 20, 2), "scale": rng.uniform(0.1, 0.2, 2),
        "subject": int(rng.choice([1, 5, 9])), "action": int(rng.randint(2, 17)),
        "subaction": int(rng.randint(1, 3)), "camera_id": int(rng.randint(4)),
        "image_id": i, "video_id": int(rng.randint(100)),
    } for i in range(n)]


@pytest.mark.parametrize("retain", [1, 2])
def test_h36m_dataset_equals_the_jax_package(tmp_path, retain):
    """``from_pickle`` on a tiny label pickle with a packed frame store:
    the same arrays, paths, shards and frames."""
    rng = np.random.RandomState(7)
    labels = tmp_path / "labels.pkl"
    labels.write_bytes(pickle.dumps(_labels(6, rng)))
    store = tmp_path / "frames.npy"
    np.save(store, rng.randint(0, 256, (6, 32, 24, 3)).astype(np.uint8))
    kw = dict(image_shape=(32, 24), retain_every_n=retain,
              frame_store=str(store))
    ours = h36m.H36MDataset.from_pickle(str(labels), "root", **kw)
    theirs = jh36m.H36MDataset.from_pickle(str(labels), "root", **kw)
    assert len(ours) == len(theirs) == 6 // retain
    idxs = np.arange(len(ours))[::-1]
    np.testing.assert_array_equal(ours.load_batch(idxs),
                                  theirs.load_batch(idxs))
    np.testing.assert_array_equal(ours.load_image(1), theirs.load_image(1))
    assert ours.shard(0, 2) == theirs.shard(0, 2)
    for name in ("joints_3d", "joints_2d", "joints_2d_crop", "center",
                 "scale", "action_idx", "subject_idx", "video_idx",
                 "image_paths", "store_idx"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_the_port_imports_nothing_of_the_jax_package():
    files = sorted((REPO / "contextaware_poseformer_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f)
           if m == JAX_PACKAGE or m.startswith(JAX_PACKAGE + ".")
           or m.split(".")[0] in ("jax", "jaxlib", "flax")]
    assert not bad, bad
