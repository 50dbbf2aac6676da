"""The port's own copies of the JAX package's framework-neutral modules
(config, skeleton, geometry, synthetic, H36M and MPI-INF-3DHP data, the
checkpoint converter, the 3DHP metrics) give the same results bit for bit,
and no module of the port, nor ``chip_smoke.py``, imports the JAX
package."""

import ast
import pickle
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import torch

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.data import h36m as jh36m
from contextaware_poseformer_tpu.data import mpi3dhp as jmpi3dhp
from contextaware_poseformer_tpu.data import synthetic as jsynthetic
from contextaware_poseformer_tpu.models import convert as jconvert
from contextaware_poseformer_tpu.train import metrics as jmetrics
from contextaware_poseformer_tpu.utils import geometry as jgeometry
from contextaware_poseformer_tpu.utils import skeleton as jskeleton
from contextaware_poseformer_tpu_torch import config
from contextaware_poseformer_tpu_torch.data import h36m, mpi3dhp, synthetic
from contextaware_poseformer_tpu_torch.models import convert
from contextaware_poseformer_tpu_torch.train import metrics
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
                 "H36M_ACTION_NAMES", "MPI3DHP_TEST_SEQUENCES",
                 "MPI3DHP_SCENE_SETTINGS"):
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
    pts = rng.uniform(0, 2048, (5, 17, 2)).astype(np.float32)
    for w, h in ((2048, 2048), (1920, 1080)):
        ours = geometry.normalize_screen_coordinates(pts, w, h)
        theirs = jgeometry.normalize_screen_coordinates(pts, w, h)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_batch_geometry_equals_the_jax_package():
    """The streaming path's host geometry, bit for bit in the same
    dtypes: the batched affine solve and its application, the single
    affine, the bbox conversion and the inverse screen mapping."""
    rng = np.random.RandomState(1)
    centers = rng.uniform(100, 900, (6, 2)).astype(np.float32)
    scales = rng.uniform(0.8, 2.4, (6, 2)).astype(np.float32)
    pts = rng.uniform(0, 1000, (6, 17, 2)).astype(np.float32)
    for inv in (False, True):
        ours = geometry.get_affine_transform_batch(centers, scales, (48, 64),
                                                   inv=inv)
        theirs = jgeometry.get_affine_transform_batch(centers, scales,
                                                      (48, 64), inv=inv)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
        mapped = geometry.affine_transform_batch(pts, ours)
        assert mapped.dtype == np.float64
        np.testing.assert_array_equal(
            mapped, jgeometry.affine_transform_batch(pts, theirs))
        np.testing.assert_array_equal(
            geometry.affine_transform(pts[0], ours[0]),
            jgeometry.affine_transform(pts[0], theirs[0]))
    for box in ((10, 20, 110, 140), (0, 0, 300, 90), (5, 5, 77, 102.4)):
        for ours, theirs in zip(geometry.bbox_center_scale(box, 0.75),
                                jgeometry.bbox_center_scale(box, 0.75)):
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
    norm = geometry.normalize_screen_coordinates(pts, 1000, 1002)
    ours = geometry.image_coordinates(norm, 1000, 1002)
    np.testing.assert_array_equal(
        ours, jgeometry.image_coordinates(norm, 1000, 1002))


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


def _assert_trees_equal(ours, theirs, path=()):
    assert type(ours) is type(theirs), path
    if isinstance(ours, dict):
        assert list(ours) == list(theirs), path
        for k in ours:
            _assert_trees_equal(ours[k], theirs[k], path + (k,))
    else:
        assert ours.dtype == theirs.dtype, path
        np.testing.assert_array_equal(ours, theirs, err_msg=str(path))


def _conv_bn(sd, rng, conv, cin, cout, k=3):
    sd[f"{conv}.weight"] = rng.randn(cout, cin, k, k).astype(np.float32)
    bn = jconvert._bn_name_for_conv(conv)
    for leaf in ("weight", "bias", "running_mean"):
        sd[f"{bn}.{leaf}"] = rng.randn(cout).astype(np.float32)
    sd[f"{bn}.running_var"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    sd[f"{bn}.num_batches_tracked"] = np.asarray(3)


def test_convert_equals_the_jax_package(tmp_path):
    """The converter copy on hand-made reference-style state dicts: the
    checkpoint loader (DDP ``module.`` keys under ``state_dict``), BN
    folding of named and Sequential convs with skipped heads, the lifter and
    composite mappings, the live-BN COCO CPN tree, and the same errors for a
    missing and an unconsumed key."""
    rng = np.random.RandomState(3)
    sd = {}
    _conv_bn(sd, rng, "conv1", 3, 8)
    _conv_bn(sd, rng, "layer1.0.downsample.0", 8, 16, 1)
    sd["final_layer.weight"] = rng.randn(17, 16, 1, 1).astype(np.float32)
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(
        np.asarray(v)) for k, v in sd.items()}}, path)
    ours = convert.load_torch_state_dict(str(path))
    theirs = jconvert.load_torch_state_dict(str(path))
    _assert_trees_equal(ours, theirs)

    shapes = {"conv1": {"kernel": np.zeros((3, 3, 3, 8)),
                        "scale": np.zeros(8), "bias": np.zeros(8)},
              "layer1.0.downsample.0": {
                  "kernel": np.zeros((1, 1, 8, 16)), "scale": np.zeros(16),
                  "bias": np.zeros(16)}}
    _assert_trees_equal(convert.convert_conv_backbone(ours, shapes),
                        jconvert.convert_conv_backbone(theirs, shapes))
    for module in (convert, jconvert):
        with pytest.raises(ValueError, match="unconsumed"):
            module.convert_conv_backbone(ours, shapes, skip_patterns=())
    assert convert.BACKBONE_SKIPS == jconvert.BACKBONE_SKIPS

    lifter = {}

    def lin(name, *shape):  # a Linear (cout, cin) or a LayerNorm (d,)
        lifter[f"{name}.weight"] = rng.randn(*shape).astype(np.float32)
        lifter[f"{name}.bias"] = rng.randn(shape[0]).astype(np.float32)

    lin("coord_embed", 8, 2)
    lifter["Spatial_pos_embed"] = rng.randn(1, 2, 17, 8).astype(np.float32)
    lin("head.0", 16)
    lin("head.1", 3, 16)
    lin("feat_embed.0", 8, 8)
    for blocks in ("res_blocks.0", "joint_blocks.0"):
        lin(f"{blocks}.norm1", 8)
        lin(f"{blocks}.norm2", 8)
        lin(f"{blocks}.attn.qkv", 24, 8)
        lin(f"{blocks}.attn.proj", 8, 8)
        lin(f"{blocks}.mlp.fc1", 16, 8)
        lin(f"{blocks}.mlp.fc2", 8, 16)
    kw = dict(depth=1, levels=1, use_deformable=False)
    _assert_trees_equal(convert.convert_lifter(lifter, **kw),
                        jconvert.convert_lifter(lifter, **kw))
    composite = {**{f"volume_net.{k}": v for k, v in lifter.items()},
                 **{f"backbone.{k}": v for k, v in theirs.items()}}
    _assert_trees_equal(
        convert.convert_composite(composite, shapes, **kw),
        jconvert.convert_composite(composite, shapes, **kw))
    del lifter["coord_embed.bias"]
    for module in (convert, jconvert):
        with pytest.raises(KeyError, match="coord_embed.bias"):
            module.convert_lifter(lifter, **kw)

    coco = {}
    _conv_bn(coco, rng, "a.conv1", 3, 4)
    coco["head.weight"] = rng.randn(5, 4, 3, 3).astype(np.float32)
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        coco[f"up.bn.{leaf}"] = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    tree = {"params": {
        "a.conv1": {"kernel": np.zeros((3, 3, 3, 4)),
                    "bn": {"scale": np.zeros(4), "bias": np.zeros(4)}},
        "head.kernel": np.zeros((3, 3, 4, 5)),
        "up.bn": {"scale": np.zeros(4), "bias": np.zeros(4)}}}
    _assert_trees_equal(convert.convert_cpn_coco(coco, tree),
                        jconvert.convert_cpn_coco(coco, tree))


def test_3dhp_metrics_equal_the_jax_package():
    """Per-joint errors, PCK@150/AUC by joint group, and the sequence,
    overall, activity and scene-setting tables, on errors around the
    thresholds (some exactly on one: the comparison is strict)."""
    rng = np.random.RandomState(4)
    pred = rng.randn(40, 17, 3) * 90
    gt = rng.randn(40, 17, 3) * 90
    errors = metrics.joint_errors_mm(pred, gt)
    np.testing.assert_array_equal(errors, jmetrics.joint_errors_mm(pred, gt))
    errors[0, :5] = (150.0, 145.0, 0.0, 5.0, 75.0)
    assert metrics.pck_auc(errors) == jmetrics.pck_auc(errors)
    seqs = {name: errors[i * 8:(i + 1) * 8]
            for i, name in enumerate(("TS1", "TS2", "TS4", "TS5", "TS6"))}
    acts = {name: rng.randint(1, 8, len(e)) for name, e in seqs.items()}
    for activities in (None, acts):
        assert (metrics.mpi3dhp_evaluate(seqs, activities)
                == jmetrics.mpi3dhp_evaluate(seqs, activities))
    for name in ("MPI3DHP_JOINT_GROUPS", "PCK_THRESHOLD_MM",
                 "AUC_THRESHOLDS_MM", "MPI3DHP_ACTIVITY_NAMES"):
        assert getattr(metrics, name) == getattr(jmetrics, name), name


def _npz(path, data):
    np.savez(path, data=np.asarray(data, dtype=object))
    return str(path)


def _anim(rng, n, valid=False):
    out = {"data_3d": rng.randn(n, 17, 3) * 500,
           "data_2d": rng.uniform(0, 2048, (n, 17, 3)),
           "data_2d_crop": rng.uniform(0, 192, (n, 17, 2))}
    if valid:
        out["valid"] = (rng.rand(n) > 0.3).astype(np.float32)
    return out


def _assert_datasets_equal(ours, theirs):
    assert ours.seq_names == theirs.seq_names
    for name in ("joints_3d", "joints_2d", "joints_2d_crop", "image_paths",
                 "seq_idx", "action_idx", "valid_mask", "store_idx"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b)


def test_mpi3dhp_equals_the_jax_package(tmp_path):
    """``load_train`` and ``load_test`` (valid frames only, and all with
    the mask; a packed frame store) on synthetic npz files in the
    reference's layout, the shards, the multi-frame windows and the
    ``.mat`` export."""
    rng = np.random.RandomState(5)
    train = _npz(tmp_path / "train.npz", {
        "S1 Seq1": [{0: _anim(rng, 4), 2: _anim(rng, 3)}],
        "S2 Seq2": [{1: _anim(rng, 5)}]})
    ours = mpi3dhp.load_train(train, "img")
    theirs = jmpi3dhp.load_train(train, "img")
    _assert_datasets_equal(ours, theirs)
    assert ours.shard(1, 2) == theirs.shard(1, 2)
    _assert_datasets_equal(ours, theirs)

    test = _npz(tmp_path / "test.npz", {
        "TS1": _anim(rng, 6, valid=True), "TS5": _anim(rng, 7, valid=True)})
    for keep in (False, True):
        kw = dict(keep_invalid=keep)
        ours = mpi3dhp.load_test(test, "img", **kw)
        theirs = jmpi3dhp.load_test(test, "img", **kw)
        _assert_datasets_equal(ours, theirs)
        for frames, train_ in ((3, False), (5, True), (1, False)):
            if frames > 1 and not keep and not train_:
                continue
            a = mpi3dhp.make_windows(ours, frames=frames, train=train_,
                                     chunk_length=2 if train_ else 1,
                                     reverse_aug=train_, flip_aug=train_)
            b = jmpi3dhp.make_windows(theirs, frames=frames, train=train_,
                                      chunk_length=2 if train_ else 1,
                                      reverse_aug=train_, flip_aug=train_)
            np.testing.assert_array_equal(a.pairs, b.pairs)
            assert len(a) == len(b) > 0
            for i in range(len(a)):
                x, y = a[i], b[i]
                assert x.keys() == y.keys()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])

    n = len(ours)
    store = tmp_path / "frames.npy"
    np.save(store, rng.randint(0, 256, (n, 256, 192, 3)).astype(np.uint8))
    ours = mpi3dhp.load_test(test, "img", keep_invalid=True,
                             frame_store=str(store))
    theirs = jmpi3dhp.load_test(test, "img", keep_invalid=True,
                                frame_store=str(store))
    _assert_datasets_equal(ours, theirs)
    idxs = np.arange(n)[::-2]
    np.testing.assert_array_equal(ours.load_batch(idxs),
                                  theirs.load_batch(idxs))
    np.testing.assert_array_equal(ours.load_image(2), theirs.load_image(2))

    preds = rng.randn(n, 17, 3).astype(np.float32)
    for module, name in ((mpi3dhp, "ours.mat"), (jmpi3dhp, "theirs.mat")):
        module.export_inference_mat(str(tmp_path / name), preds,
                                    ours.seq_idx, ours.seq_names)
    a = scipy.io.loadmat(str(tmp_path / "ours.mat"))
    b = scipy.io.loadmat(str(tmp_path / "theirs.mat"))
    for seq in ours.seq_names:
        np.testing.assert_array_equal(a[seq], b[seq])


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
    pkg = REPO / "contextaware_poseformer_tpu_torch"
    assert {pkg / "models/streaming.py", pkg / "utils/profiling.py",
            pkg / "data/pipeline.py"} <= set(files)
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f)
           if m == JAX_PACKAGE or m.startswith(JAX_PACKAGE + ".")
           or m.split(".")[0] in ("jax", "jaxlib", "flax")]
    assert not bad, bad
