"""The port's streaming lifter against the JAX package's, on the CPU.

``models/streaming.py::StreamingLifter`` on the JAX streaming test's tiny
model (HRNet width 8, all four stages, lifter embed 32 depth 1, 64x64
frames, ``use_bf16=False``), from the same flax weights and the same
numpy-seeded frames: ``lift_batch`` with a padded last chunk, ``stream``
with a per-camera EMA, the refusal before ``prepare``, and the latency
window. The JAX side runs as its own tests run it (``jit`` on the CPU); the
port takes its plain versions (CPU tensors). Tolerance: 1e-3 of the
output's RMS (fp32 in both, summed in other orders).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu.models import streaming as jstreaming
from contextaware_poseformer_tpu_torch import config
from contextaware_poseformer_tpu_torch.models import streaming

IMAGE_WH = (1000, 1000)
TOL = 1e-3  # of the output RMS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tiny graphs run op by op,
    and a pool of threads a test worker only contends with the other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_cfg(cfglib, width=8, blocks=2, quantize="none"):
    """The JAX streaming test's model (``tests/test_streaming.py``): a
    structurally complete HRNet of ``width`` with ``blocks`` BasicBlocks a
    branch."""
    c = (width, 2 * width, 4 * width, 8 * width)
    stage = cfglib.HRNetStageConfig
    backbone = cfglib.BackboneConfig(
        kind="hrnet", width=width, quantize=quantize,
        stage2=stage(1, 2, (blocks,) * 2, c[:2]),
        stage3=stage(2, 3, (blocks,) * 3, c[:3]),
        stage4=stage(2, 4, (blocks,) * 4, c))
    return cfglib.ModelConfig(
        backbone=backbone,
        lifter=cfglib.LifterConfig(embed_dim_ratio=32, depth=1, levels=4,
                                   sampler="gather"),
        image_shape=(64, 64))


def _variables(jcfg, seed=0):
    """Flax variables of the composite with numpy leaves drawn from
    ``seed`` (the tree from ``jax.eval_shape``): conv kernels he-scaled,
    Dense kernels U(+-1/sqrt(fan_in)), scales U(0.5, 1.5), biases and
    ``pos_embed`` N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(
        JCAPF(cfg=jcfg).init, jax.random.PRNGKey(0),
        np.zeros((1, 64, 64, 3), np.float32), np.zeros((1, 17, 2), np.float32),
        np.zeros((1, 17, 2), np.float32))

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
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _frames(seed, n):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 255, (n, 64, 64, 3)).astype(np.uint8)
    kp_full = rng.uniform(100, 900, (n, 17, 2))
    centers = rng.uniform(480, 520, (n, 2))
    scales = rng.uniform(0.9, 1.1, (n, 2))
    return frames, kp_full, IMAGE_WH, centers, scales


def _scfg(**kw):
    return dict(batch_size=4, use_bf16=False, **kw)


@pytest.fixture(scope="module")
def tiny():
    """(port config, JAX config, flax variables) of the tiny model."""
    jcfg = _model_cfg(jconfig)
    return _model_cfg(config), jcfg, _variables(jcfg)


@pytest.fixture(scope="module")
def jax_lifter(tiny):
    """One JAX ``StreamingLifter`` of the tiny model at batch 4 (its step
    compiles once); a test sets its ``cfg`` as it needs."""
    _, jcfg, variables = tiny
    return jstreaming.StreamingLifter(
        jcfg, variables, jstreaming.StreamingConfig(**_scfg()))


def _rel(ours, theirs):
    return (np.abs(ours - theirs).max()
            / np.sqrt(np.mean(np.square(theirs))))


def test_lift_batch_with_padding_matches_jax(tiny, jax_lifter):
    """6 frames in chunks of 4: the second chunk padded from 2 to 4 by
    repeating its last row; the port's poses equal JAX's within 1e-3 of
    their RMS, and the padded result equals one exact batch of 6."""
    cfg, _, variables = tiny
    args = _frames(1, 6)
    ours = streaming.StreamingLifter(
        cfg, variables, streaming.StreamingConfig(**_scfg()),
        device="cpu").lift_batch(*args)
    jax_lifter.cfg = jstreaming.StreamingConfig(**_scfg())
    theirs = jax_lifter.lift_batch(*args)
    assert ours.shape == (6, 17, 3) and ours.dtype == np.float32
    assert np.isfinite(ours).all()
    assert _rel(ours, theirs) < TOL
    exact = streaming.StreamingLifter(
        cfg, variables, streaming.StreamingConfig(batch_size=6,
                                                  use_bf16=False),
        device="cpu").lift_batch(*args)
    np.testing.assert_allclose(ours, exact, rtol=1e-4, atol=1e-5)


def _camera_stream(seed, cams=2, slots=3):
    rng = np.random.RandomState(seed)
    for _ in range(slots):
        for cam in range(cams):
            frame = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
            yield cam, frame, rng.uniform(100, 900, (17, 2))


def _boxes(cam):
    return np.array([500.0 + 5 * cam, 495.0]), np.array([1.0, 1.05])


def test_stream_ema_matches_jax_per_camera(tiny, jax_lifter):
    """2 cameras x 3 time slots in batches of 4 (one padded) with
    ``ema_alpha=0.5``: the same cameras in the same order, each camera's
    smoothed poses equal JAX's within 1e-3 of their RMS, and equal to the
    EMA of ``lift_batch``'s raw poses over that camera."""
    cfg, _, variables = tiny
    scfg = _scfg(ema_alpha=0.5)
    sl = streaming.StreamingLifter(
        cfg, variables, streaming.StreamingConfig(**scfg), device="cpu")
    ours = list(sl.stream(_camera_stream(2), IMAGE_WH, _boxes))
    jax_lifter.cfg = jstreaming.StreamingConfig(**scfg)
    jax_lifter._ema.clear()
    theirs = list(jax_lifter.stream(_camera_stream(2), IMAGE_WH, _boxes))
    assert [c for c, _ in ours] == [c for c, _ in theirs] == [0, 1] * 3
    for cam in (0, 1):
        a = np.stack([p for c, p in ours if c == cam])
        b = np.stack([p for c, p in theirs if c == cam])
        assert a.shape == (3, 17, 3)
        assert _rel(a, b) < TOL

    items = list(_camera_stream(2))
    raw = streaming.StreamingLifter(
        cfg, variables, streaming.StreamingConfig(**_scfg()),
        device="cpu").lift_batch(
            np.stack([f for _, f, _ in items]),
            np.stack([k for _, _, k in items]), IMAGE_WH,
            np.stack([_boxes(c)[0] for c, _, _ in items]),
            np.stack([_boxes(c)[1] for c, _, _ in items]))
    for cam in (0, 1):
        ema = None
        for pose, (c, _, _) in zip(raw, items):
            if c == cam:
                ema = pose if ema is None else 0.5 * ema + 0.5 * pose
        last = [p for c, p in ours if c == cam][-1]
        np.testing.assert_allclose(last, ema, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["serve", "static", "c128"])
def test_lift_batch_refuses_before_prepare(tiny, mode):
    """"serve" and "static" need ``prepare`` (calibrated scales) before the
    first lift, as JAX's ``_needs_prepare`` reads it; "c128" serves without
    it. After ``prepare`` every mode lifts finite poses."""
    cfg, _, variables = tiny
    qcfg = replace(cfg, backbone=replace(cfg.backbone, quantize=mode))
    args = _frames(3, 4)
    sl = streaming.StreamingLifter(
        qcfg, variables, streaming.StreamingConfig(**_scfg()), device="cpu")
    if mode == "c128":
        assert np.isfinite(sl.lift_batch(*args)).all()
    else:
        with pytest.raises(ValueError, match="prepare"):
            sl.lift_batch(*args)
    sl.prepare(*args)
    out = sl.lift_batch(*args)
    assert out.shape == (4, 17, 3) and np.isfinite(out).all()


def test_latency_stats_window(tiny):
    """frames/s over the same trimmed window as the percentiles: after
    5000 recorded calls of 4 frames at 10 ms, 4096 remain and frames/s is
    400, as the JAX test reads it."""
    cfg, _, variables = tiny
    sl = streaming.StreamingLifter(
        cfg, variables, streaming.StreamingConfig(**_scfg()), device="cpu")
    assert sl.latency_stats() == {"n": 0}
    for _ in range(5000):
        sl._record_latency(10.0, 4)
    stats = sl.latency_stats()
    assert stats["n"] == 4096
    np.testing.assert_allclose(stats["frames_per_sec"], 400.0, rtol=1e-6)
    for k in ("p50_ms", "p90_ms", "p99_ms", "mean_ms"):
        np.testing.assert_allclose(stats[k], 10.0, rtol=1e-6)
    sl.lift_batch(*_frames(4, 2))
    assert sl.latency_stats()["n"] == 4096


def test_padding_keeps_the_real_rows_of_a_dynamic_int8_chunk():
    """A width-32 HRNet under "c128" (its two widest branches' convs run in
    dynamic int8, quantized with the chunk's max|x|): the real rows of a
    chunk padded by repeating its last row equal those rows lifted alone,
    bit for bit, where padding with zero frames moves them."""
    cfg = _model_cfg(config, width=32, blocks=1, quantize="c128")
    variables = _variables(_model_cfg(jconfig, width=32, blocks=1), seed=5)
    frames, kp, wh, centers, scales = _frames(6, 6)
    sl = streaming.StreamingLifter(
        cfg, variables, streaming.StreamingConfig(**_scfg()), device="cpu")
    padded = sl.lift_batch(frames, kp, wh, centers, scales)[4:]
    alone = streaming.StreamingLifter(
        cfg, variables, streaming.StreamingConfig(batch_size=2,
                                                  use_bf16=False),
        device="cpu").lift_batch(frames[4:], kp[4:], wh, centers[4:],
                                 scales[4:])
    np.testing.assert_array_equal(padded, alone)

    zeros = np.concatenate([frames[4:], np.zeros_like(frames[:2])])
    kp_z, centers_z, scales_z = (np.concatenate([a[4:], a[4:]])
                                 for a in (kp, centers, scales))
    zero_padded = sl.lift_batch(zeros, kp_z, wh, centers_z, scales_z)[:2]
    assert not np.array_equal(zero_padded, alone)
