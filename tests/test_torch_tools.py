"""The port's tools (``contextaware_poseformer_tpu_torch/tools``) on the
CPU: the FLOP count against JAX's cost analysis and the committed
``FLOPS_torch.json``, the trace budget on a hand-made trace and on a real
CPU profile of the annotated model, ``train_bench --tiny`` and the demo."""

import json
import sys
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contextaware_poseformer_tpu import config as jconfig
from contextaware_poseformer_tpu.models import ContextAwarePoseFormer as JCAPF
from contextaware_poseformer_tpu_torch import config, serve
from contextaware_poseformer_tpu_torch.data import augment
from contextaware_poseformer_tpu_torch.tools import (
    demo,
    model_flops,
    trace_budget,
    train_bench,
)
from contextaware_poseformer_tpu_torch.train import steps, train_h36m
from contextaware_poseformer_tpu_torch.utils import profiling

# a tiny config's count against XLA's cost analysis of JAX's unoptimized
# graph (the same per-op rules): -0.8% (h36m_hrnet_32) and -0.4%
# (mpi_3dhp_hrnet_32) measured, all of it elementwise work in the lifter
# (XLA lowers erf to a polynomial of multiplies and adds, counted there,
# where torch's erf is one transcendental op, counted as none)
TINY_FLOPS_RTOL = 0.01


def _jax_tiny(name):
    """JAX's model config equal to ``train_h36m.tiny(preset(name))``."""
    m = jconfig.preset(name).model
    c = (8, 16, 32, 64)
    stage = jconfig.HRNetStageConfig
    return replace(
        m, image_shape=(64, 64),
        backbone=replace(m.backbone, kind="hrnet", width=8,
                         stage2=stage(1, 2, (2, 2), c[:2]),
                         stage3=stage(1, 3, (2, 2, 2), c[:3]),
                         stage4=stage(1, 4, (2, 2, 2, 2), c)),
        lifter=replace(m.lifter, embed_dim_ratio=32, depth=2, levels=4))


@pytest.mark.parametrize("name", ["h36m_hrnet_32", "mpi_3dhp_hrnet_32"])
def test_model_flops_of_a_tiny_config_match_jax_cost_analysis(name):
    ours_cfg = train_h36m.tiny(config.preset(name)).model
    theirs_cfg = _jax_tiny(name)
    assert asdict(ours_cfg) == asdict(theirs_cfg)
    b = 8
    model = JCAPF(cfg=theirs_cfg)
    args = (jnp.zeros((b, 64, 64, 3)), jnp.zeros((b, 17, 2)),
            jnp.zeros((b, 17, 2)))
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                         *args))
    theirs = _xla_flops(jax.jit(model.apply).lower(params, *args)) / b / 1e9
    ours = model_flops.count(ours_cfg, batch=b)["gflops_per_frame"]
    assert ours == pytest.approx(theirs, rel=TINY_FLOPS_RTOL)


def _xla_flops(lowered) -> float:
    """XLA's cost analysis of a lowered (unoptimized) graph: its FLOPs."""
    ca = lowered.cost_analysis()
    return (ca[0] if isinstance(ca, list) else ca)["flops"]


def _jax_op(key):
    """(function, argument shapes) of JAX's counterpart of one of
    ``XlaRules.heavy``'s ops."""
    if key[0] == "convolution":
        x, w, stride, padding, dilation, groups, bias = key[1:]

        def conv(x, w, *b):
            y = jax.lax.conv_general_dilated(
                x, w, stride, [(p, p) for p in padding],
                rhs_dilation=dilation, feature_group_count=groups,
                dimension_numbers=("NCHW", "OIHW", "NCHW"))
            return y + b[0][:, None, None] if b else y

        return conv, (x, w) + (((w[0],),) if bias else ())
    if key[0] == "addmm":
        return (lambda c, a, b: c + jnp.matmul(a, b)), key[1:]
    return jnp.matmul, key[1:]


@pytest.mark.parametrize("name", config.PRESETS)
def test_every_convolution_and_matmul_counts_as_xla_counts_it(name):
    """Each convolution and matmul of a preset's parity graph, counted
    alone, equals XLA's count of the same op to the FLOP: a convolution's
    taps inside its input, a matmul's 2 M N K and a bias add."""
    rules = model_flops.XlaRules()
    model_flops.count(config.preset(name).model, batch=1, rules=rules)
    kinds = {key[0] for key in rules.heavy}
    assert {"convolution", "addmm"} <= kinds
    for key, (_, flops) in rules.heavy.items():
        fn, shapes = _jax_op(key)
        args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
        assert flops == _xla_flops(jax.jit(fn).lower(*args)), key


def test_model_flops_json_is_a_fresh_count():
    """The committed ``FLOPS_torch.json`` holds h36m_cpn's count as the tool
    makes it now; no preset counts above the JAX package's ``FLOPS.json``
    (XLA's optimized graph, which recomputes elementwise work); the deploy
    graph runs its preset's convolutions and matmuls and, with the CPN's
    native pyramid, skips the refineNet's output resizes; a training step
    counts the forward and the lifter's backward."""
    committed = model_flops.load()
    assert set(committed) == set(config.PRESETS)
    assert model_flops.count_preset("h36m_cpn") == committed["h36m_cpn"]
    dev = model_flops.against_jax(committed)
    assert set(dev) == set(config.PRESETS)
    assert all(v <= 0 for v in dev.values())
    rules = [model_flops.XlaRules() for _ in range(2)]
    fwd = model_flops.count(config.preset("h36m_cpn").model, batch=2,
                            rules=rules[0])
    deploy = model_flops.count(serve.deploy_config("h36m_cpn").model,
                               batch=2, rules=rules[1])
    assert rules[0].heavy == rules[1].heavy
    assert deploy["by_module"]["lifter"] == fwd["by_module"]["lifter"]
    assert deploy["gflops_per_frame"] < fwd["gflops_per_frame"]
    lifter = fwd["by_module"]["lifter"]
    train = committed["h36m_cpn"]["train_gflops_per_frame"]
    assert train == pytest.approx(fwd["gflops_per_frame"] + 2 * lifter,
                                  rel=1e-2)
    assert model_flops.mfu(10.0, 98_900.0) == pytest.approx(1.0)


def _event(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0 if cat not in ("kernel", "gpu_memcpy") else 9,
            "tid": tid, "args": args}


def _hand_made_trace(extra_unknown_us=0.0, extra_lifter_us=0.0):
    """Ranges on the main thread (1) and the autograd thread (2), launches
    joined to device events by correlation id."""
    ev = [
        _event("user_annotation", "fn:input normalize", 0, 10),
        _event("user_annotation", "nn:<model>", 10, 200),
        _event("user_annotation", "nn:backbone", 11, 100),
        _event("user_annotation", "nn:backbone.resnet_layer2_0_conv1", 20,
               10),
        _event("user_annotation", "nn:lifter", 120, 80),
        _event("user_annotation", "nn:lifter.res_block_0", 130, 30),
        _event("user_annotation", "nn:lifter.res_block_0.attn", 131, 10),
        _event("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
               300, 20, tid=2),
        _event("user_annotation", "fn:optimizer", 400, 50),
        _event("user_annotation", "Optimizer.step#AdamW.step", 410, 30),
    ]
    launches = [(1, 5, "elementwise_kernel", 3.0),  # normalize
                (1, 25, "cudnn_conv", 40.0),  # layer2
                (1, 50, "sample_levels_kernel", 7.0),  # named: sampler
                (1, 135, "gemm_kernel", 5.0),  # attention
                (1, 150, "add_kernel", 2.0),  # the block's residual
                (1, 125, "cat_kernel", 1.0 + extra_lifter_us),  # lifter other
                (2, 310, "gemm_kernel", 9.0),  # backward
                (1, 420, "multi_tensor_apply", 4.0),  # optimizer
                (1, 500, "stray_kernel", 1.0 + extra_unknown_us)]
    for corr, (tid, ts, name, dur) in enumerate(launches):
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid,
                         correlation=corr))
        ev.append(_event("kernel", name, 1000 + ts, dur, correlation=corr))
    ev.append(_event("gpu_memcpy", "Memcpy HtoD", 900, 2.0,
                     correlation=99))
    return {"traceEvents": ev}


def test_trace_budget_on_a_hand_made_trace(tmp_path):
    """Every device event to its bucket: by kernel name, by innermost
    module, by function range, backward on the autograd thread, the
    optimizer, copies; a kernel outside every range is unattributed, one
    in no named part of the lifter goes to a fallback bucket, and the tool
    exits 2 once the two together pass 5% of device time."""
    result = trace_budget.budget(_hand_made_trace())
    assert result["buckets"] == {
        "backbone layer2": 40.0, "backward (lifter)": 9.0, "sampler": 7.0,
        "lifter attention": 5.0, "optimizer": 4.0, "input normalize": 3.0,
        "lifter blocks (residual, drop-path)": 2.0, "copies": 2.0,
        "lifter other": 1.0, "UNATTRIBUTED": 1.0}
    assert result["total_us"] == 74.0
    assert result["coverage"] == pytest.approx(1 - 1 / 74)
    assert result["catch_all"] == pytest.approx(1 / 74)
    assert result["named"] == pytest.approx(1 - 2 / 74)
    assert result["unattributed"] == {"stray_kernel": 1.0}
    assert result["top"]["sampler"] == [("sample_levels_kernel", 7.0)]
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps(_hand_made_trace()))
    bad.write_text(json.dumps(_hand_made_trace(extra_unknown_us=9.0)))
    vague = tmp_path / "vague.json"
    vague.write_text(json.dumps(_hand_made_trace(extra_lifter_us=9.0)))
    out = tmp_path / "budget.json"
    assert trace_budget.main([str(good), "2", "--json", str(out)]) == 0
    assert json.loads(out.read_text())["buckets"]["sampler"] == 7.0
    assert trace_budget.main([str(bad)]) == 2
    assert trace_budget.main([str(vague)]) == 2


def test_annotate_emits_module_and_function_ranges_on_a_cpu_profile(
        tmp_path):
    """A CPU profile of a tiny served request and a training step under
    ``annotate``: the hooks' module ranges, the functions' ranges, the
    autograd engine's ops; afterwards no hook or wrapper is left."""
    torch.manual_seed(0)
    cfg = train_h36m.tiny(serve.slice_config("h36m_hrnet_32"))
    model = serve.build_serving_model(
        cfg, "cpu", generator=torch.Generator().manual_seed(0))
    h, w = cfg.model.image_shape
    key = config.preset("h36m_hrnet_32").train.loss
    normalize, loss = augment.serving_images, steps.losses.LOSSES[key]
    trainer_cfg = train_h36m.tiny(config.preset("h36m_hrnet_32"))
    from contextaware_poseformer_tpu_torch.data import pipeline
    from contextaware_poseformer_tpu_torch.data.synthetic import (
        SyntheticPoseDataset,
    )
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    ds = SyntheticPoseDataset(size=2, image_shape=(64, 64))
    trainer = Trainer(trainer_cfg, ds, ds, "cpu")
    state = trainer.init_state(0)
    raw = pipeline.to_device(next(pipeline.batch_iterator(
        ds, 2, shuffle=False, num_workers=1))[0], "cpu")
    with profiling.trace(str(tmp_path)):
        with trace_budget.annotate(model):
            serve.lift(model, torch.zeros(2, h, w, 3, dtype=torch.uint8),
                       torch.zeros(2, 17, 2), torch.zeros(2, 17, 2))
        with trace_budget.annotate(state.model):
            steps.train_step(state, raw, trainer_cfg, trainer.task, 1)
    (path,) = tmp_path.glob("trace_*.json")
    events = trace_budget.load_trace(str(path))["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"nn:<model>", "nn:backbone.conv1", "nn:lifter.joint_block_1",
            "nn:lifter.res_block_0.attn", "nn:lifter.head",
            "fn:input normalize", "fn:input (normalize, augment)",
            "fn:loss", "fn:optimizer"} <= names
    assert any(e.get("name", "").startswith(
        "autograd::engine::evaluate_function") for e in events)
    assert augment.serving_images is normalize
    assert steps.augmented_batch.__name__ == "augmented_batch"
    assert not hasattr(steps.augmented_batch, "__wrapped__")
    assert steps.losses.LOSSES[key] is loss
    assert not any(m._forward_pre_hooks or m._forward_hooks
                   for m in model.modules())
    result = trace_budget.budget(events)
    assert result["total_us"] == 0  # no device here


def test_annotate_names_the_cpn_functions_on_a_cpu_profile(tmp_path):
    """A tiny h36m_cpn int8 deploy request under ``annotate``: the int8
    quantizations (the stem's quantize and pool, K10p's function, and the
    four stream quantizes) and the bilinear resizes, which the CPN's
    forward calls between its modules, run in function ranges of their own
    (they would otherwise fall to "backbone other"), each innermost where
    it runs, and each bottleneck in a range named as its block, which takes
    its layer's bucket; the stream's pool runs in no "backbone stem" range
    (the float graph's pool keeps that one); afterwards the module's
    functions and methods are back."""
    from contextaware_poseformer_tpu_torch.models import cpn

    hw = (64, 64)
    cfg = serve.deploy_config("h36m_cpn")
    cfg = replace(cfg, model=replace(
        cfg.model, image_shape=hw,
        backbone=replace(cfg.model.backbone, cpn_layers=(1, 1, 1, 1)),
        lifter=replace(cfg.model.lifter, embed_dim_ratio=32, depth=1)))
    model = serve.build_serving_model(
        cfg, "cpu", generator=torch.Generator().manual_seed(0))
    frames = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    serve.prepare(model, [frames])
    originals = (cpn.max_pool_3x3_s2, cpn.quant, cpn.quant_max_pool_3x3_s2,
                 cpn.resize_bilinear_align_corners, cpn.CPN._bottleneck_i8)
    with profiling.trace(str(tmp_path)):
        with trace_budget.annotate(model):
            serve.lift(model, frames, torch.zeros(2, 17, 2),
                       torch.full((2, 17, 2), 32.0))
    (path,) = tmp_path.glob("trace_*.json")
    events = trace_budget.load_trace(str(path))["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation"]
    labels = ("fn:int8 quantize", "fn:bilinear resize (globalNet, refineNet)")
    assert [n for _, _, n in ranges].count("fn:int8 quantize") == 5
    assert "fn:backbone stem" not in {n for _, _, n in ranges}
    for label in labels:
        inside = [r for r in ranges if r[2] == label]
        assert inside, label
        start, end, _ = inside[0]
        around = [n for s, e, n in sorted(ranges, key=lambda r: (r[0], -r[1]))
                  if s <= start and end <= e]  # outermost first
        assert "nn:backbone" in around and trace_budget.classify(
            "any_kernel", around) == label[3:]
    blocks = {n for _, _, n in ranges if n.startswith("nn:backbone.resnet.")}
    assert "nn:backbone.resnet.layer2.0" in blocks
    assert trace_budget.classify("add_relu", [
        "nn:<model>", "nn:backbone", "nn:backbone.resnet.layer2.0"]) == \
        "backbone layer2"
    assert (cpn.max_pool_3x3_s2, cpn.quant, cpn.quant_max_pool_3x3_s2,
            cpn.resize_bilinear_align_corners,
            cpn.CPN._bottleneck_i8) == originals


def test_train_bench_tiny_on_the_cpu(tmp_path):
    results = train_bench.main(
        ["--tiny", "--device", "cpu", "--batches", "2", "--iters", "2",
         "--bursts", "1", "--eval", "--trace-steps", "1:2", "--logdir",
         str(tmp_path)])
    (r,) = results
    assert r["batch"] == 2 and r["steps_per_s"] > 0 and r["mfu"] > 0
    assert r["frames_per_s"] == pytest.approx(2 * r["steps_per_s"])
    assert r["eval_frames_per_s"] > 0
    assert r["train_gflops_per_frame"] == pytest.approx(
        model_flops.count(train_h36m.tiny(config.preset("h36m_hrnet_32"))
                          .model, train=True)["gflops_per_frame"])
    assert r["trace"].startswith(str(tmp_path))


@pytest.mark.parametrize("matplotlib_present", [True, False])
def test_demo_writes_a_png(tmp_path, monkeypatch, matplotlib_present):
    """With matplotlib, the visualization copy's grid; without it,
    ``render_flat``'s rows of three panels."""
    from PIL import Image

    if not matplotlib_present:
        monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    path, preds = demo.main(["--tiny", "--device", "cpu", "--n", "2",
                             "--out", str(tmp_path / "demo.png")])
    assert path == str(tmp_path / "demo.png")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert preds.shape == (2, 17, 3) and np.isfinite(preds).all()
    if not matplotlib_present:
        assert Image.open(path).size == (3 * 64, 2 * 64)
