"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line of output each (failures raise and exit non-zero):

1. device: requires CUDA (there is no CPU path) and prints the card's name
   and power limit as ``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader`` gives them;
2. build: compiles the hand-written kernels (ops/csrc/*.cu) from the
   checkout into build/kernels/ and prints the build seconds;
3. kernels: each of K1-K4 against its plain PyTorch version on the card, at
   the serving path's shapes with batch 64, in bf16 and fp32 (TF32 off):
   max abs error, error relative to max|plain|, median kernel and plain
   device times over 20 CUDA-event-timed runs;
4. slice: the full-width h36m_cpn serving slice (bf16 CPN ResNet-50 with the
   native pyramid, lifter embed 128 depth 4, random weights from seed 0)
   serves 3 requests of 64 uint8 frames through ``serve.lift``; the output
   must be finite (64, 17, 3), every kernel's launch count must grow by its
   per-request count, and the same request through the plain versions must
   agree to a relative RMS of 2e-2;
5. backward: K6 against the plain backward at the training shapes (four
   64x48x256 maps, batch 64, 4x272 border points and 4x17 zeros points),
   fp32 and bf16, with and without dF: max abs error and error / max|plain|
   of d(points) and dF, median kernel and plain device times; then the
   training step's own call (fp32, border, no dF) at batch 256;
6. train: the h36m_cpn training preset at full width (fp32 CPN ResNet-50
   with the /4 graph, lifter embed 128 depth 4 with deformable blocks,
   AdamW, batch 256, flip augmentation, drop-path 0.2; TF32 off; synthetic
   data and weights from seed 0), set up by the training CLI's own
   ``make_config`` and ``make_datasets``, takes 4 steps and evaluates 1
   flip-test batch through the ``Trainer``. Every loss must be finite, the
   lifter must change and the backbone must not, K1 must launch 5 times and
   K6 4 times a step, and one deterministic step through the kernels must
   agree with one through the plain sampler (``sampler="gather"``) from the
   same weights on the same batch: loss to 1e-5 relative, lifter gradients
   to a global relative L2 of 1e-4. Steps/s (information only): a warm
   epoch of 4 steps through the ``Trainer`` (host batch assembly and copy
   included), and ``train_step`` on a device-resident batch with the
   kernels and with the plain sampler;
7. a JSON line of per-kernel results (``launches`` summed over the serving
   and training runs, each counted from 0; K1-K4 errors and times in bf16 at
   the serving shapes, K6's those of the training step's call at batch 256
   times its 4 calls a step), then the final JSON status line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time
from dataclasses import replace

import torch

BATCH = 64
REQUESTS = 3
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # error / max|plain|
SLICE_REL_RMS = 2e-2
PER_REQUEST = {"K1": 5, "K2": 12, "K3": 4, "K4": 4}
TRAIN_STEPS = 4
TRAIN_BATCH = 256  # the h36m_cpn preset's batch
PER_TRAIN_STEP = {"K1": 5, "K6": 4}  # the 17 reference points need no K6
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL_L2 = 1e-4
CSRC = "contextaware_poseformer_tpu_torch/ops/csrc/"
REPLACES = {
    "K1": "contextaware_poseformer_tpu/ops/deformable.py:409",
    "K2": "contextaware_poseformer_tpu/ops/fused_mlp.py:75",
    "K3": "contextaware_poseformer_tpu/ops/small_attention.py:58",
    "K4": "contextaware_poseformer_tpu/ops/joint_attention.py:50",
    "K6": "contextaware_poseformer_tpu/ops/deformable.py:783",
}
SOURCES = {"K1": "sampler.cu", "K2": "fused_mlp.cu",
           "K3": "small_attention.cu", "K4": "joint_attention.cu",
           "K6": "sampler_bwd.cu"}
LEVELS = ((8, 6), (16, 12), (32, 24), (64, 48))  # native pyramid, 256x192
SLEEP_CYCLES = 4_000_000  # ~2 ms of device clock ahead of a timed window


def _median_ms(fn, runs=20, warmup=3):
    """Median device time of ``fn`` over ``runs`` CUDA-event windows. A
    sleep kernel queued before each window keeps the device busy while the
    host enqueues ``fn``'s launches, so a window holds device work only and
    not the host's Python and dispatch time."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for start, end in events:
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max((o.float() - r.float()).abs().max().item()
              for o, r in zip(outs, refs))
    scale = max(r.float().abs().max().item() for r in refs)
    return err, err / scale


def _kernel_cases(dtype, gen):
    """(kernel, case name, calls per forward, kernel fn, plain fn) at the
    serving shapes with batch BATCH."""
    from contextaware_poseformer_tpu_torch.ops import (
        deformable, fused_mlp, joint_attention, small_attention,
    )

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    def uniform(lo, hi, *shape):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).cuda()

    b = BATCH
    maps = [randn(b, h, w, 256) for h, w in LEVELS]
    ref_pts = uniform(-1.1, 1.1, b, 4, 17, 2)
    def_pts = uniform(-1.5, 1.5, b, 4, 17, 16, 2)
    projs = [uniform(-1, 1, 256, 32) / 16 for _ in LEVELS]
    biases = [uniform(-0.1, 0.1, 32) for _ in LEVELS]
    cases = [
        ("K1", "zeros P=17", 1,
         lambda: deformable.sample_points_multi(maps, ref_pts, "zeros"),
         lambda: deformable.sample_points_multi_reference(
             maps, ref_pts, "zeros")),
        ("K1", "border+proj P=272", 4,
         lambda: deformable.sample_points_multi(
             maps, def_pts, "border", True, projs, biases),
         lambda: deformable.sample_points_multi_reference(
             maps, def_pts, "border", True, projs, biases)),
    ]
    for label, shape, eps in (
        ("context", (b, 4, 17, 128), 1e-5),
        ("res", (b * 17, 5, 128), 1e-6),
        ("joint", (b, 17, 640), 1e-6),
    ):
        d = shape[-1]
        x = randn(*shape)
        p = (uniform(0.5, 1.5, d), uniform(-0.1, 0.1, d),
             uniform(-1, 1, d, 2 * d) / d ** 0.5,
             uniform(-0.1, 0.1, 2 * d),
             uniform(-1, 1, 2 * d, d) / (2 * d) ** 0.5,
             uniform(-0.1, 0.1, d))
        cases.append((
            "K2", f"{label} D={d}", 4,
            lambda x=x, p=p, eps=eps: fused_mlp.ln_mlp_residual_kernel(
                x, *p, eps),
            lambda x=x, p=p, eps=eps: fused_mlp.ln_mlp_reference(
                x, *p, eps),
        ))
    xa = randn(b * 17, 5, 128)
    wa = (randn(128, 384, scale=128 ** -0.5), randn(384, scale=0.1),
          randn(128, 128, scale=128 ** -0.5), randn(128, scale=0.1))
    cases.append((
        "K3", "R=b*17 N=5 D=128", 4,
        lambda: small_attention.small_attention_kernel(xa, *wa, 8),
        lambda: small_attention.attention_reference(xa, *wa, 8),
    ))
    qkv = randn(b, 17, 1920)
    cases.append((
        "K4", "N=17 D=640", 4,
        lambda: joint_attention.attention_middle_kernel(qkv, 8),
        lambda: joint_attention.attention_middle_reference(qkv, 8),
    ))
    return cases


def check_kernels():
    """Phase 3: returns {kernel: {"max_abs_err", "ms", "plain_ms"}} with
    bf16 errors and per-forward bf16 times (sum over the forward's calls)."""
    results = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for k in PER_REQUEST}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(1234)
        with torch.inference_mode():
            for kern, case, calls, fn, plain in _kernel_cases(dtype, gen):
                out, ref = fn(), plain()
                torch.cuda.synchronize()
                err, rel = _err(out, ref)
                ms, plain_ms = _median_ms(fn), _median_ms(plain)
                name = str(dtype).removeprefix("torch.")
                print(f"kernels: {kern} {case} {name}: max_abs_err {err:.3e} "
                      f"rel {rel:.3e} (tol {TOL[dtype]:.0e}); kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
                if not rel <= TOL[dtype]:
                    raise AssertionError(
                        f"{kern} {case} {name}: rel error {rel:.3e} > "
                        f"{TOL[dtype]:.0e}")
                if dtype == torch.bfloat16:
                    r = results[kern]
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    r["ms"] += calls * ms
                    r["plain_ms"] += calls * plain_ms
    return results


def _counters():
    """{kernel: (module, name of its launch counter)}"""
    from contextaware_poseformer_tpu_torch.ops import (
        deformable, fused_mlp, joint_attention, small_attention,
    )

    return {"K1": (deformable, "launches"), "K2": (fused_mlp, "launches"),
            "K3": (small_attention, "launches"),
            "K4": (joint_attention, "launches"),
            "K6": (deformable, "launches_bwd")}


def _counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def _reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _expected(per_call, calls=1):
    return {k: calls * per_call.get(k, 0) for k in _counters()}


def check_slice(card):
    """Phase 4: returns the main path's launch counts."""
    from contextaware_poseformer_tpu_torch import serve

    cfg = serve.slice_config()
    t0 = time.perf_counter()
    model = serve.build_serving_model(
        cfg, "cuda", generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    h, w = cfg.model.image_shape
    gen = torch.Generator().manual_seed(0)
    requests = [
        (torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                       generator=gen).cuda(),
         (torch.rand(BATCH, 17, 2, generator=gen) * 2 - 1).cuda(),
         (torch.rand(BATCH, 17, 2, generator=gen) * w).cuda())
        for _ in range(REQUESTS)
    ]
    print(f"slice: model built in {time.perf_counter() - t0:.1f} s "
          f"(image {h}x{w}, lifter embed {cfg.model.lifter.embed_dim_ratio} "
          f"depth {cfg.model.lifter.depth}, backbone "
          f"{cfg.model.compute_dtype})", flush=True)

    _reset_counts()
    outs = []
    for i, req in enumerate(requests):
        before = _counts()
        outs.append(serve.lift(model, *req))
        torch.cuda.synchronize()
        grew = {k: v - before[k] for k, v in _counts().items()}
        if grew != _expected(PER_REQUEST):
            raise AssertionError(f"request {i}: kernel launches {grew}, "
                                 f"expected {PER_REQUEST}")
    launches = _counts()
    for out in outs:
        if out.shape != (BATCH, 17, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"bad output {tuple(out.shape)}, finite="
                                 f"{bool(torch.isfinite(out).all())}")

    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        cfg.model.lifter, sampler="gather", attention="einsum",
        attention_joint="einsum", mlp="einsum")))
    plain = serve.build_serving_model(
        plain_cfg, "cuda", generator=torch.Generator().manual_seed(1))
    plain.load_state_dict(model.state_dict())
    before = _counts()
    ref = serve.lift(plain, *requests[0])
    torch.cuda.synchronize()
    if _counts() != before:
        raise AssertionError("the plain path launched a kernel")
    rel = ((outs[0] - ref).pow(2).mean().sqrt()
           / ref.pow(2).mean().sqrt()).item()
    print(f"slice: {REQUESTS} requests of {BATCH} frames -> "
          f"{tuple(outs[0].shape)} finite; launches per request "
          f"{PER_REQUEST}; kernel vs plain "
          f"rel RMS {rel:.3e} (tol {SLICE_REL_RMS:.0e})", flush=True)
    if not rel <= SLICE_REL_RMS:
        raise AssertionError(f"slice rel RMS {rel:.3e} > {SLICE_REL_RMS}")

    rates = []
    for m in (model, plain):
        serve.lift(m, *requests[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for req in requests * 3:
            serve.lift(m, *req)
        torch.cuda.synchronize()
        rates.append(BATCH * 3 * REQUESTS / (time.perf_counter() - t0))
    print(f"slice: {rates[0]:.1f} frames/s with the kernels, {rates[1]:.1f} "
          f"frames/s plain (information only; batch {BATCH}, {card})",
          flush=True)
    return launches


def _edge_points(gen, *shape, lo=-1.5, hi=1.5):
    """Uniform points with some exactly on the edges and some past them."""
    pts = torch.rand(*shape, generator=gen) * (hi - lo) + lo
    flat = pts.view(-1, 2)
    flat[:6] = torch.tensor([[1, 1], [-1, -1], [1, -1], [-1, 1],
                             [1.25, 0.3], [-0.2, -1.2]])
    return pts.cuda()


def _backward_case(label, dtype, maps, pts, grads, mode, need_df):
    """K6 against the plain backward on one case: prints and checks the
    errors; returns (d(points) max abs error, kernel ms, plain ms)."""
    from contextaware_poseformer_tpu_torch.ops import deformable

    def fn():
        return deformable.sample_points_multi_backward(
            maps, pts, grads, mode, True, need_df)

    def plain():
        return deformable.sample_points_multi_backward_reference(
            maps, pts, grads, mode, True, need_df)

    (dfs, dpts), (rdfs, rdpts) = fn(), plain()
    torch.cuda.synchronize()
    errs = {"d(points)": _err(dpts, rdpts)}
    if need_df:
        errs["dF"] = _err(tuple(dfs), tuple(rdfs))
    ms, plain_ms = _median_ms(fn), _median_ms(plain)
    text = "; ".join(f"{k} max_abs_err {e:.3e} rel {r:.3e}"
                     for k, (e, r) in errs.items())
    print(f"backward: {label}: {text} (tol {TOL[dtype]:.0e}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    for k, (e, r) in errs.items():
        if not r <= TOL[dtype]:
            raise AssertionError(f"{label} {k}: rel error {r:.3e} > "
                                 f"{TOL[dtype]:.0e}")
    return errs["d(points)"][0], ms, plain_ms


def check_backward():
    """Phase 5: K6 against the plain backward. Returns K6's JSON numbers:
    fp32 d(points) error and per-step times of the training step's call
    (border, no dF, batch TRAIN_BATCH; 4 calls a step)."""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        gen = torch.Generator().manual_seed(4321)
        maps = [torch.randn(BATCH, 64, 48, 256, generator=gen).to(
            "cuda", dtype) for _ in range(4)]
        for mode, shape in (("border", (BATCH, 4, 17, 16, 2)),
                            ("zeros", (BATCH, 4, 17, 2))):
            pts = _edge_points(gen, *shape)
            grads = [torch.randn(BATCH, *shape[2:-1], 256, generator=gen)
                     .to("cuda", dtype) for _ in range(4)]
            for need_df in (True, False):
                _backward_case(
                    f"K6 {mode} P={math.prod(shape[2:-1])} {name} "
                    f"{'with' if need_df else 'without'} dF", dtype, maps,
                    pts, grads, mode, need_df)
        del maps

    # the training step's call at its batch: fp32, border, no dF
    gen = torch.Generator("cuda").manual_seed(4321)
    maps = [torch.randn(TRAIN_BATCH, 64, 48, 256, device="cuda",
                        generator=gen) for _ in range(4)]
    pts = _edge_points(torch.Generator().manual_seed(4321), TRAIN_BATCH, 4,
                       17, 16, 2)
    grads = [torch.randn(TRAIN_BATCH, 17, 16, 256, device="cuda",
                         generator=gen) for _ in range(4)]
    err, ms, plain_ms = _backward_case(
        f"K6 border P=272 float32 without dF, batch {TRAIN_BATCH} (the "
        "training step's call)", torch.float32, maps, pts, grads, "border",
        False)
    calls = PER_TRAIN_STEP["K6"]
    return {"max_abs_err": err, "ms": calls * ms, "plain_ms": calls * plain_ms}


def check_train(card):
    """Phase 6: returns the training run's launch counts."""
    from contextaware_poseformer_tpu_torch.data import pipeline
    from contextaware_poseformer_tpu_torch.models.capf import (
        ContextAwarePoseFormer,
    )
    from contextaware_poseformer_tpu_torch.train import steps, train_h36m
    from contextaware_poseformer_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    args = train_h36m.build_argparser().parse_args(
        ["--preset", "h36m_cpn", "--synthetic", "--device", "cuda"])
    train_h36m.check_ported(args)
    cfg = train_h36m.make_config(args)
    if cfg.train.batch_size != TRAIN_BATCH:
        raise AssertionError(f"h36m_cpn batch {cfg.train.batch_size}")
    train_ds, val_ds = train_h36m.make_datasets(cfg, args)
    trainer = Trainer(cfg, train_ds, val_ds, "cuda")
    state = trainer.init_state(cfg.train.seed)
    lifter0 = [p.detach().clone() for p in state.model.lifter.parameters()]
    backbone0 = {k: v.clone()
                 for k, v in state.model.backbone.state_dict().items()}
    torch.cuda.synchronize()
    lc = cfg.model.lifter
    print(f"train: h36m_cpn built in {time.perf_counter() - t0:.1f} s "
          f"(image {cfg.model.image_shape}, batch {cfg.train.batch_size}, "
          f"lifter embed {lc.embed_dim_ratio} depth {lc.depth}, drop-path "
          f"{lc.drop_path_rate}, flip {cfg.train.flip_aug}, "
          f"{cfg.model.compute_dtype})", flush=True)

    _reset_counts()
    t0 = time.perf_counter()
    m = trainer.train_epoch(state, 0, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    if launches != _expected(PER_TRAIN_STEP, TRAIN_STEPS):
        raise AssertionError(f"{TRAIN_STEPS} train steps launched {launches}"
                             f", expected {PER_TRAIN_STEP} a step")
    losses = m["step_losses"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    _reset_counts()
    summary, _ = trainer.evaluate(state, max_batches=1)
    torch.cuda.synchronize()
    evaluated = _counts()
    if evaluated != _expected({"K1": 5}):
        raise AssertionError(f"the flip-test batch launched {evaluated}")
    if not all(map(math.isfinite, summary.values())):
        raise AssertionError(f"eval summary {summary}")
    changed = any(not torch.equal(a, p.detach()) for a, p in
                  zip(lifter0, state.model.lifter.parameters()))
    frozen = all(torch.equal(backbone0[k], v) for k, v in
                 state.model.backbone.state_dict().items())
    print(f"train: {TRAIN_STEPS} steps, losses "
          f"{[f'{v:.6f}' for v in losses]}, {TRAIN_STEPS / seconds:.2f} "
          f"steps/s (first steps included); launches {launches}; flip-test "
          f"batch p1 {summary['p1_mm']:.2f} mm, launches {evaluated}; lifter "
          f"changed {changed}, backbone bit-identical {frozen}", flush=True)
    if not (changed and frozen):
        raise AssertionError("the lifter must change and the backbone not")

    t0 = time.perf_counter()
    warm = trainer.train_epoch(state, 1, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    trainer_rate = TRAIN_STEPS / (time.perf_counter() - t0)
    if not all(map(math.isfinite, warm["step_losses"])):
        raise AssertionError(f"warm epoch losses {warm['step_losses']}")

    # one deterministic step through the kernels and one through the plain
    # sampler, from the same weights on the same batch
    plain_cfg = replace(cfg, model=replace(cfg.model, lifter=replace(
        lc, sampler="gather")))
    plain = ContextAwarePoseFormer(plain_cfg.model, device="cuda")
    plain.load_state_dict(state.model.state_dict())
    plain.backbone.to(memory_format=torch.channels_last)
    plain.backbone.requires_grad_(False)
    raw, _ = next(pipeline.batch_iterator(train_ds, cfg.train.batch_size,
                                          shuffle=False, num_workers=8))
    raw = pipeline.to_device(raw, "cuda")
    batch = steps.prepare(raw, cfg.model.backbone, trainer.task)
    results = []
    for model in (state.model, plain):
        before = _counts()
        model.zero_grad(set_to_none=True)
        loss = steps.loss_and_grads(model, cfg, batch, None,
                                    deterministic=True)
        torch.cuda.synchronize()
        grew = {k: v - before[k] for k, v in _counts().items()}
        results.append((loss.item(), [p.grad.clone() for p in
                                      model.lifter.parameters()], grew))
    if results[0][2] != _expected(PER_TRAIN_STEP) or any(
            results[1][2].values()):
        raise AssertionError(f"deterministic step launches: kernels "
                             f"{results[0][2]}, plain {results[1][2]}")
    (loss_k, grads_k, _), (loss_p, grads_p, _) = results
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    num = sum((a - b).pow(2).sum() for a, b in zip(grads_k, grads_p))
    den = sum(b.pow(2).sum() for b in grads_p)
    grad_rel = (num.sqrt() / den.sqrt()).item()

    rates = []
    for model in (state.model, plain):
        run = steps.TrainState(
            model, steps.make_optimizer(cfg, trainer.steps_per_epoch, model))
        steps.train_step(run, raw, cfg, trainer.task, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            steps.train_step(run, raw, cfg, trainer.task, 1)
        torch.cuda.synchronize()
        rates.append(3 / (time.perf_counter() - t0))
    print(f"train: deterministic step, kernels vs plain sampler: loss "
          f"{loss_k:.8f} vs {loss_p:.8f} (rel {loss_rel:.3e}, tol "
          f"{TRAIN_LOSS_RTOL:.0e}), lifter gradients global rel L2 "
          f"{grad_rel:.3e} (tol {TRAIN_GRAD_REL_L2:.0e})", flush=True)
    print(f"train: {trainer_rate:.3f} steps/s through the Trainer (a warm "
          f"epoch of {TRAIN_STEPS} steps, host batch assembly and copy "
          f"included); train_step on a device-resident batch: "
          f"{rates[0]:.3f} steps/s with the kernels, {rates[1]:.3f} steps/s "
          f"with the plain sampler (information only; batch "
          f"{cfg.train.batch_size}, {card})", flush=True)
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL_L2):
        raise AssertionError(f"kernels vs plain: loss rel {loss_rel:.3e}, "
                             f"gradient rel L2 {grad_rel:.3e}")
    return {k: launches[k] + evaluated[k] for k in launches}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs "
                         "an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(f"device: torch {torch.__version__} CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    print(smi, flush=True)

    from contextaware_poseformer_tpu_torch.ops import _build

    # fp32 at full precision: TF32 off for cuDNN convolutions (PyTorch's
    # default is on) and for cuBLAS matmuls (default off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    path, seconds = _build.build()
    log = path.with_suffix(".log")
    usage = [ln.strip() for ln in log.read_text().splitlines()
             if any(w in ln for w in ("entry function", "registers", "spill"))
             ] if log.exists() else []
    print(f"build: {seconds:.1f} s -> {path.name}", flush=True)
    for ln in usage:
        print(f"build: {ln}", flush=True)

    results = check_kernels()
    served = check_slice(card)
    results["K6"] = check_backward()
    trained = check_train(card)
    kernels = [
        {"name": k, "route": "cuda", "source": CSRC + SOURCES[k],
         "replaces": REPLACES[k], "launches": served[k] + trained[k],
         **results[k]}
        for k in SOURCES
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
