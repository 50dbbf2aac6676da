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
5. a JSON line of per-kernel results, then the final JSON status line.
"""

from __future__ import annotations

import json
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
CSRC = "contextaware_poseformer_tpu_torch/ops/csrc/"
REPLACES = {
    "K1": "contextaware_poseformer_tpu/ops/deformable.py:409",
    "K2": "contextaware_poseformer_tpu/ops/fused_mlp.py:75",
    "K3": "contextaware_poseformer_tpu/ops/small_attention.py:58",
    "K4": "contextaware_poseformer_tpu/ops/joint_attention.py:50",
}
SOURCES = {"K1": "sampler.cu", "K2": "fused_mlp.cu",
           "K3": "small_attention.cu", "K4": "joint_attention.cu"}
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


def _kernel_modules():
    from contextaware_poseformer_tpu_torch.ops import (
        deformable, fused_mlp, joint_attention, small_attention,
    )

    return {"K1": deformable, "K2": fused_mlp, "K3": small_attention,
            "K4": joint_attention}


def _counts():
    return {k: mod.launches for k, mod in _kernel_modules().items()}


def _reset_counts():
    for mod in _kernel_modules().values():
        mod.launches = 0


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
        if grew != PER_REQUEST:
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
    launches = check_slice(card)
    kernels = [
        {"name": k, "route": "cuda", "source": CSRC + SOURCES[k],
         "replaces": REPLACES[k], "launches": launches[k], **results[k]}
        for k in PER_REQUEST
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
