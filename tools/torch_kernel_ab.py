"""Same-call A/B on the card of the port's K1 (fp32 projected body), K2,
K3, K5, K7, K9, K10s, K10u and the window-shift probe against another
commit's.

    git archive <commit> contextaware_poseformer_tpu_torch/ops \\
        contextaware_poseformer_tpu_torch/probes | tar -x -C build/parent
    python3 tools/torch_kernel_ab.py --parent build/parent [--only K5,K7]

Run from the repository root on a machine with an NVIDIA GPU and nvcc. The
other commit's ``ops`` package is loaded by path with its own ``_build``
(its library lands in ``<parent>/build/kernels``), so both versions run in
one process on one card. Each case is timed in the order parent, new, new,
parent (median device ms of 50 CUDA-event windows, ``chip_smoke._median_ms``)
at the shapes the serving and training paths launch:

- K2 (``--only K2``): the fp32 body at the seven calls of chip_smoke.py's
  kernels phase (context D=128 at 4352 rows, res D=128 at 5440, joint
  D=640 at 1088, the 3DHP lifters' D=64/96 at 5440 and 320/480 at 1088),
  each with the plain version's time beside it;
- K3: a bf16 call at R = 1088 rows of 5 tokens (batch 64) for D = 128, 64
  and 96 (the parent with its weights cast to bf16 beforehand, and with the
  four per-call casts its lifter made), fp32 at R = 1088 for D = 128, 64
  and 96 and at the training batch's R = 4352, and bf16 at D = 32 (the
  CUDA-core body's bf16 width);
- K9: the four-launch chain, block 0 and block 1 alone, and the floor build,
  at batch 64 and 128 on the 64x48x64 stem output;
- K5 (the sampler at the HRNet pyramids, batch 64): the W32 and W48 border
  calls with the lifter's projections (W a parameter, as served), each of
  their levels alone, the zeros 17-point calls, the W32 border call's gather
  alone and in fp32; and, as K1's guard, the CPN calls: bf16 zeros and
  border+proj, and the main path's int8 calls (zeros, and border+proj as
  each commit's lifter serves it: the other commit is handed W * scale made
  per call, the port W and the scale apart);
- K7: the first DeformableBlock's call of a served h36m_cpn and
  h36m_hrnet_32 request (batch 64), bf16 and fp32, beside the block's own
  route (K1 + ``embed_proj`` + einsum) with the new ops;
- K10s (the fold stem) alone at batch 64 on 256x192 frames, bf16 and fp32,
  in two forms: the served one (``kernel_q`` a tensor with a version
  counter, so its k-steps are made once per parameter state) and the one
  recorded under ``torch.inference_mode()`` (no version counter: every
  call also makes the k-steps, ``stem_weight_steps``);
- K10u (the s8 top-down hop) at each hop of a request (8x6, 16x12 and
  32x24 sources, C 256, batch 64) and the three together, bf16 and fp32;
- with K10s or K10u: the bf16 fold+topdown deploy graph's request
  (``chip_smoke._knob_graph``) with each commit's K10s and K10u swapped in,
  its device busy ms and the two kernels' share under torch.profiler;
- K1f32: K1's fp32 projected body at the CPN border call (4 levels, 256 ->
  32, 272 points a level and item, batch 64, the kernels phase's points),
  the W32 border call (level 0 gathered in the same launch) and the W48
  one, each with its plain version, its library call and its bound
  (``chip_smoke._sampler_work``, all at the fp32 rate), and, as guards,
  the fp32 gather's calls: the CPN zeros call, the CPN border call's
  gather alone (training's K1 call) and W32's level 0 alone;
- window: the window-shift probe's two forms (``probes/window.py``; the
  other commit's wrapper transposed w with a copy kernel), beside the
  launch floor of the same timer (the library's empty kernel).

``--sweep`` times the new K9 chain at each input-ring depth and at fixed
strip lengths. ``--breakdown`` builds variants of the new
``csrc/layer1_chain.cu`` with one piece cut (conv2's products, the conv1 and
conv3 epilogues, the input loads, the output stores, all of them; timing
only, wrong numbers) and times each chain at batch 64: what a piece costs is
the full build's time less the variant's. ``--stem-breakdown`` does the
same for K10s (``csrc/stem_conv.cu``: its products, its A fragments'
build and reads, its epilogue, its stores, its bias-map and input-row
loads), bf16 and fp32 at batch 64. ``--fp32-breakdown`` does the same for
K2's fp32 routes (``csrc/fused_mlp.cu``: the products, the staging of the
operands' K-slices, the LN, the epilogues; the joint call, two-phase, and
the res call, fused) and for K3's CUDA-core body (``csrc/small_attention.cu``:
the products, the weights' staging, the middle), batch 64.
``--k1-breakdown`` does the same for K1's fp32 projected body
(``csrc/sampler.cu``: gather only (no products), products only (no tap
loads), no W staging, the skeleton) at the CPN and W32 border calls.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import shutil
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from contextaware_poseformer_tpu_torch import serve  # noqa: E402
from contextaware_poseformer_tpu_torch.ops import (  # noqa: E402
    _build,
    deformable,
    fused_mlp,
    int8_conv,
    layer1_chain,
    small_attention,
)

RUNS = 50


def _load(name, path, build=None):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    if build is not None:
        mod._build = build
    return mod


def _ab(label, parent_fn, new_fn, card):
    t = [cs._median_ms(fn, runs=RUNS)
         for fn in (parent_fn, new_fn, new_fn, parent_fn)]
    print(f"ab: {label}: parent {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} "
          f"/ {t[2]:.4f} ms ({card})", flush=True)


def _k3_operands(d, rows, dtype, n=5, seed=0):
    """x (rows, n, d) in ``dtype`` and fp32 parameters made outside
    inference mode, as the lifter holds them (the routes make their
    operands once per parameter state)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, n, d, generator=gen).to("cuda", dtype)
    w = [(torch.randn(*s, generator=gen) * sc).cuda() for s, sc in (
        ((d, 3 * d), d ** -0.5), ((3 * d,), 0.1), ((d, d), d ** -0.5),
        ((d,), 0.1))]
    return x, w


def _k2_operands(rows, d, seed=0):
    """x (rows, d) fp32 and K2's parameters (LN scale and bias, W1, b1, W2,
    b2; H = 2D) as chip_smoke.py's kernels phase makes them."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(lo, hi, *shape):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).cuda()

    x = torch.randn(rows, d, generator=gen).cuda()
    return x, (uniform(0.5, 1.5, d), uniform(-0.1, 0.1, d),
               uniform(-1, 1, d, 2 * d) / d ** 0.5,
               uniform(-0.1, 0.1, 2 * d),
               uniform(-1, 1, 2 * d, d) / (2 * d) ** 0.5,
               uniform(-0.1, 0.1, d))


# K2's fp32 calls in the kernels phase: (label, rows, D) at batch 64
K2_FP32_CALLS = (("context", 4352, 128), ("res", 5440, 128),
                 ("joint", 1088, 640), ("3DHP res", 5440, 64),
                 ("3DHP res", 5440, 96), ("3DHP joint", 1088, 320),
                 ("3DHP joint", 1088, 480))


def _k2(parent, card):
    """K2's fp32 body at the seven calls of the kernels phase, against the
    other commit's, with the plain version's time beside them."""
    for label, rows, d in K2_FP32_CALLS:
        x, p = _k2_operands(rows, d)
        with torch.inference_mode():
            _ab(f"K2 fp32 {label} D={d} ({rows} rows) a call",
                lambda: parent.ln_mlp_residual_kernel(x, *p, 1e-6),
                lambda: fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6), card)
            plain = cs._median_ms(
                lambda: fused_mlp.ln_mlp_reference(x, *p, 1e-6), runs=RUNS)
        print(f"ab: K2 fp32 {label} D={d}: plain {plain:.4f} ms ({card})",
              flush=True)


def _k3(parent, card):
    for d, rows, dtype in ((128, 1088, torch.bfloat16),
                           (64, 1088, torch.bfloat16),
                           (96, 1088, torch.bfloat16),
                           (128, 1088, torch.float32),
                           (64, 1088, torch.float32),
                           (96, 1088, torch.float32),
                           (32, 1088, torch.bfloat16),
                           (128, 4352, torch.float32)):
        x, w = _k3_operands(d, rows, dtype)
        wc = [t.to(dtype) for t in w]
        name = str(dtype).removeprefix("torch.")
        with torch.inference_mode():
            _ab(f"K3 {name} D={d} R={rows} a call",
                lambda: parent.small_attention_kernel(x, *wc, 8),
                lambda: small_attention.small_attention_kernel(x, *w, 8),
                card)
            if dtype == torch.bfloat16:
                _ab(f"K3 {name} D={d} R={rows} a call, the parent with its "
                    "lifter's 4 casts",
                    lambda: parent.small_attention_kernel(
                        x, *(t.to(dtype) for t in w), 8),
                    lambda: small_attention.small_attention_kernel(x, *w, 8),
                    card)


def _k9_inputs(b):
    gen = torch.Generator().manual_seed(32)
    x = (torch.randn(b, 64, 48, 64, generator=gen) * 2).to(
        "cuda", torch.bfloat16)
    return x, cs._layer1_blocks(gen), torch.tensor(6.0, device="cuda")


def _k9(parent, card):
    for b in (64, 128):
        x, blocks, amax = _k9_inputs(b)
        x1 = layer1_chain.layer1_block_kernel(x, amax, blocks[0])
        a1 = blocks[0]["out"]
        with torch.inference_mode():
            _ab(f"K9 chain (4 launches) b={b}",
                lambda: parent.layer1_chain_kernel(x, amax, blocks),
                lambda: layer1_chain.layer1_chain_kernel(x, amax, blocks),
                card)
            _ab(f"K9 block 0 b={b}",
                lambda: parent.layer1_block_kernel(x, amax, blocks[0]),
                lambda: layer1_chain.layer1_block_kernel(x, amax, blocks[0]),
                card)
            _ab(f"K9 block 1 b={b}",
                lambda: parent.layer1_block_kernel(x1, a1, blocks[1]),
                lambda: layer1_chain.layer1_block_kernel(x1, a1, blocks[1]),
                card)
            _ab(f"K9 floor build chain b={b}",
                lambda: parent.layer1_chain_kernel(x, amax, blocks,
                                                   floor=True),
                lambda: layer1_chain.layer1_chain_kernel(x, amax, blocks,
                                                         floor=True),
                card)


def _k5_cases():
    """(label, maps, points, mode, projs, biases, scales, the other
    commit's projs) of the sampler calls the K5 A/B times, batch 64;
    projections made outside inference mode, as the served lifter's
    parameters. int8 levels carry a dequant scale: the port takes it apart
    from W, the other commit (as its lifter served) W * scale made per
    call under inference mode."""
    gen = torch.Generator().manual_seed(10)

    def uniform(lo, hi, *shape):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).cuda()

    b, hd, cases = cs.BATCH, cs.HEAD_DIM, []
    pyramids = {**cs.HRNET_PYRAMIDS,
                "CPN": tuple((h, w, 256) for h, w in cs.LEVELS)}
    for name, dims in pyramids.items():
        for dtype in (torch.bfloat16, torch.int8, torch.float32):
            # int8: the CPN pyramid only; fp32: the W32 border call only
            if dtype != torch.bfloat16 and name != {
                    torch.int8: "CPN", torch.float32: "W32"}[dtype]:
                continue
            if dtype == torch.int8:
                maps = [torch.randint(-127, 128, (b, h, w, c), generator=gen,
                                      dtype=torch.int8).cuda()
                        for h, w, c in dims]
            else:
                maps = [torch.randn(b, h, w, c, generator=gen).to(
                    "cuda", dtype) for h, w, c in dims]
            on = [deformable.kernel_can_preproject(h, w, c, hd, dtype)
                  for h, w, c in dims]
            projs = [uniform(-1, 1, c, hd) / c ** 0.5 if o else None
                     for (_, _, c), o in zip(dims, on)]
            biases = [uniform(-0.1, 0.1, hd) if o else None for o in on]
            border = uniform(-1.5, 1.5, b, len(dims), 17, 16, 2)
            zeros = uniform(-1.1, 1.1, b, len(dims), 17, 2)
            tag = f"{name} {str(dtype).removeprefix('torch.')}"
            if dtype == torch.float32:
                if name == "W32":
                    cases.append((f"{tag} border+proj P=272", maps, border,
                                  "border", projs, biases, None, projs))
                continue
            scales, folded = None, projs
            if dtype == torch.int8:
                scales = [torch.tensor(0.02, device="cuda") for _ in projs]
                with torch.inference_mode():  # W * scale, made per call
                    folded = [None if w is None else w * 0.02
                              for w in projs]
            cases.append((f"{tag} zeros P=17", maps, zeros, "zeros", None,
                          None, None, None))
            cases.append((f"{tag} border+proj P=272", maps, border, "border",
                          projs, biases, scales, folded))
            if name != "CPN" and dtype == torch.bfloat16:
                cases.append((f"{tag} border P=272 gather only", maps,
                              border, "border", None, None, None, None))
                for l in range(len(dims)):
                    cases.append((
                        f"{tag} border+proj P=272 level {l} "
                        f"{dims[l]} alone", [maps[l]],
                        border[:, l:l + 1].contiguous(),
                        "border", [projs[l]], [biases[l]], None,
                        [projs[l]]))
    return cases


def _k5(parent, card):
    for (label, maps, pts, mode, projs, biases, scales,
         folded) in _k5_cases():
        with torch.inference_mode():
            _ab(f"K5/K1 {label}",
                lambda: parent.sample_points_multi(maps, pts, mode, True,
                                                   folded, biases),
                lambda: deformable.sample_points_multi(
                    maps, pts, mode, True, projs, biases, scales),
                card)


def _k7_cases():
    """(label, block, args) of K7 on the first DeformableBlock of a served
    h36m_cpn and h36m_hrnet_32 request (``chip_smoke._served_block``),
    bf16 and fp32."""
    cases = []
    for name in cs.AGGREGATE_PRESETS:
        block, tokens, ref, features = cs._served_block(name)
        with torch.inference_mode():
            weights, packed = block.sampling(tokens, ref)
        b, lp1, p, _ = tokens.shape
        pos = packed.reshape(b, lp1 - 1, p, -1, 2)
        levels = range(lp1 - 1)
        args = (features, pos, weights,
                [block.embed_proj(l).kernel for l in levels],
                [block.embed_proj(l).bias for l in levels])
        cases.append((f"{name} block bf16", block, args))
        cases.append((f"{name} block fp32", None,
                      ([f.float() for f in features], *args[1:])))
    return cases


def _k7(parent, card):
    for label, block, args in _k7_cases():
        with torch.inference_mode():
            _ab(f"K7 {label}",
                lambda: parent.deformable_aggregate(*args, "border"),
                lambda: deformable.deformable_aggregate(*args, "border"),
                card)
            if block is not None:
                ms = cs._median_ms(lambda: block.pool(*args[:3]), runs=RUNS)
                print(f"ab: K7 {label}: the block's own route (K1 + "
                      f"embed_proj + einsum, new ops) {ms:.4f} ms ({card})",
                      flush=True)


def _stem_operands(dtype, batch=64, h=256, w=192):
    """The fold stem's operands at the served width
    (``chip_smoke.stem_operands``) and its byte bound (the frames and the
    map read once, the output written once)."""
    frames, rest = cs.stem_operands(torch.Generator().manual_seed(17),
                                    dtype, batch, h, w)
    elem = rest[-2].element_size()
    nbytes = frames.numel() + (batch + 1) * rest[-2].numel() * elem
    return frames, rest, cs._bound(nbytes, 0, torch.float32)[0]


def _k10s(parent, card):
    for dtype in (torch.bfloat16, torch.float32):
        frames, rest, bound = _stem_operands(dtype)
        with torch.inference_mode():
            recorded = (rest[0].clone(), *rest[1:])  # no version counter
        name = str(dtype).removeprefix("torch.")
        for form, args in (("served form (k-steps once)", rest),
                           ("recorded form (k-steps every call)",
                            recorded)):
            _ab(f"K10s {name} (64, 256, 192) {form}, bound {bound:.4f} ms",
                lambda: parent.stem_conv_kernel(frames, *args),
                lambda: int8_conv.stem_conv_kernel(frames, *args), card)


HOPS = ((8, 6), (16, 12), (32, 24))  # globalNet's top-down hops' sources


def _k10u(parent, card):
    gen = torch.Generator().manual_seed(18)
    for dtype in (torch.bfloat16, torch.float32):
        hops = []
        for h, w in HOPS:
            q = torch.randint(-127, 128, (64, h, w, 256), dtype=torch.int8,
                              generator=gen).cuda()
            lat = torch.randn(64, 2 * h, 2 * w, 256, generator=gen).to(
                "cuda", dtype)
            hops.append((q, torch.tensor(7.3, device="cuda"), lat, dtype))
        name = str(dtype).removeprefix("torch.")
        total = 0.0
        for (h, w), args in zip(HOPS, hops):
            bound = cs._bound(args[0].numel() + 2 * args[2].numel()
                              * args[2].element_size(), 0, torch.float32)[0]
            total += bound
            _ab(f"K10u {name} hop {h}x{w} -> {2 * h}x{2 * w}, bound "
                f"{bound:.4f} ms",
                lambda args=args: parent.topdown_kernel(*args),
                lambda args=args: int8_conv.topdown_kernel(*args), card)
        _ab(f"K10u {name} the 3 hops, bound {total:.4f} ms",
            lambda: [parent.topdown_kernel(*a) for a in hops],
            lambda: [int8_conv.topdown_kernel(*a) for a in hops], card)


def _knob_request(parent, card, requests=5):
    """The bf16 fold+topdown request with each commit's K10s and K10u, in
    the order parent, new, new, parent: device busy ms a request and the
    two kernels' ms under torch.profiler (the rest of the graph is this
    commit's)."""
    import tempfile

    from contextaware_poseformer_tpu_torch.utils import profiling

    cfg, model, req, _ = cs._knob_graph(
        "fold+topdown", {"cpn_fold_normalize": True,
                         "cpn_int8_topdown": True}, torch.bfloat16, card)
    new = (int8_conv.stem_conv_kernel, int8_conv.topdown_kernel)
    sides = {"parent": (parent.stem_conv_kernel, parent.topdown_kernel),
             "new": new}
    rows = []
    for side in ("parent", "new", "new", "parent"):
        int8_conv.stem_conv_kernel, int8_conv.topdown_kernel = sides[side]
        for _ in range(2):
            serve.lift(model, *req)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d, profiling.trace(d) as prof:
            for _ in range(requests):
                serve.lift(model, *req)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]

        def ms(names=None):
            return sum(e.self_device_time_total for e in kernels
                       if names is None or any(n in e.key for n in names)
                       ) / 1e3 / requests

        rows.append((side, ms(), ms(cs.SHARE_KERNELS["K10s"]),
                     ms(cs.SHARE_KERNELS["K10u"])))
    int8_conv.stem_conv_kernel, int8_conv.topdown_kernel = new
    for side, busy, stem, hop in rows:
        print(f"ab: the bf16 fold+topdown request ({side} K10s, K10u): "
              f"device busy {busy:.3f} ms a request, K10s {stem:.4f} ms "
              f"({stem / busy:.1%}), K10u {hop:.4f} ms ({hop / busy:.1%}) "
              f"(torch.profiler over {requests} requests, batch "
              f"{cs.BATCH}; {card})", flush=True)


def _sweep(card):
    x, blocks, amax = _k9_inputs(64)
    plan = layer1_chain.plan

    def timed(label, fixed):
        layer1_chain.plan = fixed
        with torch.inference_mode():
            ms = cs._median_ms(
                lambda: layer1_chain.layer1_chain_kernel(x, amax, blocks),
                runs=RUNS)
        layer1_chain.plan = plan
        print(f"sweep: K9 chain b=64, {label}: {ms:.4f} ms ({card})",
              flush=True)

    for depth in (1, 2, 3):
        def fixed(b, h, w, cin, sms, depth=depth):
            p = plan(b, h, w, cin, sms)
            return replace(p, depth=depth, smem=layer1_chain.smem_bytes(
                cin, p.lead, depth))
        timed(f"ring depth {depth}", fixed)
    for rows in (8, 16, 32, 64):
        def fixed(b, h, w, cin, sms, rows=rows):
            strips = b * -(-h // rows)
            return replace(plan(b, h, w, cin, sms), strip_rows=rows,
                           strips=strips, grid=min(strips, sms))
        timed(f"strips of {rows} rows", fixed)


# the pieces a breakdown variant cuts: (macro, first line, line after the
# piece), found by text in csrc/layer1_chain.cu
CUTS = {
    "NO_CONV2": ("for (int tap = 0; tap < 9; ++tap) {", -1,
                 "// t2 (conv3's A", 0),
    "NO_EPI1": ("int8_t* t1 = s_t1 + (i % L.t1_slots)", 0,
                "t1 tile i - lead complete", -1),
    "NO_EPI3": ("for (int j = 0; j < 8; ++j) {", -1,
                "__syncthreads();  // the output tile is staged", -1),
    "NO_LOAD": ("for (int e = tid; e < kBM * kPieces; e += kThreads) {", 0,
                "    };", 0),
    "NO_STORE": ("for (int e = tid; e < valid * (kExp / 16);", 0,
                 "// the next step's first barrier", 0),
}
VARIANTS = {"full": (), "no_conv2": ("NO_CONV2",), "no_epi1": ("NO_EPI1",),
            "no_epi3": ("NO_EPI3",), "no_load": ("NO_LOAD",),
            "no_store": ("NO_STORE",), "skeleton": tuple(CUTS)}


class _VariantBuild:  # the port's _build with a variant's library
    def __init__(self, lib):
        self.lib = lib

    def library(self):
        return self.lib

    def __getattr__(self, key):
        return getattr(_build, key)


def _build_variants(source, text, variants, entries, out):
    """Build ``source`` (a file of csrc/, its text ``text`` carrying the
    ``#ifndef`` cuts) once per variant (name -> macros defined), each with
    one nvcc, all started together, into libraries under ``out``; returns
    name -> a ``_build`` stand-in whose library is that variant's, its
    ``entries`` bound."""
    src_dir = out / "src"
    src_dir.mkdir(parents=True, exist_ok=True)
    (src_dir / source).write_text(text)
    for path in (*_build.CSRC.glob("*.cuh"), _build.CSRC / "errors.cu"):
        shutil.copy(path, src_dir / path.name)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
         *(f"-D{m}" for m in macros), "-I", str(src_dir), "-o",
         str(out / f"{name}.so"), str(src_dir / source),
         str(src_dir / "errors.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in variants.items()}
    builds = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn in (*entries, "capf_error_string"):
            f = getattr(lib, fn)
            f.restype, f.argtypes = _build.SIGNATURES[fn]
        builds[name] = _VariantBuild(lib)
    return builds


def _breakdown(card):
    lines = (_build.CSRC / "layer1_chain.cu").read_text().split("\n")

    def find(text, start=0):
        return next(i for i in range(start, len(lines)) if text in lines[i])

    marks = []
    for macro, (first, d1, after, d2) in CUTS.items():
        a = find(first) + d1
        marks.append((macro, a, find(after, a) + d2))
    cut = list(lines)
    for macro, a, b in sorted(marks, key=lambda m: -m[1]):
        cut.insert(b, "#endif")
        cut.insert(a, f"#ifndef {macro}")
    builds = _build_variants(
        "layer1_chain.cu", "\n".join(cut), VARIANTS,
        ("capf_layer1_block", "capf_layer1_block_floor"),
        ROOT / "build" / "k9_variants")
    x, blocks, amax = _k9_inputs(64)
    with torch.inference_mode():
        for name, build in builds.items():
            layer1_chain._build = build
            ms = cs._median_ms(
                lambda: layer1_chain.layer1_chain_kernel(x, amax, blocks),
                runs=RUNS)
            print(f"breakdown: K9 chain b=64, {name}: {ms:.4f} ms ({card})",
                  flush=True)
    layer1_chain._build = _build


# the pieces the K10s breakdown cuts from csrc/stem_conv.cu: (the text
# cut, what stands in for it so that the rest is not optimised away), or a
# list of such pairs
STEM_CUTS = {
    "NO_PRODUCTS": (
        "      wgmma_s8_n64_ra(d, af[ky],\n"
        "                      sw128_desc(smem + (ky / 4) * kStage + "
        "32 * (ky % 4)));",
        "      d[ky] += af[ky][0] ^ af[ky][1] ^ af[ky][2] ^ af[ky][3];"),
    "NO_A_BUILD": [("    if (Ring<E>::kKeepA && t < tiles) {",
                    "    if (false) {"),
                   ("      if (t < tiles && iy >= 0 && iy < a.h) {",
                    "      if (false) {")],
    "NO_EPILOGUE": (
        "        m[2 * j] = Epi<E>::finish(d[4 * j], d[4 * j + 1], eff, bias,\n"
        "                                  m[2 * j]);\n"
        "        m[2 * j + 1] = Epi<E>::finish(d[4 * j + 2], d[4 * j + 3], "
        "eff, bias,\n"
        "                                      m[2 * j + 1]);",
        "        if (d[4 * j] + d[4 * j + 1] + d[4 * j + 2] + d[4 * j + 3] =="
        " 123456789) m[2 * j] = eff;"),
    "NO_STORE": (
        "        *reinterpret_cast<uint4*>(dst + px * kCout + p * (16 / "
        "sizeof(E))) =\n"
        "            *reinterpret_cast<const uint4*>(m_row + (16 * t + px) * "
        "kPitchE +\n"
        "                                            p * (16 / sizeof(E)));",
        "        if (px == 99) dst[0] = m_row[0];"),
    "NO_MAP_LOAD": (
        "      cp_async16(dst + px * kPitchE + p * (16 / sizeof(E)),\n"
        "                 src + px * kCout + p * (16 / sizeof(E)), 16);", ""),
    "NO_ROW_LOAD": (
        "        cp_async16(s_ring + slot * pitch + 16 * p,\n"
        "                   frame + static_cast<size_t>(iy) * row_bytes + "
        "xb, 16);", ""),
}
STEM_VARIANTS = {
    "full": (), "no_products": ("NO_PRODUCTS",),
    "no_a_build": ("NO_A_BUILD",), "no_epilogue": ("NO_EPILOGUE",),
    "no_store": ("NO_STORE",), "no_map_load": ("NO_MAP_LOAD",),
    "no_row_load": ("NO_ROW_LOAD",),
    "no_loads": ("NO_MAP_LOAD", "NO_ROW_LOAD"),
    "compute_only": ("NO_STORE", "NO_MAP_LOAD", "NO_ROW_LOAD"),
    "skeleton": tuple(STEM_CUTS)}


def _cut_text(source, cuts):
    """The text of csrc/``source`` with each cut's piece (a macro -> a
    (piece, stand-in) pair or a list of them; each piece in the file
    once) kept under ``#ifndef`` the macro, its stand-in under ``#else``."""
    text = (_build.CSRC / source).read_text()
    for macro, pairs in cuts.items():
        for piece, stand_in in pairs if isinstance(pairs, list) else [pairs]:
            if text.count(piece) != 1:
                raise RuntimeError(f"breakdown: {macro}'s text is not in "
                                   f"csrc/{source} once")
            text = text.replace(piece, f"#ifndef {macro}\n{piece}\n#else\n"
                                       f"{stand_in}\n#endif")
    return text


def _stem_breakdown(card):
    """K10s at batch 64 on 256x192 frames, bf16 and fp32, in builds of
    csrc/stem_conv.cu with pieces cut (timing only, wrong numbers): what a
    piece costs is the full build's time less the variant's."""
    text = _cut_text("stem_conv.cu", STEM_CUTS)
    builds = _build_variants("stem_conv.cu", text, STEM_VARIANTS,
                             ("capf_stem_conv",),
                             ROOT / "build" / "k10s_variants")
    for dtype in (torch.bfloat16, torch.float32):
        frames, rest, bound = _stem_operands(dtype)
        for name, build in builds.items():
            int8_conv._build = build
            ms = cs._median_ms(
                lambda: int8_conv.stem_conv_kernel(frames, *rest), runs=RUNS)
            print(f"breakdown: K10s {str(dtype).removeprefix('torch.')} "
                  f"(64, 256, 192), {name}: {ms:.4f} ms (bound {bound:.4f}"
                  f" ms; {card})", flush=True)
    int8_conv._build = _build


# the pieces the fp32 breakdown cuts from csrc/fused_mlp.cu (K2's fp32
# routes) and csrc/small_attention.cu (K3's CUDA-core body), each with its
# stand-in (timing only, wrong numbers)
K2_CUTS = {
    "NO_PRODUCTS": [
        ("    fma_slice<TM, 8, kFusedBK>(\n"
         "        acc, s_a + tr * (d + 4) + s * kFusedBK, "
         "kFusedRG * (d + 4),\n"
         "        ring + (s % kF32Stages) * kFusedBK * h + tc * 4, h, h / 2);",
         "    acc[0][0] += s_a[tr * (d + 4) + s];"),
        ("    fma_slice<TM, 4, kFusedBK>(\n"
         "        acc2, s_h + tr * (h + 4) + s * kFusedBK, "
         "kFusedRG * (h + 4),\n"
         "        ring + ((n1 + s) % kF32Stages) * kFusedBK * h + tc * 4, d, "
         "0);",
         "    acc2[0][0] += s_h[tr * (h + 4) + s];"),
        ("    fma_slice<TM, TN, kGemmBK>(acc, ring + tr * (kGemmBK + 4),\n"
         "                               rg * (kGemmBK + 4), ring + slot_a + "
         "tc * 4,\n                               bn, bn / 2);",
         "    acc[0][0] += ring[tr];")],
    "NO_STAGING": [
        ("      copy_pieces(slot, w1 + static_cast<size_t>(s) * kFusedBK * "
         "h,\n"
         "                  kFusedBK * h / 4);", "      (void)slot;"),
        ("      copy_pieces(slot, w2 + static_cast<size_t>(s - n1) * kFusedBK "
         "* d,\n                  kFusedBK * d / 4);", "      (void)slot;"),
        ("      copy_block(ring, kGemmBK + 4, g.A, g.lda, m0, k0,\n"
         "                 capf::f32::walk(bm, kGemmBK / 4), g.rows, "
         "g.lda / 4);\n"
         "      copy_block(ring + slot_a, bn, g.B, g.n, k0, n0,\n"
         "                 capf::f32::walk(kGemmBK, bn / 4), g.kb, g.n / 4);",
         "      (void)ring, (void)k0;")],
    "NO_LN": [
        ("    ln_row(s_x + r * (d + 4), s_a + r * (d + 4), d, a.ln_scale, "
         "a.ln_bias,\n           a.eps);", ""),
        ("  ln_row(static_cast<const float*>(a.x) + static_cast<size_t>(row) "
         "* a.d,\n         dst, a.d, a.ln_scale, a.ln_bias, a.eps);", "")],
    # the stand-ins read all four sums, so that no product is dropped
    "NO_EPILOGUE": [
        ("      *reinterpret_cast<float4*>(s_h + (tr + kFusedRG * i) * "
         "(h + 4) "
         "+ c) =\n"
         "          make_float4(gelu_erf(v[0] + a.b1[c]), gelu_erf(v[1] + "
         "a.b1[c + 1]),\n"
         "                      gelu_erf(v[2] + a.b1[c + 2]),\n"
         "                      gelu_erf(v[3] + a.b1[c + 3]));",
         "      if (v[0] + v[1] + v[2] + v[3] == 1234.5f) s_h[c] = v[1];"),
        ("    *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * d + "
         "c) "
         "=\n"
         "        make_float4(xv.x + (acc2[i][0] + a.b2[c]),\n"
         "                    xv.y + (acc2[i][1] + a.b2[c + 1]),\n"
         "                    xv.z + (acc2[i][2] + a.b2[c + 2]),\n"
         "                    xv.w + (acc2[i][3] + a.b2[c + 3]));",
         "    if (acc2[i][0] + acc2[i][1] + acc2[i][2] + acc2[i][3] == "
         "1234.5f)\n      out[c] = xv.x;"),
        ("      gemm_epilogue<kResidual>(g, row, n0 + half * (bn / 2) + "
         "tc * 4,"
         "\n                               acc[i] + 4 * half);",
         "      const float* v = acc[i] + 4 * half;\n"
         "      if (v[0] + v[1] + v[2] + v[3] == 1234.5f) "
         "g.out[row] = v[0];")],
}
K3_CUTS = {
    "NO_PRODUCTS": [
        ("      fma_slice<kQkvTM, 8, kCoresBK>(\n"
         "          acc, s_x + qr * (d + 4) + k * kCoresBK, "
         "kQkvRG * (d + 4),\n"
         "          ring + ((base + k) % kStages) * kCoresBK * d3 + qc * 4, "
         "d3,\n          d3 / 2);", "      acc[0][0] += s_x[qr];"),
        ("      fma_slice<kProjTM, 4, kCoresBK>(\n"
         "          acc2, s_o + pr * (d + 4) + k * kCoresBK, "
         "kProjRG * (d + 4),"
         "\n          ring + ((base + nq + k) % kStages) * kCoresBK * d3 + pc "
         "* 4, d, 0);", "      acc2[0][0] += s_o[pr];")],
    "NO_STAGING": [
        ("        copy_pieces(slot, wqkv + static_cast<size_t>(k) * kCoresBK * "
         "d3,\n                    kCoresBK * d3 / 4);", "        (void)slot;"),
        ("        copy_pieces(slot, wproj + static_cast<size_t>(k - nq) * "
         "kCoresBK * d,\n                    kCoresBK * d / 4);",
         "        (void)slot;")],
    "NO_MIDDLE": (
        "    for (int i = tid; i < valid * heads; i += blockDim.x) {",
        "    for (int i = tid; i < 0; i += blockDim.x) {"),
}
FP32_VARIANTS = {"full": (), "no_products": ("NO_PRODUCTS",),
                 "no_staging": ("NO_STAGING",)}
K2_VARIANTS = {**FP32_VARIANTS, "no_ln": ("NO_LN",),
               "no_epilogue": ("NO_EPILOGUE",), "skeleton": tuple(K2_CUTS)}
K3_VARIANTS = {**FP32_VARIANTS, "no_middle": ("NO_MIDDLE",),
               "skeleton": tuple(K3_CUTS)}


def _fp32_breakdown(card):
    """K2's fp32 routes (the joint call, D = 640 at 1088 rows, two-phase;
    the res call, D = 128 at 5440 rows, fused) and K3's CUDA-core body
    (D = 128, 1088 rows of 5), batch 64, in builds with pieces cut (timing
    only, wrong numbers): what a piece costs is the full build's time less
    the variant's."""
    out = ROOT / "build" / "fp32_variants"
    builds = {
        "K2": _build_variants("fused_mlp.cu", _cut_text("fused_mlp.cu",
                                                        K2_CUTS),
                              K2_VARIANTS, ("capf_ln_mlp_residual",),
                              out / "k2"),
        "K3": _build_variants("small_attention.cu", _cut_text(
            "small_attention.cu", K3_CUTS), K3_VARIANTS,
            ("capf_small_attention",), out / "k3")}
    cases = [("K2", f"{label} D={d}", fused_mlp, lambda x=x, p=p:
              fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6))
             for label, (x, p), d in (
                 ("joint", _k2_operands(1088, 640), 640),
                 ("res", _k2_operands(5440, 128), 128))]
    x, w = _k3_operands(128, 1088, torch.float32)
    cases.append(("K3", "D=128 R=1088", small_attention,
                  lambda: small_attention.small_attention_kernel(x, *w, 8)))
    with torch.inference_mode():
        for kern, label, module, fn in cases:
            for name, build in builds[kern].items():
                module._build = build
                ms = cs._median_ms(fn, runs=RUNS)
                print(f"breakdown: {kern} fp32 {label}, {name}: {ms:.4f} ms "
                      f"({card})", flush=True)
            module._build = _build


def _k1f32_cases():
    """(label, timed, maps, points, mode, projs, biases) of K1's fp32 calls
    at batch 64: the projected border calls (``timed``: with the plain
    version, the library call and the bound) and the fp32 gather's guard
    calls; projections made outside inference mode, as the fp32 lifter
    holds them."""
    gen = torch.Generator().manual_seed(20)

    def uniform(lo, hi, *shape):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).cuda()

    b, hd, cases = cs.BATCH, cs.HEAD_DIM, []
    pyramids = {"CPN": tuple((h, w, 256) for h, w in cs.LEVELS),
                **cs.HRNET_PYRAMIDS}
    for name, dims in pyramids.items():
        maps = [torch.randn(b, h, w, c, generator=gen).cuda()
                for h, w, c in dims]
        on = [name == "CPN" or deformable.kernel_can_preproject(
            h, w, c, hd, torch.float32) for h, w, c in dims]
        projs = [uniform(-1, 1, c, hd) / c ** 0.5 if o else None
                 for (_, _, c), o in zip(dims, on)]
        biases = [uniform(-0.1, 0.1, hd) if o else None for o in on]
        border = uniform(-1.5, 1.5, b, len(dims), 17, 16, 2)
        cases.append((f"{name} fp32 border+proj P=272", True, maps, border,
                      "border", projs, biases))
        if name == "CPN":
            zeros = uniform(-1.1, 1.1, b, len(dims), 17, 2)
            cases.append(("guard: CPN fp32 zeros P=17 (gather)", False,
                          maps, zeros, "zeros", None, None))
            cases.append(("guard: CPN fp32 border P=272 gather only "
                          "(training's call)", False, maps, border,
                          "border", None, None))
        if name == "W32":
            cases.append(("guard: W32 fp32 level 0 (64, 48, 32) alone "
                          "(gather)", False, [maps[0]],
                          border[:, :1].contiguous(), "border", None, None))
    return cases


def _k1f32(parent, card):
    for label, timed, maps, pts, mode, projs, biases in _k1f32_cases():
        with torch.inference_mode():
            _ab(f"K1 {label}",
                lambda: parent.sample_points_multi(maps, pts, mode, True,
                                                   projs, biases),
                lambda: deformable.sample_points_multi(maps, pts, mode, True,
                                                       projs, biases),
                card)
            if not timed:
                continue
            plain = cs._median_ms(lambda: deformable.
                                  sample_points_multi_reference(
                                      maps, pts, mode, True, projs, biases),
                                  runs=RUNS)
            lib = cs._median_ms(cs._grid_sample_fn(maps, pts, mode, projs,
                                                   biases), runs=RUNS)
        work = cs._sampler_work(maps, pts, projs, mode == "border")
        bound, by = cs._bound(*work, torch.float32)
        print(f"ab: K1 {label}: plain {plain:.4f} ms, library {lib:.4f} ms,"
              f" bound {bound:.4f} ms ({by}; {card})", flush=True)


def _window(parent, card):
    from contextaware_poseformer_tpu_torch.probes import window

    gen = torch.Generator().manual_seed(6)
    xf = (torch.randn(window.M, window.LANES, generator=gen) * 2).cuda()
    wv = torch.randint(-20, 21, (window.K, window.N), generator=gen,
                       dtype=torch.int8).cuda()
    a4 = torch.tensor(4.0, device="cuda")
    dev = torch.device("cuda")
    floor = cs._median_ms(lambda: _build.empty_kernel(dev), runs=RUNS)
    with torch.inference_mode():
        for form, words in (("words (kernel_bitcast)", True),
                            ("offset (kernel_slice)", False)):
            _ab(f"window {form}, launch floor {floor:.4f} ms",
                lambda: parent.window_matmul(xf, wv, a4, words),
                lambda: window.window_matmul(xf, wv, a4, words), card)


# the pieces the K1 fp32 breakdown cuts from csrc/sampler.cu's fp32
# projected body, each with its stand-in (timing only, wrong numbers)
K1_CUTS = {
    "NO_PRODUCTS": (
        "        capf::f32::fma_slice<kF32Rows, 4, kF32Slice>(\n"
        "            acc, s_samp + (s & 1) * kF32SampSlot + at.tr * kF32Pitch,"
        "\n            kF32RowGroups * kF32Pitch,\n"
        "            s_w + (s & 1) * kF32WSlot + at.tc * 4, 4 * cg, 0);",
        "        acc[0][0] += s_samp[(s & 1) * kF32SampSlot + at.tr] + "
        "s_w[(s & 1) * kF32WSlot + at.tc];"),
    "NO_GATHER": (
        "            raw[u][k] = *reinterpret_cast<const float4*>(\n"
        "                feat + static_cast<size_t>(r[k]) * c + ch);",
        "            raw[u][k] = make_float4(r[k], ch, 0.f, 1.f);"),
    "NO_W": (
        "        cp_async16(dst + r * 4 * cg + 4 * q,\n"
        "                   in ? w + static_cast<size_t>(k) * cout + c0 + "
        "4 * q : w,\n                   in ? 16 : 0);",
        "        (void)dst, (void)in;"),
}
K1_VARIANTS = {"full": (), "gather_only": ("NO_PRODUCTS",),
               "products_only": ("NO_GATHER",), "no_w": ("NO_W",),
               "skeleton": tuple(K1_CUTS)}


def _k1_breakdown(card):
    """K1's fp32 projected body at the CPN and W32 border calls (batch
    64), in builds of csrc/sampler.cu with pieces cut (timing only, wrong
    numbers): what a piece costs is the full build's time less the
    variant's."""
    builds = _build_variants("sampler.cu", _cut_text("sampler.cu", K1_CUTS),
                             K1_VARIANTS, ("capf_sample_levels",),
                             ROOT / "build" / "k1_variants")
    cases = [c for c in _k1f32_cases() if c[1] and not c[0].startswith(
        "W48")]
    with torch.inference_mode():
        for label, _, maps, pts, mode, projs, biases in cases:
            for name, build in builds.items():
                deformable._build = build
                ms = cs._median_ms(lambda: deformable.sample_points_multi(
                    maps, pts, mode, True, projs, biases), runs=RUNS)
                print(f"breakdown: K1 {label}, {name}: {ms:.4f} ms "
                      f"({card})", flush=True)
    deformable._build = _build


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a directory holding the other commit's "
                         "contextaware_poseformer_tpu_torch/ops")
    ap.add_argument("--only", default="K2,K3,K9,K5,K7",
                    help="the kernels to A/B, comma-separated")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--stem-breakdown", action="store_true")
    ap.add_argument("--fp32-breakdown", action="store_true")
    ap.add_argument("--k1-breakdown", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    serve.configure_numerics()
    _build.library()
    only = set(args.only.split(","))
    if args.parent is not None:
        pkg = args.parent.resolve() / "contextaware_poseformer_tpu_torch"
        pbuild = _load("parent_build", pkg / "ops" / "_build.py")
        pbuild.library()
        loaded = {}

        def parent(module):
            if module not in loaded:
                path = pkg / ("probes" if module == "window" else "ops")
                loaded[module] = _load(f"parent_{module}",
                                       path / f"{module}.py", pbuild)
            return loaded[module]

        for kern, module, run in (("K1f32", "deformable", _k1f32),
                                  ("window", "window", _window),
                                  ("K2", "fused_mlp", _k2),
                                  ("K3", "small_attention", _k3),
                                  ("K9", "layer1_chain", _k9),
                                  ("K5", "deformable", _k5),
                                  ("K7", "deformable", _k7),
                                  ("K10s", "int8_conv", _k10s),
                                  ("K10u", "int8_conv", _k10u)):
            if kern in only:
                run(parent(module), card)
        if only & {"K10s", "K10u"}:
            _knob_request(parent("int8_conv"), card)
    if args.sweep:
        _sweep(card)
    if args.breakdown:
        _breakdown(card)
    if args.stem_breakdown:
        _stem_breakdown(card)
    if args.fp32_breakdown:
        _fp32_breakdown(card)
    if args.k1_breakdown:
        _k1_breakdown(card)


if __name__ == "__main__":
    main()
