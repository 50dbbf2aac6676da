"""Same-call A/B on the card of the int8 quantizes of the CPN deploy graph.

    git archive <commit> contextaware_poseformer_tpu_torch chip_smoke.py \\
        | tar -x -C build/parent
    python3 tools/quantize_ab.py --parent build/parent

Run from the repository root on a machine with an NVIDIA GPU and nvcc. Each
tree (the other commit's, unpacked under a gitignored directory, and this
one) runs in a process of its own, in the order parent, new, new, parent,
and builds its kernels into its own ``build/kernels``. A process measures,
at batch 64 on the main path (``serve.deploy_config("h36m_cpn")``, random
weights from seed 0, prepared on one seeded batch):

- K10q's step form (``int8_conv.quantize_kernel``, calibrated) on the three
  globalNet up-convs' bf16 inputs (8x6, 16x12 and 32x24 x 256);
- the stream's quantizes as its CPN calls them: ``cpn.quant`` on the three
  refineNet cascades' inputs and the int8 /4 map (64x48 x 256), and the
  stem, ``cpn.quant_max_pool_3x3_s2`` where the tree has it, else
  ``cpn.max_pool_3x3_s2(cpn.quant(...))``, on the (64, 128, 96, 64) stem
  output;
- one main-path request under ``tools/trace_budget.annotate`` three times:
  device busy ms and the "int8 quantize" and "backbone stem" buckets; and
  host ms a request over 10 requests.

Kernel times are the median device ms of 20 CUDA-event windows
(``chip_smoke._median_ms``). It prints one JSON line a process and a
summary, and writes them to ``chiprun_out/quantize_ab.json``.

``--sweep`` (no ``--parent``) builds variants of this tree's
``csrc/int8_conv.cu`` instead, each with one choice changed (groups in
flight a thread, blocks an SM, the balanced grid, streaming load/store
hints, K10p's threads a block), every one with nvcc in parallel into
``build/quantize_sweep/``, and times K10q at the CPN request's shapes and
K10p at the stem with 1-4 output rows a block, each checked bit for bit
against the plain version first, in two rounds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH = 64
UP_INPUTS = ((8, 6), (16, 12), (32, 24))  # globalNet's bf16 up-conv inputs
STREAM_INPUTS = ((8, 6), (16, 12), (32, 24), (64, 48))  # 256 channels
STEM = (BATCH, 128, 96, 64)
PROFILED = 3
TIMED = 10


def worker(tree: str) -> dict:
    """The measurements of one tree, in this process."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from contextaware_poseformer_tpu_torch import serve
    from contextaware_poseformer_tpu_torch.models import cpn
    from contextaware_poseformer_tpu_torch.ops import int8_conv
    from contextaware_poseformer_tpu_torch.tools import trace_budget
    from contextaware_poseformer_tpu_torch.utils import profiling

    assert Path(int8_conv.__file__).resolve().is_relative_to(
        Path(tree).resolve()), int8_conv.__file__
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)

    def bf16(*shape):
        return (torch.randn(*shape, generator=gen) * 2).to(
            torch.bfloat16).cuda()

    a = torch.tensor(5.3, device="cuda")
    out = {"tree": tree, "kernels": {}}
    ms = chip_smoke._median_ms
    with torch.inference_mode():
        for h, w in UP_INPUTS:
            x = bf16(BATCH, h, w, 256)
            out["kernels"][f"K10q step {h}x{w}x256"] = ms(
                lambda: int8_conv.quantize_kernel(x, a, True))
        for h, w in STREAM_INPUTS:
            x = bf16(BATCH, h, w, 256)
            out["kernels"][f"stream quant {h}x{w}x256"] = ms(
                lambda: cpn.quant(x, a))
        x = bf16(*STEM)
        if hasattr(cpn, "quant_max_pool_3x3_s2"):
            stem = lambda: cpn.quant_max_pool_3x3_s2(x, a)  # noqa: E731
        else:
            stem = lambda: cpn.max_pool_3x3_s2(cpn.quant(x, a))  # noqa: E731
        out["kernels"]["stem quant + pool 128x96x64"] = ms(stem)
        del x
    cfg = serve.deploy_config("h36m_cpn")
    model = serve.build_serving_model(
        cfg, "cuda", generator=torch.Generator().manual_seed(0))
    h, w = cfg.model.image_shape
    g = torch.Generator().manual_seed(0)
    serve.prepare(model, [torch.randint(0, 256, (BATCH, h, w, 3),
                                        dtype=torch.uint8,
                                        generator=g).cuda()])
    req = (torch.randint(0, 256, (BATCH, h, w, 3), dtype=torch.uint8,
                         generator=g).cuda(),
           (torch.rand(BATCH, 17, 2, generator=g) * 2 - 1).cuda(),
           (torch.rand(BATCH, 17, 2, generator=g) * w).cuda())
    for _ in range(3):
        serve.lift(model, *req)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        serve.lift(model, *req)
    torch.cuda.synchronize()
    out["host_ms"] = (time.perf_counter() - t0) * 1e3 / TIMED
    out["requests"] = []
    for _ in range(PROFILED):
        with tempfile.TemporaryDirectory() as d:
            with trace_budget.annotate(model), profiling.trace(d):
                serve.lift(model, *req)
                torch.cuda.synchronize()
            (path,) = [os.path.join(d, f) for f in os.listdir(d)]
            b = trace_budget.budget(trace_budget.load_trace(path))
        out["requests"].append({
            "busy_ms": b["total_us"] / 1e3,
            "int8_quantize_ms": b["buckets"].get("int8 quantize", 0.0) / 1e3,
            "backbone_stem_ms": b["buckets"].get("backbone stem", 0.0) / 1e3,
            "named": b["named"]})
    return out


# (variant, [(text of csrc/int8_conv.cu, its replacement)])
_BALANCED = ("  const long long rounds = (tiles + most - 1) / most;  // tiles a "
             "block\n  const long long blocks = (tiles + rounds - 1) / rounds;")
VARIANTS = (
    ("as built", []),
    ("4 groups a thread", [("kQuantUnroll = 2;", "kQuantUnroll = 4;")]),
    ("8 groups, 2 blocks an SM", [("kQuantUnroll = 2;", "kQuantUnroll = 8;"),
                                  ("kQuantBlocksPerSm = 4;",
                                   "kQuantBlocksPerSm = 2;")]),
    ("8 blocks an SM", [("kQuantBlocksPerSm = 4;", "kQuantBlocksPerSm = 8;")]),
    ("unbalanced grid", [(_BALANCED, "  const long long blocks = tiles < "
                          "most ? tiles : most;")]),
    ("streaming hints", [
        ("        v[u][0] = x[2 * g];\n        v[u][1] = x[2 * g + 1];",
         "        v[u][0] = __ldcs(x + 2 * g);\n"
         "        v[u][1] = __ldcs(x + 2 * g + 1);"),
        ("      out[g] = exact ?", "      __stcs(out + g, exact ?"),
        (": quant16<kForm, false>(v[u][0], v[u][1], k);",
         ": quant16<kForm, false>(v[u][0], v[u][1], k));")]),
    ("K10p 128 threads", [("kPoolThreads = 256;", "kPoolThreads = 128;")]),
    ("K10p 512 threads", [("kPoolThreads = 256;", "kPoolThreads = 512;")]),
)
# K10q's calls of a CPN request: (label, shape, form: 1 step, 2 scale)
SWEEP_CALLS = tuple((f"step {h}x{w}x256", (BATCH, h, w, 256), 1)
                    for h, w in UP_INPUTS) + tuple(
    (f"scale {h}x{w}x256", (BATCH, h, w, 256), 2) for h, w in STREAM_INPUTS)


def sweep() -> dict:
    """The variant builds' times: {(variant, case): [ms a round]}."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from contextaware_poseformer_tpu_torch.ops import _build, int8_conv

    src = (_build.CSRC / "int8_conv.cu").read_text()
    out_dir = ROOT / "build" / "quantize_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, subs) in enumerate(VARIANTS):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"quantize_ab: variant {name!r}: {old!r} "
                                 "is not in csrc/int8_conv.cu")
            text = text.replace(old, new)
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        procs.append((name, out_dir / f"v{i}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", "-o", str(out_dir / f"v{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"quantize_ab: variant {name!r}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.capf_int8_quantize.argtypes = _build.SIGNATURES[
            "capf_int8_quantize"][1]
        lib.capf_int8_quant_pool.argtypes = _build.SIGNATURES[
            "capf_int8_quant_pool"][1]
        libs[name] = lib
    gen = torch.Generator().manual_seed(0)
    a = torch.tensor(5.3, device="cuda")
    xs = {label: (torch.randn(*shape, generator=gen) * 2).to(
        torch.bfloat16).cuda() for label, shape, _ in SWEEP_CALLS}
    stem = (torch.randn(*STEM, generator=gen) * 2).to(torch.bfloat16).cuda()
    pooled = int8_conv.quant_max_pool_3x3_s2_reference(stem, a)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for _ in range(2):
        for name, lib in libs.items():
            for label, _, form in SWEEP_CALLS:
                x = xs[label]
                out = torch.empty(x.shape, dtype=torch.int8, device="cuda")

                def run(x=x, out=out, form=form, lib=lib):
                    err = lib.capf_int8_quantize(
                        x.data_ptr(), a.data_ptr(), out.data_ptr(),
                        x.numel(), form, 0, stream)
                    if err:
                        raise RuntimeError(f"K10q {name}: CUDA error {err}")
                run()
                ref = (int8_conv.quant_reference(x, a) if form == 2
                       else int8_conv.quantize_reference(x, a))
                if not torch.equal(out, ref):
                    raise SystemExit(f"quantize_ab: {name} {label} differs")
                times.setdefault((name, f"K10q {label}"), []).append(
                    chip_smoke._median_ms(run))
            for rows in (1, 2, 3, 4):
                out = torch.empty(pooled.shape, dtype=torch.int8,
                                  device="cuda")

                def run(out=out, rows=rows, lib=lib):
                    err = lib.capf_int8_quant_pool(
                        stem.data_ptr(), a.data_ptr(), out.data_ptr(),
                        *STEM, rows, 0, stream)
                    if err:
                        raise RuntimeError(f"K10p {name}: CUDA error {err}")
                run()
                if not torch.equal(out, pooled):
                    raise SystemExit(f"quantize_ab: {name} K10p rows {rows} "
                                     "differs")
                times.setdefault((name, f"K10p {rows} row(s) a block"),
                                 []).append(chip_smoke._median_ms(run))
    return times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other commit's unpacked tree")
    ap.add_argument("--sweep", action="store_true",
                    help="time variant builds of csrc/int8_conv.cu")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker)), flush=True)
        return
    if not args.parent and not args.sweep:
        ap.error("--parent or --sweep is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.sweep:
        times = sweep()
        for (name, case), ms in sorted(times.items(),
                                       key=lambda kv: (kv[0][1], kv[0][0])):
            print(f"sweep: {case}: {name}: "
                  + ", ".join(f"{t:.4f}" for t in ms) + f" ms ({smi})",
                  flush=True)
        return
    runs = []
    for label, tree in (("parent", args.parent), ("new", str(ROOT)),
                        ("new", str(ROOT)), ("parent", args.parent)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(Path(tree).resolve())], capture_output=True, text=True,
            cwd=tree)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            raise SystemExit(f"quantize_ab: the {label} worker failed")
        r = json.loads(lines[-1][7:])
        r["label"] = label
        runs.append(r)
        print(f"{label}: {time.perf_counter() - t0:.1f} s; " + json.dumps(r),
              flush=True)
    summary = {}
    for label in ("parent", "new"):
        mine = [r for r in runs if r["label"] == label]
        reqs = [q for r in mine for q in r["requests"]]
        summary[label] = {
            "kernels": {k: [r["kernels"][k] for r in mine]
                        for k in mine[0]["kernels"]},
            "busy_ms": [q["busy_ms"] for q in reqs],
            "int8_quantize_ms": [q["int8_quantize_ms"] for q in reqs],
            "backbone_stem_ms": [q["backbone_stem_ms"] for q in reqs],
            "host_ms": [r["host_ms"] for r in mine],
        }
        s = summary[label]
        print(f"{label}: busy ms median "
              f"{statistics.median(s['busy_ms']):.3f} {s['busy_ms']}; "
              f"int8 quantize {statistics.median(s['int8_quantize_ms']):.3f}"
              f"; backbone stem "
              f"{statistics.median(s['backbone_stem_ms']):.3f}; host ms "
              f"{s['host_ms']} ({smi})", flush=True)
        for k, v in s["kernels"].items():
            print(f"{label}: {k}: {v} ms", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "quantize_ab.json").write_text(json.dumps(
        {"card": smi, "runs": runs, "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
