"""Same-call A/B of the port's K3 and K9 against another commit's, on the card.

    git archive <commit> contextaware_poseformer_tpu_torch/ops \\
        | tar -x -C build/parent
    python3 tools/torch_kernel_ab.py --parent build/parent

Run from the repository root on a machine with an NVIDIA GPU and nvcc. The
other commit's ``ops`` package is loaded by path with its own ``_build``
(its library lands in ``<parent>/build/kernels``), so both versions run in
one process on one card. Each case is timed in the order parent, new, new,
parent (median device ms of 50 CUDA-event windows, ``chip_smoke._median_ms``)
at the shapes the serving and training paths launch:

- K3: a bf16 call at R = 1088 rows of 5 tokens (batch 64) for D = 128, 64
  and 96 (the parent with its weights cast to bf16 beforehand, and with the
  four per-call casts its lifter made), and fp32 at R = 1088 and at the
  training batch's R = 4352;
- K9: the four-launch chain, block 0 and block 1 alone, and the floor build,
  at batch 64 and 128 on the 64x48x64 stem output.

``--sweep`` times the new K9 chain at each input-ring depth and at fixed
strip lengths. ``--breakdown`` builds variants of the new
``csrc/layer1_chain.cu`` with one piece cut (conv2's products, the conv1 and
conv3 epilogues, the input loads, the output stores, all of them; timing
only, wrong numbers) and times each chain at batch 64: what a piece costs is
the full build's time less the variant's.
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
    layer1_chain,
    small_attention,
)

RUNS = 50


def _load(name, path, build=None):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if build is not None:
        mod._build = build
    return mod


def _ab(label, parent_fn, new_fn, card):
    t = [cs._median_ms(fn, runs=RUNS)
         for fn in (parent_fn, new_fn, new_fn, parent_fn)]
    print(f"ab: {label}: parent {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} "
          f"/ {t[2]:.4f} ms ({card})", flush=True)


def _k3(parent, card):
    gen = torch.Generator().manual_seed(0)
    for d, rows, dtype in ((128, 1088, torch.bfloat16),
                           (64, 1088, torch.bfloat16),
                           (96, 1088, torch.bfloat16),
                           (128, 1088, torch.float32),
                           (128, 4352, torch.float32)):
        x = torch.randn(rows, 5, d, generator=gen).to("cuda", dtype)
        # fp32 parameters made outside inference mode, as the lifter holds
        # them (the new bf16 route makes its operands once)
        w = [(torch.randn(*s, generator=gen) * sc).cuda() for s, sc in (
            ((d, 3 * d), d ** -0.5), ((3 * d,), 0.1), ((d, d), d ** -0.5),
            ((d,), 0.1))]
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


def _breakdown(card):
    out = ROOT / "build" / "k9_variants"
    src_dir = out / "src"
    src_dir.mkdir(parents=True, exist_ok=True)
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
    (src_dir / "layer1_chain.cu").write_text("\n".join(cut))
    for name in ("common.cuh", "hopper.cuh", "errors.cu"):
        shutil.copy(_build.CSRC / name, src_dir / name)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
         *(f"-D{m}" for m in macros), "-I", str(src_dir), "-o",
         str(out / f"{name}.so"), str(src_dir / "layer1_chain.cu"),
         str(src_dir / "errors.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn in ("capf_layer1_block", "capf_layer1_block_floor",
                   "capf_error_string"):
            f = getattr(lib, fn)
            f.restype, f.argtypes = _build.SIGNATURES[fn]
        libs[name] = lib

    class Build:  # the port's _build with a variant's library
        def __init__(self, lib):
            self.lib = lib

        def library(self):
            return self.lib

        def __getattr__(self, key):
            return getattr(_build, key)

    x, blocks, amax = _k9_inputs(64)
    with torch.inference_mode():
        for name, lib in libs.items():
            layer1_chain._build = Build(lib)
            ms = cs._median_ms(
                lambda: layer1_chain.layer1_chain_kernel(x, amax, blocks),
                runs=RUNS)
            print(f"breakdown: K9 chain b=64, {name}: {ms:.4f} ms ({card})",
                  flush=True)
    layer1_chain._build = _build


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a directory holding the other commit's "
                         "contextaware_poseformer_tpu_torch/ops")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    serve.configure_numerics()
    _build.library()
    if args.parent is not None:
        ops = args.parent.resolve() / "contextaware_poseformer_tpu_torch" / \
            "ops"
        pbuild = _load("parent_build", ops / "_build.py")
        pbuild.library()
        _k3(_load("parent_small_attention", ops / "small_attention.py",
                  pbuild), card)
        _k9(_load("parent_layer1_chain", ops / "layer1_chain.py", pbuild),
            card)
    if args.sweep:
        _sweep(card)
    if args.breakdown:
        _breakdown(card)


if __name__ == "__main__":
    main()
