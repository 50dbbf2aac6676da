"""What bounds K2's fp32 two-phase GEMM on the card: its inner loop alone,
its staging alone, and each phase at candidate tiles.

    python3 tools/torch_fp32_tiles.py [--loop] [--staging] [--sweep 640 480]

Run from the repository root on a machine with an NVIDIA GPU and nvcc.

- ``--loop``: the share of the SMs' fp32 FMA peak (132 SMs x 128 FMAs a
  cycle at 1.98 GHz) that ``f32_tile.cuh``'s ``fma_slice`` reaches on its
  own: each block repeats a K = 32 slice on operands resident in shared
  memory, a barrier a slice, at the micro-tiles (TM x TN) and thread
  groups (RG x CG) the plan chooses among, one or more blocks an SM; and
  the SM clock the blocks saw (``clock64`` over the elapsed time). These
  shares are ``fused_mlp._GEMM_MICRO``'s (8 x 8's lowered to what it
  reaches in the kernel).
- ``--staging``: the rate of the GEMM's staging pattern alone (the A and B
  K-slices of a joint-shape phase through a 3-slot cp.async ring, no
  products), in TB/s from L2.
- ``--sweep D ...``: K2's fp32 two-phase call at width D (1088 rows, batch
  64) with each phase's tile forced to each candidate (``gemm_tile``
  replaced), the LN and both phases' device ms under torch.profiler, the
  plan's own choice first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from contextaware_poseformer_tpu_torch.ops import _build, fused_mlp  # noqa: E402

OUT = ROOT / "build" / "fp32_tiles"
ROWS = 1088  # the joint blocks' rows at batch 64

LOOP = r"""
#include <cstdio>
#include "f32_tile.cuh"
using namespace capf::f32;

template <int TM, int TN>
__global__ void loop(float* out, int iters, int rg, int cg,
                     long long* cycles) {
  const long long t0 = clock64();
  extern __shared__ __align__(16) float sm[];
  const int bm = rg * TM, bn = cg * TN;
  float* B = sm + bm * 36;
  for (int i = threadIdx.x; i < bm * 36 + 32 * bn; i += blockDim.x)
    sm[i] = 1e-3f * (i % 97);
  __syncthreads();
  const Place pl = place(rg, cg);
  float acc[TM][TN];
  zero(acc);
  for (int it = 0; it < iters; ++it) {
    __syncthreads();
    fma_slice<TM, TN, 32>(acc, sm + pl.tr * 36, rg * 36, B + pl.tc * 4, bn,
                          bn / 2);
  }
  float s = 0;
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = clock64() - t0;
}

template <int TM, int TN>
void run(float* out, long long* cyc, int rg, int cg, int per_sm) {
  const int bm = rg * TM, bn = cg * TN, blocks = 132 * per_sm;
  const int smem = 4 * (bm * 36 + 32 * bn), iters = 400;
  cudaFuncSetAttribute(loop<TM, TN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  loop<TM, TN><<<blocks, rg * cg, smem>>>(out, 4, rg, cg, cyc);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  loop<TM, TN><<<blocks, rg * cg, smem>>>(out, iters, rg, cg, cyc);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  long long c;
  cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  const double fmas = double(blocks) * rg * cg * TM * TN * 32.0 * iters;
  printf("loop: %dx%d micro-tile, %d x %d threads, %d block(s) an SM: %.1f%%"
         " of the FMA peak, SM clock %.0f MHz\n", TM, TN, rg, cg, per_sm,
         100.0 * fmas / (ms * 1e-3) / (132 * 128 * 1.98e9), c / (ms * 1e3));
}

int main() {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 4 << 20);
  cudaMalloc(&cyc, 8);
  run<4, 4>(out, cyc, 16, 24, 1);
  run<4, 4>(out, cyc, 17, 20, 1);
  run<4, 8>(out, cyc, 24, 16, 1);
  run<4, 8>(out, cyc, 17, 20, 1);
  run<4, 8>(out, cyc, 17, 10, 1);
  run<4, 8>(out, cyc, 16, 8, 3);
  run<8, 4>(out, cyc, 16, 24, 1);
  run<8, 4>(out, cyc, 17, 20, 1);
  run<8, 8>(out, cyc, 16, 16, 1);
  run<8, 8>(out, cyc, 17, 10, 1);
  run<6, 8>(out, cyc, 8, 48, 1);
  printf("loop: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""

STAGING = r"""
#include <cstdio>
#include "f32_tile.cuh"
using namespace capf::f32;
using namespace capf::sm90;

__global__ void stage(const float* A, const float* B, int rows, int k, int n,
                      int bm, int bn, int split, float* out) {
  extern __shared__ __align__(16) float sm[];
  const int slot_a = bm * 36, slot = slot_a + 32 * bn;
  const int n0 = blockIdx.x * bn, m0 = blockIdx.y * bm;
  const int per = k / 32 / split, s0 = blockIdx.z * per;
  auto issue = [&](int s) {
    if (s < per) {
      float* ring = sm + (s % 3) * slot;
      const int k0 = (s0 + s) * 32;
      copy_block(ring, 36, A, k, m0, k0, walk(bm, 8), rows, k / 4);
      copy_block(ring + slot_a, bn, B, n, k0, n0, walk(32, bn / 4), k,
                 n / 4);
    }
    cp_async_commit();
  };
  float acc = 0;
  issue(0);
  issue(1);
  for (int s = 0; s < per; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    issue(s + 2);
    acc += sm[(s % 3) * slot + threadIdx.x];
  }
  out[threadIdx.x] = acc;
}

void run(const float* A, const float* B, float* out, int rows, int k, int n,
         int bm, int bn, int threads, int split) {
  const int smem = 4 * 3 * (bm * 36 + 32 * bn);
  cudaFuncSetAttribute(stage, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((n + bn - 1) / bn, (rows + bm - 1) / bm, split);
  stage<<<grid, threads, smem>>>(A, B, rows, k, n, bm, bn, split, out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 10; ++r)
    stage<<<grid, threads, smem>>>(A, B, rows, k, n, bm, bn, split, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  ms /= 10;
  const double bytes = double(grid.x) * grid.y * k * (bm + bn) * 4.0;
  printf("staging: %d x %d x %d (rows x cols x K), %d x %d tiles, K in %d: "
         "%.4f ms, %.0f MB, %.2f TB/s\n", rows, n, k, bm, bn, split, ms,
         bytes / 1e6, bytes / ms / 1e9);
}

int main() {
  float *A, *B, *out;
  cudaMalloc(&A, 1088 * 1280 * 4);
  cudaMalloc(&B, 1280 * 1280 * 4);
  cudaMalloc(&out, 4096);
  cudaMemset(A, 0, 1088 * 1280 * 4);
  cudaMemset(B, 0, 1280 * 1280 * 4);
  run(A, B, out, 1088, 640, 1280, 136, 80, 340, 1);  // phase 1, joint
  run(A, B, out, 1088, 1280, 640, 136, 80, 340, 2);  // phase 2, joint
  run(A, B, out, 1088, 640, 1280, 64, 64, 128, 1);
  printf("staging: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""

# the sweep's candidates (TM, TN, RG, CG, split), beside the plan's own
CANDIDATES = ((4, 8, 16, 8, 1), (8, 4, 16, 8, 1), (4, 8, 17, 20, 1),
              (8, 4, 17, 20, 1), (4, 4, 17, 20, 1), (4, 4, 16, 16, 1),
              (8, 4, 8, 16, 1), (8, 8, 16, 16, 1), (4, 4, 16, 8, 1),
              (8, 4, 17, 20, 2), (4, 4, 16, 8, 2), (8, 4, 16, 8, 2),
              (4, 4, 17, 20, 2), (4, 8, 17, 10, 2), (8, 8, 17, 10, 2))


def _bench(name, source, card):
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / f"{name}.cu", OUT / name
    src.write_text(source)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:4], "-I",
                    str(_build.CSRC), "-o", str(exe), str(src)], check=True)
    text = subprocess.run([str(exe)], capture_output=True, text=True,
                          check=True).stdout
    for line in text.splitlines():
        print(f"{line} ({card})", flush=True)


def _phase_ms(x, p, n=30):
    """{ln, p1, p2}: device ms of one K2 call's launches (torch.profiler)."""
    for _ in range(3):
        fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fused_mlp.ln_mlp_residual_kernel(x, *p, 1e-6)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kind = ("ln" if "ln_rows" in e.key else
                    "p2" if "true>" in e.key else "p1")
            out[kind] = e.self_device_time_total / n / 1e3
    return out


def _sweep(d, card):
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_kernel_ab as ab

    x, p = ab._k2_operands(ROWS, d)
    plan = fused_mlp.plan(torch.float32, d, 2 * d, ROWS)
    dp, hp = fused_mlp.f32_workspaces(d, 2 * d)
    chosen = fused_mlp.gemm_tile
    with torch.inference_mode():
        t = _phase_ms(x, p)
        print(f"sweep: D={d} the plan's tiles {plan.tiles[:5]} "
              f"{plan.tiles[5:]}: ln {t['ln']:.4f}, phase 1 {t['p1']:.4f}, "
              f"phase 2 {t['p2']:.4f} ms ({card})", flush=True)
        for phase, cols in ((1, hp), (2, d)):
            for tile in CANDIDATES:
                def forced(rows, c, k, tile=tile, phase_cols=cols):
                    return tile if c == phase_cols else chosen(rows, c, k)
                fused_mlp.gemm_tile = forced
                try:
                    t = _phase_ms(x, p)
                finally:
                    fused_mlp.gemm_tile = chosen
                print(f"sweep: D={d} phase {phase} tile {tile}: "
                      f"{t[f'p{phase}']:.4f} ms ({card})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--staging", action="store_true")
    ap.add_argument("--sweep", type=int, nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fp32_tiles: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.loop:
        _bench("loop", LOOP, card)
    if args.staging:
        _bench("staging", STAGING, card)
    for d in args.sweep:
        _sweep(d, card)


if __name__ == "__main__":
    main()
