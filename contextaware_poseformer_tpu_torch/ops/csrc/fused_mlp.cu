// K2: fused LayerNorm -> fc1 -> exact-erf GELU -> fc2 -> residual add.
//
// Replaces contextaware_poseformer_tpu/ops/fused_mlp.py::_kernel (entry
// ln_mlp_residual): y = x + fc2(gelu(fc1(LN(x)))) per row, LN statistics with
// the fast variance E[x^2] - mu^2 and the residual add in fp32, the matmul
// operands in the call's dtype with fp32 accumulation; in bf16 the LN output
// and the GELU output are rounded to bf16 before the product that reads them.
//
// What bounds it on the H100: 4*D*H MACs a row against 4*D bytes of row
// traffic (bf16), so with the (rows, H) hidden kept on chip or in L2 the
// lifter's calls (1088 to 5440 rows at D = 64..640, H = 2D) need 0.4-3.6 GFLOP
// and 1.5-9 MB: a few microseconds at the bf16 tensor-core rate. What costs
// more is reading W1 and W2 (64 KB to 3.3 MB in bf16) from L2 once for every
// small row tile, the weights' per-call cast, and idle SMs. The bf16 routes
// are built on Hopper's asynchronous machinery (hopper.cuh): wgmma m64nNk16
// from 128-byte-swizzled K-major operands in shared memory, the weights by
// TMA, fp32 accumulators in registers. The wrapper (ops/fused_mlp.py) hands
// the weights over as bf16 W1^T (H, D) and W2^T (D, H), K-major for wgmma,
// cast once per parameter state.
//
// A row tile is 64 rows, wgmma's M, so the lifter's calls have only 17 to
// 85 of them: a tile's latency, not the card's throughput, sets the time.
// Two warpgroups share each tile (the LN and the exact-erf GELU epilogue
// run on CUDA cores), and every load of a step is in flight at once.
// ops/fused_mlp.py::plan picks the route from D and the shared-memory
// budget:
//
// - weights-resident (route 1; D = 64, 96, 128 with H = 2D: the context and
//   res blocks, 3DHP's 64 and 96): a persistent kernel, one block an SM,
//   min(SMs, row tiles) blocks. Each block loads W1^T and W2^T into shared
//   memory ONCE by TMA (128 KB at D = 128), then walks 64-row tiles, the
//   next tile's x arriving by cp.async while the current one runs: LN in
//   registers -> bf16 A (swizzled) -> fc1 in 64-column tiles by wgmma, the
//   warpgroups taking alternate tiles -> bias + GELU in registers -> bf16
//   hidden (swizzled) -> fc2, each warpgroup half of D's columns -> bias +
//   fp32 residual, written over the x tile in place -> 16-byte stores.
// - two-phase (route 2; any other D and H that are multiples of 16: the
//   joint blocks at D = 640, 3DHP's 320 and 480): W1 and W2 (3.3 MB at
//   D = 640) fit no block, so a call is two launches.
//   Phase 1, a block a (64-row tile, kBN1 hidden columns, half of them a
//   warpgroup): the tile's x rows land by cp.async in the swizzled bf16 A
//   operand (80 KB at D = 640) while the first W1^T chunks arrive through
//   a TMA ring of 4 stages; the LN runs there in place; fc1 by wgmma;
//   bias + GELU, rounded to bf16 into the (rows, H) hidden workspace (2.8
//   MB at the joint shape, which stays in L2). The block's fixed cost (x,
//   LN) is most of its time, so ops/fused_mlp.py::plan takes kBN1 = 256
//   from D = 480 on (one wave of blocks at the joint shape, half the LN
//   work: 51 -> 30 us at D = 640 on an H100 80GB HBM3) and 128 below
//   (D = 320's 85 blocks fill one wave already; 256 was slower there).
//   Phase 2, a block a (64-row tile, 64 output columns): hidden and W2^T
//   chunks through the same kind of ring (zero fill past H), fc2 by wgmma
//   m64n64k16, then bias + fp32 residual and 16-byte stores.
//   The grid runs column tiles fastest, so the blocks that share a row
//   tile run together and read it from L2 while it is hot.
// - fp32 (routes 0 and 3: the lifter served in fp32, parity runs): exact
//   fp32 FMAs on the CUDA cores (no TF32), register-tiled (f32_tile.cuh):
//   a thread owns a micro-tile of TM rows x 4 or 8 columns, fed by 16-byte
//   shared loads (TM + TN of them for 4 * TM * TN FMAs), the operands'
//   K-slices arriving by cp.async through a ring of 3 slots while the
//   previous slice is multiplied. The weights are read as the model holds
//   them, (D, H) and (H, D) row-major: a K-slice of either is contiguous.
//   At 4*D*H FMAs a row against 67 TFLOP/s, fp32 is bound by operations
//   (0.053 ms at the joint shape, 1088 x 640). On an H100 80GB HBM3 this
//   loop, as nvcc schedules it, reaches 52-68% of that rate alone (4 x 4
//   to 8 x 8 micro-tiles, 8 warps an SM; fewer warps, less), and the
//   problem is small: the joint call's 1.4 M phase-1 outputs fill 132 SMs
//   with 8 warps only at 8 x 4 (PERF.md, section 6).
//   Route 0 (fused, one launch; H = 2D, D a multiple of 16 up to 128, 2D
//   threads a block: D = 64, 96, 128 and the gate's 32): a block owns
//   kBM = 8 * TM rows (TM = 4, 5 or 6; ops/fused_mlp.py::plan picks the
//   one that puts the fewest rows on the busiest SM, 48 at 5440 rows and
//   40 at 4352: one wave) and keeps them whole: x by cp.async, the LN
//   (statistics once a row) into a second tile, fc1 at the full width H
//   with TN = 8, bias + GELU into a hidden tile in shared memory, fc2
//   with TN = 4 from it, then b2 and the residual from the x tile.
//   Route 3 (two-phase, three launches; any D and H divisible by 4): the
//   LN of every row, once, into an fp32 (rows, Dp) workspace (a warp a
//   row); phase 1 (LN(x) W1 + b1, GELU, into the fp32 (rows, Hp) hidden
//   workspace: 5.6 MB at the joint shape, which stays in L2) and phase 2
//   (hidden W2 + b2 + x) are one GEMM kernel whose tile each launch
//   chooses (ops/fused_mlp.py::gemm_tile, by the busiest SM's cycles: a
//   micro-tile of 4 or 8 x 4 or 8 and row and column groups of any count,
//   so that 17-row multiples fill one wave: 136 x 80 tiles, 128 blocks, at
//   the joint shape), optionally with K in two parts (the last part of a
//   tile to finish, by a counter, adds both and runs the epilogue:
//   deterministic, as an fp32 sum of two is).

// Every ring and operand region starts on a 1024-byte boundary, as the
// swizzle needs. A wait on a TMA barrier traps after ~2^28 polls, so a
// fault fails the launch instead of hanging the card.

#include "common.cuh"
#include "f32_tile.cuh"
#include "hopper.cuh"

extern "C" {
struct CapfMlpArgs {  // mirrored by ops/fused_mlp.py::_Args
  const void* x;          // (rows, D) in the call's dtype
  const float* ln_scale;  // (D,)
  const float* ln_bias;   // (D,)
  const void* w1;         // fp32 (D, H); bf16 W1^T (H, D)
  const float* b1;        // (H,)
  const void* w2;         // fp32 (H, D); bf16 W2^T (D, H)
  const float* b2;        // (D,)
  void* hidden;           // route 2: the (rows, H) bf16 workspace;
                          // route 3: the fp32 (rows, Hp) one
  void* out;              // (rows, D)
  int rows, d, hdim;
  float eps;
  int dtype, route;       // route: 0 fp32 fused, 1 weights-resident,
                          // 2 two-phase, 3 fp32 two-phase
  int tile1;              // route 2: phase 1's hidden columns a block;
                          // route 0: rows a block
  void* normed;           // route 3: the fp32 (rows, Dp) LN workspace
  int gemm1[5], gemm2[5];  // route 3: each phase's (TM, TN, RG, CG, split)
  void* partial;          // route 3: (2, rows, max(Hp, D)) fp32 K-halves
  int* count;             // route 3: a counter a split tile, zeroed by
                          // launch 1
};
}  // extern "C"

namespace {

using namespace capf::sm90;
using bf16 = __nv_bfloat16;

constexpr int kWg = 128;             // threads of a warpgroup
constexpr int kWgs = 2;              // bf16 routes (but phase 2): warpgroups
constexpr int kTcThreads = kWgs * kWg;
constexpr int kBM = 64;              // rows of a tile: wgmma's M
constexpr int kChunk = kSwizzleRow;  // bytes of K in a swizzled chunk
constexpr int kChunkElems = kChunk / 2;  // 64 bf16
constexpr int kATile = kBM * kChunk;     // one 64-row chunk of A: 8 KB
constexpr int kStages = 4;               // route 2: the TMA ring's depth
constexpr int kBN2 = 64;                 // route 2 phase 2: output columns
constexpr int kAlign = 1024;

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.f + erff(a * 0.70710678118654752f));
}

// ---- fp32 (routes 0 and 3) -------------------------------------------------

using capf::f32::copy_block;
using capf::f32::copy_pieces;
using capf::f32::fma_slice;
constexpr int kF32Stages = capf::f32::kStages;

constexpr int kF32MaxThreads = 256;  // route 0: 2D threads a block
constexpr int kFusedRG = 8;          // route 0: row groups (D / 4 columns)
constexpr int kFusedBK = 16;         // route 0: K a slice
constexpr int kGemmBK = 32;          // route 3: K a slice

// ops/fused_mlp.py mirrors these three: route 0's x, LN(x) and hidden
// tiles and its ring of W1 / W2 slices; route 3's ring of A and B slices
// (a tile of bm x bn); route 3's padded widths (its workspaces' row
// pitches: K-slices of 32)
__host__ __device__ constexpr int f32_fused_smem(int bm, int d, int h) {
  return 4 * (2 * bm * (d + 4) + bm * (h + 4) + kF32Stages * kFusedBK * h);
}
__host__ __device__ constexpr int f32_gemm_smem(int bm, int bn) {
  return 4 * kF32Stages * (bm * (kGemmBK + 4) + kGemmBK * bn);
}
__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The LayerNorm of one row of d values (d % 4 == 0) by one warp, with the
// fast variance E[x^2] - mu^2: dst[k] = (x[k] - mu) * rstd * scale[k] +
// bias[k], four values a lane at a time.
__device__ __forceinline__ void ln_row(const float* xr, float* dst, int d,
                                       const float* scale, const float* bias,
                                       float eps) {
  const int lane = threadIdx.x % 32;
  float s = 0.f, ss = 0.f;
  for (int k = 4 * lane; k < d; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + k);
    s += (v.x + v.y) + (v.z + v.w);
    ss += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
  s = capf::warp_sum(s);
  ss = capf::warp_sum(ss);
  const float mu = s / d;
  const float rstd = rsqrtf(ss / d - mu * mu + eps);
  for (int k = 4 * lane; k < d; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + k);
    const float4 g = *reinterpret_cast<const float4*>(scale + k);
    const float4 c = *reinterpret_cast<const float4*>(bias + k);
    *reinterpret_cast<float4*>(dst + k) = make_float4(
        (v.x - mu) * rstd * g.x + c.x, (v.y - mu) * rstd * g.y + c.y,
        (v.z - mu) * rstd * g.z + c.z, (v.w - mu) * rstd * g.w + c.w);
  }
}

// Route 0: a block of 2D threads owns kTileRows = 8 * TM rows. Thread
// (tr, tc) of 8 x D/4: fc1's rows tr + 8i, columns 4tc + {0..3} and H/2 + 4tc +
// {0..3}; fc2's rows the same, columns 4tc + {0..3}.
template <int TM>
__global__ void __launch_bounds__(kF32MaxThreads)
    ln_mlp_f32_fused_kernel(const CapfMlpArgs a) {
  constexpr int kTileRows = kFusedRG * TM;
  const int d = a.d, h = a.hdim;
  const capf::f32::Place pl = capf::f32::place(kFusedRG, d / 4);
  const int tr = pl.tr, tc = pl.tc;
  extern __shared__ __align__(16) float smem_f[];
  float* s_x = smem_f;                     // (rows, d + 4): x
  float* s_a = s_x + kTileRows * (d + 4);  // (rows, d + 4): LN(x)
  float* s_h = s_a + kTileRows * (d + 4);  // (rows, h + 4): GELU(fc1)
  float* ring = s_h + kTileRows * (h + 4);  // slots of kFusedBK x h
  const int m0 = blockIdx.x * kTileRows;
  const int valid = min(kTileRows, a.rows - m0);
  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);
  const int n1 = d / kFusedBK, n2 = h / kFusedBK;
  // slice s of the block's stream: W1's K-slices, then W2's
  auto issue = [&](int s) {
    float* slot = ring + (s % kF32Stages) * kFusedBK * h;
    if (s < n1) {
      copy_pieces(slot, w1 + static_cast<size_t>(s) * kFusedBK * h,
                  kFusedBK * h / 4);
    } else if (s < n1 + n2) {
      copy_pieces(slot, w2 + static_cast<size_t>(s - n1) * kFusedBK * d,
                  kFusedBK * d / 4);
    }
    cp_async_commit();
  };

  copy_block(s_x, d + 4, static_cast<const float*>(a.x), d, m0, 0,
             capf::f32::walk(kTileRows, d / 4), a.rows, d / 4);
  for (int s = 0; s < kF32Stages - 1; ++s) issue(s);
  cp_async_wait<kF32Stages - 2>();  // x (with slice 0)
  __syncthreads();
  for (int r = threadIdx.x / 32; r < kTileRows; r += blockDim.x / 32) {
    ln_row(s_x + r * (d + 4), s_a + r * (d + 4), d, a.ln_scale, a.ln_bias,
           a.eps);
  }

  float acc[TM][8];
  capf::f32::zero(acc);
  for (int s = 0; s < n1; ++s) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    issue(s + kF32Stages - 1);
    fma_slice<TM, 8, kFusedBK>(
        acc, s_a + tr * (d + 4) + s * kFusedBK, kFusedRG * (d + 4),
        ring + (s % kF32Stages) * kFusedBK * h + tc * 4, h, h / 2);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * (h / 2) + tc * 4;
      const float* v = acc[i] + 4 * half;
      *reinterpret_cast<float4*>(s_h + (tr + kFusedRG * i) * (h + 4) + c) =
          make_float4(gelu_erf(v[0] + a.b1[c]), gelu_erf(v[1] + a.b1[c + 1]),
                      gelu_erf(v[2] + a.b1[c + 2]),
                      gelu_erf(v[3] + a.b1[c + 3]));
    }
  }

  float acc2[TM][4];
  capf::f32::zero(acc2);
  for (int s = 0; s < n2; ++s) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // (the first: the hidden tile is complete)
    issue(n1 + s + kF32Stages - 1);
    fma_slice<TM, 4, kFusedBK>(
        acc2, s_h + tr * (h + 4) + s * kFusedBK, kFusedRG * (h + 4),
        ring + ((n1 + s) % kF32Stages) * kFusedBK * h + tc * 4, d, 0);
  }
  float* out = static_cast<float*>(a.out) + static_cast<size_t>(m0) * d;
  const int c = tc * 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tr + kFusedRG * i;
    if (r >= valid) continue;
    const float4 xv = *reinterpret_cast<const float4*>(s_x + r * (d + 4) + c);
    *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * d + c) =
        make_float4(xv.x + (acc2[i][0] + a.b2[c]),
                    xv.y + (acc2[i][1] + a.b2[c + 1]),
                    xv.z + (acc2[i][2] + a.b2[c + 2]),
                    xv.w + (acc2[i][3] + a.b2[c + 3]));
  }
}

// Route 3, launch 1: the LayerNorm of every row, a warp a row, into the
// (rows, dp) workspace; its columns [d, dp) are zeros.
__global__ void __launch_bounds__(256)
    ln_rows_f32_kernel(const CapfMlpArgs a, int dp, int counters) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < counters) a.count[gid] = 0;
  const int row = gid / 32;
  if (row >= a.rows) return;
  float* dst = static_cast<float*>(a.normed) + static_cast<size_t>(row) * dp;
  ln_row(static_cast<const float*>(a.x) + static_cast<size_t>(row) * a.d,
         dst, a.d, a.ln_scale, a.ln_bias, a.eps);
  for (int k = a.d + 4 * (threadIdx.x % 32); k < dp; k += 128) {
    *reinterpret_cast<float4*>(dst + k) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// A launch of route 3's GEMM: C = A (rows, k_pad; row pitch lda) x B (kb,
// n; rows past kb and columns past n read as zeros) in tiles of rg * TM
// rows x cg * TN columns (rg x cg threads), each tile's K in ``split``
// parts (grid: column tiles, row tiles, parts). Phase 1 (kResidual false):
// out = GELU(C + bias) into the hidden workspace (row pitch ldo; its
// columns past n, up to ldo, are zeros); phase 2: out = x + (C + bias) for
// the columns below n (x and out of row pitch ldo).
struct GemmArgs {
  const float* A;
  const float* B;
  const float* bias;
  const float* x;
  float* out;
  float* part;  // split > 1: (split, rows, ldo) partial sums
  int* count;   // split > 1: a counter a tile, zero at launch
  int lda, kb, n, ldo, rows, k_pad, rg, cg, split;
};

// a block's most threads: 8 x 8 micro-tiles take ~165-180 registers a
// thread; the others up to 170 (65536 / 384), which keeps them unspilled
__host__ __device__ constexpr int gemm_max_threads(int tm, int tn) {
  return tm * tn >= 64 ? 256 : 384;
}

// The epilogue of four columns (col .. col + 3) of a row: v the sums
template <bool kResidual>
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& g, int row,
                                              int col, const float* v) {
  const size_t off = static_cast<size_t>(row) * g.ldo + col;
  if constexpr (kResidual) {
    if (col >= g.n) return;
    const float4 xv = *reinterpret_cast<const float4*>(g.x + off);
    *reinterpret_cast<float4*>(g.out + off) = make_float4(
        xv.x + (v[0] + g.bias[col]), xv.y + (v[1] + g.bias[col + 1]),
        xv.z + (v[2] + g.bias[col + 2]), xv.w + (v[3] + g.bias[col + 3]));
  } else {
    if (col >= g.ldo) return;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = gelu_erf(v[e] + (col + e < g.n ? g.bias[col + e] : 0.f));
    }
    *reinterpret_cast<float4*>(g.out + off) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

// With split K, every part stores its sums; the last part of a tile to
// finish (a counter a tile) adds them, part 0 first, and runs the epilogue.
template <int TM, int TN, bool kResidual>
__global__ void __launch_bounds__(gemm_max_threads(TM, TN), 1)
    mlp_f32_gemm_kernel(const GemmArgs g) {
  const int rg = g.rg, cg = g.cg;
  const int bm = rg * TM, bn = cg * TN;
  const int slot_a = bm * (kGemmBK + 4), slot = slot_a + kGemmBK * bn;
  extern __shared__ __align__(16) float smem_f[];
  const capf::f32::Place pl = capf::f32::place(rg, cg);
  const int tr = pl.tr, tc = pl.tc;
  const int n0 = blockIdx.x * bn, m0 = blockIdx.y * bm;
  const int slices = g.k_pad / kGemmBK;
  const int per = (slices + g.split - 1) / g.split;
  const int s0 = blockIdx.z * per;
  const int nk = min(slices, s0 + per) - s0;
  auto issue = [&](int s) {
    if (s < nk) {
      float* ring = smem_f + (s % kF32Stages) * slot;
      const int k0 = (s0 + s) * kGemmBK;
      copy_block(ring, kGemmBK + 4, g.A, g.lda, m0, k0,
                 capf::f32::walk(bm, kGemmBK / 4), g.rows, g.lda / 4);
      copy_block(ring + slot_a, bn, g.B, g.n, k0, n0,
                 capf::f32::walk(kGemmBK, bn / 4), g.kb, g.n / 4);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
  capf::f32::zero(acc);
  for (int s = 0; s < kF32Stages - 1; ++s) issue(s);
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    issue(s + kF32Stages - 1);
    const float* ring = smem_f + (s % kF32Stages) * slot;
    fma_slice<TM, TN, kGemmBK>(acc, ring + tr * (kGemmBK + 4),
                               rg * (kGemmBK + 4), ring + slot_a + tc * 4,
                               bn, bn / 2);
  }
  if (g.split > 1) {
    const size_t plane = static_cast<size_t>(g.rows) * g.ldo;
    float* mine = g.part + blockIdx.z * plane;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + tr + rg * i;
#pragma unroll
      for (int half = 0; half < TN / 4; ++half) {
        const int col = n0 + half * (bn / 2) + tc * 4;
        if (row < g.rows && col < g.ldo) {
          const float* v = acc[i] + 4 * half;
          *reinterpret_cast<float4*>(mine + static_cast<size_t>(row) *
                                                g.ldo + col) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    int* count = g.count + blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(count, 1) == g.split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + tr + rg * i;
#pragma unroll
      for (int half = 0; half < TN / 4; ++half) {
        const int col = n0 + half * (bn / 2) + tc * 4;
        if (row >= g.rows || col >= g.ldo) continue;
        const size_t off = static_cast<size_t>(row) * g.ldo + col;
        float4 sum = __ldcg(reinterpret_cast<const float4*>(g.part + off));
        for (int z = 1; z < g.split; ++z) {
          const float4 p = __ldcg(
              reinterpret_cast<const float4*>(g.part + z * plane + off));
          sum = make_float4(sum.x + p.x, sum.y + p.y, sum.z + p.z,
                            sum.w + p.w);
        }
        acc[i][4 * half] = sum.x;
        acc[i][4 * half + 1] = sum.y;
        acc[i][4 * half + 2] = sum.z;
        acc[i][4 * half + 3] = sum.w;
      }
    }
    if (threadIdx.x == 0) *count = 0;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + tr + rg * i;
    if (row >= g.rows) continue;
#pragma unroll
    for (int half = 0; half < TN / 4; ++half) {
      gemm_epilogue<kResidual>(g, row, n0 + half * (bn / 2) + tc * 4,
                               acc[i] + 4 * half);
    }
  }
}

// ---- the bf16 routes ------------------------------------------------------

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + kAlign - 1) & ~uintptr_t(kAlign - 1));
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_bf16x2(void* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Element pair (k, k + 1) (k even) of row r in a swizzled K-major operand
// of 64-row chunks: chunk k / 64, its 16-byte piece, its byte in the piece.
__device__ __forceinline__ unsigned char* a_pair(unsigned char* s_a, int r,
                                                 int k) {
  const int kk = k % kChunkElems;
  return s_a + (k / kChunkElems) * kATile + sw128_offset(r, kk / 8) +
         (kk % 8) * 2;
}

// LayerNorm of a 64-row tile (d values a row; ``src(r, k)`` points at the
// bf16 pair k, k + 1 of row r; rows from ``valid`` on read as zeros) into
// the swizzled bf16 A operand, which may be the source itself: each pair is
// read and written by the same lane. A warp takes every (warps)-th row; a
// lane the pairs 2 lane + 64 i, so that a row's reads are coalesced and its
// swizzled writes hit 32 distinct banks.
template <typename Src>
__device__ __forceinline__ void ln_tile(Src src, int valid, int d,
                                        const float* scale, const float* bias,
                                        float eps, unsigned char* s_a) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += blockDim.x / 32) {
    const bool live = r < valid;
    float s = 0.f, ss = 0.f;
#pragma unroll 4
    for (int k = 2 * lane; k < d; k += 64) {
      const float2 v = live ? load_bf16x2(src(r, k)) : make_float2(0.f, 0.f);
      s += v.x + v.y;
      ss += v.x * v.x + v.y * v.y;
    }
    s = capf::warp_sum(s);
    ss = capf::warp_sum(ss);
    const float mu = s / d;
    const float rstd = rsqrtf(ss / d - mu * mu + eps);
#pragma unroll 4
    for (int k = 2 * lane; k < d; k += 64) {
      const float2 v = live ? load_bf16x2(src(r, k)) : make_float2(0.f, 0.f);
      store_bf16x2(a_pair(s_a, r, k),
                   (v.x - mu) * rstd * scale[k] + bias[k],
                   (v.y - mu) * rstd * scale[k + 1] + bias[k + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// The accumulator layout of wgmma m64nNk16 (hopper.cuh): thread t of a
// warpgroup holds, for each 8 columns j, columns 8j + 2(t%4) + {0, 1} of
// rows 16(t/32) + (t%32)/4 (acc[4j], acc[4j+1]) and 8 rows further down
// (acc[4j+2], acc[4j+3]).
struct AccPos {
  int row, col;
  __device__ __forceinline__ AccPos()
      : row(16 * (threadIdx.x % kWg / 32) + (threadIdx.x % 32) / 4),
        col(2 * (threadIdx.x % 4)) {}
};

// The shared memory of the weights-resident route at width D, H = 2D:
// W1^T and W2^T (swizzled, K-major), the LN and hidden operands, two x
// tiles (row-major, rows padded by 8 values so that the epilogue's
// accumulator-layout accesses hit distinct banks), the biases and LN
// parameters, two barriers.
// ops/fused_mlp.py::_resident_smem mirrors kSmem.
template <int D, int H>
struct Resident {
  static constexpr int kKc1 = (D + kChunkElems - 1) / kChunkElems;
  static constexpr int kKc2 = H / kChunkElems;
  static constexpr int kW1 = kKc1 * H * kChunk;
  static constexpr int kW2 = kKc2 * D * kChunk;
  static constexpr int kA = kKc1 * kATile;
  static constexpr int kHid = kKc2 * kATile;
  static constexpr int kXPitch = D + 8;
  static constexpr int kX = kBM * kXPitch * 2;
  static constexpr int kVecs = (H + 3 * D) * 4;
  static constexpr int kSmem =
      kAlign + kW1 + kW2 + kA + kHid + 2 * kX + kVecs + 2 * 8;
  static constexpr int kN2 = D / kWgs;  // fc2's columns a warpgroup
  static_assert(D % 16 == 0 && H % kChunkElems == 0 && H <= 256 &&
                    D <= 256 && kN2 % 16 == 0,
                "widths the wgmma and TMA box sizes take");
  static_assert(kSmem <= 232448, "fits one block's shared memory");
};

// x rows [tile * 64, tile * 64 + 64) into a row-major tile of row pitch
// D + 8 by 16-byte cp.asyncs; rows past the end are zero-filled (src-size 0)
template <int D>
__device__ __forceinline__ void load_x_tile(const bf16* x, int rows,
                                            int tile, bf16* dst) {
  constexpr int kPieces = D / 8;
  for (int i = threadIdx.x; i < kBM * kPieces; i += kTcThreads) {
    const int r = i / kPieces;
    const int row = tile * kBM + r;
    const bool in = row < rows;
    const bf16* src = in ? x + static_cast<size_t>(row) * D +
                               (i - r * kPieces) * 8
                         : x;
    cp_async16(dst + r * (D + 8) + (i - r * kPieces) * 8, src, in ? 16 : 0);
  }
}

template <int D, int H>
__global__ void __launch_bounds__(kTcThreads, 1)
    ln_mlp_resident_kernel(const __grid_constant__ CUtensorMap w1map,
                           const __grid_constant__ CUtensorMap w2map,
                           const CapfMlpArgs a) {
  using L = Resident<D, H>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* s_w1 = align_smem(smem_raw);
  unsigned char* s_w2 = s_w1 + L::kW1;
  unsigned char* s_a = s_w2 + L::kW2;
  unsigned char* s_hid = s_a + L::kA;
  bf16* s_x = reinterpret_cast<bf16*>(s_hid + L::kHid);  // two x tiles
  float* s_b1 = reinterpret_cast<float*>(s_x + 2 * kBM * L::kXPitch);
  float* s_b2 = s_b1 + H;
  float* s_ls = s_b2 + D;
  float* s_lb = s_ls + D;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_lb + D);  // W1, W2

  const int tid = threadIdx.x;
  const int wg = tid / kWg;
  const int tiles = (a.rows + kBM - 1) / kBM;
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* out = static_cast<bf16*>(a.out);

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // the weights, once: every chunk of K, all rows a box
    mbar_arrive_expect_tx(&bars[0], L::kW1);
    for (int c = 0; c < L::kKc1; ++c) {
      tma_load_2d(s_w1 + c * H * kChunk, &w1map, c * kChunk, 0, &bars[0]);
    }
    mbar_arrive_expect_tx(&bars[1], L::kW2);
    for (int c = 0; c < L::kKc2; ++c) {
      tma_load_2d(s_w2 + c * D * kChunk, &w2map, c * kChunk, 0, &bars[1]);
    }
  }
  for (int i = tid; i < H; i += kTcThreads) s_b1[i] = a.b1[i];
  for (int i = tid; i < D; i += kTcThreads) {
    s_b2[i] = a.b2[i];
    s_ls[i] = a.ln_scale[i];
    s_lb[i] = a.ln_bias[i];
  }

  const AccPos pos;
  int tile = blockIdx.x;
  load_x_tile<D>(x, a.rows, tile, s_x);
  cp_async_commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles) {
      load_x_tile<D>(x, a.rows, next, s_x + (buf ^ 1) * kBM * L::kXPitch);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's pieces have landed
    __syncthreads();     // ... everyone's (and the vectors above)
    bf16* xt = s_x + buf * kBM * L::kXPitch;

    ln_tile([&](int r, int k) { return xt + r * L::kXPitch + k; },
            a.rows - tile * kBM, D, s_ls, s_lb, a.eps, s_a);
    fence_proxy_async();
    __syncthreads();
    mbar_wait(&bars[0], 0);

    // fc1 + bias + GELU, 64 hidden columns (one K chunk of fc2) at a time,
    // the warpgroups taking alternate column tiles
#pragma unroll 1
    for (int nt = wg; nt < H / kChunkElems; nt += kWgs) {
      float acc[32];
      zero(acc);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_bf16<64>(
            acc, sw128_desc(s_a + (ks / 4) * kATile + (ks % 4) * 32),
            sw128_desc(s_w1 + (ks / 4) * H * kChunk + nt * 64 * kChunk +
                       (ks % 4) * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      unsigned char* hid = s_hid + nt * kATile;
      const float* b1 = s_b1 + nt * kChunkElems;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + pos.col;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = pos.row + 8 * h;
          store_bf16x2(hid + sw128_offset(r, j) + pos.col * 2,
                       gelu_erf(acc[4 * j + 2 * h] + b1[c]),
                       gelu_erf(acc[4 * j + 2 * h + 1] + b1[c + 1]));
        }
      }
    }
    fence_proxy_async();
    __syncthreads();
    mbar_wait(&bars[1], 0);

    // fc2, each warpgroup kN2 of the D output columns
    constexpr int kN2 = L::kN2;
    float acc[kN2 / 2];
    zero(acc);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < H / 16; ++ks) {
      wgmma_bf16<kN2>(
          acc, sw128_desc(s_hid + (ks / 4) * kATile + (ks % 4) * 32),
          sw128_desc(s_w2 + (ks / 4) * D * kChunk + wg * kN2 * kChunk +
                     (ks % 4) * 32));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // bias and the fp32 residual, written over the x tile in place (each
    // element by the thread that reads it), then 16-byte stores
#pragma unroll
    for (int j = 0; j < kN2 / 8; ++j) {
      const int c = wg * kN2 + 8 * j + pos.col;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* p = xt + (pos.row + 8 * h) * L::kXPitch + c;
        const float2 xv = load_bf16x2(p);
        store_bf16x2(p, xv.x + (acc[4 * j + 2 * h] + s_b2[c]),
                     xv.y + (acc[4 * j + 2 * h + 1] + s_b2[c + 1]));
      }
    }
    __syncthreads();
    constexpr int kPieces = D / 8;
    for (int i = tid; i < kBM * kPieces; i += kTcThreads) {
      const int r = i / kPieces;
      const int row = tile * kBM + r;
      if (row < a.rows) {
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * D +
                                  (i - r * kPieces) * 8) =
            *reinterpret_cast<const uint4*>(xt + r * L::kXPitch +
                                            (i - r * kPieces) * 8);
      }
    }
    __syncthreads();  // the tile's buffer is refilled two tiles on
  }
}

// ---- route 2, phase 1: LN + fc1 + GELU into the hidden workspace ----------

// the ring's bytes (at least the staged bf16 output tile, which reuses it)
__host__ __device__ constexpr int phase1_ring(int bn1, int stages) {
  return stages * bn1 * kChunk > kBM * (bn1 + 8) * 2
             ? stages * bn1 * kChunk
             : kBM * (bn1 + 8) * 2;
}
__host__ __device__ constexpr int phase2_ring(int stages) {
  return stages * (kBM + kBN2) * kChunk > kBM * (kBN2 + 8) * 4
             ? stages * (kBM + kBN2) * kChunk
             : kBM * (kBN2 + 8) * 4;
}
__host__ __device__ constexpr int ring_stages(int chunks) {
  return chunks < kStages ? chunks : kStages;
}
// ops/fused_mlp.py::_two_phase_smem mirrors these two: phase 1 holds the
// A operand, the ring, the barriers and the LN parameters
__host__ __device__ constexpr int phase1_smem(int bn1, int d) {
  return kAlign + ((d + kChunkElems - 1) / kChunkElems) * kATile +
         phase1_ring(bn1, ring_stages((d + kChunkElems - 1) / kChunkElems)) +
         kStages * 8 + 2 * d * 4;
}
__host__ __device__ constexpr int phase2_smem(int hdim) {
  return kAlign + phase2_ring(ring_stages((hdim + kChunkElems - 1) /
                                          kChunkElems)) +
         kStages * 8;
}

// Grid: (hidden column tiles of kBN1, row tiles of 64). Warpgroup g takes
// the tile's columns kBN1 / 2 * g and the next kBN1 / 2. kBN1 (128 or 256)
// comes from ops/fused_mlp.py::plan.
template <int kBN1>
__global__ void __launch_bounds__(kTcThreads)
    ln_fc1_kernel(const __grid_constant__ CUtensorMap w1map,
                  const CapfMlpArgs a) {
  const int n0 = blockIdx.x * kBN1;
  const int m0 = blockIdx.y * kBM;
  const int chunks = (a.d + kChunkElems - 1) / kChunkElems;
  const int stages = ring_stages(chunks);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* s_a = align_smem(smem_raw);
  unsigned char* ring = s_a + chunks * kATile;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + phase1_ring(kBN1, stages));
  float* s_ls = reinterpret_cast<float*>(full + kStages);
  float* s_lb = s_ls + a.d;
  const int tid = threadIdx.x;
  const int wg = tid / kWg;
  constexpr int kStage = kBN1 * kChunk;
  constexpr int kN = kBN1 / kWgs;  // a warpgroup's columns

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // W1^T's first chunks arrive while the rows are normed
    for (int s = 0; s < stages; ++s) {
      mbar_arrive_expect_tx(&full[s], kStage);
      tma_load_2d(ring + s * kStage, &w1map, s * kChunk, n0, &full[s]);
    }
  }
  // the tile's x rows into the A operand's swizzled slots, every 16-byte
  // piece in flight at once (rows past the end: zeros); then the LN in place
  const bf16* x = static_cast<const bf16*>(a.x);
  const int pieces = a.d / 8;
  for (int i = tid; i < kBM * pieces; i += kTcThreads) {
    const int r = i / pieces;
    const int k8 = i - r * pieces;
    const bool in = m0 + r < a.rows;
    cp_async16(s_a + (k8 / 8) * kATile + sw128_offset(r, k8 % 8),
               in ? x + static_cast<size_t>(m0 + r) * a.d + k8 * 8 : x,
               in ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < a.d; i += kTcThreads) {
    s_ls[i] = a.ln_scale[i];
    s_lb[i] = a.ln_bias[i];
  }
  cp_async_wait<0>();
  __syncthreads();
  ln_tile([&](int r, int k) { return reinterpret_cast<const bf16*>(
                                  a_pair(s_a, r, k)); },
          a.rows - m0, a.d, s_ls, s_lb, a.eps, s_a);
  fence_proxy_async();
  __syncthreads();

  float acc[kN / 2];
  zero(acc);
  for (int kt = 0; kt < chunks; ++kt) {
    const int s = kt % stages;
    mbar_wait(&full[s], (kt / stages) & 1);
    const int steps = min(4, (a.d - kt * kChunkElems) / 16);
    const unsigned char* sa = s_a + kt * kATile;
    const unsigned char* sb = ring + s * kStage;
    fence_regs(acc);
    wgmma_fence();
    for (int k = 0; k < steps; ++k) {
      wgmma_bf16<kN>(acc, sw128_desc(sa + 32 * k),
                     sw128_desc(sb + wg * kN * kChunk + 32 * k));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done with its stage
    fence_regs(acc);
    __syncthreads();  // ... in both warpgroups
    const int refill = kt - 1 + stages;
    if (tid == 0 && kt > 0 && refill < chunks) {
      const int ps = (kt - 1) % stages;
      mbar_arrive_expect_tx(&full[ps], kStage);
      tma_load_2d(ring + ps * kStage, &w1map, refill * kChunk, n0, &full[ps]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();  // every product is done with the ring

  // bias + GELU, rounded to bf16, staged row-major in the ring, then
  // 16-byte stores of the rows and columns inside (rows, H)
  const AccPos pos;
  bf16* tile = reinterpret_cast<bf16*>(ring);
  constexpr int kPitch = kBN1 + 8;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int c = wg * kN + 8 * j + pos.col;
    const float b0 = n0 + c < a.hdim ? a.b1[n0 + c] : 0.f;
    const float b1 = n0 + c + 1 < a.hdim ? a.b1[n0 + c + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      store_bf16x2(tile + (pos.row + 8 * h) * kPitch + c,
                   gelu_erf(acc[4 * j + 2 * h] + b0),
                   gelu_erf(acc[4 * j + 2 * h + 1] + b1));
    }
  }
  __syncthreads();
  bf16* hidden = static_cast<bf16*>(a.hidden);
  constexpr int kPieces = kBN1 / 8;
  for (int i = tid; i < kBM * kPieces; i += kTcThreads) {
    const int r = i / kPieces;
    const int c = (i - r * kPieces) * 8;
    if (m0 + r < a.rows && n0 + c < a.hdim) {  // H % 8 == 0
      *reinterpret_cast<uint4*>(hidden + static_cast<size_t>(m0 + r) * a.hdim +
                                n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * kPitch + c);
    }
  }
}

// ---- route 2, phase 2: fc2 + bias + residual ---------------------------------

// Grid: (output column tiles of kBN2, row tiles of 64). A stage holds a
// 128-byte K chunk of 64 hidden rows (A) and of 64 W2^T rows (B); TMA
// zero-fills K past H and rows past the ends.
__global__ void __launch_bounds__(kWg)
    fc2_residual_kernel(const __grid_constant__ CUtensorMap hmap,
                        const __grid_constant__ CUtensorMap w2map,
                        const CapfMlpArgs a) {
  const int n0 = blockIdx.x * kBN2;
  const int m0 = blockIdx.y * kBM;
  const int chunks = (a.hdim + kChunkElems - 1) / kChunkElems;
  const int stages = ring_stages(chunks);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + phase2_ring(stages));
  const int tid = threadIdx.x;
  constexpr int kStage = (kBM + kBN2) * kChunk;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int s, int kt) {
    mbar_arrive_expect_tx(&full[s], kStage);
    tma_load_2d(ring + s * kStage, &hmap, kt * kChunk, m0, &full[s]);
    tma_load_2d(ring + s * kStage + kATile, &w2map, kt * kChunk, n0,
                &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) load(s, s);
  }

  float acc[kBN2 / 2];
  zero(acc);
  for (int kt = 0; kt < chunks; ++kt) {
    const int s = kt % stages;
    mbar_wait(&full[s], (kt / stages) & 1);
    const unsigned char* sa = ring + s * kStage;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_bf16<kBN2>(acc, sw128_desc(sa + 32 * k),
                       sw128_desc(sa + kATile + 32 * k));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    const int refill = kt - 1 + stages;
    if (tid == 0 && kt > 0 && refill < chunks) load((kt - 1) % stages, refill);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();

  // acc + b2 staged in fp32; then 8 columns a thread: the bf16 residual
  // added in fp32, one 16-byte load and one 16-byte store
  const AccPos pos;
  float* tile = reinterpret_cast<float*>(ring);
  constexpr int kPitch = kBN2 + 8;
#pragma unroll
  for (int j = 0; j < kBN2 / 8; ++j) {
    const int c = 8 * j + pos.col;
    const float b0 = n0 + c < a.d ? a.b2[n0 + c] : 0.f;
    const float b1 = n0 + c + 1 < a.d ? a.b2[n0 + c + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(tile + (pos.row + 8 * h) * kPitch + c) =
          make_float2(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
  }
  __syncthreads();
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* out = static_cast<bf16*>(a.out);
  constexpr int kPieces = kBN2 / 8;
  for (int i = tid; i < kBM * kPieces; i += kWg) {
    const int r = i / kPieces;
    const int c = (i - r * kPieces) * 8;
    if (m0 + r >= a.rows || n0 + c >= a.d) continue;  // D % 8 == 0
    const size_t off = static_cast<size_t>(m0 + r) * a.d + n0 + c;
    const uint4 xv = *reinterpret_cast<const uint4*>(x + off);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const float* v = tile + r * kPitch + c;
    uint4 yv;
    uint32_t* yw = reinterpret_cast<uint32_t*>(&yv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 y = __floats2bfloat162_rn(
          __bfloat162float(xe[2 * e]) + v[2 * e],
          __bfloat162float(xe[2 * e + 1]) + v[2 * e + 1]);
      yw[e] = *reinterpret_cast<const uint32_t*>(&y);
    }
    *reinterpret_cast<uint4*>(out + off) = yv;
  }
}

// ---- host side ---------------------------------------------------------------

template <int TM>
cudaError_t launch_f32_fused(const CapfMlpArgs& a, cudaStream_t stream) {
  constexpr int kTileRows = kFusedRG * TM;
  const int smem = f32_fused_smem(kTileRows, a.d, a.hdim);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = ln_mlp_f32_fused_kernel<TM>;
  static int opted = 0;  // the largest opted in so far (one device)
  if (smem > opted) {
    const cudaError_t err = capf::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  kernel<<<(a.rows + kTileRows - 1) / kTileRows, 2 * a.d, smem, stream>>>(
      a);
  return cudaGetLastError();
}

// a phase's tile and grid
struct GemmTile {
  int tm, tn, rg, cg, split;
};

inline dim3 gemm_grid(const GemmTile& t, int rows, int cols) {
  return dim3((cols + t.cg * t.tn - 1) / (t.cg * t.tn),
              (rows + t.rg * t.tm - 1) / (t.rg * t.tm), t.split);
}

template <int TM, int TN, bool kResidual>
cudaError_t launch_f32_gemm(const GemmTile& t, dim3 grid, const GemmArgs& g,
                            cudaStream_t stream) {
  const int threads = t.rg * t.cg;
  const int smem = f32_gemm_smem(t.rg * TM, t.cg * TN);
  if (t.rg < 1 || t.cg < 1 || threads > gemm_max_threads(TM, TN) ||
      t.split < 1 || t.split > 2 || smem > 232448) {
    return cudaErrorInvalidValue;
  }
  auto kernel = mlp_f32_gemm_kernel<TM, TN, kResidual>;
  static int opted = 0;  // the largest opted in so far (one device)
  if (smem > opted) {
    const cudaError_t err = capf::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  kernel<<<grid, threads, smem, stream>>>(g);
  return cudaGetLastError();
}

// a phase's launch by its (TM, TN): 4 or 8 each
template <bool kResidual>
cudaError_t launch_f32_phase(const GemmTile& t, dim3 grid, const GemmArgs& g,
                             cudaStream_t stream) {
#define CAPF_F32_PHASE(TM, TN)                                        \
  if (t.tm == TM && t.tn == TN) {                                     \
    return launch_f32_gemm<TM, TN, kResidual>(t, grid, g, stream);    \
  }
  CAPF_F32_PHASE(4, 4)
  CAPF_F32_PHASE(4, 8)
  CAPF_F32_PHASE(8, 4)
  CAPF_F32_PHASE(8, 8)
#undef CAPF_F32_PHASE
  return cudaErrorInvalidValue;
}

// route 3: the LN (which zeroes the split tiles' counters), then the two
// phases
cudaError_t launch_f32_two_phase(const CapfMlpArgs& a, cudaStream_t stream) {
  const int dp = round_up(a.d, kGemmBK), hp = round_up(a.hdim, kGemmBK);
  const GemmTile t1{a.gemm1[0], a.gemm1[1], a.gemm1[2], a.gemm1[3],
                    a.gemm1[4]};
  const GemmTile t2{a.gemm2[0], a.gemm2[1], a.gemm2[2], a.gemm2[3],
                    a.gemm2[4]};
  // phase 1's tiles cover Hp, so that the hidden's padding is written
  const dim3 grid1 = gemm_grid(t1, a.rows, hp), grid2 = gemm_grid(t2, a.rows,
                                                                   a.d);
  const int tiles1 = grid1.x * grid1.y, tiles2 = grid2.x * grid2.y;
  const bool split = t1.split > 1 || t2.split > 1;
  if (split && (a.partial == nullptr || a.count == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int counters = split ? tiles1 + tiles2 : 0;
  const int lanes = (a.rows * 32 > counters ? a.rows * 32 : counters);
  ln_rows_f32_kernel<<<(lanes + 255) / 256, 256, 0, stream>>>(a, dp,
                                                              counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* hidden = static_cast<float*>(a.hidden);
  float* part = static_cast<float*>(a.partial);
  const GemmArgs g1{static_cast<const float*>(a.normed),
                    static_cast<const float*>(a.w1), a.b1, nullptr, hidden,
                    part, a.count, dp, a.d, a.hdim, hp, a.rows, dp, t1.rg,
                    t1.cg, t1.split};
  err = launch_f32_phase<false>(t1, grid1, g1, stream);
  if (err != cudaSuccess) return err;
  const GemmArgs g2{hidden, static_cast<const float*>(a.w2), a.b2,
                    static_cast<const float*>(a.x),
                    static_cast<float*>(a.out), part,
                    split ? a.count + tiles1 : nullptr, hp, a.hdim, a.d, a.d,
                    a.rows, hp, t2.rg, t2.cg, t2.split};
  return launch_f32_phase<true>(t2, grid2, g2, stream);
}

cudaError_t launch_f32(const CapfMlpArgs& a, cudaStream_t stream) {
  if (a.d % 4 || a.hdim % 4) return cudaErrorInvalidValue;
  if (a.route == 0) {
    if (a.hdim != 2 * a.d || a.d % kFusedBK || 2 * a.d > kF32MaxThreads) {
      return cudaErrorInvalidValue;
    }
    if (a.tile1 == 32) return launch_f32_fused<4>(a, stream);
    if (a.tile1 == 40) return launch_f32_fused<5>(a, stream);
    if (a.tile1 == 48) return launch_f32_fused<6>(a, stream);
    return cudaErrorInvalidValue;
  }
  if (a.route != 3 || a.hidden == nullptr || a.normed == nullptr) {
    return cudaErrorInvalidValue;
  }
  return launch_f32_two_phase(a, stream);
}

template <int D, int H>
cudaError_t launch_resident(const CapfMlpArgs& a, int device,
                            cudaStream_t stream) {
  using L = Resident<D, H>;
  CUtensorMap w1map, w2map;
  cudaError_t err = weight_map(a.w1, 2ull * D, H, H, &w1map);
  if (err != cudaSuccess) return err;
  err = weight_map(a.w2, 2ull * H, D, D, &w2map);
  if (err != cudaSuccess) return err;
  auto kernel = ln_mlp_resident_kernel<D, H>;
  static bool opted = false;  // once per instantiation (one device)
  if (!opted) {
    err = capf::allow_smem(kernel, L::kSmem);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const int tiles = (a.rows + kBM - 1) / kBM;
  const int blocks = tiles < sm_count(device) ? tiles : sm_count(device);
  kernel<<<blocks, kTcThreads, L::kSmem, stream>>>(w1map, w2map, a);
  return cudaGetLastError();
}

template <int kBN1>
cudaError_t launch_two_phase(const CapfMlpArgs& a, cudaStream_t stream) {
  const int smem1 = phase1_smem(kBN1, a.d), smem2 = phase2_smem(a.hdim);
  if (smem1 > 232448 || smem2 > 232448) return cudaErrorInvalidValue;
  CUtensorMap w1map, hmap, w2map;
  cudaError_t err = weight_map(a.w1, 2ull * a.d, a.hdim, kBN1, &w1map);
  if (err != cudaSuccess) return err;
  err = weight_map(a.hidden, 2ull * a.hdim, a.rows, kBM, &hmap);
  if (err != cudaSuccess) return err;
  err = weight_map(a.w2, 2ull * a.hdim, a.d, kBN2, &w2map);
  if (err != cudaSuccess) return err;
  // the largest shared memory opted in so far (once per instantiation)
  static int opted1 = 0, opted2 = 0;
  if (smem1 > opted1) {
    err = capf::allow_smem(ln_fc1_kernel<kBN1>, smem1);
    if (err != cudaSuccess) return err;
    opted1 = smem1;
  }
  if (smem2 > opted2) {
    err = capf::allow_smem(fc2_residual_kernel, smem2);
    if (err != cudaSuccess) return err;
    opted2 = smem2;
  }
  const unsigned row_tiles = (a.rows + kBM - 1) / kBM;
  ln_fc1_kernel<kBN1><<<dim3((a.hdim + kBN1 - 1) / kBN1, row_tiles),
                        kTcThreads, smem1, stream>>>(w1map, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fc2_residual_kernel<<<dim3((a.d + kBN2 - 1) / kBN2, row_tiles), kWg, smem2,
                        stream>>>(hmap, w2map, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_ln_mlp_residual(const CapfMlpArgs* args, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const CapfMlpArgs& a = *args;
  if (a.rows < 1 || a.d < 1 || a.hdim < 1 || a.rows >= (1 << 22)) {
    return cudaErrorInvalidValue;
  }
  if (a.dtype == capf::kFloat32) return launch_f32(a, stream);
  if (a.dtype != capf::kBFloat16 || a.d % 16 || a.hdim % 16) {
    return cudaErrorInvalidValue;
  }
  if (a.route == 1) {
    if (a.hdim != 2 * a.d) return cudaErrorInvalidValue;
    if (a.d == 64) return launch_resident<64, 128>(a, device, stream);
    if (a.d == 96) return launch_resident<96, 192>(a, device, stream);
    if (a.d == 128) return launch_resident<128, 256>(a, device, stream);
    return cudaErrorInvalidValue;
  }
  if (a.route == 2 && a.hidden != nullptr) {
    if (a.tile1 == 128) return launch_two_phase<128>(a, stream);
    if (a.tile1 == 256) return launch_two_phase<256>(a, stream);
  }
  return cudaErrorInvalidValue;
}
