// K7: the deformable aggregation: multi-level bilinear sampling, each
// level's C_l -> hd projection plus bias, the attention weighting and the
// sum over a head's ns samples, in one launch.
//
// Replaces contextaware_poseformer_tpu/ops/deformable.py::
// _aggregate_multi_kernel, reached through deformable_aggregate.
//
// Contract (ops/deformable.py aggregate_reference): maps (B, H_l, W_l, C_l)
// NHWC in fp32 or bf16; points (B, L, R * ns, 2) fp32 with R = p * nh rows
// (one row per joint and head), a row's ns samples consecutive; weights
// (B, L, R * ns) fp32; per level W and b (hd,) fp32. Output (B, L, R, hd)
// in the maps' dtype:
//   out[r] = sum_s (sample(x_{r,s}) @ W + b) * w_{r,s}
// in BOTH padding modes, with the bias on every sample: the weights need
// not sum to 1.
//
// Design: pool before projecting. The function is linear in the samples:
//   out[r] = (sum_s w_{r,s} sample(x_{r,s})) @ W + (sum_s w_{r,s}) b,
// so a row needs ONE projection instead of ns (the TPU kernel projects
// every sample, then weights and sums them).
// - Rows are flattened over items within a level and cut into tiles of
//   kRows = 64, one tile a block (ops/deformable.py::aggregate_plan; blocks
//   that walked 2 or 4 tiles, staging W once for them, were slower at
//   every served shape on the card). A block issues its level's W by
//   16-byte cp.asyncs, which stay in flight while the tile gathers.
// - Every (row, sample) point's four tap rows and bilinear
//   weights, each weight multiplied by the sample's attention weight, into
//   shared memory, and each row's sum of attention weights. Then an item
//   is one (row, 16-byte channel group); a thread issues the taps of
//   kBatch (item, sample) pairs before it blends any of them, blends a
//   row's 4 * ns taps in fp32 and writes the pooled row once.
// - bf16 maps: the pooled row is rounded ONCE to bf16 into a padded A tile;
//   W arrives as the bf16 W^T (hd, C) that the wrapper makes once per
//   parameter state. The projection runs on the tensor cores (mma.sync
//   m16n8k16 bf16 -> fp32; a warp takes one 16-row tile and every other
//   8-column tile), then (sum_s w_s) * b in fp32, the bf16 result staged
//   for 16-byte stores. Rounding points: the pooled rows and W in bf16,
//   fp32 accumulation, one rounding of the output. The TPU kernel (DEFAULT
//   precision) rounds each SAMPLE to bf16 before it projects, and the
//   plain version is fp32 throughout: the three agree within the bf16
//   tolerance, 2e-2 of max|plain| per level. C need only be a multiple of
//   8: the A tile and W^T are zero-padded to a multiple of 16 channels.
// - fp32 maps (parity and training): the pooled rows stay fp32 in shared
//   memory, and one thread per (row, 4 outputs) projects them with fp32 W
//   (C, hd) on CUDA cores, fp32 FMAs throughout (1e-4 of max|plain|).
//
// What bounds it on the H100: pooled first, the served CPN block's call
// needs 0.18 GFLOP of fp32 blending and weighting, 0.29 GFLOP of
// projection (0.3 us at the tensor cores' bf16 rate) and ~16.5 MB of
// bytes (4.9 us at 3.35 TB/s): bytes bound it, as chip_smoke.py counts
// it (the projection at the bf16 rate, W^T at 2 bytes an element).
//
// Grid: levels x tiles a level, flat; block: kThreads threads.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using capf::from_float;
using capf::to_float;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kRows = 64;     // rows (joint, head) a tile
constexpr int kPad = 8;       // bf16 padding of a shared-memory row
constexpr int kMaxHd = 64;    // tensor-core outputs: 4 n-tiles of 8 a warp
constexpr int kBatch = 4;     // (item, sample) tap sets loaded together
constexpr int kTapBytes = 32;  // a point's tap rows and weights

}  // namespace

extern "C" {

struct CapfAggregateLevel {
  const void* feat;     // (B, H, W, C) NHWC, in the call's dtype
  const void* proj_w;   // bf16 maps: W^T (hd, C) bf16; fp32: W (C, hd) fp32
  const float* proj_b;  // (hd,) fp32
  int h, w, c;
};

struct CapfAggregateArgs {
  const float* points;   // (B, L, R * ns, 2) fp32, x then y
  const float* weights;  // (B, L, R * ns) fp32
  void* out;             // (B, L, R, hd), in the call's dtype
  CapfAggregateLevel levels[kMaxLevels];
  int num_levels, batch, rows, ns, hd, border, align_corners, dtype;
};

}  // extern "C"

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int round16(int c) {
  return (c + 15) / 16 * 16;
}

// Shared memory of a block: the tile's taps (kRows * ns points), the rows'
// weight sums, then the body: bf16 the A tile (kRows, K + kPad), W^T
// (hd, K + kPad) and the output staging (kRows, hd + kPad), K = C rounded
// up to 16; fp32 the pooled rows (kRows, C + 4) and W (C, hd). Every piece
// is a multiple of 16 bytes.
__host__ __device__ __forceinline__ size_t body_offset(int ns) {
  return static_cast<size_t>(kRows) * ns * kTapBytes + kRows * sizeof(float);
}

__host__ __device__ __forceinline__ size_t smem_bytes(bool bf, int c, int hd,
                                                      int ns) {
  if (bf) {
    const int ld = round16(c) + kPad;
    return body_offset(ns) +
           (static_cast<size_t>(kRows + hd) * ld +
            static_cast<size_t>(kRows) * (hd + kPad)) * sizeof(bf16);
  }
  return body_offset(ns) +
         (static_cast<size_t>(kRows) * (c + 4) +
          static_cast<size_t>(c) * hd) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    aggregate_kernel(const CapfAggregateArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kVec = 16 / sizeof(T);

  const int tid = threadIdx.x;
  const int total = args.batch * args.rows;  // rows a level
  const int tiles = (total + kRows - 1) / kRows;
  const int lvl = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - lvl * tiles) * kRows;
  const int n_rows = min(kRows, total - r0);
  const CapfAggregateLevel lv = args.levels[lvl];
  const int c = lv.c, hd = args.hd, ns = args.ns;
  const int pts = kRows * ns;  // points a tile

  int4* s_rows = reinterpret_cast<int4*>(smem);
  float4* s_wts = reinterpret_cast<float4*>(smem + 16 * pts);
  float* s_wsum = reinterpret_cast<float*>(smem + kTapBytes * pts);
  unsigned char* body = smem + body_offset(ns);
  const int k_pad = kBf16 ? round16(c) : c;  // the projection's depth
  const int lda = kBf16 ? k_pad + kPad : c + 4;
  T* s_a = reinterpret_cast<T*>(body);  // (kRows, lda)
  void* s_w = s_a + kRows * lda;        // bf16 (hd, lda); fp32 (C, hd)

  // W (in flight during the gather); bf16: the zero padding of the A tile
  // and of W^T past C
  if constexpr (kBf16) {
    const int pieces = c / 8;
    const bf16* wt = static_cast<const bf16*>(lv.proj_w);
    for (int i = tid; i < hd * pieces; i += kThreads) {
      const int n = i / pieces;
      capf::sm90::cp_async16(
          static_cast<bf16*>(s_w) + n * lda + (i - n * pieces) * 8,
          wt + 8 * i, 16);
    }
    if (k_pad > c) {  // one 8-channel group of zeros a row
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int r = tid; r < kRows + hd; r += kThreads) {
        *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(s_a) + r * lda +
                                  c) = zero;
      }
    }
  } else {
    const int quads = hd / 4;
    const float* w = static_cast<const float*>(lv.proj_w);
    for (int i = tid; i < c * quads; i += kThreads) {
      capf::sm90::cp_async16(static_cast<float*>(s_w) + 4 * i, w + 4 * i,
                             16);
    }
  }
  capf::sm90::cp_async_commit();

  const T* feat = static_cast<const T*>(lv.feat);
  const int groups = c / kVec;
  const int items = kRows * groups;
  // this thread's items: tid, tid + kThreads, ...; each takes ns samples
  const int mine = tid < items ? (items - tid + kThreads - 1) / kThreads : 0;
  const int pairs = mine * ns;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;

  // taps: point j = (tile row j / ns, sample j % ns); rows past the end
  // take row 0 and weight 0
  for (int j = tid; j < pts; j += kThreads) {
    int rw[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    const int r = j / ns;
    if (r < n_rows) {
      const int flat = r0 + r;  // (item, row) flat within the level
      const int b = flat / args.rows;
      const size_t p = (static_cast<size_t>(b) * args.num_levels + lvl) *
                           args.rows * ns +
                       static_cast<size_t>(flat - b * args.rows) * ns +
                       (j - r * ns);
      const float2 xy =
          *reinterpret_cast<const float2*>(args.points + 2 * p);
      capf::point_taps(xy.x, xy.y, lv.h, lv.w, args.border != 0,
                       args.align_corners != 0, rw, wt);
      const float aw = args.weights[p];
      const int base = b * lv.h * lv.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rw[k] += base;
        wt[k] *= aw;
      }
    }
    s_rows[j] = make_int4(rw[0], rw[1], rw[2], rw[3]);
    s_wts[j] = make_float4(wt[0], wt[1], wt[2], wt[3]);
  }
  for (int r = tid; r < kRows; r += kThreads) {
    float sum = 0.f;
    if (r < n_rows) {
      const int flat = r0 + r;
      const int b = flat / args.rows;
      const float* w =
          args.weights +
          ((static_cast<size_t>(b) * args.num_levels + lvl) * args.rows +
           (flat - b * args.rows)) * ns;
      for (int s = 0; s < ns; ++s) sum += w[s];
    }
    s_wsum[r] = sum;
  }
  __syncthreads();

  // pool: the (item, sample) pairs of this thread in order, kBatch tap
  // sets in flight; a row's pooled group is written after its last sample
  float acc[kVec] = {};
  for (int u0 = 0; u0 < pairs; u0 += kBatch) {
    uint4 raw[kBatch][4];
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      const int u = u0 + v;
      if (u < pairs) {
        const int k = u / ns;
        const int i = tid + k * kThreads;
        const int r = i / groups;
        const int ch = (i - r * groups) * kVec;
        const int4 rw = s_rows[r * ns + (u - k * ns)];
        const int rows4[4] = {rw.x, rw.y, rw.z, rw.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          raw[v][e] = *reinterpret_cast<const uint4*>(
              feat + static_cast<size_t>(rows4[e]) * c + ch);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      const int u = u0 + v;
      if (u < pairs) {
        const int k = u / ns;
        const int s = u - k * ns;
        const int i = tid + k * kThreads;
        const int r = i / groups;
        const int ch = (i - r * groups) * kVec;
        const float4 w = s_wts[r * ns + s];
        const float wk[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* tap = reinterpret_cast<const T*>(&raw[v][e]);
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc[x] += wk[e] * to_float(tap[x]);
        }
        if (s == ns - 1) {
          if constexpr (kBf16) {
            uint32_t words[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const __nv_bfloat162 h2 =
                  __floats2bfloat162_rn(acc[2 * x], acc[2 * x + 1]);
              words[x] = *reinterpret_cast<const uint32_t*>(&h2);
            }
            *reinterpret_cast<uint4*>(s_a + r * lda + ch) =
                make_uint4(words[0], words[1], words[2], words[3]);
          } else {
            *reinterpret_cast<float4*>(s_a + r * lda + ch) =
                make_float4(acc[0], acc[1], acc[2], acc[3]);
          }
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc[x] = 0.f;
        }
      }
    }
  }
  capf::sm90::cp_async_wait<0>();
  __syncthreads();

  T* out = static_cast<T*>(args.out);
  if constexpr (kBf16) {
    // project: warp w takes rows 16 (w % 4) .. + 15 and the 8-column
    // tiles w / 4, w / 4 + 2, ...; fragments by 32-bit loads
    const bf16* a_row = s_a + (16 * (warp % 4) + g) * lda + 2 * q;
    const bf16* wt = static_cast<const bf16*>(s_w);
    const int ntiles = hd / 8;
    float d[kMaxHd / 16][4] = {};
    for (int k0 = 0; k0 < k_pad; k0 += 16) {
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(a_row + k0),
          *reinterpret_cast<const uint32_t*>(a_row + 8 * lda + k0),
          *reinterpret_cast<const uint32_t*>(a_row + k0 + 8),
          *reinterpret_cast<const uint32_t*>(a_row + 8 * lda + k0 + 8)};
#pragma unroll
      for (int j = 0; j < kMaxHd / 16; ++j) {
        const int nt = warp / 4 + 2 * j;
        if (nt < ntiles) {
          const bf16* w0 = wt + (nt * 8 + g) * lda + k0 + 2 * q;
          const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(w0),
                                 *reinterpret_cast<const uint32_t*>(w0 + 8)};
          capf::mma_bf16_16x8x16(d[j], a, b);
        }
      }
    }
    // (sum_s w_s) * b in fp32, rounded once to bf16 into the staging tile
    bf16* s_o = static_cast<bf16*>(s_w) + hd * lda;  // (kRows, hd + kPad)
    const int ldo = hd + kPad;
    const int row = 16 * (warp % 4) + g;
    const float ws0 = s_wsum[row], ws1 = s_wsum[row + 8];
#pragma unroll
    for (int j = 0; j < kMaxHd / 16; ++j) {
      const int nt = warp / 4 + 2 * j;
      if (nt < ntiles) {
        const int col = nt * 8 + 2 * q;
        const float b0 = lv.proj_b[col], b1 = lv.proj_b[col + 1];
        *reinterpret_cast<__nv_bfloat162*>(s_o + row * ldo + col) =
            __floats2bfloat162_rn(d[j][0] + ws0 * b0, d[j][1] + ws0 * b1);
        *reinterpret_cast<__nv_bfloat162*>(s_o + (row + 8) * ldo + col) =
            __floats2bfloat162_rn(d[j][2] + ws1 * b0, d[j][3] + ws1 * b1);
      }
    }
    __syncthreads();
    const int pieces = hd / 8;
    for (int i = tid; i < n_rows * pieces; i += kThreads) {
      const int r = i / pieces;
      const int pc = (i - r * pieces) * 8;
      const int flat = r0 + r;
      const int b = flat / args.rows;
      const size_t o = ((static_cast<size_t>(b) * args.num_levels + lvl) *
                            args.rows + (flat - b * args.rows)) * hd + pc;
      *reinterpret_cast<uint4*>(out + o) =
          *reinterpret_cast<const uint4*>(s_o + r * ldo + pc);
    }
  } else {
    // project on CUDA cores: one thread per (row, 4 outputs)
    const float* w = static_cast<const float*>(s_w);
    const int quads = hd / 4;
    for (int i = tid; i < n_rows * quads; i += kThreads) {
      const int r = i / quads;
      const int d0 = (i - r * quads) * 4;
      const float* ar = reinterpret_cast<const float*>(s_a) + r * lda;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < c; k += 4) {
        const float4 av = *reinterpret_cast<const float4*>(ar + k);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 wv =
              *reinterpret_cast<const float4*>(w + (k + u) * hd + d0);
          d[0] = fmaf(ak[u], wv.x, d[0]);
          d[1] = fmaf(ak[u], wv.y, d[1]);
          d[2] = fmaf(ak[u], wv.z, d[2]);
          d[3] = fmaf(ak[u], wv.w, d[3]);
        }
      }
      const float ws = s_wsum[r];
      const int flat = r0 + r;
      const int b = flat / args.rows;
      float* o = reinterpret_cast<float*>(out) +
                 ((static_cast<size_t>(b) * args.num_levels + lvl) *
                      args.rows + (flat - b * args.rows)) * hd + d0;
      *reinterpret_cast<float4*>(o) = make_float4(
          d[0] + ws * lv.proj_b[d0], d[1] + ws * lv.proj_b[d0 + 1],
          d[2] + ws * lv.proj_b[d0 + 2], d[3] + ws * lv.proj_b[d0 + 3]);
    }
  }
}

template <typename T>
cudaError_t launch(const CapfAggregateArgs& args, size_t smem, int blocks,
                   cudaStream_t stream) {
  cudaError_t err = capf::allow_smem(aggregate_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  aggregate_kernel<T><<<blocks, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_deformable_aggregate(const CapfAggregateArgs* args,
                                         int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool bf = args->dtype == capf::kBFloat16;
  if (args->num_levels < 1 || args->num_levels > kMaxLevels ||
      args->batch < 1 || args->rows < 1 || args->ns < 1 ||
      static_cast<long long>(args->batch) * args->rows > (1LL << 30) ||
      (!bf && args->dtype != capf::kFloat32) ||
      (bf ? args->hd % 8 != 0 || args->hd > kMaxHd
          : args->hd % 4 != 0) || args->hd < 4) {
    return cudaErrorInvalidValue;
  }
  const int vec = bf ? 8 : 4;
  size_t smem = 0;
  for (int l = 0; l < args->num_levels; ++l) {
    const CapfAggregateLevel& lv = args->levels[l];
    if (lv.c < vec || lv.c % vec != 0 || lv.proj_w == nullptr ||
        lv.proj_b == nullptr ||
        static_cast<long long>(args->batch) * lv.h * lv.w >= (1LL << 31)) {
      return cudaErrorInvalidValue;
    }
    const size_t need = smem_bytes(bf, lv.c, args->hd, args->ns);
    smem = need > smem ? need : smem;
  }
  if (smem > 232448) return cudaErrorInvalidValue;  // 227 KB a block
  const int blocks =
      args->num_levels * ((args->batch * args->rows + kRows - 1) / kRows);
  if (bf) {
    err = launch<bf16>(*args, smem, blocks, stream);
  } else {
    err = launch<float>(*args, smem, blocks, stream);
  }
  return static_cast<int>(err);
}
