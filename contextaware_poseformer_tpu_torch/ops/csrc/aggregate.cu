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
// (B, L, R * ns) fp32; per level W (C_l, hd) and b (hd,) fp32. Output
// (B, L, R, hd) in the maps' dtype:
//   out[r] = sum_k (sample(x_{r,k}) @ W + b) * weight_{r,k}
// Sample-then-project in BOTH padding modes, and the bias is added to
// every sample before it is weighted: the weights need not sum to 1.
//
// Design: K1's projection path (csrc/sampler.cu) with a pooling epilogue.
// A block takes one level of one image and a tile of whole rows, so a
// row's ns samples never leave the block (no cross-block reduction, any ns
// and any row count, no padding). It stages W_l in shared memory (fp32,
// 32 KB at C = 256 and hd = 32; 48 KB at W48's 384 channels), blends its
// tile's points into fp32 samples in shared memory (16-byte loads of 4
// fp32 or 8 bf16 channels, consecutive threads on consecutive channel
// groups of one point), then one thread per (point, 4 outputs) projects a
// sample, adds the bias and multiplies by the point's weight into shared
// memory, and one thread per (row, 4 outputs) sums its ns weighted
// projections in registers and stores once. A tile holds 32 / ns rows (at
// least one; the wrapper passes rows_per_tile), so the sample buffer
// matches K1's 32-point tile: 96 KB in all at W48's 384-channel level,
// within the 227 KB a block may use.
//
// What bounds it on the H100: fp32 operations of the projection on CUDA
// cores (2 * C * hd a point against 8 * C for its blend), like K1's
// projected calls: the served CPN block's call moves ~16.5 MB (5 us at
// 3.35 TB/s) for 1.3 GFLOP (19 us at 67 TFLOP/s).
//
// Grid: (row tiles, levels, batch); block: kThreads threads.

#include "common.cuh"

using capf::from_float;
using capf::to_float;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

}  // namespace

extern "C" {

struct CapfAggregateLevel {
  const void* feat;     // (B, H, W, C) NHWC, in the call's dtype
  const float* proj_w;  // (C, hd) fp32
  const float* proj_b;  // (hd,) fp32
  int h, w, c;
};

struct CapfAggregateArgs {
  const float* points;   // (B, L, R * ns, 2) fp32, x then y
  const float* weights;  // (B, L, R * ns) fp32
  void* out;             // (B, L, R, hd), in the call's dtype
  CapfAggregateLevel levels[kMaxLevels];
  int num_levels, batch, rows, ns, hd, rows_per_tile, border, align_corners,
      dtype;
};

}  // extern "C"

namespace {

// Dynamic shared memory of a block: W (C, hd), samples (P, C), weighted
// projections (P, hd), tap weights (P, 4) and tap rows (P, 4), with P the
// tile's points; every piece is a multiple of 16 bytes (C % 4, hd % 4).
size_t smem_bytes(int c, int hd, int tile_points) {
  return (static_cast<size_t>(c) * hd + static_cast<size_t>(tile_points) *
          (c + hd + 8)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    aggregate_kernel(const CapfAggregateArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lvl = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const CapfAggregateLevel lv = args.levels[lvl];
  const int c = lv.c, hd = args.hd, ns = args.ns;
  const int row0 = blockIdx.x * args.rows_per_tile;
  const int n_rows = min(args.rows_per_tile, args.rows - row0);
  const int n_pts = n_rows * ns;
  const int tile_pts = args.rows_per_tile * ns;

  float* s_w = reinterpret_cast<float*>(smem_raw);  // (C, hd)
  float* s_samp = s_w + c * hd;                     // (P, C)
  float* s_pw = s_samp + tile_pts * c;              // (P, hd)
  float* s_wts = s_pw + tile_pts * hd;              // (P, 4)
  int* s_rows = reinterpret_cast<int*>(s_wts + tile_pts * 4);  // (P, 4)

  // the tile's first point in (B, L, R * ns)
  const size_t pt0 =
      ((static_cast<size_t>(b) * args.num_levels + lvl) * args.rows + row0) *
      ns;
  for (int i = tid; i < n_pts; i += kThreads) {
    const float* pt = args.points + (pt0 + i) * 2;
    capf::point_taps(pt[0], pt[1], lv.h, lv.w, args.border != 0,
                     args.align_corners != 0, s_rows + 4 * i, s_wts + 4 * i);
  }
  const float4* w4 = reinterpret_cast<const float4*>(lv.proj_w);
  float4* s_w4 = reinterpret_cast<float4*>(s_w);
  for (int i = tid; i < c * hd / 4; i += kThreads) s_w4[i] = w4[i];
  __syncthreads();

  // blend each point's four taps into fp32 samples
  const T* feat = static_cast<const T*>(lv.feat) +
                  static_cast<size_t>(b) * lv.h * lv.w * c;
  constexpr int kVec = 16 / sizeof(T);
  const int groups = c / kVec;
  for (int i = tid; i < n_pts * groups; i += kThreads) {
    const int pl = i / groups;
    const int ch = (i - pl * groups) * kVec;
    float acc[kVec] = {};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          feat + static_cast<size_t>(s_rows[4 * pl + k]) * c + ch);
      const T* tap = reinterpret_cast<const T*>(&raw);
      const float wk = s_wts[4 * pl + k];
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[v] += wk * to_float(tap[v]);
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) s_samp[pl * c + ch + v] = acc[v];
  }
  __syncthreads();

  // project, add the bias and weight: one thread per (point, 4 outputs)
  const int quads = hd / 4;
  const float* weights = args.weights + pt0;
  for (int i = tid; i < n_pts * quads; i += kThreads) {
    const int pl = i / quads;
    const int d0 = (i - pl * quads) * 4;
    const float* sp = s_samp + pl * c;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < c; k += 4) {
      const float4 sv = *reinterpret_cast<const float4*>(sp + k);
      const float sk[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 wv =
            *reinterpret_cast<const float4*>(s_w + (k + u) * hd + d0);
        acc[0] = fmaf(sk[u], wv.x, acc[0]);
        acc[1] = fmaf(sk[u], wv.y, acc[1]);
        acc[2] = fmaf(sk[u], wv.z, acc[2]);
        acc[3] = fmaf(sk[u], wv.w, acc[3]);
      }
    }
    const float wt = weights[pl];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s_pw[pl * hd + d0 + e] = (acc[e] + lv.proj_b[d0 + e]) * wt;
    }
  }
  __syncthreads();

  // pool: one thread per (row, 4 outputs) sums its row's ns samples
  T* out = static_cast<T*>(args.out) +
           ((static_cast<size_t>(b) * args.num_levels + lvl) * args.rows +
            row0) * hd;
  for (int i = tid; i < n_rows * quads; i += kThreads) {
    const int r = i / quads;
    const int d0 = (i - r * quads) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < ns; ++k) {
      const float* pw = s_pw + (r * ns + k) * hd + d0;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += pw[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[r * hd + d0 + e] = from_float<T>(acc[e]);
  }
}

template <typename T>
cudaError_t launch(const CapfAggregateArgs& args, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = capf::allow_smem(aggregate_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.rows + args.rows_per_tile - 1) / args.rows_per_tile,
                  args.num_levels, args.batch);
  aggregate_kernel<T><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_deformable_aggregate(const CapfAggregateArgs* args,
                                         int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (args->num_levels < 1 || args->num_levels > kMaxLevels ||
      args->batch < 1 || args->rows < 1 || args->ns < 1 || args->hd < 4 ||
      args->hd % 4 != 0 || args->rows_per_tile < 1 ||
      (args->dtype != capf::kFloat32 && args->dtype != capf::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  const int vec = args->dtype == capf::kBFloat16 ? 8 : 4;
  int c_max = 0;
  for (int l = 0; l < args->num_levels; ++l) {
    const CapfAggregateLevel& lv = args->levels[l];
    if (lv.c < vec || lv.c % vec != 0 || lv.proj_w == nullptr ||
        lv.proj_b == nullptr) {
      return cudaErrorInvalidValue;
    }
    c_max = lv.c > c_max ? lv.c : c_max;
  }
  const size_t smem =
      smem_bytes(c_max, args->hd, args->rows_per_tile * args->ns);
  if (smem > 232448) return cudaErrorInvalidValue;  // 227 KB a block
  if (args->dtype == capf::kBFloat16) {
    err = launch<__nv_bfloat16>(*args, smem, stream);
  } else {
    err = launch<float>(*args, smem, stream);
  }
  return static_cast<int>(err);
}
