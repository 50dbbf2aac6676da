// K1: multi-level bilinear point sampler, optionally fused with a per-level
// channel projection.
//
// Replaces contextaware_poseformer_tpu/ops/deformable.py::_sample_multi_kernel
// (one-stage body _sample_body_xy), reached through _multi_fwd_impl from
// sample_points_multi / sample_project_points_multi / sample_points_levels.
//
// Contract (ops/grid_sample.py): NHWC maps, xy points in [-1, 1],
// align_corners or not, zeros padding (out-of-bounds taps contribute 0) or
// border padding (coordinates clamped before the floor). Each level reads its
// own H and W; one launch covers every level of a call.
//
// What bounds it on the H100: gathered bytes. The TPU kernel builds one-hot
// (P, H*W) mixing matrices for its matrix unit; on the GPU that would be
// ~H*W/4 times the work. Here each point reads only its 4 taps: 4 rows of C
// contiguous channels, which consecutive threads read coalesced, 16 bytes a
// lane (8 bf16 or 4 fp32 channels) so that enough bytes are in flight to
// keep device memory busy (2-byte loads left the deformable call at 0.18 ms).
// Needs C divisible by 8 (bf16) or 4 (fp32) and 16-byte aligned maps.
//
// Projection (deformable blocks, border mode only): sample-then-project. A
// tile of kTile points is blended in fp32 into shared memory, then multiplied
// by W (C x Cout, staged in shared memory) plus b. For 272 points against a
// 3072-pixel map this is ~11x less work than projecting the map first, and it
// equals sample(F @ W + b) exactly because border-mode weights sum to 1 (the
// Python wrapper refuses a projection in zeros mode). The product reads
// shared memory as float4: a thread takes one point and 4 outputs, and one
// sample load and 4 weight loads feed 16 FMAs. Needs C and Cout divisible
// by 4.
//
// K5: the same kernel also replaces the separable two-stage branch of
// _sample_body_xy (deformable.py:148-197), which the TPU takes on large
// maps with few channels (H*W >= 1024, C < 64: HRNet's 64x48 level 0 with
// C = 32 or 48) only to fill its 128 output lanes. A gather has no lanes to
// fill: each point still reads its four taps, so K5's port is this body at
// those shapes. At C = 32 in bf16 a point is 4 sixteen-byte groups, so a
// tile keeps 128 of the 256 threads busy in the blend (192 at C = 48), and
// the dynamic shared memory is the largest projected level's (96 KB for
// W48's 384-channel level), reserved by every block of the launch.
//
// K8: the single-level sampler (_sample_kernel / _sample_kernel_2stage,
// reached through sample_points) is this kernel launched with one level;
// the TPU's one-stage and two-stage bodies both become this gather.
//
// int8 maps (the deploy graph's raw quantized samples, K1 and K8): a
// 16-byte load carries 16 channels (C % 16 == 0), the blend stays fp32 and
// rounds once to bf16, as the TPU kernel's bf16 output. The caller owns the
// dequant scale: a projected int8 level (the CPN deploy graph's lifter)
// takes projection weights already multiplied by it, and projects the fp32
// blend of the raw int8 taps as any other level (deformable.py:541-561).
//
// Grid: (point tiles, levels, batch); block: kThreads threads.

#include "common.cuh"

using capf::from_float;
using capf::to_float;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kTile = 32;  // points per block

}  // namespace

extern "C" {

struct CapfSampleLevel {
  const void* feat;     // (B, H, W, C) NHWC, in the call's dtype
  const float* proj_w;  // (C, Cout) fp32, or null: no projection
  const float* proj_b;  // (Cout,) fp32, or null: no bias
  void* out;            // (B, P, Cout), in the call's dtype (bf16: int8)
  int h, w, c, cout;
};

struct CapfSampleArgs {
  const float* points;  // (B, L, P, 2) fp32, x then y
  CapfSampleLevel levels[kMaxLevels];
  int num_levels, batch, num_points, border, align_corners, dtype;
};

}  // extern "C"

namespace {

// T: the maps' type (float, __nv_bfloat16 or int8_t); O: the outputs'
// (T, or __nv_bfloat16 for int8 maps)
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
    sample_levels_kernel(const CapfSampleArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_rows[kTile][4];
  __shared__ float s_wts[kTile][4];

  const int lvl = blockIdx.y;
  const int b = blockIdx.z;
  const int tile0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const CapfSampleLevel lv = args.levels[lvl];
  const int num_points = args.num_points;
  const int c = lv.c;
  const bool proj = lv.proj_w != nullptr;

  float* s_w = reinterpret_cast<float*>(smem_raw);  // (C, Cout)
  float* s_samp = s_w + (proj ? c * lv.cout : 0);   // (kTile, C)

  if (tid < kTile) {
    const int p = tile0 + tid;
    if (p < num_points) {
      const float* pt =
          args.points +
          ((static_cast<size_t>(b) * args.num_levels + lvl) * num_points + p) *
              2;
      capf::point_taps(pt[0], pt[1], lv.h, lv.w, args.border != 0,
                       args.align_corners != 0, s_rows[tid], s_wts[tid]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_rows[tid][k] = 0;
        s_wts[tid][k] = 0.f;
      }
    }
  }
  if (proj) {
    const float4* w4 = reinterpret_cast<const float4*>(lv.proj_w);
    float4* s_w4 = reinterpret_cast<float4*>(s_w);
    for (int i = tid; i < c * lv.cout / 4; i += kThreads) s_w4[i] = w4[i];
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(lv.feat) +
                  static_cast<size_t>(b) * lv.h * lv.w * c;
  O* out = static_cast<O*>(lv.out);
  const int n_tile = min(kTile, num_points - tile0);

  // blend: consecutive threads take consecutive 16-byte channel groups of
  // one point (4 fp32, 8 bf16 or 16 int8 channels)
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kStores = kVec * sizeof(O) / 16;  // 16-byte output stores
  const int groups = c / kVec;
  for (int i = tid; i < n_tile * groups; i += kThreads) {
    const int pl = i / groups;
    const int ch = (i - pl * groups) * kVec;
    float acc[kVec] = {};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          feat + static_cast<size_t>(s_rows[pl][k]) * c + ch);
      const T* tap = reinterpret_cast<const T*>(&raw);
      const float wk = s_wts[pl][k];
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[v] += wk * to_float(tap[v]);
    }
    if (proj) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) s_samp[pl * c + ch + v] = acc[v];
    } else {
      alignas(16) O o[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) o[v] = from_float<O>(acc[v]);
      uint4* dst = reinterpret_cast<uint4*>(
          out + (static_cast<size_t>(b) * num_points + tile0 + pl) * c + ch);
#pragma unroll
      for (int s = 0; s < kStores; ++s) {
        dst[s] = reinterpret_cast<const uint4*>(o)[s];
      }
    }
  }
  if (!proj) return;  // uniform per block: the level decides
  __syncthreads();

  // project: one thread per (point, 4 consecutive output channels)
  const int cout = lv.cout;
  const int quads = cout / 4;
  for (int i = tid; i < n_tile * quads; i += kThreads) {
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
            *reinterpret_cast<const float4*>(s_w + (k + u) * cout + d0);
        acc[0] = fmaf(sk[u], wv.x, acc[0]);
        acc[1] = fmaf(sk[u], wv.y, acc[1]);
        acc[2] = fmaf(sk[u], wv.z, acc[2]);
        acc[3] = fmaf(sk[u], wv.w, acc[3]);
      }
    }
    O* o =
        out + (static_cast<size_t>(b) * num_points + tile0 + pl) * cout + d0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float bias = lv.proj_b != nullptr ? lv.proj_b[d0 + e] : 0.f;
      o[e] = from_float<O>(acc[e] + bias);
    }
  }
}

template <typename T, typename O>
cudaError_t launch(const CapfSampleArgs& args, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = capf::allow_smem(sample_levels_kernel<T, O>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.num_points + kTile - 1) / kTile, args.num_levels,
                  args.batch);
  sample_levels_kernel<T, O><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_sample_levels(const CapfSampleArgs* args, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (args->num_levels < 1 || args->num_levels > kMaxLevels ||
      args->num_points < 1 || args->batch < 1) {
    return cudaErrorInvalidValue;
  }
  size_t smem = 0;
  const int vec = args->dtype == capf::kInt8       ? 16
                  : args->dtype == capf::kBFloat16 ? 8
                                                   : 4;
  for (int l = 0; l < args->num_levels; ++l) {
    const CapfSampleLevel& lv = args->levels[l];
    if (lv.c % vec != 0) return cudaErrorInvalidValue;
    if (lv.proj_w != nullptr) {
      if (lv.cout % 4 != 0) return cudaErrorInvalidValue;  // C: above
      const size_t need =
          static_cast<size_t>(lv.c) * (lv.cout + kTile) * sizeof(float);
      smem = need > smem ? need : smem;
    }
  }
  if (args->dtype == capf::kInt8) {
    err = launch<int8_t, __nv_bfloat16>(*args, smem, stream);
  } else if (args->dtype == capf::kBFloat16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(*args, smem, stream);
  } else {
    err = launch<float, float>(*args, smem, stream);
  }
  return static_cast<int>(err);
}
