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
// Projection (deformable blocks, border mode only): sample-then-project. For
// 272 points against a 3072-pixel map this is ~11x less work than projecting
// the map first, and it equals sample(F @ W + b) exactly because border-mode
// weights sum to 1 (the Python wrapper refuses a projection in zeros mode).
// - bf16 and int8 maps (the serving path): one block a (item, level, chunk
//   of kChunk = 64 points), so the 272-point call is 5 chunks a level. The
//   block first issues its level's W (fp32, 32 KB at C = 256, Cout = 32)
//   into shared memory by 16-byte cp.asyncs, which stay in flight while it
//   gathers; it issues the taps of kBatch (point, 16-byte channel group)
//   items a thread before it blends any of them; the blend is fp32,
//   rounded once to bf16 into a padded A tile in shared memory. The
//   projection runs on the tensor cores (mma.sync m16n8k16 bf16 -> fp32; a
//   warp takes one 16-point row tile and every other 8-output column tile;
//   W is rounded to bf16 as its fragments are built), then the bias, and
//   the bf16 tile is staged for 16-byte stores. Rounding points: the blend and W are rounded
//   to bf16, the products accumulate in fp32. The plain version projects
//   fp32 blends with fp32 W; the JAX kernel projects with bf16 operands and
//   fp32 accumulation (DEFAULT precision), so these roundings are the
//   reference's own arithmetic. Needs C divisible by 16 and Cout by 8,
//   Cout <= 64; the padded rows make every fragment load conflict-free.
// - fp32 maps (parity runs and training): a tile of kTile points is blended
//   in fp32 into shared memory, then multiplied by W (C x Cout, fp32 in
//   shared memory) plus b on CUDA cores, float4 reads: a thread takes one
//   point and 4 outputs, and one sample load and 4 weight loads feed 16
//   FMAs. Needs C and Cout divisible by 4.
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
// Grid: (chunks of kChunk points where every level of the call takes the
// tensor-core projection, else tiles of kTile points; levels; batch). A
// call with no such level launches the build without that body.
//
// int8 maps (the deploy graph's raw quantized samples, K1 and K8): a
// 16-byte load carries 16 channels (C % 16 == 0), the blend stays fp32 and
// rounds once to bf16, as the TPU kernel's bf16 output. The caller owns the
// dequant scale: a projected int8 level (the CPN deploy graph's lifter)
// takes projection weights already multiplied by it, and projects the
// blend of the raw int8 taps as any other level (deformable.py:541-561).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using capf::from_float;
using capf::to_float;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kTile = 32;     // points a block: the gather, fp32 projection
constexpr int kChunk = 64;    // points a block: the tensor-core projection
constexpr int kMaxCout = 64;  // its outputs: up to 4 n-tiles of 8 a warp
constexpr int kPad = 8;       // bf16 padding of its shared-memory rows
constexpr int kBatch = 4;     // gather items whose taps load together

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

using bf16 = __nv_bfloat16;

// The tap rows and bilinear weights of points p0 .. p0 + n - 1 of one level
// into s_rows / s_wts (threads 0 .. n_slots - 1; slots past n: row 0,
// weight 0).
__device__ __forceinline__ void stage_taps(const CapfSampleArgs& args,
                                           const CapfSampleLevel& lv, int lvl,
                                           int b, int p0, int n, int n_slots,
                                           int (*s_rows)[4],
                                           float (*s_wts)[4]) {
  const int tid = threadIdx.x;
  if (tid >= n_slots) return;
  if (tid < n) {
    const float* pt =
        args.points +
        ((static_cast<size_t>(b) * args.num_levels + lvl) * args.num_points +
         p0 + tid) *
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

// two fp32 values rounded to bf16 (round to nearest even), the first in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The projected body on the tensor cores (bf16 or int8 maps T): points
// p0 .. p0 + 63 of one (item, level), sampled, projected by W and b, stored
// as bf16. Shared memory: the A tile (kChunk, lda) bf16, which later stages
// the output, then W (C, ldw) fp32, its rows padded by 4 so that the B
// fragments' loads hit distinct banks; ops/deformable.py::projected_plan
// mirrors its size.
template <typename T>
__device__ __forceinline__ void project_chunk(const CapfSampleArgs& args,
                                              const CapfSampleLevel& lv,
                                              int lvl, int b,
                                              unsigned char* smem,
                                              int (*s_rows)[4],
                                              float (*s_wts)[4]) {
  const int tid = threadIdx.x;
  const int num_points = args.num_points;
  const int p0 = blockIdx.x * kChunk;
  const int n = min(kChunk, num_points - p0);
  const int c = lv.c, cout = lv.cout;
  const int lda = (c > cout ? c : cout) + kPad;
  const int ldw = cout + 4;
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  float* s_w = reinterpret_cast<float*>(s_a + kChunk * lda);

  // W: fp32 (C, Cout) by 16-byte cp.asyncs, landing while the taps load
  const int quads = cout / 4;
  for (int i = tid; i < c * quads; i += kThreads) {
    const int k = i / quads;
    capf::sm90::cp_async16(s_w + k * ldw + (i - k * quads) * 4,
                           lv.proj_w + 4 * i, 16);
  }
  capf::sm90::cp_async_commit();
  stage_taps(args, lv, lvl, b, p0, n, kChunk, s_rows, s_wts);
  __syncthreads();

  // gather: an item is one 16-byte channel group (8 bf16 or 16 int8
  // channels) of one point; a thread loads the 4 taps of kBatch items, then
  // blends them in fp32 and rounds once to bf16 into the A tile. Rows of
  // points past n are never written: their products are never stored.
  const T* feat = static_cast<const T*>(lv.feat) +
                  static_cast<size_t>(b) * lv.h * lv.w * c;
  constexpr int kVec = 16 / sizeof(T);
  const int groups = c / kVec;
  const int items = n * groups;
  for (int i0 = tid; i0 < items; i0 += kThreads * kBatch) {
    uint4 raw[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < items) {
        const int pl = i / groups;
        const int ch = (i - pl * groups) * kVec;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          raw[u][k] = *reinterpret_cast<const uint4*>(
              feat + static_cast<size_t>(s_rows[pl][k]) * c + ch);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < items) {
        const int pl = i / groups;
        const int ch = (i - pl * groups) * kVec;
        float acc[kVec] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const T* tap = reinterpret_cast<const T*>(&raw[u][k]);
          const float wk = s_wts[pl][k];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] += wk * to_float(tap[e]);
        }
        uint32_t words[kVec / 2];
#pragma unroll
        for (int e = 0; e < kVec / 2; ++e) {
          const __nv_bfloat162 v2 =
              __floats2bfloat162_rn(acc[2 * e], acc[2 * e + 1]);
          words[e] = *reinterpret_cast<const uint32_t*>(&v2);
        }
        uint4* dst = reinterpret_cast<uint4*>(s_a + pl * lda + ch);
#pragma unroll
        for (int s = 0; s < kVec / 8; ++s) {
          dst[s] = make_uint4(words[4 * s], words[4 * s + 1],
                              words[4 * s + 2], words[4 * s + 3]);
        }
      }
    }
  }
  capf::sm90::cp_async_wait<0>();
  __syncthreads();

  // project: warp w takes rows 16 (w % 4) .. + 15 and the 8-output column
  // tiles w / 4, w / 4 + 2, ...; fragments by 32-bit loads (common.cuh's
  // mma_bf16_16x8x16 layout), W's rounded to bf16 as they are built
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int row = 16 * (warp % 4) + g;
  const int ntiles = cout / 8;
  float acc[kMaxCout / 16][4] = {};
  const bf16* a_row = s_a + row * lda + 2 * q;
  for (int k0 = 0; k0 < c; k0 += 16) {
    const uint32_t a[4] = {
        *reinterpret_cast<const uint32_t*>(a_row + k0),
        *reinterpret_cast<const uint32_t*>(a_row + 8 * lda + k0),
        *reinterpret_cast<const uint32_t*>(a_row + k0 + 8),
        *reinterpret_cast<const uint32_t*>(a_row + 8 * lda + k0 + 8)};
#pragma unroll
    for (int j = 0; j < kMaxCout / 16; ++j) {
      const int nt = warp / 4 + 2 * j;
      if (nt < ntiles) {
        const float* w0 = s_w + (k0 + 2 * q) * ldw + nt * 8 + g;
        const uint32_t bw[2] = {pack_bf16(w0[0], w0[ldw]),
                                pack_bf16(w0[8 * ldw], w0[9 * ldw])};
        capf::mma_bf16_16x8x16(acc[j], a, bw);
      }
    }
  }
  __syncthreads();  // every warp is done with the A tile

  // bias, rounded to bf16, staged over the A tile; then 16-byte stores
  const int ldo = cout + kPad;
#pragma unroll
  for (int j = 0; j < kMaxCout / 16; ++j) {
    const int nt = warp / 4 + 2 * j;
    if (nt < ntiles) {
      const int col = nt * 8 + 2 * q;
      const float b0 = lv.proj_b != nullptr ? lv.proj_b[col] : 0.f;
      const float b1 = lv.proj_b != nullptr ? lv.proj_b[col + 1] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(s_a + row * ldo + col) =
          __floats2bfloat162_rn(acc[j][0] + b0, acc[j][1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(s_a + (row + 8) * ldo + col) =
          __floats2bfloat162_rn(acc[j][2] + b0, acc[j][3] + b1);
    }
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(lv.out) +
              (static_cast<size_t>(b) * num_points + p0) * cout;
  const int pieces = cout / 8;
  for (int i = tid; i < n * pieces; i += kThreads) {
    const int r = i / pieces;
    const int pc = (i - r * pieces) * 8;
    *reinterpret_cast<uint4*>(out + r * cout + pc) =
        *reinterpret_cast<const uint4*>(s_a + r * ldo + pc);
  }
}

// T: the maps' type (float, __nv_bfloat16 or int8_t); O: the outputs'
// (T, or __nv_bfloat16 for int8 maps). kTc: the build with the tensor-core
// projected body, launched only for calls that have such a level, so that
// the gather alone (the zeros call, K8) keeps its own, smaller register
// budget and its occupancy.
template <typename T, typename O, bool kTc>
__global__ void __launch_bounds__(kThreads)
    sample_levels_kernel(const CapfSampleArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_rows[kChunk][4];
  __shared__ float s_wts[kChunk][4];

  const int lvl = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const CapfSampleLevel lv = args.levels[lvl];
  const int num_points = args.num_points;
  const int c = lv.c;
  const bool proj = lv.proj_w != nullptr;
  if constexpr (kTc && !std::is_same<T, float>::value) {
    if (proj) {  // uniform per block: the level decides
      if (blockIdx.x * kChunk < num_points) {
        project_chunk<T>(args, lv, lvl, b, smem_raw, s_rows, s_wts);
      }
      return;
    }
  }
  const int tile0 = blockIdx.x * kTile;
  if (tile0 >= num_points) return;

  float* s_w = reinterpret_cast<float*>(smem_raw);  // (C, Cout)
  float* s_samp = s_w + (proj ? c * lv.cout : 0);   // (kTile, C)

  stage_taps(args, lv, lvl, b, tile0, min(kTile, num_points - tile0), kTile,
             s_rows, s_wts);
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
cudaError_t launch(const CapfSampleArgs& args, size_t smem, bool tc,
                   bool all_tc, cudaStream_t stream) {
  auto kernel = tc ? sample_levels_kernel<T, O, true>
                   : sample_levels_kernel<T, O, false>;
  cudaError_t err = capf::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tile = all_tc ? kChunk : kTile;
  const dim3 grid((args.num_points + tile - 1) / tile, args.num_levels,
                  args.batch);
  kernel<<<grid, kThreads, smem, stream>>>(args);
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
  const bool fp32 = args->dtype == capf::kFloat32;
  const int vec = args->dtype == capf::kInt8 ? 16 : fp32 ? 4 : 8;
  bool any_tc = false, all_tc = true;  // levels taking the tensor-core body
  for (int l = 0; l < args->num_levels; ++l) {
    const CapfSampleLevel& lv = args->levels[l];
    if (lv.c % vec != 0) return cudaErrorInvalidValue;
    const bool tc = !fp32 && lv.proj_w != nullptr;
    any_tc = any_tc || tc;
    all_tc = all_tc && tc;
    if (lv.proj_w == nullptr) continue;
    size_t need;
    if (fp32) {
      if (lv.cout % 4 != 0) return cudaErrorInvalidValue;  // C: above
      need = static_cast<size_t>(lv.c) * (lv.cout + kTile) * sizeof(float);
    } else {
      if (lv.c % 16 || lv.cout % 8 || lv.cout > kMaxCout) {
        return cudaErrorInvalidValue;
      }
      const int lda = (lv.c > lv.cout ? lv.c : lv.cout) + kPad;
      need = static_cast<size_t>(kChunk) * lda * sizeof(__nv_bfloat16) +
             static_cast<size_t>(lv.c) * (lv.cout + 4) * sizeof(float);
    }
    smem = need > smem ? need : smem;
  }
  if (args->dtype == capf::kInt8) {
    err = launch<int8_t, __nv_bfloat16>(*args, smem, any_tc, all_tc, stream);
  } else if (args->dtype == capf::kBFloat16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(*args, smem, any_tc, all_tc,
                                               stream);
  } else {
    err = launch<float, float>(*args, smem, false, false, stream);
  }
  return static_cast<int>(err);
}
