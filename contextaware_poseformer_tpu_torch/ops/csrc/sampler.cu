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
// Geometry: one flat grid of work units. A level's points are flattened
// over (item, point), and each level cuts them into units of its own size,
// so no block of a call is empty and each body takes the shape it needs:
// - the gather (no projection): enough 16-byte (point, channel group) items
//   that every thread blends 4 of them (256 points at C = 32 in bf16, 32 at
//   C = 256), at most kMaxPoints and at most one item's points (the zeros
//   call's 17);
// - the tensor-core projection (bf16 and int8 maps): kChunk = 64 points;
// - the fp32 projection: kTile = 32 points.
// ops/deformable.py::sampler_plan owns the plan: each level's unit, the
// order in which the levels' units fill the grid and where each level's
// units end; the host entry below checks them and sizes the shared memory.
// A block's dynamic shared memory starts with its points' tap rows and
// weights (32 bytes a point), then its body's own region, so a gather
// block of a mixed call reserves what the largest level needs, and no
// more: the tensor-core body stages W in bf16.
//
// Every body issues the taps of several items a thread (kGatherBatch,
// kTcBatch) before it blends any of them, and blends in fp32 in the tap
// order 00, 01, 10, 11. The units of the levels with the most work a unit
// run first (blocks start roughly in index order; HRNet's widest level
// last would trail the launch). The tensor-core builds cap their registers
// so that 3 blocks share an SM. These choices were measured on the card
// (PERF.md).
//
// Projection (deformable blocks, border mode only): sample-then-project. For
// 272 points against a 3072-pixel map this is ~11x less work than projecting
// the map first, and it equals sample(F @ W + b) exactly because border-mode
// weights sum to 1 (the Python wrapper refuses a projection in zeros mode).
// - bf16 and int8 maps (the serving path): a block of 64 points issues its
//   level's W into shared memory by 16-byte cp.asyncs, which stay in flight
//   while it gathers. W arrives as the bf16 W^T (Cout, C) that the wrapper
//   makes once per parameter state. The blend is rounded once to bf16 into
//   a padded A tile. The projection runs on the tensor cores (mma.sync
//   m16n8k16 bf16 -> fp32; a warp takes one 16-point row tile and every
//   other 8-output column tile), then the level's scale where it has one
//   (an int8 level's dequant scale) and the bias, in fp32, and the bf16
//   tile is staged for 16-byte stores. Rounding points: the blend and W are
//   rounded to bf16, the products accumulate in fp32. The plain version
//   projects fp32 blends with fp32 W (times the scale); the JAX kernel
//   projects with bf16 operands and fp32 accumulation (DEFAULT precision),
//   so these roundings are the reference's own arithmetic, except that the
//   JAX kernel rounds W * scale to bf16 where this body rounds W and
//   scales the fp32 product. Needs C divisible by 16 and Cout by 8, Cout <=
//   64; the padded rows make every fragment load conflict-free.
// - fp32 maps (parity runs and training): a unit of kTile points is blended
//   in fp32 into shared memory, then multiplied by W (C x Cout, fp32 in
//   shared memory) plus b on CUDA cores, float4 reads: a thread takes one
//   point and 4 outputs, and one sample load and 4 weight loads feed 16
//   FMAs, then the scale and the bias. Needs C and Cout divisible by 4.
//
// K5: the same kernel also replaces the separable two-stage branch of
// _sample_body_xy (deformable.py:148-197), which the TPU takes on large
// maps with few channels (H*W >= 1024, C < 64: HRNet's 64x48 level 0 with
// C = 32 or 48) only to fill its 128 output lanes. A gather has no lanes to
// fill: each point still reads its four taps, so K5's port is this kernel at
// those shapes; in W32's border call its level stays unprojected (C = 32
// is the head dim) and takes gather units of 256 points.
//
// K8: the single-level sampler (_sample_kernel / _sample_kernel_2stage,
// reached through sample_points) is this kernel launched with one level;
// the TPU's one-stage and two-stage bodies both become this gather.
//
// A call with no tensor-core level launches the build without that body
// (kTc = false), whose smaller register budget keeps the gather's
// occupancy.
//
// int8 maps (the deploy graph's raw quantized samples, K1 and K8): a
// 16-byte load carries 16 channels (C % 16 == 0), the blend stays fp32 and
// rounds once to bf16, as the TPU kernel's bf16 output. The caller owns the
// dequant scale: a projected int8 level (the CPN deploy graph's lifter)
// hands it as the level's proj_scale, which multiplies the projection of
// the blend of the raw int8 taps (deformable.py:541-561).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using capf::from_float;
using capf::to_float;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kTile = 32;        // points a unit: the fp32 projection
constexpr int kChunk = 64;       // points a unit: the tensor-core projection
constexpr int kMaxPoints = 256;  // points a unit: the gather
constexpr int kMaxCout = 64;     // tensor-core outputs: 4 n-tiles of 8 a warp
constexpr int kPad = 8;          // bf16 padding of its shared-memory rows
constexpr int kTapBytes = 32;    // a point's tap rows and weights
// items a thread loads together: the gather and the tensor-core body
constexpr int kGatherBatch = 2;
constexpr int kTcBatch = 2;
// blocks an SM must hold for a build with the tensor-core body: a cap on
// its registers (80 allocated), so that 3 blocks share an SM
constexpr int kTcBlocksPerSm = 3;

}  // namespace

extern "C" {

struct CapfSampleLevel {
  const void* feat;     // (B, H, W, C) NHWC, in the call's dtype
  const void* proj_w;   // W: fp32 (C, Cout) for fp32 maps, bf16 W^T
                        // (Cout, C) for the tensor-core body; null: no
                        // projection
  const float* proj_b;  // (Cout,) fp32, or null: no bias
  // one fp32 that multiplies the projection before the bias (an int8
  // level's dequant scale), or null
  const float* proj_scale;
  void* out;  // (B, P, Cout), in the call's dtype (bf16: int8)
  int h, w, c, cout;
  int unit_points;  // points a unit of this level takes
};

struct CapfSampleArgs {
  const float* points;  // (B, L, P, 2) fp32, x then y
  CapfSampleLevel levels[kMaxLevels];
  int num_levels, batch, num_points, border, align_corners, dtype;
  // the levels in the order their units run and the units of the first
  // i + 1 of them (ops/deformable.py::sampler_plan; checked by the entry)
  int order[kMaxLevels], unit_end[kMaxLevels];
};

}  // extern "C"

namespace {

using bf16 = __nv_bfloat16;

// The tap rows (item * H * W + y * W + x) and bilinear weights of the flat
// points q0 .. q0 + n - 1 of one level into s_rows / s_wts; slots n ..
// n_slots - 1 get row 0, weight 0.
__device__ __forceinline__ void stage_taps(const CapfSampleArgs& args,
                                           const CapfSampleLevel& lv, int lvl,
                                           int q0, int n, int n_slots,
                                           int4* s_rows, float4* s_wts) {
  for (int i = threadIdx.x; i < n_slots; i += kThreads) {
    int r[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < n) {
      const int q = q0 + i;
      const int b = q / args.num_points;
      const int p = q - b * args.num_points;
      const float2 xy = *reinterpret_cast<const float2*>(
          args.points +
          ((static_cast<size_t>(b) * args.num_levels + lvl) *
               args.num_points + p) * 2);
      capf::point_taps(xy.x, xy.y, lv.h, lv.w, args.border != 0,
                       args.align_corners != 0, r, wt);
      const int base = b * lv.h * lv.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] += base;
    }
    s_rows[i] = make_int4(r[0], r[1], r[2], r[3]);
    s_wts[i] = make_float4(wt[0], wt[1], wt[2], wt[3]);
  }
}

// The blend of the unit's n points: an item is one 16-byte channel group
// (4 fp32, 8 bf16 or 16 int8 channels) of one point, consecutive threads
// on consecutive groups of a point. A thread loads the 4 taps of kBatch
// items, then blends each in fp32 and hands it to emit(point, channel,
// values).
template <typename T, int kBatch, typename Emit>
__device__ __forceinline__ void blend_items(const T* feat, int c, int n,
                                            const int4* s_rows,
                                            const float4* s_wts, Emit emit) {
  constexpr int kVec = 16 / sizeof(T);
  const int groups = c / kVec;
  const int items = n * groups;
  for (int i0 = threadIdx.x; i0 < items; i0 += kThreads * kBatch) {
    uint4 raw[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < items) {
        const int pl = i / groups;
        const int ch = (i - pl * groups) * kVec;
        const int4 r = s_rows[pl];
        const int rows[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          raw[u][k] = *reinterpret_cast<const uint4*>(
              feat + static_cast<size_t>(rows[k]) * c + ch);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < items) {
        const int pl = i / groups;
        const int ch = (i - pl * groups) * kVec;
        const float4 w = s_wts[pl];
        const float wk[4] = {w.x, w.y, w.z, w.w};
        float acc[kVec] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const T* tap = reinterpret_cast<const T*>(&raw[u][k]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] += wk[k] * to_float(tap[e]);
        }
        emit(pl, ch, acc);
      }
    }
  }
}

// two fp32 values rounded to bf16 (round to nearest even), the first in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// W^T (Cout, C) bf16 of a tensor-core level into shared memory by 16-byte
// cp.asyncs (one group), in rows of C + kPad, so that the B fragments'
// loads hit distinct banks.
__device__ __forceinline__ void stage_w(const CapfSampleLevel& lv,
                                        bf16* s_w) {
  const int ldw = lv.c + kPad;
  const int pieces = lv.c / 8;
  const bf16* wt = static_cast<const bf16*>(lv.proj_w);
  for (int i = threadIdx.x; i < lv.cout * pieces; i += kThreads) {
    const int n = i / pieces;
    capf::sm90::cp_async16(s_w + n * ldw + (i - n * pieces) * 8, wt + 8 * i,
                           16);
  }
  capf::sm90::cp_async_commit();
}

// the scale a level's projection is multiplied by (1 without one)
__device__ __forceinline__ float proj_scale(const CapfSampleLevel& lv) {
  return lv.proj_scale != nullptr ? *lv.proj_scale : 1.f;
}

// The projected body on the tensor cores (bf16 or int8 maps T): the unit's
// n <= kChunk flat points q0 .. q0 + n - 1, sampled, projected by W, scaled
// and biased, stored as bf16. ``body``: the A tile (kChunk, lda) bf16,
// which later stages the output, then W^T (staged by stage_w).
template <typename T>
__device__ __forceinline__ void project_chunk(const CapfSampleLevel& lv,
                                              int q0, int n,
                                              unsigned char* body,
                                              const int4* s_rows,
                                              const float4* s_wts) {
  const int tid = threadIdx.x;
  const int c = lv.c, cout = lv.cout;
  const int lda = (c > cout ? c : cout) + kPad;
  const int ldw = c + kPad;
  bf16* s_a = reinterpret_cast<bf16*>(body);
  const bf16* s_w = s_a + kChunk * lda;

  // the blend, rounded once to bf16 into the A tile; rows of points past n
  // are never written: their products are never stored
  blend_items<T, kTcBatch>(
      static_cast<const T*>(lv.feat), c, n, s_rows, s_wts,
      [&](int pl, int ch, const float* acc) {
        constexpr int kVec = 16 / sizeof(T);
        uint32_t words[kVec / 2];
#pragma unroll
        for (int e = 0; e < kVec / 2; ++e) {
          words[e] = pack_bf16(acc[2 * e], acc[2 * e + 1]);
        }
        uint4* dst = reinterpret_cast<uint4*>(s_a + pl * lda + ch);
#pragma unroll
        for (int s = 0; s < kVec / 8; ++s) {
          dst[s] = make_uint4(words[4 * s], words[4 * s + 1],
                              words[4 * s + 2], words[4 * s + 3]);
        }
      });
  capf::sm90::cp_async_wait<0>();
  __syncthreads();

  // project: warp w takes rows 16 (w % kRowTiles) .. + 15 and the
  // 8-output column tiles w / kRowTiles + j * kColStep; fragments by 32-bit
  // loads
  constexpr int kRowTiles = kChunk / 16, kColStep = 8 / kRowTiles;
  constexpr int kTiles = kMaxCout / 8 / kColStep;  // column tiles a warp
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int row = 16 * (warp % kRowTiles) + g;
  const int ntiles = cout / 8;
  float acc[kTiles][4] = {};
  const bf16* a_row = s_a + row * lda + 2 * q;
  for (int k0 = 0; k0 < c; k0 += 16) {
    const uint32_t a[4] = {
        *reinterpret_cast<const uint32_t*>(a_row + k0),
        *reinterpret_cast<const uint32_t*>(a_row + 8 * lda + k0),
        *reinterpret_cast<const uint32_t*>(a_row + k0 + 8),
        *reinterpret_cast<const uint32_t*>(a_row + 8 * lda + k0 + 8)};
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int nt = warp / kRowTiles + kColStep * j;
      if (nt < ntiles) {
        const bf16* w0 = s_w + (nt * 8 + g) * ldw + k0 + 2 * q;
        const uint32_t bw[2] = {*reinterpret_cast<const uint32_t*>(w0),
                                *reinterpret_cast<const uint32_t*>(w0 + 8)};
        capf::mma_bf16_16x8x16(acc[j], a, bw);
      }
    }
  }
  __syncthreads();  // every warp is done with the A tile

  // scale and bias in fp32, rounded to bf16, staged over the A tile; then
  // 16-byte stores
  const int ldo = cout + kPad;
  const float sc = proj_scale(lv);
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int nt = warp / kRowTiles + kColStep * j;
    if (nt < ntiles) {
      const int col = nt * 8 + 2 * q;
      const float b0 = lv.proj_b != nullptr ? lv.proj_b[col] : 0.f;
      const float b1 = lv.proj_b != nullptr ? lv.proj_b[col + 1] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(s_a + row * ldo + col) =
          __floats2bfloat162_rn(acc[j][0] * sc + b0, acc[j][1] * sc + b1);
      *reinterpret_cast<__nv_bfloat162*>(s_a + (row + 8) * ldo + col) =
          __floats2bfloat162_rn(acc[j][2] * sc + b0, acc[j][3] * sc + b1);
    }
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(lv.out) + static_cast<size_t>(q0) * cout;
  const int pieces = cout / 8;
  for (int i = tid; i < n * pieces; i += kThreads) {
    const int r = i / pieces;
    const int pc = (i - r * pieces) * 8;
    *reinterpret_cast<uint4*>(out + r * cout + pc) =
        *reinterpret_cast<const uint4*>(s_a + r * ldo + pc);
  }
}

// The fp32 projected body: the unit's n <= kTile points blended into fp32
// samples in shared memory, then one thread per (point, 4 outputs)
// projects on CUDA cores. ``body``: W (C, Cout) fp32, then the samples.
__device__ __forceinline__ void project_fp32(const CapfSampleLevel& lv,
                                             int q0, int n,
                                             unsigned char* body,
                                             const int4* s_rows,
                                             const float4* s_wts) {
  const int tid = threadIdx.x;
  const int c = lv.c, cout = lv.cout;
  float* s_w = reinterpret_cast<float*>(body);  // (C, Cout)
  float* s_samp = s_w + c * cout;               // (kTile, C)
  const float4* w4 = static_cast<const float4*>(lv.proj_w);
  float4* s_w4 = reinterpret_cast<float4*>(s_w);
  for (int i = tid; i < c * cout / 4; i += kThreads) s_w4[i] = w4[i];
  blend_items<float, kGatherBatch>(
      static_cast<const float*>(lv.feat), c, n, s_rows, s_wts,
      [&](int pl, int ch, const float* acc) {
        *reinterpret_cast<float4*>(s_samp + pl * c + ch) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      });
  __syncthreads();

  float* out = static_cast<float*>(lv.out) + static_cast<size_t>(q0) * cout;
  const int quads = cout / 4;
  const float sc = proj_scale(lv);
  for (int i = tid; i < n * quads; i += kThreads) {
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
    float* o = out + pl * cout + d0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = acc[e] * sc + (lv.proj_b != nullptr ? lv.proj_b[d0 + e] : 0.f);
    }
  }
}

// T: the maps' type (float, __nv_bfloat16 or int8_t); O: the outputs'
// (T, or __nv_bfloat16 for int8 maps). kTc: the build with the tensor-core
// projected body, launched only for calls that have such a level.
template <typename T, typename O, bool kTc>
__global__ void __launch_bounds__(kThreads, kTc ? kTcBlocksPerSm : 1)
    sample_levels_kernel(const CapfSampleArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];

  int pos = 0;  // uniform per block: the level whose unit this block takes
  while (blockIdx.x >= static_cast<unsigned>(args.unit_end[pos])) ++pos;
  const int unit = blockIdx.x - (pos > 0 ? args.unit_end[pos - 1] : 0);
  const int lvl = args.order[pos];
  const CapfSampleLevel lv = args.levels[lvl];
  const int total = args.batch * args.num_points;
  const int q0 = unit * lv.unit_points;
  const int n = min(lv.unit_points, total - q0);
  int4* s_rows = reinterpret_cast<int4*>(smem);
  float4* s_wts = reinterpret_cast<float4*>(smem + 16 * lv.unit_points);
  unsigned char* body = smem + kTapBytes * lv.unit_points;
  const bool proj = lv.proj_w != nullptr;

  if constexpr (kTc && !std::is_same<T, float>::value) {
    if (proj) {
      const int lda = (lv.c > lv.cout ? lv.c : lv.cout) + kPad;
      // W in flight during the gather
      stage_w(lv, reinterpret_cast<bf16*>(body) + kChunk * lda);
      stage_taps(args, lv, lvl, q0, n, kChunk, s_rows, s_wts);
      __syncthreads();
      project_chunk<T>(lv, q0, n, body, s_rows, s_wts);
      return;
    }
  }
  stage_taps(args, lv, lvl, q0, n, n, s_rows, s_wts);
  __syncthreads();
  if constexpr (std::is_same<T, float>::value) {
    if (proj) {
      project_fp32(lv, q0, n, body, s_rows, s_wts);
      return;
    }
  }
  // the gather: 16-byte stores of the blends
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kStores = kVec * sizeof(O) / 16;
  const int c = lv.c;
  O* out = static_cast<O*>(lv.out) + static_cast<size_t>(q0) * c;
  blend_items<T, kGatherBatch>(
      static_cast<const T*>(lv.feat), c, n, s_rows, s_wts,
      [&](int pl, int ch, const float* acc) {
        alignas(16) O o[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = from_float<O>(acc[e]);
        uint4* dst =
            reinterpret_cast<uint4*>(out + static_cast<size_t>(pl) * c + ch);
#pragma unroll
        for (int s = 0; s < kStores; ++s) {
          dst[s] = reinterpret_cast<const uint4*>(o)[s];
        }
      });
}

template <typename T, typename O>
cudaError_t launch(const CapfSampleArgs& args, size_t smem, bool tc,
                   cudaStream_t stream) {
  auto kernel = tc ? sample_levels_kernel<T, O, true>
                   : sample_levels_kernel<T, O, false>;
  cudaError_t err = capf::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<args.unit_end[args.num_levels - 1], kThreads, smem, stream>>>(
      args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_sample_levels(const CapfSampleArgs* in, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (in->num_levels < 1 || in->num_levels > kMaxLevels ||
      in->num_points < 1 || in->batch < 1 ||
      static_cast<long long>(in->batch) * in->num_points > (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  CapfSampleArgs args = *in;
  const bool fp32 = args.dtype == capf::kFloat32;
  const int vec = args.dtype == capf::kInt8 ? 16 : fp32 ? 4 : 8;
  const int total = args.batch * args.num_points;
  size_t smem = 0;
  bool any_tc = false;  // a level takes the tensor-core body
  for (int l = 0; l < args.num_levels; ++l) {
    const CapfSampleLevel& lv = args.levels[l];
    if (lv.c < vec || lv.c % vec != 0 || lv.h < 1 || lv.w < 1 ||
        static_cast<long long>(args.batch) * lv.h * lv.w >= (1LL << 31)) {
      return cudaErrorInvalidValue;
    }
    size_t need = static_cast<size_t>(kTapBytes) * lv.unit_points;
    if (lv.proj_w == nullptr) {  // the gather
      if (lv.unit_points < 1 || lv.unit_points > kMaxPoints ||
          lv.proj_scale != nullptr) {
        return cudaErrorInvalidValue;
      }
    } else if (fp32) {
      if (lv.cout % 4 != 0 || lv.unit_points != kTile) {
        return cudaErrorInvalidValue;
      }
      need += static_cast<size_t>(lv.c) * (lv.cout + kTile) * sizeof(float);
    } else {
      if (lv.c % 16 || lv.cout % 8 || lv.cout > kMaxCout ||
          lv.unit_points != kChunk) {
        return cudaErrorInvalidValue;
      }
      any_tc = true;
      const int lda = (lv.c > lv.cout ? lv.c : lv.cout) + kPad;
      need += static_cast<size_t>(kChunk) * lda * sizeof(bf16);
      need += static_cast<size_t>(lv.cout) * (lv.c + kPad) * sizeof(bf16);
    }
    smem = need > smem ? need : smem;
  }
  // the plan's order: each level once; unit_end: its running unit count
  bool placed[kMaxLevels] = {};
  long long units = 0;
  for (int i = 0; i < args.num_levels; ++i) {
    const int l = args.order[i];
    if (l < 0 || l >= args.num_levels || placed[l]) {
      return cudaErrorInvalidValue;
    }
    placed[l] = true;
    const int size = args.levels[l].unit_points;
    units += (total + size - 1) / size;
    if (args.unit_end[i] != units) return cudaErrorInvalidValue;
  }
  if (smem > 232448 || units > (1LL << 30)) return cudaErrorInvalidValue;
  if (args.dtype == capf::kInt8) {
    err = launch<int8_t, __nv_bfloat16>(args, smem, any_tc, stream);
  } else if (args.dtype == capf::kBFloat16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(args, smem, any_tc, stream);
  } else {
    err = launch<float, float>(args, smem, false, stream);
  }
  return static_cast<int>(err);
}
