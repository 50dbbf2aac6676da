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
// - the fp32 projection: kF32Points = 64 points.
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
// - fp32 maps (the fp32 lifter's routes): a build of its own (kProj with
//   T = float: kF32Threads = 64 threads a block, 6 blocks an SM by a cap
//   of 170 registers) takes units of kF32Points = 32 points through
//   K-slices of kF32Slice = 32 channels. A two-slot ring in shared memory
//   holds a slice's blends (points x slice, rows padded to kF32Pitch
//   floats) and the slice's rows of W (fp32 (C, Cout), by 16-byte
//   cp.asyncs). While the FMAs of slice s run on one slot, each thread
//   already has the taps of its four (point, 4-channel) items of slice
//   s + 1 in flight (16 16-byte loads held in registers) and W's rows of
//   slice s + 1 on their way; it then blends them into the other slot, and
//   one barrier a slice closes the step. The product is register-tiled
//   (f32_tile.cuh, fma_slice: a thread's 4 points x 4 outputs, exact FMAs,
//   no TF32), then the scale and the bias, and 16-byte stores from the
//   registers. Outputs past kF32Cols take another pass over the slices.
//   The footprint does not grow with C (18 KB a block), so every level
//   takes it and six blocks share an SM, one's gather beside another's
//   products. Measured on the card against other geometries (PERF.md):
//   fewer loads in flight a thread (16- or 8-channel slices), larger
//   micro-tiles (6 or 8 points), 128-thread blocks of 64 points, and taps
//   staged by cp.async into a 3-slot ring were slower. Needs C and Cout
//   divisible by 4. The fp32 gather keeps its own build (a gather that
//   shared a build with a projection measured 20% slower).

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
// A call with no projected level launches the build without a projected
// body (kProj = false), whose smaller register budget keeps the gather's
// occupancy; the gather levels of a call that projects run in the
// projected build (fp32: 64 threads a block, so gather_points cuts the
// unit to a quarter).
//
// int8 maps (the deploy graph's raw quantized samples, K1 and K8): a
// 16-byte load carries 16 channels (C % 16 == 0), the blend stays fp32 and
// rounds once to bf16, as the TPU kernel's bf16 output. The caller owns the
// dequant scale: a projected int8 level (the CPN deploy graph's lifter)
// hands it as the level's proj_scale, which multiplies the projection of
// the blend of the raw int8 taps (deformable.py:541-561).

#include <type_traits>

#include "common.cuh"
#include "f32_tile.cuh"
#include "hopper.cuh"

using capf::from_float;
using capf::to_float;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
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
// the fp32 projected build: threads a block, points a unit, channels a
// K-slice, outputs a pass (8 column groups of 4), floats a staged sample
// row (pitch = 4 mod 32: the 4 rows a warp reads at one k fall in
// distinct banks), blocks an SM it must hold (a cap of 170 registers)
constexpr int kF32Threads = 64;
constexpr int kF32Points = 32;
constexpr int kF32Slice = 32;
constexpr int kF32Cols = 32;
constexpr int kF32Pitch = kF32Slice + 4;
constexpr int kF32BlocksPerSm = 6;
// a thread's micro-tile: kF32Rows points (every kF32RowGroups-th) x 4
// outputs; its gather items a slice: (point, 4-channel group) pairs
constexpr int kF32RowGroups = kF32Threads / (kF32Cols / 4);
constexpr int kF32Rows = kF32Points / kF32RowGroups;
constexpr int kF32Groups = kF32Slice / 4;
constexpr int kF32Items = kF32Points * kF32Groups / kF32Threads;
// the fp32 projected body's shared memory after the taps: two slots of
// (points x pitch) blends and (slice x kF32Cols) rows of W, in floats
constexpr int kF32SampSlot = kF32Points * kF32Pitch;
constexpr int kF32WSlot = kF32Slice * kF32Cols;
constexpr int kF32RingBytes = 2 * (kF32SampSlot + kF32WSlot) * 4;
static_assert(kF32Items * kF32Threads == kF32Points * kF32Groups &&
                  kF32Threads % kF32Groups == 0,
              "whole gather items a thread and slice");
static_assert(kF32Rows * kF32RowGroups == kF32Points,
              "one micro-tile a thread at kF32Cols outputs");

// a build's threads a block and the blocks an SM its register cap is set
// for: the projected builds (kProj) of fp32 and of bf16/int8 maps, and
// the gather-only builds
template <typename T, bool kProj>
constexpr int kBlockThreads =
    kProj && std::is_same<T, float>::value ? kF32Threads : kThreads;
template <typename T, bool kProj>
constexpr int kMinBlocks =
    !kProj ? 1 : std::is_same<T, float>::value ? kF32BlocksPerSm
                                               : kTcBlocksPerSm;

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
// n_slots - 1 get row 0, weight 0. kBlock: the block's threads.
template <int kBlock>
__device__ __forceinline__ void stage_taps(const CapfSampleArgs& args,
                                           const CapfSampleLevel& lv, int lvl,
                                           int q0, int n, int n_slots,
                                           int4* s_rows, float4* s_wts) {
  for (int i = threadIdx.x; i < n_slots; i += kBlock) {
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
// values). kBlock: the block's threads.
template <typename T, int kBatch, int kBlock, typename Emit>
__device__ __forceinline__ void blend_items(const T* feat, int c, int n,
                                            const int4* s_rows,
                                            const float4* s_wts, Emit emit) {
  constexpr int kVec = 16 / sizeof(T);
  const int groups = c / kVec;
  const int items = n * groups;
  for (int i0 = threadIdx.x; i0 < items; i0 += kBlock * kBatch) {
    uint4 raw[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kBlock;
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
      const int i = i0 + u * kBlock;
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
  blend_items<T, kTcBatch, kThreads>(
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

// The fp32 blend of one (point, 4-channel) item from its 4 taps, in the
// tap order 00, 01, 10, 11, as blend_items blends.
__device__ __forceinline__ float4 blend4(const float4 (&tap)[4], float4 w) {
  const float wk[4] = {w.x, w.y, w.z, w.w};
  float acc[4] = {};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float t[4] = {tap[k].x, tap[k].y, tap[k].z, tap[k].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += wk[k] * t[e];
  }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// The fp32 projected body (the fp32 projected build, kF32Threads threads):
// the unit's n <= kF32Points flat points q0 .. q0 + n - 1, sampled,
// projected by W (C, Cout) fp32, scaled and biased, stored as fp32.
// ``body``: two slots of blends (kF32Points x kF32Pitch), then two slots of
// W rows (kF32Slice x the pass's outputs). Slice s blends channels
// s * kF32Slice .. + kF32Slice - 1 (zeros past C, where W's rows are zero
// too); thread t gathers channel group t % kF32Groups of the points
// t / kF32Groups + i * kF32Threads / kF32Groups (i < kF32Items).
__device__ __forceinline__ void project_fp32(const CapfSampleLevel& lv,
                                             int q0, int n,
                                             unsigned char* body,
                                             const int4* s_rows,
                                             const float4* s_wts) {
  using capf::sm90::cp_async16;
  const int tid = threadIdx.x;
  const int c = lv.c, cout = lv.cout;
  const float* feat = static_cast<const float*>(lv.feat);
  const float* w = static_cast<const float*>(lv.proj_w);
  float* s_samp = reinterpret_cast<float*>(body);
  float* s_w = s_samp + 2 * kF32SampSlot;
  const int slices = (c + kF32Slice - 1) / kF32Slice;
  constexpr int kStride = kF32Threads / kF32Groups;  // points between items
  const int grp = tid % kF32Groups, pt = tid / kF32Groups;
  int4 rows[kF32Items];
  float4 wts[kF32Items];
#pragma unroll
  for (int u = 0; u < kF32Items; ++u) {
    rows[u] = s_rows[pt + u * kStride];
    wts[u] = s_wts[pt + u * kStride];
  }
  const float sc = proj_scale(lv);

  for (int c0 = 0; c0 < cout; c0 += kF32Cols) {
    // this pass's column groups, and the threads that own a micro-tile
    const int cg = min(kF32Cols, cout - c0) / 4;
    const bool owner = tid < kF32RowGroups * cg;
    const capf::f32::Place at = capf::f32::place(kF32RowGroups, cg);
    float acc[kF32Rows][4];
    capf::f32::zero(acc);
    float4 raw[kF32Items][4];
    // W rows of slice s (columns c0 .. c0 + 4 cg - 1) into its slot, one
    // cp.async group; rows past C zero-filled
    auto stage_rows = [&](int s) {
      float* dst = s_w + (s & 1) * kF32WSlot;
      for (int p = tid; p < kF32Slice * cg; p += kF32Threads) {
        const int r = p / cg, q = p - r * cg;
        const int k = s * kF32Slice + r;
        const bool in = k < c;
        cp_async16(dst + r * 4 * cg + 4 * q,
                   in ? w + static_cast<size_t>(k) * cout + c0 + 4 * q : w,
                   in ? 16 : 0);
      }
      capf::sm90::cp_async_commit();
    };
    // the taps of this thread's items of slice s, in flight together
    auto load = [&](int s) {
      const int ch = s * kF32Slice + 4 * grp;
      if (ch < c) {
#pragma unroll
        for (int u = 0; u < kF32Items; ++u) {
          const int r[4] = {rows[u].x, rows[u].y, rows[u].z, rows[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            raw[u][k] = *reinterpret_cast<const float4*>(
                feat + static_cast<size_t>(r[k]) * c + ch);
          }
        }
      }
    };
    auto blend = [&](int s) {
      float* dst = s_samp + (s & 1) * kF32SampSlot + 4 * grp;
      const bool in = s * kF32Slice + 4 * grp < c;
#pragma unroll
      for (int u = 0; u < kF32Items; ++u) {
        *reinterpret_cast<float4*>(dst + (pt + u * kStride) * kF32Pitch) =
            in ? blend4(raw[u], wts[u]) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };

    stage_rows(0);
    load(0);
    blend(0);
    capf::sm90::cp_async_wait<0>();
    __syncthreads();
    for (int s = 0; s < slices; ++s) {
      const bool next = s + 1 < slices;
      if (next) {  // slice s + 1 in flight while slice s's FMAs run
        stage_rows(s + 1);
        load(s + 1);
      }
      if (owner) {
        capf::f32::fma_slice<kF32Rows, 4, kF32Slice>(
            acc, s_samp + (s & 1) * kF32SampSlot + at.tr * kF32Pitch,
            kF32RowGroups * kF32Pitch,
            s_w + (s & 1) * kF32WSlot + at.tc * 4, 4 * cg, 0);
      }
      if (next) blend(s + 1);
      capf::sm90::cp_async_wait<0>();
      __syncthreads();
    }

    if (owner) {  // the scale and the bias, 16-byte stores
      const int col = c0 + 4 * at.tc;
      float b[4] = {0.f, 0.f, 0.f, 0.f};
      if (lv.proj_b != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = lv.proj_b[col + e];
      }
      float* out = static_cast<float*>(lv.out);
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const int row = at.tr + kF32RowGroups * i;
        if (row < n) {
          *reinterpret_cast<float4*>(
              out + static_cast<size_t>(q0 + row) * cout + col) =
              make_float4(acc[i][0] * sc + b[0], acc[i][1] * sc + b[1],
                          acc[i][2] * sc + b[2], acc[i][3] * sc + b[3]);
        }
      }
    }
  }
}

// T: the maps' type (float, __nv_bfloat16 or int8_t); O: the outputs'
// (T, or __nv_bfloat16 for int8 maps). kProj: the build with the projected
// body (the tensor cores for bf16 and int8 maps, fp32 FMAs for fp32 maps),
// launched only for calls that have a projected level.
template <typename T, typename O, bool kProj>
__global__ void __launch_bounds__(kBlockThreads<T, kProj>,
                                  kMinBlocks<T, kProj>)
    sample_levels_kernel(const CapfSampleArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBlock = kBlockThreads<T, kProj>;
  constexpr bool kFloat = std::is_same<T, float>::value;

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

  if constexpr (kProj && !kFloat) {
    if (proj) {
      const int lda = (lv.c > lv.cout ? lv.c : lv.cout) + kPad;
      // W in flight during the gather
      stage_w(lv, reinterpret_cast<bf16*>(body) + kChunk * lda);
      stage_taps<kBlock>(args, lv, lvl, q0, n, kChunk, s_rows, s_wts);
      __syncthreads();
      project_chunk<T>(lv, q0, n, body, s_rows, s_wts);
      return;
    }
  }
  if constexpr (kProj && kFloat) {
    if (proj) {
      stage_taps<kBlock>(args, lv, lvl, q0, n, kF32Points, s_rows, s_wts);
      __syncthreads();
      project_fp32(lv, q0, n, body, s_rows, s_wts);
      return;
    }
  }
  stage_taps<kBlock>(args, lv, lvl, q0, n, n, s_rows, s_wts);
  __syncthreads();
  // the gather: 16-byte stores of the blends
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kStores = kVec * sizeof(O) / 16;
  const int c = lv.c;
  O* out = static_cast<O*>(lv.out) + static_cast<size_t>(q0) * c;
  blend_items<T, kGatherBatch, kBlock>(
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
cudaError_t launch(const CapfSampleArgs& args, size_t smem, bool proj,
                   cudaStream_t stream) {
  auto kernel = proj ? sample_levels_kernel<T, O, true>
                     : sample_levels_kernel<T, O, false>;
  const int threads =
      proj ? kBlockThreads<T, true> : kBlockThreads<T, false>;
  cudaError_t err = capf::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<args.unit_end[args.num_levels - 1], threads, smem, stream>>>(
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
  bool any_proj = false;  // a level takes a projected body
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
      if (lv.cout % 4 != 0 || lv.unit_points != kF32Points) {
        return cudaErrorInvalidValue;
      }
      any_proj = true;
      need += kF32RingBytes;
    } else {
      if (lv.c % 16 || lv.cout % 8 || lv.cout > kMaxCout ||
          lv.unit_points != kChunk) {
        return cudaErrorInvalidValue;
      }
      any_proj = true;
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
    err = launch<int8_t, __nv_bfloat16>(args, smem, any_proj, stream);
  } else if (args.dtype == capf::kBFloat16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(args, smem, any_proj, stream);
  } else {
    err = launch<float, float>(args, smem, any_proj, stream);
  }
  return static_cast<int>(err);
}
