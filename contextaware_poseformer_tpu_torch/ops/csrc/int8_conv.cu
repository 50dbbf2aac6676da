// K10: the int8 convolution of the deploy graphs (HRNet and CPN).
//
// Replaces the XLA int8 convolution of
// contextaware_poseformer_tpu/models/backbone_common.py::ConvBN (its int8
// routes, 157-213; the conv at 204-213), which has no Pallas kernel and no
// PyTorch CUDA counterpart, together with the elementwise ops that the CPN
// int8 stream fuses into it (contextaware_poseformer_tpu/models/cpn.py:
// 43-51, 123-181). The JAX package quantizes a float input once
// (backbone_common.py:192-203) and then convolves the int8 tensor; so does
// this file: int8_quantize_kernel (K10q, step form) writes round(x / step)
// clipped to +-127 (the step max(amax, 1e-12) / 127 of a calibrated amax,
// or max|x| / 127, unclamped, of the dynamic route), and the convolution
// always reads int8. K10q's scale form is the CPN stream's own quantize
// (cpn.py:43-51), and int8_quant_pool_kernel (K10p) its stem's quantize
// and max-pool in one pass (cpn.py:241-244); see their section below.
// The convolution: NHWC int8 input, a (Cout, kh*kw*Cin) int8 kernel, 1x1 or
// 3x3, stride 1 or 2, zero padding (k - 1) / 2; exact int32 accumulation;
// then, in the epilogue's dtype E (bf16, or fp32 for a backbone that
// computes in fp32, as the JAX package's ConvBN runs its epilogue in the
// backbone's dtype), the folded affine with the JAX package's rounding
// points (common.cuh, affine<E>); an optional residual added in E (the
// downsample conv's output, or an int8 skip dequantized as
// E(xq) * E(amax / 127)); an optional ReLU; out in E, or requantized to int8
// with a calibrated amax, clip(round(y * (127 / amax))). E is a template
// parameter of one kernel: everything before the int32 accumulator is the
// same code in both forms. K10q and K10p take a bf16 or an fp32 input the
// same way.
// That requantizing variant, chained, is also the counterpart of the TPU
// probe experiments/int8_chain_conv.py::kernel (an n-conv int8 3x3 chain).
//
// What bounds it on the H100: the deploy graphs' convs (batch 64, 8x6 to
// 64x48 maps, 64-2048 channels) are 0.4-30 GOP on a few to 100 MB, so HBM
// and latency bound the CPN stream (its 64x48 convs with Cin 64 have one
// K stage) and the int8 tensor-core rate only the widest convs. The design
// is an implicit GEMM (M = output pixels, N = Cout, K = kh*kw*Cin
// flattened) on Hopper's asynchronous machinery, so that loads overlap the
// products and every byte moves in 16-byte pieces:
// - a ring of up to kStages shared-memory stages, each 128 bytes of K for a
//   BM x BN tile, in the 128-byte-swizzled K-major layout that the wgmma
//   descriptors name; one producer warpgroup fills it, one consumer
//   warpgroup (the tile's 64 output rows) drains it; full/empty mbarriers;
// - B, the weights, by TMA (a 2-D map over the (Cout, K) bytes, encoded on
//   the host and cached by pointer and shape; its zero fill pads K and Cout);
// - A, the implicit im2col rows, by 16-byte cp.async with zero fill (src-size
//   0) for taps outside the image and for K past its end. A 4-D TMA box
//   cannot follow a tile of consecutive output pixels across rows and
//   images, so cp.async, which addresses each 16-byte piece, takes A; a
//   piece never straddles two taps (Cin is a multiple of 16), so a stage
//   may span taps (Cin 32 and 64 fill whole 128-byte stages; where K =
//   kh*kw*Cin does not, as K = 144 or 432 at Cin 16 or 48, the last
//   stage's tail pieces load nothing and the map's box past K is zero
//   filled, so those K columns are zero in both operands and add nothing);
// - wgmma.mma_async m64nNk32 s8 x s8 -> s32 (N = BN, 64 or 128) from shared
//   memory, K-major for both operands, the only layout int8 wgmma takes;
// - the producer also prefetches the tile's residual into shared memory by
//   cp.async behind the ring's first fill, so the epilogue reads no global
//   memory but its stores; a block caps its registers at 128 a thread, so
//   that two blocks share an SM and one's loads hide the other's latency
//   (a 128-row tile on two consumer warpgroups, measured, never won);
// - the epilogue applies the affine in the accumulator layout, stages the
//   tile in the ring (bf16, or fp32: 64 x 136 x 4 bytes, which the ring of
//   any tile holds), then each thread finishes 8 (or 16) consecutive
//   channels of one pixel and stores 16 bytes a piece (8 for an int8 output
//   whose Cout is not a multiple of 16; two pieces for 8 fp32 values).
// The tile (64 x 64 or 64 x 128) comes from ops/int8_conv.py::plan,
// which picks it per (M, N) from measured times.
//
// The TPU probe experiments/int8_chain_micro.py timed the pieces of such a
// chain apart; its counterparts are builds of this file's code: the main
// loop alone with an int32 output (Mode::kAccum; a 1x1 call over a
// pre-windowed 576-channel input is the probe's matmul1), the same with the
// border test compiled out (Mode::kAccumNoMask, wrong at the edges on
// purpose), the same ring on bf16 operands (wgmma m64nNk16, fp32 out), the
// epilogue alone (int8_requant_kernel: the same arithmetic and stores) and the
// quantize pass (int8_quantize_kernel, on the path: K10q).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using capf::affine;
using capf::folded_scale;
using capf::load8;
using capf::round_to;
using capf::stage2;
using capf::store8;
using capf::to_int8_rne;

// the entry points' argument block, passed by pointer from ctypes
extern "C" {
struct Int8ConvArgs {  // mirrored by ops/int8_conv.py::_Args
  const void* x;         // (B, H, W, Cin) int8 (bf16 in the bf16 probe)
  const void* wq;        // (Cout, kh*kw*Cin) int8 (bf16 in the bf16 probe)
  const float* wscale;   // (Cout,)
  const float* scale;    // (Cout,) BN scale
  const float* bias;     // (Cout,) BN bias
  const float* amax;     // scalar: the calibrated amax, or max|x|
  const void* res;       // (B, Ho, Wo, Cout) E or int8, or null
  const float* res_amax; // scalar: the int8 residual's calibrated amax
  const float* out_amax; // scalar: the int8 output's amax; null: E out
  void* out;             // (B, Ho, Wo, Cout) E, int8, or int32/fp32
  int batch, h, w, cin, cout, ksize, stride, ho, wo;
  int clamp_amax, res_int8, relu;
  int tile_n;            // the plan: the tile's width, 64 or 128
  int f32;               // the epilogue's dtype E: 1 fp32, 0 bf16
};

struct Int8RequantArgs {  // mirrored by probes/int8_chain.py::_RequantArgs
  const int* acc;         // (M, N) int32
  const float* wscale;    // (N,)
  const float* scale;     // (N,)
  const float* bias;      // (N,)
  const float* amax;      // scalar: the input's calibrated amax
  const float* out_amax;  // scalar: the output's calibrated amax
  int8_t* out;            // (M, N)
  int rows, cols, relu;
};
}  // extern "C"

namespace {

using namespace capf::sm90;

constexpr int kBK = kSwizzleRow;  // bytes of K a stage holds: one swizzle row
constexpr int kStages = 4;        // the ring's depth
constexpr int kWarpgroup = 128;

enum class Mode { kProduct, kAccum, kAccumNoMask };

// ---- the product (Hopper primitives: hopper.cuh) ---------------------------

template <int kBN>
__device__ __forceinline__ void wgmma_tile(int (&d)[kBN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (kBN == 64) {
    wgmma_s8_n64(d, da, db);
  } else {
    wgmma_s8_n128(d, da, db);
  }
}
template <int kBN>
__device__ __forceinline__ void wgmma_tile(float (&d)[kBN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (kBN == 64) {
    wgmma_bf16_n64(d, da, db);
  } else {
    wgmma_bf16_n128(d, da, db);
  }
}

// ---- the epilogue's arithmetic ----------------------------------------------

// the quantization step: max(amax, 1e-12) / 127 for a calibrated amax,
// max|x| / 127 for a runtime one (a multiply by fl32(1 / 127), as XLA
// compiles the division under jit)
__device__ __forceinline__ float input_step(float amax, bool clamp) {
  return __fmul_rn(clamp ? fmaxf(amax, 1e-12f) : amax, capf::kRecip127);
}

// 127 / max(amax, 1e-12), an IEEE division as XLA computes it
__device__ __forceinline__ float requant_scale(float amax) {
  return __fdiv_rn(127.f, fmaxf(amax, 1e-12f));
}
__device__ __forceinline__ float requant_scale(const float* amax) {
  return requant_scale(*amax);
}

// E(max(amax, 1e-12) / 127): the dequant scale of an int8 skip
template <typename E>
__device__ __forceinline__ float dequant_scale(const float* amax) {
  return round_to<E>(__fmul_rn(fmaxf(*amax, 1e-12f), capf::kRecip127));
}

// one output value after the affine: the residual added in E, then the
// ReLU (common to the conv and the requant probe)
template <typename E>
__device__ __forceinline__ float finish(float y, float res, bool has_res,
                                        bool relu) {
  if (has_res) y = round_to<E>(__fadd_rn(y, res));
  return relu ? fmaxf(y, 0.f) : y;
}

// 8 consecutive residual values of one pixel as floats: an E residual as
// it is, an int8 skip dequantized as E(xq) * E(amax / 127)
template <typename E>
__device__ __forceinline__ void residual8(const void* p, bool res_int8,
                                          float res_deq, float* r) {
  if (res_int8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t w = e < 4 ? q.x : q.y;
      const int8_t v = static_cast<int8_t>((w >> (8 * (e % 4))) & 0xff);
      r[e] = round_to<E>(__fmul_rn(static_cast<float>(v), res_deq));
    }
  } else {
    load8(static_cast<const E*>(p), r);
  }
}

// four int8 in one word, the first in the low byte
__device__ __forceinline__ uint32_t pack_int8x4(int8_t a, int8_t b, int8_t c,
                                                int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) |
         static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24;
}

// kCH (8 or 16) finished values -> int8 with the output's requant scale,
// one store of kCH bytes
template <int kCH>
__device__ __forceinline__ void store_int8(int8_t* out, const float* y,
                                           float q_out) {
  uint32_t w[kCH / 4];
#pragma unroll
  for (int i = 0; i < kCH / 4; ++i) {
    w[i] = pack_int8x4(to_int8_rne(__fmul_rn(y[4 * i], q_out)),
                       to_int8_rne(__fmul_rn(y[4 * i + 1], q_out)),
                       to_int8_rne(__fmul_rn(y[4 * i + 2], q_out)),
                       to_int8_rne(__fmul_rn(y[4 * i + 3], q_out)));
  }
  if constexpr (kCH == 16) {
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[1]);
  }
}

// ---- the convolution ------------------------------------------------------

template <int kBN>
struct Tile {
  static constexpr int kBM = 64;  // output pixels: one consumer warpgroup
  static constexpr int kConsumers = kWarpgroup;
  static constexpr int kThreads = kConsumers + kWarpgroup;
  // two blocks an SM (registers capped at 128 a thread), so that one
  // block's loads hide the other's latency
  static constexpr int kMinBlocks = 2;
  static constexpr int kAStage = kBM * kBK;       // bytes
  static constexpr int kBStage = kBN * kBK;
  static constexpr int kStage = kAStage + kBStage;
  static constexpr int kPitch = kBN + 8;  // a staged row's values (E or
                                          // the probes' 32-bit sums)
  static constexpr int kBarriers = (2 * kStages + 1) * sizeof(uint64_t);
  // the staged tile of ``elem``-byte values: the affine's E output (the
  // product), the probes' 32-bit sums
  __host__ __device__ static constexpr int staged(int elem) {
    return kBM * kPitch * elem;
  }
  // the ring's bytes, ``stages`` deep: at least the staged tile, which
  // reuses it once the products are done
  __host__ __device__ static constexpr int ring(int stages, int elem) {
    return stages * kStage > staged(elem) ? stages * kStage : staged(elem);
  }
  // the block's shared memory: slack to align the ring to the 1024 bytes
  // the swizzle needs, the ring, the prefetched residual tile, the barriers
  // and the epilogue's scales
  __host__ __device__ static constexpr int smem(int stages, int elem,
                                                int res_bytes) {
    return 1024 + ring(stages, elem) + res_bytes + kBarriers +
           2 * kBN * static_cast<int>(sizeof(float));
  }
  // smem() at its largest for an E of ``elem`` bytes: the full ring and an
  // E residual (ops/int8_conv.py::plan_smem)
  __host__ __device__ static constexpr int smem_max(int elem) {
    return smem(kStages, elem, kBM * kBN * elem);
  }
  static_assert(kStages * kStage >= kBM * kPitch * 4, "the tile fits");
};

// Grid: one block per (M tile, N tile), N tiles fastest so that the blocks
// sharing an A tile run together and A crosses HBM once. Threads: one
// consumer warpgroup (the 64 output rows), then one producer warpgroup.
// kBf16: the bf16 probe (bf16 operands, fp32 out). E: the product's
// epilogue dtype (bf16 or float; the probes' builds take bf16 and use none).
template <int kBN, Mode kMode, bool kBf16, typename E>
__global__ void __launch_bounds__(Tile<kBN>::kThreads, Tile<kBN>::kMinBlocks)
    conv_kernel(const __grid_constant__ CUtensorMap wmap,
                const Int8ConvArgs a) {
  using T = Tile<kBN>;
  using Acc = typename std::conditional<kBf16, float, int>::type;
  constexpr int kBM = T::kBM;
  constexpr int kConsumers = T::kConsumers;
  constexpr bool kProduct = kMode == Mode::kProduct;
  constexpr int kEs = kBf16 ? 1 : 0;  // log2 of the operands' element bytes
  // the staged tile's value bytes: E (the product), 32-bit sums (the probes)
  constexpr int kOut = kProduct ? static_cast<int>(sizeof(E)) : 4;
  static_assert(!kBf16 || kMode == Mode::kAccum, "the bf16 probe");

  const int tid = threadIdx.x;
  const int n_tiles = (a.cout + kBN - 1) / kBN;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int m_total = a.batch * a.ho * a.wo;
  const int kbytes = (a.ksize * a.ksize * a.cin) << kEs;
  const int ktiles = (kbytes + kBK - 1) / kBK;
  const int stages = ktiles < kStages ? ktiles : kStages;  // the ring's depth
  const bool has_res = kProduct && a.res != nullptr;
  const int res_elem = a.res_int8 ? 1 : static_cast<int>(sizeof(E));

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_a = ring;                        // stages x A
  unsigned char* s_b = ring + stages * T::kAStage;  // stages x B
  unsigned char* s_res = ring + T::ring(stages, kOut);  // the residual
  uint64_t* full = reinterpret_cast<uint64_t*>(
      s_res + (has_res ? kBM * kBN * res_elem : 0));
  uint64_t* empty = full + kStages;
  uint64_t* res_full = empty + kStages;
  float* s_eff = reinterpret_cast<float*>(res_full + 1);
  float* s_bias = s_eff + kBN;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // full: the producer's 128 cp.async arrivals and one expect_tx
      mbar_init(&full[s], kWarpgroup + 1);
      mbar_init(&empty[s], 1);  // the consumer warpgroup's arrival
    }
    mbar_init(res_full, kWarpgroup);  // the producer's residual cp.asyncs
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: B by TMA, A by cp.async, ``stages`` ahead; then the
    // residual tile, which the epilogue reads from shared memory ----
    const int p = tid - kConsumers;
    const int chunk = p & 7;         // the 16-byte piece of a row it loads
    constexpr int kRows = kBM / 16;  // rows it loads: p / 8 + 16 i
    const int pad = (a.ksize - 1) / 2;
    int row_pix[kRows], row_y[kRows], row_x[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + (p >> 3) + 16 * i;
      const int mm = m < m_total ? m : m_total - 1;
      const int b = mm / (a.ho * a.wo);
      const int r = mm - b * a.ho * a.wo;
      const int oy = r / a.wo;
      const int ox = r - oy * a.wo;
      row_pix[i] = m < m_total ? b * a.h * a.w : -1;  // -1: past M
      row_y[i] = oy * a.stride - pad;
      row_x[i] = ox * a.stride - pad;
    }
    const int8_t* x = static_cast<const int8_t*>(a.x);
    const long long last_pix = 1LL * a.batch * a.h * a.w - 1;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % stages;
      mbar_wait(&empty[s], ((kt / stages) & 1) ^ 1);
      if (p == 0) {
        mbar_arrive_expect_tx(&full[s], T::kBStage);
        tma_load_2d(s_b + s * T::kBStage, &wmap, kt * kBK, n0, &full[s]);
      }
      const int kb = kt * kBK + chunk * 16;  // byte of K
      const int ke = kb >> kEs;              // element of K
      const int tap = ke / a.cin;
      const int c = ke - tap * a.cin;
      const int ky = tap / a.ksize;
      const int kx = tap - ky * a.ksize;
      const bool k_in = kb < kbytes;
      unsigned char* stage = s_a + s * T::kAStage;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = (p >> 3) + 16 * i;
        const int iy = row_y[i] + ky;
        const int ix = row_x[i] + kx;
        long long pix;
        bool in;
        if constexpr (kMode == Mode::kAccumNoMask) {
          // no border test: the tap's pixel clamped into the tensor only so
          // that no read leaves it (a neighbouring pixel stands in for the
          // zero), as the TPU probe's unmasked build reads its neighbours
          const long long base = row_pix[i] < 0 ? 0 : row_pix[i];
          pix = base + 1LL * iy * a.w + ix;
          pix = pix < 0 ? 0 : (pix > last_pix ? last_pix : pix);
          in = k_in;
        } else {
          in = k_in && row_pix[i] >= 0 && iy >= 0 && iy < a.h && ix >= 0 &&
               ix < a.w;
          pix = in ? row_pix[i] + 1LL * iy * a.w + ix : 0;
        }
        const int8_t* src =
            in ? x + ((static_cast<size_t>(pix) * a.cin + c) << kEs) : x;
        cp_async16(stage + sw128_offset(row, chunk), src, in ? 16 : 0);
      }
      cp_async_arrive(&full[s]);
      if (has_res && kt == stages - 1) {
        // the residual tile, behind the ring's first fill: BM rows of BN
        // values in 16-byte pieces (8-byte ones for an int8 residual whose
        // rows are not 16-byte aligned)
        const int row_bytes = kBN * res_elem;
        const int valid = (a.cout - n0 < kBN ? a.cout - n0 : kBN) * res_elem;
        const int piece = a.res_int8 && a.cout % 16 ? 8 : 16;
        const int pieces = row_bytes / piece;
        const unsigned char* res = static_cast<const unsigned char*>(a.res);
        for (int idx = p; idx < kBM * pieces; idx += kWarpgroup) {
          const int r = idx / pieces;
          const int off = (idx - r * pieces) * piece;
          if (m0 + r >= m_total || off >= valid) continue;  // never read
          const unsigned char* src =
              res + (static_cast<size_t>(m0 + r) * a.cout + n0) * res_elem +
              off;
          if (piece == 16) {
            cp_async16(s_res + r * row_bytes + off, src, 16);
          } else {
            cp_async8(s_res + r * row_bytes + off, src);
          }
        }
        cp_async_arrive(res_full);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumers: wgmma on each stage as it lands, then the epilogue
    if constexpr (kProduct) {
      const float step = input_step(*a.amax, a.clamp_amax != 0);
      for (int i = tid; i < kBN; i += kConsumers) {
        const int n = n0 + i;
        s_eff[i] =
            n < a.cout ? folded_scale<E>(a.scale[n], a.wscale[n], step) : 0.f;
        s_bias[i] = n < a.cout ? round_to<E>(a.bias[n]) : 0.f;
      }
    }
    Acc acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % stages;
      mbar_wait(&full[s], (kt / stages) & 1);
      // the cp.async bytes were written through the generic proxy; wgmma
      // reads through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const unsigned char* sa = s_a + s * T::kAStage;
      const unsigned char* sb = s_b + s * T::kBStage;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK; k += 32) {
        wgmma_tile<kBN>(acc, sw128_desc(sa + k), sw128_desc(sb + k));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done with it
      fence_regs(acc);
      if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % stages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // stage the tile through the ring, which no one reads any more: the
    // affine's E output (the product), the 32-bit sums (the probes)
    named_sync(1, kConsumers);
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row = warp * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    if constexpr (kProduct) {
      E* tile = reinterpret_cast<E*>(ring);
#pragma unroll
      for (int q = 0; q < kBN / 8; ++q) {
        const int col = 8 * q + col0;
        const float e0 = s_eff[col], e1 = s_eff[col + 1];
        const float b0 = s_bias[col], b1 = s_bias[col + 1];
        stage2(tile + row * T::kPitch + col, affine<E>(acc[4 * q], e0, b0),
               affine<E>(acc[4 * q + 1], e1, b1));
        stage2(tile + (row + 8) * T::kPitch + col,
               affine<E>(acc[4 * q + 2], e0, b0),
               affine<E>(acc[4 * q + 3], e1, b1));
      }
    } else {
      int* tile = reinterpret_cast<int*>(ring);
#pragma unroll
      for (int q = 0; q < kBN / 8; ++q) {
        int v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kBf16) {
            v[e] = __float_as_int(acc[4 * q + e]);
          } else {
            v[e] = acc[4 * q + e];
          }
        }
        const int col = 8 * q + col0;
        *reinterpret_cast<int2*>(tile + row * T::kPitch + col) =
            make_int2(v[0], v[1]);
        *reinterpret_cast<int2*>(tile + (row + 8) * T::kPitch + col) =
            make_int2(v[2], v[3]);
      }
    }
    named_sync(1, kConsumers);

    if constexpr (!kProduct) {
      // the probes: the raw 32-bit sums, 4 channels (16 bytes) a store
      const int* tile = reinterpret_cast<const int*>(ring);
      constexpr int kChunks = kBN / 4;
      for (int idx = tid; idx < kBM * kChunks; idx += kConsumers) {
        const int r = idx / kChunks;
        const int col = (idx - r * kChunks) * 4;
        const int m = m0 + r;
        const int n = n0 + col;
        if (m >= m_total || n >= a.cout) continue;  // Cout % 8 == 0
        *reinterpret_cast<int4*>(static_cast<int*>(a.out) +
                                 static_cast<size_t>(m) * a.cout + n) =
            *reinterpret_cast<const int4*>(tile + r * T::kPitch + col);
      }
    } else {
      const E* tile = reinterpret_cast<const E*>(ring);
      const float res_deq =
          has_res && a.res_int8 ? dequant_scale<E>(a.res_amax) : 0.f;
      if (has_res) mbar_wait(res_full, 0);
      const bool int8_out = a.out_amax != nullptr;
      const float q_out = int8_out ? requant_scale(a.out_amax) : 0.f;
      const bool relu = a.relu != 0;
      // the staged affine output of 8 channels from column c of row r, the
      // residual added, the ReLU
      auto finish8 = [&](int r, int c, float* y) {
        float res[8];
        load8(tile + r * T::kPitch + c, y);
        if (has_res) {
          residual8<E>(s_res + (r * kBN + c) * res_elem, a.res_int8 != 0,
                       res_deq, res);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          y[e] = finish<E>(y[e], has_res ? res[e] : 0.f, has_res, relu);
        }
      };
      // 8 channels a thread (16 or 32 bytes of E out), or 16 for an int8 out
      // whose Cout is a multiple of 16
      const int ch = int8_out && a.cout % 16 == 0 ? 16 : 8;
      const int chunks = kBN / ch;
      for (int idx = tid; idx < kBM * chunks; idx += kConsumers) {
        const int r = idx / chunks;
        const int col = (idx - r * chunks) * ch;
        const int m = m0 + r;
        const int n = n0 + col;
        if (m >= m_total || n >= a.cout) continue;  // n + ch <= Cout then
        const size_t off = static_cast<size_t>(m) * a.cout + n;
        if (ch == 16) {
          float y[16];
          finish8(r, col, y);
          finish8(r, col + 8, y + 8);
          store_int8<16>(static_cast<int8_t*>(a.out) + off, y, q_out);
        } else {
          float y[8];
          finish8(r, col, y);
          if (int8_out) {
            store_int8<8>(static_cast<int8_t*>(a.out) + off, y, q_out);
          } else {
            store8(static_cast<E*>(a.out) + off, y);
          }
        }
      }
    }
  }
}

// The epilogue alone (the requant probe): int32 acc -> the folded bf16
// affine -> ReLU -> int8 with the output's calibrated amax; K10's
// arithmetic and stores, 16 channels a thread, 16-byte loads and stores.
__global__ void int8_requant_kernel(const Int8RequantArgs a) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 16;
  if (i >= static_cast<size_t>(a.rows) * a.cols) return;
  const int n = static_cast<int>(i % a.cols);
  const float step = input_step(*a.amax, true);
  float y[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = reinterpret_cast<const int4*>(a.acc + i)[q];
    const int acc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n + 4 * q + e;
      const float eff =
          folded_scale<__nv_bfloat16>(a.scale[c], a.wscale[c], step);
      y[4 * q + e] = finish<__nv_bfloat16>(
          affine<__nv_bfloat16>(acc[e], eff,
                                round_to<__nv_bfloat16>(a.bias[c])),
          0.f, false, a.relu != 0);
    }
  }
  store_int8<16>(a.out + i, y, requant_scale(a.out_amax));
}

// ---- K10q: the quantize pass; K10p: the stem's quantize and max-pool ---
//
// K10q turns a bf16 or an fp32 tensor into int8, clip(round(v), -127, 127)
// with round half to even, in one of two forms (QuantForm):
// - the step form, K10's float inputs (backbone_common.py:192-203): v is
//   the IEEE quotient x / step, step = max(amax, 1e-12) * fl32(1 / 127) for
//   a calibrated amax, max|x| * fl32(1 / 127) for the dynamic route;
// - the scale form, the CPN stream's _quant_i8 (cpn.py:43-51):
//   v = fp32(x) * (127 / max(amax, 1e-12)), the scale one IEEE division a
//   tensor (requant_scale).
// What bounds it: bytes, 2 (bf16) or 4 (fp32) read and 1 written a value.
// At 3.35 TB/s an SM must turn over ~7.5 bf16 values a clock, so past ~17
// thread-instructions a value issue, not HBM, would bound the pass; an IEEE
// division a value (__fdiv_rn: a MUFU reciprocal, a dozen more instructions
// and a slow-path branch) is past it. Here the quotient comes from the
// tensor's reciprocal r = RN(1 / step), computed once, and two FMA
// corrections, q = x * r, then twice q += (x - q * step) * r: the first
// brings q within an ulp of x / step, and the second then gives the
// correctly rounded quotient (Markstein: r within half an ulp of 1 / step
// and q within an ulp make the remainder exact and the corrected q the IEEE
// quotient, whatever the mantissa of x). x is first clamped to
// +-RN(127 * step), which changes no result (beyond it the quotient rounds
// to +-127 either way) and keeps every intermediate far from overflow; a
// step in [2^-64, 2^64] keeps them far from underflow, and a step outside
// that range (a dynamic route's near-zero max|x|, a non-finite amax) takes
// the IEEE division instead, a branch uniform over the grid. The round is
// cvt.rni (half to even; NaN -> 0, as the plain version's int8 cast gives),
// after a clamp that keeps a NaN. About 10 instructions a value in the step
// form, 6 in the scale form; no zero skip (zeros are no slow path any more).
// The grid: a few blocks an SM striding over the tensor; a thread has
// kQuantUnroll groups of 16 values (two 16-byte loads each in bf16, four in
// fp32) in flight before any arithmetic and stores each group's 16 int8
// values at once. Measured on the card at the CPN request's bf16 shapes: 2
// groups a thread and 4 blocks an SM beat 4 or 8 groups, 8 blocks an SM and
// streaming load/store hints. The input's dtype is a template parameter of
// one kernel (In: __nv_bfloat16 or float).

enum QuantForm { kStepDynamic = 0, kStepCalibrated = 1, kScale = 2 };

constexpr int kQuantThreads = 256;
constexpr int kQuantUnroll = 2;       // 16-value groups in flight a thread
constexpr int kQuantBlocksPerSm = 4;  // the grid's blocks an SM

struct QuantConsts {
  float mul;   // the scale form's scale, or the step form's RN(1 / step)
  float step;  // the step form's step
  float lim;   // the step form's RN(127 * step)
};

// max(lo, min(v, hi)), keeping a NaN (as torch.clamp does)
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
  asm("min.NaN.f32 %0, %0, %1;" : "+f"(r) : "f"(hi));
  return r;
}

// one value x -> its int8 in the low byte of the word. kExact: the step
// form's reciprocal route (else its IEEE division)
template <int kForm, bool kExact>
__device__ __forceinline__ uint32_t quant_value(float x,
                                                const QuantConsts& k) {
  if constexpr (kForm == kScale) {
    return static_cast<uint32_t>(__float2int_rn(
        clamp_keep_nan(__fmul_rn(x, k.mul), -127.f, 127.f)));
  } else if constexpr (kExact) {
    const float xc = clamp_keep_nan(x, -k.lim, k.lim);
    float q = __fmul_rn(xc, k.mul);
    q = __fmaf_rn(__fmaf_rn(-q, k.step, xc), k.mul, q);
    q = __fmaf_rn(__fmaf_rn(-q, k.step, xc), k.mul, q);
    return static_cast<uint32_t>(__float2int_rn(q));  // |q| <= 127 + 2^-16
  } else {
    return static_cast<uint32_t>(__float2int_rn(
        clamp_keep_nan(__fdiv_rn(x, k.step), -127.f, 127.f)));
  }
}

// 4 values -> 4 int8 in one word, the first in the low byte
template <int kForm, bool kExact>
__device__ __forceinline__ uint32_t quant4(float v0, float v1, float v2,
                                           float v3, const QuantConsts& k) {
  const uint32_t q0 = quant_value<kForm, kExact>(v0, k);
  const uint32_t q1 = quant_value<kForm, kExact>(v1, k);
  const uint32_t q2 = quant_value<kForm, kExact>(v2, k);
  const uint32_t q3 = quant_value<kForm, kExact>(v3, k);
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040),
                     0x5410);
}

// a group of 16 values -> 16 int8 values (one 16-byte word): 16 bf16 in two
// 16-byte words (the first value in the low half of the first word), or 16
// fp32 in four
template <int kForm, bool kExact>
__device__ __forceinline__ uint4 quant16(const uint4 (&v)[2],
                                         const QuantConsts& k) {
  const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                         v[1].x, v[1].y, v[1].z, v[1].w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = w[2 * i], b = w[2 * i + 1];
    o[i] = quant4<kForm, kExact>(
        __uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
        __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u), k);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}
template <int kForm, bool kExact>
__device__ __forceinline__ uint4 quant16(const uint4 (&v)[4],
                                         const QuantConsts& k) {
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = quant4<kForm, kExact>(__uint_as_float(v[i].x),
                                 __uint_as_float(v[i].y),
                                 __uint_as_float(v[i].z),
                                 __uint_as_float(v[i].w), k);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// K10q: x (groups x 16 In values) -> out (groups x 16 int8) in form kForm.
// A block takes tiles of kQuantThreads x kQuantUnroll groups, grid-strided
// (the host sizes the grid so that every block takes as many). The first
// tile's loads go out beside amax's, before the per-tensor constants, which
// pick the step form's route by a branch uniform over the grid.
template <int kForm, typename In>
__global__ void __launch_bounds__(kQuantThreads)
    int8_quantize_kernel(const uint4* __restrict__ x,
                         const float* __restrict__ amax,
                         uint4* __restrict__ out, long long groups) {
  // 16-byte words a group of 16 values takes: 2 (bf16), 4 (fp32)
  constexpr int kW = static_cast<int>(sizeof(In));
  const long long per_block = 1LL * kQuantThreads * kQuantUnroll;
  long long g0 = blockIdx.x * per_block + threadIdx.x;
  const float a = *amax;
  QuantConsts k{};
  bool exact = true;  // the step form's reciprocal route
  bool ready = false;
  for (; g0 < groups; g0 += gridDim.x * per_block) {
    uint4 v[kQuantUnroll][kW];
#pragma unroll
    for (int u = 0; u < kQuantUnroll; ++u) {  // every load before any math
      const long long g = g0 + u * kQuantThreads;
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        v[u][i] = g < groups ? x[kW * g + i] : make_uint4(0, 0, 0, 0);
      }
    }
    if (!ready) {
      ready = true;
      if constexpr (kForm == kScale) {
        k.mul = requant_scale(a);
      } else {
        k.step = input_step(a, kForm == kStepCalibrated);
        exact = k.step >= 0x1p-64f && k.step <= 0x1p64f;
        k.mul = __frcp_rn(k.step);
        k.lim = __fmul_rn(127.f, k.step);
      }
    }
#pragma unroll
    for (int u = 0; u < kQuantUnroll; ++u) {
      const long long g = g0 + u * kQuantThreads;
      if (g >= groups) continue;
      out[g] = exact ? quant16<kForm, true>(v[u], k)
                     : quant16<kForm, false>(v[u], k);
    }
  }
}

// K10p: the CPN stream's stem, max_pool_3x3_s2(quant(x)) (cpn.py:241-244,
// the pool backbone_common.py:389-395: 3x3, stride 2, padding 1), in one
// pass, the scale form, on a bf16 or an fp32 input (In). The quantize is
// monotone, so the pool of the quantized tensor is the quantize of the
// pooled one: pool in In (a max is exact), then quantize the 4x fewer
// outputs once each. A NaN quantizes to 0, as +0 does, so the pool takes a
// NaN as +0: it keeps the max that ignores NaN beside the one that keeps
// it, and where the latter is NaN takes the larger of the former and +0
// (so a window of NaN and negative values pools to 0, as the plain
// version's pool of the quantized values does). Padding never wins: every
// window holds at least 4 real pixels. Bound: bytes, the input read once
// and the int8 output written once. A block owns ``rows`` output rows of
// one image across all channels and stages the 2 rows + 1 input rows they
// need (clipped to the image) into shared memory by 16-byte cp.async; the
// row it shares with a neighbouring block (next in the grid, so running
// beside it) is found in L2. ``rows`` is the plan's
// (ops/int8_conv.py::quant_pool_rows): at the stem one row a block, 36 KB in
// bf16 (measured faster than 2-4 rows: fewer blocks an SM) and 72 KB in
// fp32. Then a thread pools 16 channels of one output pixel (over 2 or 4
// 16-byte pieces a tap), quantizes them and stores 16 bytes. A thread
// starts its pieces at a rotation so that the 8 threads of a 16-byte
// shared-memory phase fall on distinct banks at 64 channels: in bf16 (two
// pixels of 4 groups, 32 bytes a group) an odd output column reads its
// second piece first; in fp32 (64 bytes a group, so two groups share a bank
// set) thread t starts at piece (t / 2) % 4.
constexpr int kPoolThreads = 256;
constexpr int kSmemLimit = 232448;  // the 227 KB a Hopper block may use

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_max_nan(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ float f32_max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// the window's maxima of one 32-bit word of In values: m ignores a NaN, n
// keeps it
template <typename In>
__device__ __forceinline__ void max_word(uint32_t& m, uint32_t& n,
                                         uint32_t v) {
  if constexpr (sizeof(In) == 2) {
    m = bf16x2_max(m, v);
    n = bf16x2_max_nan(n, v);
  } else {
    m = __float_as_uint(fmaxf(__uint_as_float(m), __uint_as_float(v)));
    n = __float_as_uint(f32_max_nan(__uint_as_float(n), __uint_as_float(v)));
  }
}

// the pooled word: m, or max(m, +0) in each value whose n is NaN
template <typename In>
__device__ __forceinline__ uint32_t pooled_word(uint32_t m, uint32_t n) {
  if constexpr (sizeof(In) == 2) {
    // bit 15 of each half: its magnitude is past 0x7f80 (a NaN)
    const uint32_t nan = ((n & 0x7fff7fffu) + 0x007f007fu) & 0x80008000u;
    // -inf in a half without a NaN, +0 in one with
    const uint32_t floor = 0xff80ff80u & ~((nan >> 15) * 0xffffu);
    return bf16x2_max(m, floor);
  } else {
    const float f = __uint_as_float(m);
    return __float_as_uint(isnan(__uint_as_float(n)) ? fmaxf(f, 0.f) : f);
  }
}

// piece s of the kW pieces (s < kW), by selects: no indexed local array
template <int kW>
__device__ __forceinline__ uint4 pick_piece(const uint4 (&m)[kW], int s) {
  if constexpr (kW == 2) {
    return s ? m[1] : m[0];
  } else {
    return s == 0 ? m[0] : s == 1 ? m[1] : s == 2 ? m[2] : m[3];
  }
}

template <typename In>
__global__ void __launch_bounds__(kPoolThreads)
    int8_quant_pool_kernel(const In* __restrict__ x,
                           const float* __restrict__ amax,
                           int8_t* __restrict__ out, int h, int w, int c,
                           int ho, int wo, int rows) {
  constexpr int kW = static_cast<int>(sizeof(In));  // pieces of a group
  constexpr uint32_t kNegInf =
      sizeof(In) == 2 ? 0xff80ff80u : 0xff800000u;  // -inf in each value
  extern __shared__ __align__(16) unsigned char s_rows[];
  const int strips = (ho + rows - 1) / rows;
  const int b = blockIdx.x / strips;
  const int oy0 = (blockIdx.x - b * strips) * rows;
  const int oy1 = min(oy0 + rows, ho);
  const int iy0 = max(2 * oy0 - 1, 0);
  const int iy1 = min(2 * oy1, h);  // past the last input row read
  const size_t row_elems = static_cast<size_t>(w) * c;
  const In* src = x + (static_cast<size_t>(b) * h + iy0) * row_elems;
  const int chunks =
      static_cast<int>((iy1 - iy0) * row_elems * sizeof(In) / 16);
  for (int i = threadIdx.x; i < chunks; i += kPoolThreads) {
    cp_async16(s_rows + 16 * static_cast<size_t>(i),
               reinterpret_cast<const unsigned char*>(src) +
                   16 * static_cast<size_t>(i),
               16);
  }
  cp_async_commit();
  QuantConsts k{};
  k.mul = requant_scale(amax);
  cp_async_wait<0>();
  __syncthreads();
  const int groups = c / 16;
  const int tasks = (oy1 - oy0) * wo * groups;
  for (int t = threadIdx.x; t < tasks; t += kPoolThreads) {
    const int g = t % groups;
    const int p = t / groups;
    const int ox = p % wo;
    const int oy = oy0 + p / wo;
    // the piece read first (see above)
    const int rot = kW == 2 ? (ox & 1) : ((t >> 1) & 3);
    uint4 m[kW], n[kW];  // m[j], n[j]: piece (j + rot) % kW
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      m[j] = n[j] = make_uint4(kNegInf, kNegInf, kNegInf, kNegInf);
    }
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int y = 2 * oy + dy;
      if (y < 0 || y >= h) continue;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = 2 * ox + dx;
        if (xx < 0 || xx >= w) continue;
        const unsigned char* q =
            s_rows +
            ((static_cast<size_t>(y - iy0) * w + xx) * c + 16 * g) *
                sizeof(In);
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              q + 16 * ((j + rot) & (kW - 1)));
          max_word<In>(m[j].x, n[j].x, v.x);
          max_word<In>(m[j].y, n[j].y, v.y);
          max_word<In>(m[j].z, n[j].z, v.z);
          max_word<In>(m[j].w, n[j].w, v.w);
        }
      }
    }
    uint4 pooled[kW];  // in channel order
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int s = (i - rot) & (kW - 1);
      const uint4 a = pick_piece<kW>(m, s), e = pick_piece<kW>(n, s);
      pooled[i] = make_uint4(pooled_word<In>(a.x, e.x),
                             pooled_word<In>(a.y, e.y),
                             pooled_word<In>(a.z, e.z),
                             pooled_word<In>(a.w, e.w));
    }
    *reinterpret_cast<uint4*>(
        out + ((static_cast<size_t>(b) * ho + oy) * wo + ox) * c + 16 * g) =
        quant16<kScale, true>(pooled, k);
  }
}

// ---- host side -------------------------------------------------------------

template <int kBN, Mode kMode, bool kBf16, typename E>
cudaError_t launch(const Int8ConvArgs& a, cudaStream_t stream) {
  using T = Tile<kBN>;
  constexpr bool kProduct = kMode == Mode::kProduct;
  constexpr int kOut = kProduct ? static_cast<int>(sizeof(E)) : 4;
  const int es = kBf16 ? 2 : 1;
  const long long kbytes = 1LL * a.ksize * a.ksize * a.cin * es;
  CUtensorMap map;
  cudaError_t err = weight_map(a.wq, kbytes, a.cout, kBN, &map);
  if (err != cudaSuccess) return err;
  auto kernel = conv_kernel<kBN, kMode, kBf16, E>;
  static bool opted = false;  // once per instantiation (one device)
  if (!opted) {
    err = capf::allow_smem(kernel, T::smem_max(kOut));
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const int ktiles = static_cast<int>((kbytes + kBK - 1) / kBK);
  const int stages = ktiles < kStages ? ktiles : kStages;
  const int res_bytes = kProduct && a.res != nullptr
                            ? T::kBM * kBN * (a.res_int8 ? 1 : kOut)
                            : 0;
  const long long m_total = 1LL * a.batch * a.ho * a.wo;
  const long long blocks = ((m_total + T::kBM - 1) / T::kBM) *
                           ((a.cout + kBN - 1) / kBN);
  kernel<<<static_cast<unsigned>(blocks), T::kThreads,
           T::smem(stages, kOut, res_bytes), stream>>>(map, a);
  return cudaGetLastError();
}

template <Mode kMode, bool kBf16, typename E = __nv_bfloat16>
cudaError_t dispatch(const Int8ConvArgs& a, cudaStream_t stream) {
  if (a.tile_n == 128) return launch<128, kMode, kBf16, E>(a, stream);
  if (a.tile_n == 64) return launch<64, kMode, kBf16, E>(a, stream);
  return cudaErrorInvalidValue;
}

bool valid(const Int8ConvArgs& a, int multiple) {
  const long long m_total = 1LL * a.batch * a.ho * a.wo;
  return a.batch >= 1 && a.cin >= multiple && a.cin % multiple == 0 &&
         a.cout >= 8 && a.cout % 8 == 0 && (a.ksize == 1 || a.ksize == 3) &&
         (a.stride == 1 || a.stride == 2) && m_total >= 1 &&
         m_total <= (1LL << 30) && 1LL * a.batch * a.h * a.w <= (1LL << 30) &&
         1LL * a.ksize * a.ksize * a.cin <= (1 << 20);
}

}  // namespace

extern "C" int capf_int8_conv(const Int8ConvArgs* args, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Int8ConvArgs& a = *args;
  if (!valid(a, 16) || a.amax == nullptr ||
      (a.res != nullptr && a.res_int8 && !a.res_amax) ||
      (a.f32 != 0 && a.f32 != 1)) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(
      a.f32 ? dispatch<Mode::kProduct, false, float>(a, stream)
            : dispatch<Mode::kProduct, false, __nv_bfloat16>(a, stream));
}

// The probes' builds of the main loop: mode 1 the int32 accumulation, mode 2
// the same without the border test, mode 3 the bf16 main loop (fp32 out).
extern "C" int capf_int8_conv_probe(const Int8ConvArgs* args, int mode,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Int8ConvArgs& a = *args;
  if (!valid(a, mode == 3 ? 16 : 32)) return cudaErrorInvalidValue;
  if (mode == 1) {
    err = dispatch<Mode::kAccum, false>(a, stream);
  } else if (mode == 2) {
    err = dispatch<Mode::kAccumNoMask, false>(a, stream);
  } else if (mode == 3) {
    err = dispatch<Mode::kAccum, true>(a, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int capf_int8_requant(const Int8RequantArgs* args, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Int8RequantArgs& a = *args;
  const long long groups = 1LL * a.rows * a.cols / 16;
  if (a.rows < 1 || a.cols < 16 || a.cols % 16 || groups > (1LL << 34)) {
    return cudaErrorInvalidValue;
  }
  const int threads = 256;
  int8_requant_kernel<<<static_cast<unsigned>((groups + threads - 1) /
                                              threads),
                        threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// K10q on In values; the entries below take bf16 (capf_int8_quantize) or
// fp32 (capf_int8_quantize_f32) with the same arguments
template <typename In>
int quantize(const void* x, const float* amax, void* out, long long n,
             int form, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 16 || n % 16 || form < kStepDynamic || form > kScale) {
    return cudaErrorInvalidValue;
  }
  const long long groups = n / 16;
  const long long per_block = 1LL * kQuantThreads * kQuantUnroll;
  const long long tiles = (groups + per_block - 1) / per_block;
  const long long most =
      1LL * kQuantBlocksPerSm * capf::sm90::sm_count(device);
  const long long rounds = (tiles + most - 1) / most;  // tiles a block
  const long long blocks = (tiles + rounds - 1) / rounds;
  const dim3 grid(static_cast<unsigned>(blocks));
  const uint4* src = static_cast<const uint4*>(x);
  uint4* dst = static_cast<uint4*>(out);
  if (form == kStepDynamic) {
    int8_quantize_kernel<kStepDynamic, In>
        <<<grid, kQuantThreads, 0, stream>>>(src, amax, dst, groups);
  } else if (form == kStepCalibrated) {
    int8_quantize_kernel<kStepCalibrated, In>
        <<<grid, kQuantThreads, 0, stream>>>(src, amax, dst, groups);
  } else {
    int8_quantize_kernel<kScale, In>
        <<<grid, kQuantThreads, 0, stream>>>(src, amax, dst, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10p on In values, ``rows`` (ops/int8_conv.py::quant_pool_rows) output
// rows a block; the block's shared memory holds min(2 rows + 1, H) input
// rows
template <typename In>
int quant_pool(const void* x, const float* amax, void* out, int batch, int h,
               int w, int c, int rows, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch < 1 || h < 1 || w < 1 || c < 16 || c % 16 || rows < 1) {
    return cudaErrorInvalidValue;
  }
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;
  const int staged = 2 * rows + 1 < h ? 2 * rows + 1 : h;
  const long long smem = 1LL * sizeof(In) * staged * w * c;
  const long long strips = (ho + rows - 1) / rows;
  if (smem > kSmemLimit || 1LL * batch * strips > (1LL << 31) - 1 ||
      1LL * ho * wo * (c / 16) > (1LL << 31) - 1) {
    return cudaErrorInvalidValue;
  }
  static bool opted = false;  // once per instantiation (one device)
  if (!opted) {
    err = capf::allow_smem(int8_quant_pool_kernel<In>, kSmemLimit);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  int8_quant_pool_kernel<In>
      <<<static_cast<unsigned>(batch * strips), kPoolThreads,
         static_cast<size_t>(smem), stream>>>(
          static_cast<const In*>(x), amax, static_cast<int8_t*>(out), h, w,
          c, ho, wo, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int capf_int8_quantize(const void* x, const float* amax, void* out,
                                  long long n, int form, int device,
                                  cudaStream_t stream) {
  return quantize<__nv_bfloat16>(x, amax, out, n, form, device, stream);
}

extern "C" int capf_int8_quantize_f32(const void* x, const float* amax,
                                      void* out, long long n, int form,
                                      int device, cudaStream_t stream) {
  return quantize<float>(x, amax, out, n, form, device, stream);
}

extern "C" int capf_int8_quant_pool(const void* x, const float* amax,
                                    void* out, int batch, int h, int w, int c,
                                    int rows, int device,
                                    cudaStream_t stream) {
  return quant_pool<__nv_bfloat16>(x, amax, out, batch, h, w, c, rows, device,
                                   stream);
}

extern "C" int capf_int8_quant_pool_f32(const void* x, const float* amax,
                                        void* out, int batch, int h, int w,
                                        int c, int rows, int device,
                                        cudaStream_t stream) {
  return quant_pool<float>(x, amax, out, batch, h, w, c, rows, device,
                           stream);
}
