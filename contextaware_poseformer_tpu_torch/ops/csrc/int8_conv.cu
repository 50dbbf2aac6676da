// K10: the int8 convolution of the deploy graphs (HRNet and CPN).
//
// Replaces the XLA int8 convolution of
// contextaware_poseformer_tpu/models/backbone_common.py::ConvBN (its int8
// routes, 157-213; the conv at 204-213), which has no Pallas kernel and no
// PyTorch CUDA counterpart, together with the elementwise ops that the CPN
// int8 stream fuses into it (contextaware_poseformer_tpu/models/cpn.py:
// 43-51, 123-181). The JAX package quantizes a float input once
// (backbone_common.py:192-203) and then convolves the int8 tensor; so does
// this file: int8_quantize_kernel writes round(x / step) clipped to +-127
// (the step max(amax, 1e-12) / 127 of a calibrated amax, or max|x| / 127,
// unclamped, of the dynamic route), and the convolution always reads int8.
// The convolution: NHWC int8 input, a (Cout, kh*kw*Cin) int8 kernel, 1x1 or
// 3x3, stride 1 or 2, zero padding (k - 1) / 2; exact int32 accumulation;
// then the folded affine with the JAX package's rounding points
// (common.cuh, affine_bf16); an optional residual added in bf16 (the
// downsample conv's bf16 output, or an int8 skip dequantized as
// bf16(xq) * bf16(amax / 127)); an optional ReLU; out in bf16, or
// requantized to int8 with a calibrated amax, clip(round(y * (127 / amax))).
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
//   bf16 tile in the ring, then each thread finishes 8 (or 16) consecutive
//   channels of one pixel and stores 16 bytes (8 for an int8 output whose
//   Cout is not a multiple of 16).
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
// quantize pass (int8_quantize_kernel, on the path).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using capf::affine_bf16;
using capf::folded_scale;
using capf::round_to;
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
  const void* res;       // (B, Ho, Wo, Cout) bf16 or int8, or null
  const float* res_amax; // scalar: the int8 residual's calibrated amax
  const float* out_amax; // scalar: the int8 output's amax; null: bf16 out
  void* out;             // (B, Ho, Wo, Cout) bf16, int8, or int32/fp32
  int batch, h, w, cin, cout, ksize, stride, ho, wo;
  int clamp_amax, res_int8, relu;
  int tile_n;            // the plan: the tile's width, 64 or 128
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

// round(v / step) clipped, as int8. A zero skips the division: the IEEE
// division's range check sends a zero dividend down its slow path, and the
// dynamic convs' inputs are ReLU outputs, about half of them zeros.
__device__ __forceinline__ int8_t quantize(__nv_bfloat16 v, float step) {
  const float x = __bfloat162float(v);
  return x == 0.f ? 0 : to_int8_rne(__fdiv_rn(x, step));
}

// 127 / max(amax, 1e-12), an IEEE division as XLA computes it
__device__ __forceinline__ float requant_scale(const float* amax) {
  return __fdiv_rn(127.f, fmaxf(*amax, 1e-12f));
}

// bf16(max(amax, 1e-12) / 127): the dequant scale of an int8 skip
__device__ __forceinline__ float dequant_scale(const float* amax) {
  return round_to<__nv_bfloat16>(
      __fmul_rn(fmaxf(*amax, 1e-12f), capf::kRecip127));
}

// one output value after the affine: the residual added in bf16, then the
// ReLU (common to the conv and the requant probe)
__device__ __forceinline__ float finish(float y, float res, bool has_res,
                                        bool relu) {
  if (has_res) y = round_to<__nv_bfloat16>(__fadd_rn(y, res));
  return relu ? fmaxf(y, 0.f) : y;
}

// 8 consecutive residual values of one pixel as floats: a bf16 residual as
// it is, an int8 skip dequantized as bf16(xq) * bf16(amax / 127)
__device__ __forceinline__ void residual8(const void* p, bool res_int8,
                                          float res_deq, float* r) {
  if (res_int8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t w = e < 4 ? q.x : q.y;
      const int8_t v = static_cast<int8_t>((w >> (8 * (e % 4))) & 0xff);
      r[e] = round_to<__nv_bfloat16>(__fmul_rn(static_cast<float>(v),
                                               res_deq));
    }
  } else {
    const uint4 f = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      r[e] = __bfloat162float(__ushort_as_bfloat16(
          static_cast<unsigned short>(w[e / 2] >> (16 * (e % 2)))));
    }
  }
}

// 8 consecutive bf16 values (16 bytes) as floats
__device__ __forceinline__ void load_bf16x8(const __nv_bfloat16* p,
                                            float* y) {
  const uint4 f = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    y[e] = __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>(w[e / 2] >> (16 * (e % 2)))));
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

// 8 finished values -> bf16, one 16-byte store (exact: every value is a
// bf16 number already)
__device__ __forceinline__ void store_bf16x8(__nv_bfloat16* out,
                                             const float* y) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
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
  static constexpr int kPitch = kBN + 8;  // a staged row's values (bf16 or
                                          // the probes' 32-bit sums)
  static constexpr int kBarriers = (2 * kStages + 1) * sizeof(uint64_t);
  // the staged tile: the affine's bf16 output (the product), the probes'
  // 32-bit sums
  __host__ __device__ static constexpr int staged(bool product) {
    return kBM * kPitch * (product ? 2 : 4);
  }
  // the ring's bytes, ``stages`` deep: at least the staged tile, which
  // reuses it once the products are done
  __host__ __device__ static constexpr int ring(int stages, bool product) {
    return stages * kStage > staged(product) ? stages * kStage
                                             : staged(product);
  }
  // the block's shared memory: slack to align the ring to the 1024 bytes
  // the swizzle needs, the ring, the prefetched residual tile, the barriers
  // and the epilogue's scales
  __host__ __device__ static constexpr int smem(int stages, bool product,
                                                int res_bytes) {
    return 1024 + ring(stages, product) + res_bytes + kBarriers +
           2 * kBN * static_cast<int>(sizeof(float));
  }
  // smem() at its largest: the full ring and a bf16 residual
  static constexpr int kSmemMax = 1024 + kStages * kStage + kBM * kBN * 2 +
                                  kBarriers +
                                  2 * kBN * static_cast<int>(sizeof(float));
  static_assert(kStages * kStage >= kBM * kPitch * 4, "the tile fits");
};

// Grid: one block per (M tile, N tile), N tiles fastest so that the blocks
// sharing an A tile run together and A crosses HBM once. Threads: one
// consumer warpgroup (the 64 output rows), then one producer warpgroup.
// kBf16: the bf16 probe (bf16 operands, fp32 out).
template <int kBN, Mode kMode, bool kBf16>
__global__ void __launch_bounds__(Tile<kBN>::kThreads, Tile<kBN>::kMinBlocks)
    conv_kernel(const __grid_constant__ CUtensorMap wmap,
                const Int8ConvArgs a) {
  using T = Tile<kBN>;
  using Acc = typename std::conditional<kBf16, float, int>::type;
  constexpr int kBM = T::kBM;
  constexpr int kConsumers = T::kConsumers;
  constexpr bool kProduct = kMode == Mode::kProduct;
  constexpr int kEs = kBf16 ? 1 : 0;  // log2 of the operands' element bytes
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
  const int res_elem = a.res_int8 ? 1 : 2;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_a = ring;                        // stages x A
  unsigned char* s_b = ring + stages * T::kAStage;  // stages x B
  unsigned char* s_res = ring + T::ring(stages, kProduct);  // the residual
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
        s_eff[i] = n < a.cout ? folded_scale(a.scale[n], a.wscale[n], step)
                              : 0.f;
        s_bias[i] = n < a.cout ? round_to<__nv_bfloat16>(a.bias[n]) : 0.f;
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
    // affine's bf16 output (the product), the 32-bit sums (the probes)
    named_sync(1, kConsumers);
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row = warp * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    if constexpr (kProduct) {
      __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
#pragma unroll
      for (int q = 0; q < kBN / 8; ++q) {
        const int col = 8 * q + col0;
        const float e0 = s_eff[col], e1 = s_eff[col + 1];
        const float b0 = s_bias[col], b1 = s_bias[col + 1];
        *reinterpret_cast<__nv_bfloat162*>(tile + row * T::kPitch + col) =
            __floats2bfloat162_rn(affine_bf16(acc[4 * q], e0, b0),
                                  affine_bf16(acc[4 * q + 1], e1, b1));
        *reinterpret_cast<__nv_bfloat162*>(tile + (row + 8) * T::kPitch +
                                           col) =
            __floats2bfloat162_rn(affine_bf16(acc[4 * q + 2], e0, b0),
                                  affine_bf16(acc[4 * q + 3], e1, b1));
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
      const __nv_bfloat16* tile = reinterpret_cast<const __nv_bfloat16*>(ring);
      const float res_deq =
          has_res && a.res_int8 ? dequant_scale(a.res_amax) : 0.f;
      if (has_res) mbar_wait(res_full, 0);
      const bool int8_out = a.out_amax != nullptr;
      const float q_out = int8_out ? requant_scale(a.out_amax) : 0.f;
      const bool relu = a.relu != 0;
      // the staged affine output of 8 channels from column c of row r, the
      // residual added, the ReLU
      auto finish8 = [&](int r, int c, float* y) {
        float res[8];
        load_bf16x8(tile + r * T::kPitch + c, y);
        if (has_res) {
          residual8(s_res + (r * kBN + c) * res_elem, a.res_int8 != 0,
                    res_deq, res);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          y[e] = finish(y[e], has_res ? res[e] : 0.f, has_res, relu);
        }
      };
      // 8 channels a thread (16 bytes of bf16 out), or 16 for an int8 out
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
            store_bf16x8(static_cast<__nv_bfloat16*>(a.out) + off, y);
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
      y[4 * q + e] = finish(
          affine_bf16(acc[e], folded_scale(a.scale[c], a.wscale[c], step),
                      round_to<__nv_bfloat16>(a.bias[c])),
          0.f, false, a.relu != 0);
    }
  }
  store_int8<16>(a.out + i, y, requant_scale(a.out_amax));
}

// The quantize pass: bf16 x -> int8, 16 values a thread (two 16-byte loads,
// one 16-byte store), with the calibrated (``clamp``) or dynamic step.
__global__ void int8_quantize_kernel(const __nv_bfloat16* x,
                                     const float* amax, int clamp,
                                     int8_t* out, size_t n) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 16;
  if (i >= n) return;
  const float step = input_step(*amax, clamp != 0);
  const int4* src = reinterpret_cast<const int4*>(x + i);
  const int4 lo = src[0], hi = src[1];
  const __nv_bfloat16* v0 = reinterpret_cast<const __nv_bfloat16*>(&lo);
  const __nv_bfloat16* v1 = reinterpret_cast<const __nv_bfloat16*>(&hi);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    w[j] = pack_int8x4(quantize(v0[4 * j], step), quantize(v0[4 * j + 1], step),
                       quantize(v0[4 * j + 2], step),
                       quantize(v0[4 * j + 3], step));
    w[2 + j] = pack_int8x4(
        quantize(v1[4 * j], step), quantize(v1[4 * j + 1], step),
        quantize(v1[4 * j + 2], step), quantize(v1[4 * j + 3], step));
  }
  *reinterpret_cast<uint4*>(out + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- host side -------------------------------------------------------------

template <int kBN, Mode kMode, bool kBf16>
cudaError_t launch(const Int8ConvArgs& a, cudaStream_t stream) {
  using T = Tile<kBN>;
  constexpr bool kProduct = kMode == Mode::kProduct;
  const int es = kBf16 ? 2 : 1;
  const long long kbytes = 1LL * a.ksize * a.ksize * a.cin * es;
  CUtensorMap map;
  cudaError_t err = weight_map(a.wq, kbytes, a.cout, kBN, &map);
  if (err != cudaSuccess) return err;
  auto kernel = conv_kernel<kBN, kMode, kBf16>;
  static bool opted = false;  // once per instantiation (one device)
  if (!opted) {
    err = capf::allow_smem(kernel, T::kSmemMax);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const int ktiles = static_cast<int>((kbytes + kBK - 1) / kBK);
  const int stages = ktiles < kStages ? ktiles : kStages;
  const int res_bytes = kProduct && a.res != nullptr
                            ? T::kBM * kBN * (a.res_int8 ? 1 : 2)
                            : 0;
  const long long m_total = 1LL * a.batch * a.ho * a.wo;
  const long long blocks = ((m_total + T::kBM - 1) / T::kBM) *
                           ((a.cout + kBN - 1) / kBN);
  kernel<<<static_cast<unsigned>(blocks), T::kThreads,
           T::smem(stages, kProduct, res_bytes), stream>>>(map, a);
  return cudaGetLastError();
}

template <Mode kMode, bool kBf16>
cudaError_t dispatch(const Int8ConvArgs& a, cudaStream_t stream) {
  if (a.tile_n == 128) return launch<128, kMode, kBf16>(a, stream);
  if (a.tile_n == 64) return launch<64, kMode, kBf16>(a, stream);
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
      (a.res != nullptr && a.res_int8 && !a.res_amax)) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(dispatch<Mode::kProduct, false>(a, stream));
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

extern "C" int capf_int8_quantize(const void* x, const float* amax, void* out,
                                  long long n, int clamp, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 16 || n % 16) return cudaErrorInvalidValue;
  const int threads = 256;
  const long long groups = n / 16;
  int8_quantize_kernel<<<static_cast<unsigned>((groups + threads - 1) /
                                               threads),
                         threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), amax, clamp,
      static_cast<int8_t*>(out), static_cast<size_t>(n));
  return static_cast<int>(cudaGetLastError());
}
