// K10: the int8 convolution of the deploy graphs (HRNet and CPN).
//
// Replaces the XLA int8 convolution of
// contextaware_poseformer_tpu/models/backbone_common.py::ConvBN (its int8
// routes, 157-213; the conv at 204-213), which has no Pallas kernel and no
// PyTorch CUDA counterpart, together with the elementwise ops that the CPN
// int8 stream fuses into it (contextaware_poseformer_tpu/models/cpn.py:
// 43-51, 123-181). NHWC input, either int8 with a calibrated amax (the
// x_quant route: step = max(amax, 1e-12) / 127), or bf16 quantized as it is
// loaded: with the calibrated amax of the serve_static_amax route (clamped
// as above) or with max|x| (the dynamic route, unclamped; the max comes from
// the wrapper); round(x / step) clipped to +-127. A (Cout, kh*kw*Cin) int8
// kernel, 1x1 or 3x3, stride 1 or 2, zero padding (k - 1) / 2; exact int32
// accumulation; then the folded affine with the JAX package's rounding
// points (common.cuh, affine_bf16); an optional residual added in bf16 (the
// downsample conv's bf16 output, or an int8 skip dequantized as
// bf16(xq) * bf16(amax / 127)); an optional ReLU; out in bf16, or requantized
// to int8 with a calibrated amax, clip(round(y * (127 / amax))) in fp32.
// That requantizing variant, chained, is also the counterpart of the TPU
// probe experiments/int8_chain_conv.py::kernel (an n-conv int8 3x3 chain).
//
// What bounds it on the H100: the deploy graphs' convs (batch 64, 8x6 to
// 64x48 maps, 64-2048 channels) are 0.4-30 GOP on a few to 50 MB, so the
// int8 tensor-core rate bounds the wide ones and HBM the thin ones. This
// first kernel is a plain implicit GEMM: a block owns 64 output pixels x 64
// output channels, stages 64 input channels of one tap at a time for both
// operands in shared memory (rows padded to 80 bytes, so fragment reads are
// free of bank conflicts) and runs mma.sync m16n8k32 on them; four warps,
// 32x32 each. No software pipelining, wgmma or TMA yet.
//
// The TPU probe experiments/int8_chain_micro.py timed the pieces of such a
// chain apart; its counterparts are builds of this file's code: the main
// loop alone with an int32 output (Mode::kAccum; a 1x1 call over a
// pre-windowed 576-channel input is the probe's matmul1), the same with the
// border predication compiled out (Mode::kAccumNoMask, wrong at the edges on
// purpose), the main loop on bf16 operands (bf16_conv_kernel, mma m16n8k16),
// the epilogue alone (int8_requant_kernel) and the quantize-on-load alone
// (int8_quantize_kernel).

#include "common.cuh"

using capf::affine_bf16;
using capf::folded_scale;
using capf::lds32;
using capf::round_to;
using capf::to_int8_rne;

// the entry points' argument block, passed by pointer from ctypes
extern "C" {
struct Int8ConvArgs {  // mirrored by ops/int8_conv.py::_Args
  const void* x;         // (B, H, W, Cin) int8 or bf16
  const void* wq;        // (Cout, kh*kw*Cin) int8 (bf16 in the bf16 probe)
  const float* wscale;   // (Cout,)
  const float* scale;    // (Cout,) BN scale
  const float* bias;     // (Cout,) BN bias
  const float* amax;     // scalar: calibrated amax, or max|x|
  const void* res;       // (B, Ho, Wo, Cout) bf16 or int8, or null
  const float* res_amax; // scalar: the int8 residual's calibrated amax
  const float* out_amax; // scalar: the int8 output's amax; null: bf16 out
  void* out;             // (B, Ho, Wo, Cout) bf16, int8, or int32/fp32
  int batch, h, w, cin, cout, ksize, stride, ho, wo;
  int x_int8, clamp_amax, res_int8, relu;
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

constexpr int kTile = 64;      // output pixels and channels a block owns
constexpr int kK = 64;         // input bytes staged per row and step
constexpr int kRow = kK + 16;  // bytes a staged row takes
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile

enum class Mode { kProduct, kAccum, kAccumNoMask };

// round(v / step) clipped, as int8. A zero skips the division: the IEEE
// division's range check sends a zero dividend down its slow path, and the
// dynamic convs' inputs are ReLU outputs, about half of them zeros.
__device__ __forceinline__ int8_t quantize(__nv_bfloat16 v, float step) {
  const float x = __bfloat162float(v);
  return x == 0.f ? 0 : to_int8_rne(__fdiv_rn(x, step));
}

// 16 bf16 values (two 16-byte loads) -> 16 int8
__device__ __forceinline__ int4 quantize16(int4 lo, int4 hi, float step) {
  const __nv_bfloat16* v0 = reinterpret_cast<const __nv_bfloat16*>(&lo);
  const __nv_bfloat16* v1 = reinterpret_cast<const __nv_bfloat16*>(&hi);
  int4 out;
  int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[i] = quantize(v0[i], step);
    o[8 + i] = quantize(v1[i], step);
  }
  return out;
}

// the quantization step of the input: max(amax, 1e-12) / 127 for a
// calibrated amax, max|x| / 127 for a runtime one (a multiply by
// fl32(1 / 127), as XLA compiles the division under jit)
__device__ __forceinline__ float input_step(const Int8ConvArgs& a) {
  const float amax = a.clamp_amax ? fmaxf(*a.amax, 1e-12f) : *a.amax;
  return __fmul_rn(amax, capf::kRecip127);
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

// where an A row's tap reads: (pixel offset in x, inside the image)
template <Mode kMode>
__device__ __forceinline__ bool tap_pixel(const Int8ConvArgs& a, bool a_row,
                                          int ab, int ay, int ax, int tap,
                                          int pad, size_t* pix) {
  const int iy = ay * a.stride + tap / a.ksize - pad;
  const int ix = ax * a.stride + tap % a.ksize - pad;
  if constexpr (kMode == Mode::kAccumNoMask) {
    // no border test: the tap's pixel, clamped into the tensor only so that
    // no read leaves it (a neighbouring row's pixel stands in for the zero)
    const long long last = 1LL * a.batch * a.h * a.w - 1;
    long long p = (1LL * ab * a.h + iy) * a.w + ix;
    p = p < 0 ? 0 : (p > last ? last : p);
    *pix = static_cast<size_t>(p) * a.cin;
    return a_row;
  } else {
    const bool in = a_row && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
    *pix = in ? (static_cast<size_t>(ab * a.h + iy) * a.w + ix) * a.cin : 0;
    return in;
  }
}

template <Mode kMode>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const Int8ConvArgs a) {
  __shared__ __align__(16) int8_t s_a[kTile * kRow];
  __shared__ __align__(16) int8_t s_b[kTile * kRow];
  __shared__ float s_eff[kTile];
  __shared__ float s_bias[kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int m_total = a.batch * a.ho * a.wo;

  // the probes' int32 builds on an int8 input take no amax
  const float step =
      kMode == Mode::kProduct || !a.x_int8 ? input_step(a) : 0.f;
  if (kMode == Mode::kProduct && tid < kTile) {
    const int n = n0 + tid;
    s_eff[tid] = n < a.cout ? folded_scale(a.scale[n], a.wscale[n], step)
                            : 0.f;
    s_bias[tid] = n < a.cout ? round_to<__nv_bfloat16>(a.bias[n]) : 0.f;
  }

  // loads: thread -> one row of the tile and 32 of the staged channels
  const int lr = tid >> 1;
  const int lc = (tid & 1) * 32;
  const int am = m0 + lr;
  const bool a_row = am < m_total;
  int ab = 0, ay = 0, ax = 0;
  if (a_row) {
    ab = am / (a.ho * a.wo);
    const int r = am - ab * a.ho * a.wo;
    ay = r / a.wo;
    ax = r - ay * a.wo;
  }
  const int bn = n0 + lr;
  const bool b_row = bn < a.cout;
  const int taps = a.ksize * a.ksize;
  const int pad = (a.ksize - 1) / 2;
  const size_t kdim = static_cast<size_t>(taps) * a.cin;
  const int8_t* wq = static_cast<const int8_t*>(a.wq);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  for (int tap = 0; tap < taps; ++tap) {
    size_t pix;
    const bool in = tap_pixel<kMode>(a, a_row, ab, ay, ax, tap, pad, &pix);
    for (int c0 = 0; c0 < a.cin; c0 += kK) {
      const int c = c0 + lc;
      int4 lo = make_int4(0, 0, 0, 0), hi = lo;
      if (in && c < a.cin) {
        if (a.x_int8) {
          const int4* src = reinterpret_cast<const int4*>(
              static_cast<const int8_t*>(a.x) + pix + c);
          lo = src[0];
          hi = src[1];
        } else {
          const int4* src = reinterpret_cast<const int4*>(
              static_cast<const __nv_bfloat16*>(a.x) + pix + c);
          lo = quantize16(src[0], src[1], step);
          hi = quantize16(src[2], src[3], step);
        }
      }
      int4* da = reinterpret_cast<int4*>(s_a + lr * kRow + lc);
      da[0] = lo;
      da[1] = hi;
      int4 wlo = make_int4(0, 0, 0, 0), whi = wlo;
      if (b_row && c < a.cin) {
        const int4* src = reinterpret_cast<const int4*>(
            wq + bn * kdim + static_cast<size_t>(tap) * a.cin + c);
        wlo = src[0];
        whi = src[1];
      }
      int4* db = reinterpret_cast<int4*>(s_b + lr * kRow + lc);
      db[0] = wlo;
      db[1] = whi;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kK; kk += 32) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int8_t* r0 = s_a + (wm + i * 16 + g) * kRow + kk + t * 4;
          const int8_t* r8 = r0 + 8 * kRow;
          af[i][0] = lds32(r0);
          af[i][1] = lds32(r8);
          af[i][2] = lds32(r0 + 16);
          af[i][3] = lds32(r8 + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* col = s_b + (wn + j * 8 + g) * kRow + kk + t * 4;
          bf[j][0] = lds32(col);
          bf[j][1] = lds32(col + 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            capf::mma_s8_16x8x32(acc[i][j], af[i], bf[j]);
          }
      }
      __syncthreads();
    }
  }

  const bool has_res = a.res != nullptr;
  const bool int8_out = a.out_amax != nullptr;
  const float q_out = int8_out ? requant_scale(a.out_amax) : 0.f;
  const float res_deq =
      has_res && a.res_int8 ? dequant_scale(a.res_amax) : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= m_total) continue;
      const size_t row = static_cast<size_t>(m) * a.cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn + j * 8 + t * 2;
        const int n = n0 + col;
        if (n >= a.cout) continue;  // Cout % 8 == 0: n + 1 < Cout too
        const int v[2] = {acc[i][j][half * 2], acc[i][j][half * 2 + 1]};
        if constexpr (kMode != Mode::kProduct) {
          *reinterpret_cast<int2*>(static_cast<int*>(a.out) + row + n) =
              make_int2(v[0], v[1]);
          continue;
        }
        float r[2] = {0.f, 0.f};
        if (has_res) {
          if (a.res_int8) {
            const char2 q = *reinterpret_cast<const char2*>(
                static_cast<const int8_t*>(a.res) + row + n);
            r[0] = round_to<__nv_bfloat16>(
                __fmul_rn(static_cast<float>(q.x), res_deq));
            r[1] = round_to<__nv_bfloat16>(
                __fmul_rn(static_cast<float>(q.y), res_deq));
          } else {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const __nv_bfloat16*>(a.res) + row + n));
            r[0] = f.x;
            r[1] = f.y;
          }
        }
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = finish(affine_bf16(v[e], s_eff[col + e], s_bias[col + e]),
                        r[e], has_res, a.relu != 0);
        }
        if (int8_out) {
          char2 q;
          q.x = to_int8_rne(__fmul_rn(y[0], q_out));
          q.y = to_int8_rne(__fmul_rn(y[1], q_out));
          *reinterpret_cast<char2*>(static_cast<int8_t*>(a.out) + row + n) =
              q;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + row + n) =
              __floats2bfloat162_rn(y[0], y[1]);
        }
      }
    }
  }
}

// D += A B on the tensor cores in bf16: A 16x16 (row-major fragment a[4]),
// B 16x8 (column-major fragment b[2]), D 16x8 fp32, with the same lane
// layout of D as mma_s8_16x8x32; lane l holds the bf16 pairs at
// k = 2(l%4) (+8) of its rows of A and its column of B.
__device__ __forceinline__ void mma_bf16_16x8x16(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bf16 probe (experiments/int8_chain_micro.py::bf16_matmul3_kernel):
// K10's main loop on bf16 operands, kK bytes = 32 channels a step, fp32 out.
__global__ void __launch_bounds__(kThreads)
    bf16_conv_kernel(const Int8ConvArgs a) {
  __shared__ __align__(16) int8_t s_a[kTile * kRow];
  __shared__ __align__(16) int8_t s_b[kTile * kRow];
  constexpr int kC = kK / 2;  // bf16 channels a staged row holds

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int m_total = a.batch * a.ho * a.wo;

  const int lr = tid >> 1;
  const int lc = (tid & 1) * (kC / 2);  // 16 channels, 32 bytes
  const int am = m0 + lr;
  const bool a_row = am < m_total;
  int ab = 0, ay = 0, ax = 0;
  if (a_row) {
    ab = am / (a.ho * a.wo);
    const int r = am - ab * a.ho * a.wo;
    ay = r / a.wo;
    ax = r - ay * a.wo;
  }
  const int bn = n0 + lr;
  const bool b_row = bn < a.cout;
  const int taps = a.ksize * a.ksize;
  const int pad = (a.ksize - 1) / 2;
  const size_t kdim = static_cast<size_t>(taps) * a.cin;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* wk = static_cast<const __nv_bfloat16*>(a.wq);

  float acc[2][4][4] = {};
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  for (int tap = 0; tap < taps; ++tap) {
    size_t pix;
    const bool in =
        tap_pixel<Mode::kAccum>(a, a_row, ab, ay, ax, tap, pad, &pix);
    for (int c0 = 0; c0 < a.cin; c0 += kC) {
      const int c = c0 + lc;
      int4 lo = make_int4(0, 0, 0, 0), hi = lo;
      if (in && c < a.cin) {
        const int4* src = reinterpret_cast<const int4*>(x + pix + c);
        lo = src[0];
        hi = src[1];
      }
      int4* da = reinterpret_cast<int4*>(s_a + lr * kRow + lc * 2);
      da[0] = lo;
      da[1] = hi;
      int4 wlo = make_int4(0, 0, 0, 0), whi = wlo;
      if (b_row && c < a.cin) {
        const int4* src = reinterpret_cast<const int4*>(
            wk + bn * kdim + static_cast<size_t>(tap) * a.cin + c);
        wlo = src[0];
        whi = src[1];
      }
      int4* db = reinterpret_cast<int4*>(s_b + lr * kRow + lc * 2);
      db[0] = wlo;
      db[1] = whi;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kK; kk += 32) {  // 16 bf16 = 32 bytes a step
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int8_t* r0 = s_a + (wm + i * 16 + g) * kRow + kk + t * 4;
          const int8_t* r8 = r0 + 8 * kRow;
          af[i][0] = lds32(r0);
          af[i][1] = lds32(r8);
          af[i][2] = lds32(r0 + 16);
          af[i][3] = lds32(r8 + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* col = s_b + (wn + j * 8 + g) * kRow + kk + t * 4;
          bf[j][0] = lds32(col);
          bf[j][1] = lds32(col + 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16_16x8x16(acc[i][j], af[i], bf[j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= m_total) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + t * 2;
        if (n >= a.cout) continue;
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) +
                                   static_cast<size_t>(m) * a.cout + n) =
            make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
      }
    }
}

// The epilogue alone (the requant probe): int32 acc -> the folded bf16
// affine -> ReLU -> int8 with the output's calibrated amax, a thread per
// pair of channels.
__global__ void int8_requant_kernel(const Int8RequantArgs a) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 2;
  if (i >= static_cast<size_t>(a.rows) * a.cols) return;
  const int n = static_cast<int>(i % a.cols);
  const float step =
      __fmul_rn(fmaxf(*a.amax, 1e-12f), capf::kRecip127);
  const float q_out = requant_scale(a.out_amax);
  const int2 v = *reinterpret_cast<const int2*>(a.acc + i);
  const int vs[2] = {v.x, v.y};
  char2 q;
  int8_t* qs = reinterpret_cast<int8_t*>(&q);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float y = finish(
        affine_bf16(vs[e], folded_scale(a.scale[n + e], a.wscale[n + e], step),
                    round_to<__nv_bfloat16>(a.bias[n + e])),
        0.f, false, a.relu != 0);
    qs[e] = to_int8_rne(__fmul_rn(y, q_out));
  }
  *reinterpret_cast<char2*>(a.out + i) = q;
}

// Quantize-on-load alone: bf16 x -> int8 with K10's quantize16, 16 values a
// thread; the step that of a calibrated amax, max(amax, 1e-12) / 127.
__global__ void int8_quantize_kernel(const __nv_bfloat16* x, const float* amax,
                                     int8_t* out, size_t n) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 16;
  if (i >= n) return;
  const float step = __fmul_rn(fmaxf(*amax, 1e-12f), capf::kRecip127);
  const int4* src = reinterpret_cast<const int4*>(x + i);
  *reinterpret_cast<int4*>(out + i) = quantize16(src[0], src[1], step);
}

bool valid(const Int8ConvArgs& a, int multiple) {
  const long long m_total = 1LL * a.batch * a.ho * a.wo;
  return a.batch >= 1 && a.cin >= multiple && a.cin % multiple == 0 &&
         a.cout >= 8 && a.cout % 8 == 0 && (a.ksize == 1 || a.ksize == 3) &&
         (a.stride == 1 || a.stride == 2) && m_total >= 1 &&
         m_total <= (1LL << 30);
}

dim3 conv_grid(const Int8ConvArgs& a) {
  const long long m_total = 1LL * a.batch * a.ho * a.wo;
  return dim3(static_cast<unsigned>((m_total + kTile - 1) / kTile),
              (a.cout + kTile - 1) / kTile);
}

}  // namespace

extern "C" int capf_int8_conv(const Int8ConvArgs* args, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Int8ConvArgs& a = *args;
  if (!valid(a, 32) || (a.res != nullptr && a.res_int8 && !a.res_amax)) {
    return cudaErrorInvalidValue;
  }
  int8_conv_kernel<Mode::kProduct><<<conv_grid(a), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The probes' builds of the main loop: mode 1 the int32 accumulation, mode 2
// the same without border predication, mode 3 the bf16 main loop (fp32 out).
extern "C" int capf_int8_conv_probe(const Int8ConvArgs* args, int mode,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Int8ConvArgs& a = *args;
  if (!valid(a, mode == 3 ? 16 : 32)) return cudaErrorInvalidValue;
  const dim3 grid = conv_grid(a);
  if (mode == 1) {
    int8_conv_kernel<Mode::kAccum><<<grid, kThreads, 0, stream>>>(a);
  } else if (mode == 2) {
    int8_conv_kernel<Mode::kAccumNoMask><<<grid, kThreads, 0, stream>>>(a);
  } else if (mode == 3) {
    bf16_conv_kernel<<<grid, kThreads, 0, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capf_int8_requant(const Int8RequantArgs* args, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Int8RequantArgs& a = *args;
  const long long pairs = 1LL * a.rows * a.cols / 2;
  if (a.rows < 1 || a.cols < 2 || a.cols % 2 || pairs > (1LL << 34)) {
    return cudaErrorInvalidValue;
  }
  const int threads = 256;
  int8_requant_kernel<<<static_cast<unsigned>((pairs + threads - 1) / threads),
                        threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int capf_int8_quantize(const void* x, const float* amax, void* out,
                                  long long n, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 16 || n % 16) return cudaErrorInvalidValue;
  const int threads = 256;
  const long long groups = n / 16;
  int8_quantize_kernel<<<static_cast<unsigned>((groups + threads - 1) /
                                               threads),
                         threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), amax, static_cast<int8_t*>(out),
      static_cast<size_t>(n));
  return static_cast<int>(cudaGetLastError());
}
