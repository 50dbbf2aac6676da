// Shared helpers for the port's hand-written kernels (sm_90a).
//
// Every kernel stores in T (float or __nv_bfloat16) and computes in fp32.
// round_to<T> reproduces a store-and-reload through T, at the points where
// the JAX kernels cast an intermediate to the compute dtype. The samplers
// also read int8 maps (raw quantized numbers) and store those samples in
// bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace capf {

enum DType { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch .to()
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// grid_sample's [-1, 1] -> pixel mapping (ops/grid_sample.py), shared by
// the sampler's forward (K1) and backward (K6)
__device__ __forceinline__ float unnormalize(float v, int size, bool align) {
  return align ? (v + 1.f) * 0.5f * static_cast<float>(size - 1)
               : ((v + 1.f) * static_cast<float>(size) - 1.f) * 0.5f;
}

// Tap rows (y * W + x) and bilinear weights of one point, shared by the
// sampler (K1) and the aggregation (K7); an out-of-bounds tap gets weight 0
// and row 0 (zeros padding), and border mode never has one.
__device__ __forceinline__ void point_taps(float xn, float yn, int h, int w,
                                           bool border, bool align,
                                           int* rows, float* weights) {
  float x = unnormalize(xn, w, align);
  float y = unnormalize(yn, h, align);
  if (border) {
    x = fminf(fmaxf(x, 0.f), static_cast<float>(w - 1));
    y = fminf(fmaxf(y, 0.f), static_cast<float>(h - 1));
  } else {
    // keep the int conversion defined; beyond one step outside the map
    // every tap is out of bounds either way
    x = fminf(fmaxf(x, -2.f), static_cast<float>(w + 1));
    y = fminf(fmaxf(y, -2.f), static_cast<float>(h + 1));
  }
  const float x0f = floorf(x), y0f = floorf(y);
  const float wx = x - x0f, wy = y - y0f;
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
  const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
  const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
  const float ws[4] = {(1.f - wy) * (1.f - wx), (1.f - wy) * wx,
                       wy * (1.f - wx), wy * wx};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = ys[k] >= 0 && ys[k] < h && xs[k] >= 0 && xs[k] < w;
    rows[k] = in ? ys[k] * w + xs[k] : 0;
    weights[k] = in ? ws[k] : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- int8 (K9, K10) -------------------------------------------------------

// fl32(1 / 127): the JAX package serves under jit, where XLA turns each
// division of an activation scale by the constant 127 into this multiply.
constexpr float kRecip127 = 1.0f / 127.0f;

// clip(round(v), -127, 127) as int8: round half to even, as jnp.round.
__device__ __forceinline__ int8_t to_int8_rne(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

// The int8 convolutions' folded affine with the JAX package's rounding
// points in the epilogue's dtype T (bf16 or fp32): T(acc) (through fp32, as
// XLA converts), a T multiply by the T dequant scale, a T add of the T bias;
// two roundings, no FMA. round_to<float> is the identity, so the fp32 form
// is fp32(acc) * eff + bias with each op rounded once, as torch runs them.
template <typename T>
__device__ __forceinline__ float affine(int acc, float eff, float bias) {
  float y = round_to<T>(__int2float_rn(acc));
  y = round_to<T>(__fmul_rn(y, eff));
  return round_to<T>(__fadd_rn(y, bias));
}

// T(scale * wscale * step): a conv's dequant scale folded into its BN
// scale, in fp32 and in that order, then rounded to T.
template <typename T>
__device__ __forceinline__ float folded_scale(float scale, float wscale,
                                              float step) {
  return round_to<T>(__fmul_rn(__fmul_rn(scale, wscale), step));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A B on the tensor cores: A 16x32 int8 (row-major fragment a[4]),
// B 32x8 int8 (column-major fragment b[2]), D 16x8 int32. Lane l holds
// rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4) + 1 of D, and the four
// k-consecutive bytes at k = 4(l%4) (+16) of its rows of A and column of B.
__device__ __forceinline__ void mma_s8_16x8x32(int (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// 8 consecutive E values (16 bytes of bf16, 32 of fp32) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* y) {
  const uint4 f = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    y[e] = __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>(w[e / 2] >> (16 * (e % 2)))));
  }
}
__device__ __forceinline__ void load8(const float* p, float* y) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  y[0] = lo.x, y[1] = lo.y, y[2] = lo.z, y[3] = lo.w;
  y[4] = hi.x, y[5] = hi.y, y[6] = hi.z, y[7] = hi.w;
}

// 8 finished values -> E: one 16-byte store of bf16 (exact: every value is
// a bf16 number already), two of fp32
__device__ __forceinline__ void store8(__nv_bfloat16* out, const float* y) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* out, const float* y) {
  *reinterpret_cast<float4*>(out) = make_float4(y[0], y[1], y[2], y[3]);
  *reinterpret_cast<float4*>(out + 4) = make_float4(y[4], y[5], y[6], y[7]);
}

// two staged values of one row, E(a) and E(b), at an even column
__device__ __forceinline__ void stage2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void stage2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace capf
