// K10u: the CPN's s8 top-down hop (cpn_int8_topdown), the x2 upsample of
// the requantized up-conv output fused with the lateral add.
//
// Replaces the XLA graph of contextaware_poseformer_tpu/models/cpn.py:
// 334-338 and the add at cpn.py:289, over backbone_common.py:266-280 (no
// Pallas kernel, no PyTorch CUDA counterpart). For q (B, h, w, C) int8 (the
// up-conv's output, requantized in K10's epilogue with the hop's calibrated
// amax ua) and the next level's lateral lat (B, 2h, 2w, C) in E:
//   r   = E(wr0 * q[i0] + wr1 * q[i1])        the row pass (align-corners)
//   u   = E(wc0 * r[:, j0] + wc1 * r[:, j1])  the column pass
//   out = E(lat + E(u * E(ua / 127)))
// with the JAX package's rounding points: its separable resize is two
// dense interpolation matmuls in E with the weights rounded to E, and
// each output element of a pass has two taps (a clipped edge tap folded
// into one weight), so a pass is the sum of two fp32 products rounded
// once to E (in bf16 every product is exact). The taps and weights are the
// host's tables (ops/int8_conv.py::interp_table), the same the plain
// version reads. E is bf16 or fp32 (a template parameter); no FMA, as the
// plain version computes each product and sum apart.
//
// What bounds it on the H100: bytes. The upsampled tensor never reaches
// HBM: a thread computes 8 channels of one output pixel from the 4 int8
// taps (8 bytes each; the source rows are small and cached in L1/L2), and
// reads the lateral and writes the output 16 bytes (bf16) at a time,
// consecutive threads on consecutive channels. At batch 64 and C 256 the
// three hops of a request move 16.5 MB of int8, 132.1 MB of lateral and
// 132.1 MB of output in bf16: 0.0838 ms at 3.35 TB/s.
#include "common.cuh"
#include "hopper.cuh"

using capf::load8;
using capf::round_to;
using capf::store8;

namespace {

constexpr int kThreads = 256;

// 8 int8 values (8 bytes) as floats
__device__ __forceinline__ void load8_s8(const int8_t* p, float* y) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t w = e < 4 ? v.x : v.y;
    y[e] = static_cast<float>(static_cast<int8_t>((w >> (8 * (e % 4))) & 0xff));
  }
}

// E(w0 * a + w1 * b): two products and their sum in fp32, rounded once
template <typename E>
__device__ __forceinline__ float blend(float w0, float a, float w1,
                                       float b) {
  return round_to<E>(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b)));
}

// rows (2h,): tap rows i0/i1 (int32) and weights w0/w1 (fp32 holding E
// values) of each output row; cols (2w,) the same for the columns
template <typename E>
__global__ void __launch_bounds__(kThreads)
    topdown_kernel(const int8_t* __restrict__ q, const float* __restrict__ ua,
                   const E* __restrict__ lat, E* __restrict__ out,
                   const int* __restrict__ row_idx,
                   const float* __restrict__ row_w,
                   const int* __restrict__ col_idx,
                   const float* __restrict__ col_w, int batch, int h, int w,
                   int c) {
  const int groups = c / 8;
  const int oh = 2 * h, ow = 2 * w;
  const long long total = 1LL * batch * oh * ow * groups;
  const float s = round_to<E>(__fmul_rn(fmaxf(*ua, 1e-12f), capf::kRecip127));
  for (long long t = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * kThreads) {
    const int g = static_cast<int>(t % groups);
    long long p = t / groups;
    const int ox = static_cast<int>(p % ow);
    p /= ow;
    const int oy = static_cast<int>(p % oh);
    const int b = static_cast<int>(p / oh);
    const int i0 = row_idx[2 * oy], i1 = row_idx[2 * oy + 1];
    const float wr0 = row_w[2 * oy], wr1 = row_w[2 * oy + 1];
    const int j0 = col_idx[2 * ox], j1 = col_idx[2 * ox + 1];
    const float wc0 = col_w[2 * ox], wc1 = col_w[2 * ox + 1];
    const int8_t* src = q + static_cast<size_t>(b) * h * w * c + 8 * g;
    float a00[8], a10[8], a01[8], a11[8];  // a<row tap><col tap>
    load8_s8(src + (static_cast<size_t>(i0) * w + j0) * c, a00);
    load8_s8(src + (static_cast<size_t>(i1) * w + j0) * c, a10);
    load8_s8(src + (static_cast<size_t>(i0) * w + j1) * c, a01);
    load8_s8(src + (static_cast<size_t>(i1) * w + j1) * c, a11);
    const size_t o = ((static_cast<size_t>(b) * oh + oy) * ow + ox) * c + 8 * g;
    float y[8];
    load8(lat + o, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float r0 = blend<E>(wr0, a00[e], wr1, a10[e]);
      const float r1 = blend<E>(wr0, a01[e], wr1, a11[e]);
      const float u = blend<E>(wc0, r0, wc1, r1);
      const float up = round_to<E>(__fmul_rn(u, s));
      y[e] = round_to<E>(__fadd_rn(y[e], up));
    }
    store8(out + o, y);
  }
}

template <typename E>
cudaError_t launch(const void* q, const float* ua, const void* lat,
                   void* out, const int* row_idx, const float* row_w,
                   const int* col_idx, const float* col_w, int batch, int h,
                   int w, int c, int device, cudaStream_t stream) {
  const long long total = 1LL * batch * 4 * h * w * (c / 8);
  const long long blocks = (total + kThreads - 1) / kThreads;
  const long long most = 8LL * capf::sm90::sm_count(device);  // grid-strided
  topdown_kernel<E><<<static_cast<unsigned>(blocks < most ? blocks : most),
                      kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), ua, static_cast<const E*>(lat),
      static_cast<E*>(out), row_idx, row_w, col_idx, col_w, batch, h, w, c);
  return cudaGetLastError();
}

}  // namespace

// (q, ua, lat, out, row taps, row weights, col taps, col weights, batch, h,
// w, c, f32, device, stream)
extern "C" int capf_topdown(const void* q, const float* ua, const void* lat,
                            void* out, const int* row_idx, const float* row_w,
                            const int* col_idx, const float* col_w,
                            int batch, int h, int w, int c, int f32,
                            int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch < 1 || h < 1 || w < 1 || c < 8 || c % 8 || (f32 != 0 && f32 != 1)
      || 1LL * batch * 4 * h * w * c > (1LL << 40)) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(
      f32 ? launch<float>(q, ua, lat, out, row_idx, row_w, col_idx, col_w,
                          batch, h, w, c, device, stream)
          : launch<__nv_bfloat16>(q, ua, lat, out, row_idx, row_w, col_idx,
                                  col_w, batch, h, w, c, device, stream));
}
