// K10: the int8 convolution of the HRNet deploy graph.
//
// Replaces the XLA int8 convolution of
// contextaware_poseformer_tpu/models/backbone_common.py::ConvBN (its int8
// routes, 157-213; the conv at 204-213), which has no Pallas kernel and no
// PyTorch CUDA counterpart. NHWC input, either int8 with a calibrated amax
// (the x_quant route: step = max(amax, 1e-12) / 127) or bf16 quantized as
// it is loaded (the dynamic route: step = max|x| / 127, round(x / step)
// clipped to +-127; the max comes from the wrapper); a (Cout, kh*kw*Cin)
// int8 kernel, 1x1 or 3x3, stride 1 or 2, zero padding (k - 1) / 2; exact
// int32 accumulation; then the folded affine with the JAX package's
// rounding points (common.cuh, affine_bf16), optional ReLU, bf16 NHWC out.
//
// What bounds it on the H100: the deploy graph's convs (batch 64, 8x6 to
// 64x48 maps, 128-384 channels, and transition1's 256 -> 32/64 at 64x48)
// are 1-30 GOP on a few to 50 MB, so the int8 tensor-core rate bounds the
// wide ones and HBM the thin transition. This first kernel is a plain
// implicit GEMM: a block owns 64 output pixels x 64 output channels, stages
// 64 input channels of one tap at a time for both operands in shared memory
// (rows padded to 80 bytes, so fragment reads are free of bank conflicts)
// and runs mma.sync m16n8k32 on them; four warps, 32x32 each. No software
// pipelining, wgmma or TMA yet.

#include "common.cuh"

using capf::affine_bf16;
using capf::folded_scale;
using capf::lds32;
using capf::round_to;
using capf::to_int8_rne;

// the entry point's argument block, passed by pointer from ctypes
extern "C" {
struct Int8ConvArgs {  // mirrored by ops/int8_conv.py::_Args
  const void* x;             // (B, H, W, Cin) int8 or bf16
  const int8_t* wq;          // (Cout, kh * kw * Cin), K ordered (kh, kw, Cin)
  const float* wscale;       // (Cout,)
  const float* scale;        // (Cout,) BN scale
  const float* bias;         // (Cout,) BN bias
  const float* amax;         // scalar: calibrated amax, or max|x|
  __nv_bfloat16* out;        // (B, Ho, Wo, Cout)
  int batch, h, w, cin, cout, ksize, stride, ho, wo, x_int8, relu;
};
}  // extern "C"

namespace {

constexpr int kTile = 64;      // output pixels and channels a block owns
constexpr int kK = 64;         // input channels staged per step
constexpr int kRow = kK + 16;  // bytes a staged row takes
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile

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

  const float amax = a.x_int8 ? fmaxf(*a.amax, 1e-12f) : *a.amax;
  const float step = __fmul_rn(amax, capf::kRecip127);
  if (tid < kTile) {
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
    const int iy = ay * a.stride + tap / a.ksize - pad;
    const int ix = ax * a.stride + tap % a.ksize - pad;
    const bool in = a_row && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
    const size_t pix =
        in ? (static_cast<size_t>(ab * a.h + iy) * a.w + ix) * a.cin : 0;
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
            a.wq + bn * kdim + static_cast<size_t>(tap) * a.cin + c);
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= m_total) continue;
      __nv_bfloat16* orow = a.out + static_cast<size_t>(m) * a.cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn + j * 8 + t * 2;
        const int n = n0 + col;
        if (n >= a.cout) continue;  // Cout % 8 == 0: n + 1 < Cout too
        float y0 = affine_bf16(acc[i][j][half * 2], s_eff[col], s_bias[col]);
        float y1 = affine_bf16(acc[i][j][half * 2 + 1], s_eff[col + 1],
                               s_bias[col + 1]);
        if (a.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + n) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

}  // namespace

extern "C" int capf_int8_conv(const Int8ConvArgs* args, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Int8ConvArgs& a = *args;
  const long long m_total = 1LL * a.batch * a.ho * a.wo;
  if (a.batch < 1 || a.cin < 32 || a.cin % 32 || a.cout < 8 || a.cout % 8 ||
      (a.ksize != 1 && a.ksize != 3) || (a.stride != 1 && a.stride != 2) ||
      m_total < 1 || m_total > (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>((m_total + kTile - 1) / kTile),
                  (a.cout + kTile - 1) / kTile);
  int8_conv_kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
