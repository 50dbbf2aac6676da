// K2: fused LayerNorm -> fc1 -> exact-erf GELU -> fc2 -> residual add.
//
// Replaces contextaware_poseformer_tpu/ops/fused_mlp.py::_kernel (entry
// ln_mlp_residual): y = x + fc2(gelu(fc1(LN(x)))) per row, LN statistics with
// the fast variance E[x^2] - mu^2 and the residual add in fp32, the matmul
// operands in the call's dtype with fp32 accumulation.
//
// What bounds it on the H100: at the lifter's widths (D = 128 or 640,
// H = 2D) the work is 4*D*H MACs per row against 2*D*bytes of row traffic,
// so with the (rows, H) hidden activation kept on chip the kernel is bound by
// arithmetic and by how a block reads W1 and W2 from L2, not by device
// memory. The design keeps that property of the TPU kernel: a block keeps its
// rows, their LN output and their GELU output in shared memory and streams
// W1 and W2 once per block.
//
// Two bodies, one contract:
// - bf16 (the serving path): tensor cores through WMMA 16x16x16 tiles, one
//   16-row tile per block. A warp computes a 16 x 32 output strip at a time.
//   Its B operand (W1 or W2) comes from L2 in coalesced 16-byte loads,
//   kGroup k-steps at once, and is staged in the warp's own shared-memory
//   buffer, because WMMA reads a row-major bf16 B tile from device memory
//   two bytes at a time (measured: 0.27 ms for the joint blocks' call that
//   way). The epilogue (bias, GELU or residual) runs through a 16x16 fp32
//   staging tile. Rows in shared memory are padded by kPad elements so the
//   tensor cores' 8-row reads hit distinct banks. Needs D and H to be
//   multiples of 32.
// - fp32 (parity runs): CUDA cores, 8 rows per block, one output column per
//   thread with 8 accumulators; any D and H that fit in shared memory.
//
// Grid: ceil(rows / rows per block) blocks of kThreads threads.

#include <mma.h>

#include "common.cuh"

using capf::from_float;
using capf::to_float;

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;     // fp32 body: rows per block
constexpr int kTcRows = 16;  // bf16 body: one WMMA row tile per block
constexpr int kTile = 16;    // WMMA tile edge
constexpr int kStrip = 32;   // bf16 body: output columns per warp pass
constexpr int kGroup = 4;    // bf16 body: k-steps whose B loads go together
constexpr int kPad = 8;      // bf16 body: padding of a shared-memory row
constexpr int kBufLd = kStrip + kPad;                  // staged B row
constexpr int kBufElems = kGroup * kTile * kBufLd;     // one warp's buffer

using FragA =
    wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, bf16, wmma::row_major>;
using FragB =
    wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float>;

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.f + erff(a * 0.70710678118654752f));
}

// LayerNorm statistics of one row, by one warp: (mean, 1/sqrt(var + eps))
// with the fast variance.
__device__ __forceinline__ float2 row_stats(const float* xr, int d, int lane,
                                            float eps) {
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float v = xr[k];
    s += v;
    ss += v * v;
  }
  s = capf::warp_sum(s);
  ss = capf::warp_sum(ss);
  const float mu = s / d;
  return make_float2(mu, rsqrtf(ss / d - mu * mu + eps));
}

// Load a block's rows into shared memory as fp32 (rows past the end: 0).
template <typename T>
__device__ __forceinline__ void load_rows(const T* xb, float* s_x, int n,
                                          int n_rows, int d) {
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    s_x[i] = i < n_rows * d ? to_float(xb[i]) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    ln_mlp_fp32_kernel(const float* __restrict__ x,
                       const float* __restrict__ ln_scale,
                       const float* __restrict__ ln_bias,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2, float* __restrict__ out,
                       int rows, int d, int hdim, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s_x = reinterpret_cast<float*>(smem_raw);  // (kRows, d) input
  float* s_h = s_x + kRows * d;                     // (kRows, d) LN(x)
  float* s_g = s_h + kRows * d;                     // (kRows, hdim) GELU

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, rows - row0);

  load_rows(x + static_cast<size_t>(row0) * d, s_x, kRows, n_rows, d);
  __syncthreads();

  for (int r = warp; r < kRows; r += kWarps) {
    const float* xr = s_x + r * d;
    const float2 st = row_stats(xr, d, lane, eps);
    for (int k = lane; k < d; k += 32) {
      s_h[r * d + k] = (xr[k] - st.x) * st.y * ln_scale[k] + ln_bias[k];
    }
  }
  __syncthreads();

  // fc1 + GELU: one hidden column per thread, all kRows rows at once
  for (int j = tid; j < hdim; j += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < d; ++k) {
      const float wv = w1[static_cast<size_t>(k) * hdim + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += s_h[r * d + k] * wv;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s_g[r * hdim + j] = gelu_erf(acc[r] + b1[j]);
    }
  }
  __syncthreads();

  // fc2 + bias + residual: one output column per thread
  for (int i = tid; i < d; i += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int j = 0; j < hdim; ++j) {
      const float wv = w2[static_cast<size_t>(j) * d + i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += s_g[r * hdim + j] * wv;
    }
    for (int r = 0; r < n_rows; ++r) {
      out[static_cast<size_t>(row0 + r) * d + i] =
          s_x[r * d + i] + (acc[r] + b2[i]);
    }
  }
}

// This lane's share of B for the (up to) kGroup k-steps from k0 of a strip
// starting at bn: 16 bytes of rows lrow and lrow + 8 of each k-step.
__device__ __forceinline__ void load_b_group(const bf16* bn, int ldb, int k0,
                                             int steps, int lrow, int lcol,
                                             uint4 (&r)[kGroup][2]) {
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
    if (s < steps) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = k0 + s * kTile + h * 8 + lrow;
        r[s][h] = *reinterpret_cast<const uint4*>(bn + row * ldb + lcol);
      }
    }
  }
}

// One 16 x kStrip output strip, by one warp: A (16 x k, shared memory, row
// stride lda) times columns n0 .. n0 + kStrip - 1 of B (k x ldb, device
// memory), into acc[0] and acc[1]. Each lane loads 16 bytes of a row of B,
// for kGroup k-steps at once; a group is staged in buf (the warp's
// kGroup x 16 x kBufLd buffer) for the tensor cores, and the next group's
// loads are issued before the staged group's products, so they are in
// flight while the tensor cores work.
__device__ __forceinline__ void strip_product(const bf16* a, int lda,
                                              const bf16* b, int ldb, int k,
                                              int n0, bf16* buf,
                                              FragC (&acc)[2]) {
  const int lane = threadIdx.x & 31;
  const int lrow = lane / 4;        // rows lrow and lrow + 8 of a k-step
  const int lcol = (lane % 4) * 8;  // 8 bf16 = 16 bytes
  const bf16* bn = b + n0;
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  uint4 r[kGroup][2];
  int next_steps = min(kGroup, k / kTile);  // warp-uniform
  load_b_group(bn, ldb, 0, next_steps, lrow, lcol, r);
  for (int k0 = 0; k0 < k; k0 += kGroup * kTile) {
    const int steps = next_steps;
    __syncwarp();  // the previous group's tiles have been read from buf
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      if (s < steps) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<uint4*>(
              buf + (s * kTile + h * 8 + lrow) * kBufLd + lcol) = r[s][h];
        }
      }
    }
    __syncwarp();
    const int next = k0 + kGroup * kTile;
    next_steps = next < k ? min(kGroup, (k - next) / kTile) : 0;
    load_b_group(bn, ldb, next, next_steps, lrow, lcol, r);
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      if (s < steps) {
        FragA fa;
        wmma::load_matrix_sync(fa, a + k0 + s * kTile, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, buf + s * kTile * kBufLd + j * kTile,
                                 kBufLd);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ln_mlp_bf16_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ ln_scale,
                       const float* __restrict__ ln_bias,
                       const bf16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const bf16* __restrict__ w2,
                       const float* __restrict__ b2, bf16* __restrict__ out,
                       int rows, int d, int hdim, float eps) {
  // every region starts on a 32-byte boundary, as WMMA loads and stores need
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s_x = reinterpret_cast<float*>(smem_raw);     // (16, d) input
  float* s_stage = s_x + kTcRows * d;                  // (warps, 16, 16)
  bf16* s_buf = reinterpret_cast<bf16*>(s_stage + kWarps * kTile * kTile);
  bf16* s_a = s_buf + kWarps * kBufElems;              // (16, d + kPad)
  bf16* s_g = s_a + kTcRows * (d + kPad);              // (16, hdim + kPad)
  const int lda = d + kPad;
  const int ldg = hdim + kPad;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kTcRows;
  const int n_rows = min(kTcRows, rows - row0);
  float* stage = s_stage + warp * kTile * kTile;
  bf16* buf = s_buf + warp * kBufElems;

  load_rows(x + static_cast<size_t>(row0) * d, s_x, kTcRows, n_rows, d);
  __syncthreads();

  // LayerNorm into s_a, rounded to bf16 for the tensor cores
  for (int r = warp; r < kTcRows; r += kWarps) {
    const float* xr = s_x + r * d;
    const float2 st = row_stats(xr, d, lane, eps);
    for (int k = lane; k < d; k += 32) {
      s_a[r * lda + k] =
          from_float<bf16>((xr[k] - st.x) * st.y * ln_scale[k] + ln_bias[k]);
    }
  }
  __syncthreads();

  // fc1 + bias + GELU into s_g; warp w takes strips w, w + kWarps, ...
  FragC acc[2];
  for (int n0 = warp * kStrip; n0 < hdim; n0 += kWarps * kStrip) {
    strip_product(s_a, lda, w1, hdim, d, n0, buf, acc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[j], kTile, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < kTile * kTile; i += 32) {
        const int r = i / kTile;
        const int c = n0 + j * kTile + i % kTile;
        s_g[r * ldg + c] = from_float<bf16>(gelu_erf(stage[i] + b1[c]));
      }
      __syncwarp();  // the staging tile is overwritten next
    }
  }
  __syncthreads();

  // fc2 + bias + fp32 residual into out
  for (int n0 = warp * kStrip; n0 < d; n0 += kWarps * kStrip) {
    strip_product(s_g, ldg, w2, d, hdim, n0, buf, acc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[j], kTile, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < kTile * kTile; i += 32) {
        const int r = i / kTile;
        const int c = n0 + j * kTile + i % kTile;
        if (r < n_rows) {
          out[static_cast<size_t>(row0 + r) * d + c] =
              from_float<bf16>(s_x[r * d + c] + (stage[i] + b2[c]));
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int capf_ln_mlp_residual(int dtype, const void* x,
                                    const float* ln_scale,
                                    const float* ln_bias, const void* w1,
                                    const float* b1, const void* w2,
                                    const float* b2, void* out, int rows,
                                    int d, int hdim, float eps, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows < 1 || d < 1 || hdim < 1) return cudaErrorInvalidValue;
  if (dtype == capf::kBFloat16) {
    if (d % kStrip != 0 || hdim % kStrip != 0) return cudaErrorInvalidValue;
    const size_t smem =
        (static_cast<size_t>(kTcRows) * d + kWarps * kTile * kTile) *
            sizeof(float) +
        (static_cast<size_t>(kWarps) * kBufElems +
         static_cast<size_t>(kTcRows) * (d + hdim + 2 * kPad)) *
            sizeof(bf16);
    err = capf::allow_smem(ln_mlp_bf16_kernel, smem);
    if (err != cudaSuccess) return err;
    ln_mlp_bf16_kernel<<<(rows + kTcRows - 1) / kTcRows, kThreads, smem,
                         stream>>>(
        static_cast<const bf16*>(x), ln_scale, ln_bias,
        static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
        static_cast<bf16*>(out), rows, d, hdim, eps);
  } else {
    const size_t smem =
        static_cast<size_t>(kRows) * (2 * d + hdim) * sizeof(float);
    err = capf::allow_smem(ln_mlp_fp32_kernel, smem);
    if (err != cudaSuccess) return err;
    ln_mlp_fp32_kernel<<<(rows + kRows - 1) / kRows, kThreads, smem,
                         stream>>>(
        static_cast<const float*>(x), ln_scale, ln_bias,
        static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2,
        static_cast<float*>(out), rows, d, hdim, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
