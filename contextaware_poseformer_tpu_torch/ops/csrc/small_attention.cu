// K3: full multi-head self-attention over very short sequences, qkv and
// output projections included.
//
// Replaces contextaware_poseformer_tpu/ops/small_attention.py::_attn_kernel
// (entry small_attention): x (R, N, D) -> qkv = x @ Wqkv + b ->
// softmax(q k^T / sqrt(hd)) v per head -> @ Wproj + b, for the lifter's res
// blocks (N = 5 level tokens, D = 128, 8 heads of 16). qkv, the scores and the
// softmax stay fp32; the attention output is rounded to the call's dtype
// before the projection, as in the TPU kernel.
//
// What bounds it on the H100: per row the projections are 4*N*D^2 MACs and
// the attention itself only 2*N^2*D, so the two small matmuls dominate and
// the row data (N*D values) is tiny. A block stages kMaxTok tokens (whole
// rows) in shared memory, computes their qkv with Wqkv streamed once per
// block from L2, runs one thread per (token, head) for scores, softmax and
// AV, then the projection, so no intermediate touches device memory. This
// first version uses the CUDA cores; tensor cores are later work. In the
// projections every weight meets all kMaxTok tokens, so the tokens are read
// from shared memory 4 channels at a time (one float4 load per 4 FMAs, not
// one load per FMA). Needs D divisible by 4.
//
// Grid: ceil(R / rows_per_block) blocks, rows_per_block = kMaxTok / N.

#include "common.cuh"

using capf::from_float;
using capf::round_to;
using capf::to_float;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTok = 20;  // tokens per block: 4 rows of 5

// acc[t] += sum over k of src[t][k] * w[k][col] for every staged token t:
// src (kMaxTok, d) fp32 in shared memory, w (d, ldw) in device memory.
template <typename T>
__device__ __forceinline__ void tokens_times_column(const float* src, int d,
                                                    const T* w, int ldw,
                                                    int col,
                                                    float (&acc)[kMaxTok]) {
  for (int k = 0; k < d; k += 4) {
    float wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wv[u] = to_float(w[static_cast<size_t>(k + u) * ldw + col]);
    }
#pragma unroll
    for (int t = 0; t < kMaxTok; ++t) {
      const float4 xv = *reinterpret_cast<const float4*>(src + t * d + k);
      acc[t] = fmaf(xv.x, wv[0], acc[t]);
      acc[t] = fmaf(xv.y, wv[1], acc[t]);
      acc[t] = fmaf(xv.z, wv[2], acc[t]);
      acc[t] = fmaf(xv.w, wv[3], acc[t]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    small_attention_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                           const T* __restrict__ bqkv,
                           const T* __restrict__ wproj,
                           const T* __restrict__ bproj, T* __restrict__ out,
                           int rows, int n, int d, int heads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_x = reinterpret_cast<float*>(smem_raw);  // (kMaxTok, d): x, then o
  float* s_qkv = s_x + kMaxTok * d;                 // (kMaxTok, 3d)

  const int tid = threadIdx.x;
  const int d3 = 3 * d;
  const int rows_per_block = kMaxTok / n;
  const int row0 = blockIdx.x * rows_per_block;
  const int n_tok = min(rows_per_block, rows - row0) * n;
  const size_t tok0 = static_cast<size_t>(row0) * n;

  for (int i = tid; i < kMaxTok * d; i += kThreads) {
    s_x[i] = i < n_tok * d ? to_float(x[tok0 * d + i]) : 0.f;
  }
  __syncthreads();

  // qkv projection: one of the 3d columns per thread, every token at once
  for (int j = tid; j < d3; j += kThreads) {
    float acc[kMaxTok];
#pragma unroll
    for (int t = 0; t < kMaxTok; ++t) acc[t] = 0.f;
    tokens_times_column(s_x, d, wqkv, d3, j, acc);
    const float bj = to_float(bqkv[j]);
#pragma unroll
    for (int t = 0; t < kMaxTok; ++t) {
      if (t < n_tok) s_qkv[t * d3 + j] = acc[t] + bj;
    }
  }
  __syncthreads();

  // scores, softmax and AV: one thread per (token, head); o reuses s_x
  const int hd = d / heads;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  for (int i = tid; i < n_tok * heads; i += kThreads) {
    const int t = i / heads;
    const int h = i - t * heads;
    const int first = (t / n) * n;  // first token of this row
    const float* q = s_qkv + t * d3 + h * hd;
    // p[] is indexed only in loops unrolled over kMaxTok (guarded by n), so
    // it stays in registers instead of local memory
    float p[kMaxTok];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxTok; ++j) {
      if (j < n) {
        const float* kj = s_qkv + (first + j) * d3 + d + h * hd;
        float s = 0.f;
        for (int e = 0; e < hd; ++e) s += q[e] * kj[e];
        p[j] = s * scale;
        m = fmaxf(m, p[j]);
      }
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxTok; ++j) {
      if (j < n) {
        p[j] = expf(p[j] - m);
        den += p[j];
      }
    }
    const float inv = 1.f / den;
    for (int e = 0; e < hd; ++e) {
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxTok; ++j) {
        if (j < n) {
          o += (p[j] * inv) * s_qkv[(first + j) * d3 + 2 * d + h * hd + e];
        }
      }
      s_x[t * d + h * hd + e] = round_to<T>(o);
    }
  }
  __syncthreads();

  // output projection: one of the d columns per thread
  for (int i = tid; i < d; i += kThreads) {
    float acc[kMaxTok];
#pragma unroll
    for (int t = 0; t < kMaxTok; ++t) acc[t] = 0.f;
    tokens_times_column(s_x, d, wproj, d, i, acc);
    const float bi = to_float(bproj[i]);
#pragma unroll
    for (int t = 0; t < kMaxTok; ++t) {
      if (t < n_tok) out[(tok0 + t) * d + i] = from_float<T>(acc[t] + bi);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wqkv, const void* bqkv,
                   const void* wproj, const void* bproj, void* out, int rows,
                   int n, int d, int heads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kMaxTok) * 4 * d * sizeof(float);
  cudaError_t err = capf::allow_smem(small_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int rows_per_block = kMaxTok / n;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  small_attention_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wproj),
      static_cast<const T*>(bproj), static_cast<T*>(out), rows, n, d, heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_small_attention(int dtype, const void* x, const void* wqkv,
                                    const void* bqkv, const void* wproj,
                                    const void* bproj, void* out, int rows,
                                    int n, int d, int heads, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows < 1 || n < 1 || n > kMaxTok || heads < 1 || d % heads != 0 ||
      d % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  if (dtype == capf::kBFloat16) {
    err = launch<__nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, out, rows, n, d,
                                heads, stream);
  } else {
    err = launch<float>(x, wqkv, bqkv, wproj, bproj, out, rows, n, d, heads,
                        stream);
  }
  return static_cast<int>(err);
}
