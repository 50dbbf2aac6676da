// K4: softmax-attention middle for the lifter's joint blocks.
//
// Replaces contextaware_poseformer_tpu/ops/joint_attention.py::_kernel (entry
// attention_middle): qkv (B, N, 3D) -> softmax(q k^T / sqrt(hd)) v per head
// -> (B, N, D), with N = 17 joint tokens, D = 640, 8 heads of 80. The qkv and
// output projections stay plain matmuls outside, as in the JAX package.
// Scores and softmax are fp32; the probabilities are rounded to the call's
// dtype before AV, as in the TPU kernel.
//
// What bounds it on the H100: each (image, head) pair reads 3*N*hd values and
// does 2*N^2*hd MACs, a few hundred KB per launch at batch 64, so it is bound
// by launch latency and by how fast one block gets its three tiles in. The
// TPU kernel pads 17 tokens to 24 sublanes and masks the padding; here one
// block per (image, head) stages q, k and v of exactly N tokens in shared
// memory, so there is no padding and no mask.
//
// Grid: (B, heads) blocks of kThreads threads.

#include "common.cuh"

using capf::from_float;
using capf::round_to;
using capf::to_float;

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_middle_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                            int n, int d, int heads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = d / heads;
  float* s_q = reinterpret_cast<float*>(smem_raw);  // (n, hd)
  float* s_k = s_q + n * hd;                        // (n, hd)
  float* s_v = s_k + n * hd;                        // (n, hd)
  float* s_p = s_v + n * hd;                        // (n, n)

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int d3 = 3 * d;
  const T* base = qkv + static_cast<size_t>(b) * n * d3 + h * hd;

  for (int i = tid; i < n * hd; i += kThreads) {
    const int t = i / hd;
    const int e = i - t * hd;
    const T* row = base + static_cast<size_t>(t) * d3 + e;
    s_q[i] = to_float(row[0]);
    s_k[i] = to_float(row[d]);
    s_v[i] = to_float(row[2 * d]);
  }
  __syncthreads();

  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  for (int i = tid; i < n * n; i += kThreads) {
    const int qi = i / n;
    const int kj = i - qi * n;
    const float* q = s_q + qi * hd;
    const float* k = s_k + kj * hd;
    float s = 0.f;
    for (int e = 0; e < hd; ++e) s += q[e] * k[e];
    s_p[i] = s * scale;
  }
  __syncthreads();

  for (int qi = tid; qi < n; qi += kThreads) {
    float* p = s_p + qi * n;
    float m = -INFINITY;
    for (int j = 0; j < n; ++j) m = fmaxf(m, p[j]);
    float den = 0.f;
    for (int j = 0; j < n; ++j) {
      p[j] = expf(p[j] - m);
      den += p[j];
    }
    for (int j = 0; j < n; ++j) p[j] = round_to<T>(p[j] / den);
  }
  __syncthreads();

  T* ob = out + static_cast<size_t>(b) * n * d + h * hd;
  for (int i = tid; i < n * hd; i += kThreads) {
    const int t = i / hd;
    const int e = i - t * hd;
    const float* p = s_p + t * n;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o += p[j] * s_v[j * hd + e];
    ob[static_cast<size_t>(t) * d + e] = from_float<T>(o);
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int batch, int n, int d,
                   int heads, cudaStream_t stream) {
  const int hd = d / heads;
  const size_t smem =
      (static_cast<size_t>(3) * n * hd + static_cast<size_t>(n) * n) *
      sizeof(float);
  cudaError_t err = capf::allow_smem(attention_middle_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  attention_middle_kernel<T><<<dim3(batch, heads), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, d, heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_attention_middle(int dtype, const void* qkv, void* out,
                                     int batch, int n, int d, int heads,
                                     int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch < 1 || n < 1 || heads < 1 || heads > 65535 || d % heads != 0) {
    return cudaErrorInvalidValue;
  }
  if (dtype == capf::kBFloat16) {
    err = launch<__nv_bfloat16>(qkv, out, batch, n, d, heads, stream);
  } else {
    err = launch<float>(qkv, out, batch, n, d, heads, stream);
  }
  return static_cast<int>(err);
}
