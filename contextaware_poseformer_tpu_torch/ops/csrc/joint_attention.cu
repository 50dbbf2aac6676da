// K4: softmax-attention middle for the lifter's joint blocks.
//
// Replaces contextaware_poseformer_tpu/ops/joint_attention.py::_kernel (entry
// attention_middle): qkv (B, N, 3D) -> softmax(q k^T / sqrt(hd)) v per head
// -> (B, N, D), with N = 17 joint tokens, D = 640, 8 heads of 80 (the 3DHP
// lifters: D = 320 and 480, heads of 40 and 60). The qkv and output
// projections stay plain matmuls outside, as in the JAX package. Scores and
// softmax are fp32; the probabilities are rounded to the call's dtype before
// AV, as in the TPU kernel.
//
// What bounds it on the H100: a call reads 3*N*D values and does 4*N^2*D
// operations (4.2 MB and 47 MFLOP at batch 64), a couple of microseconds of
// HBM, so launch latency and how fast each block gets its rows in decide it.
// Design: one block per (image, head or pair of heads), two warps a head. The
// block loads its heads' q, k and v rows in one coalesced pass of 16-byte
// loads into shared memory, padding the tokens to 32 and the head dim to a
// multiple of 16 with zeros (the 3DHP head dims 40 and 60 become 48 and 64),
// and keeping v transposed (dims x tokens), so that every tensor-core
// fragment is one 32-bit shared load; the row pitches are padded by 16 bytes
// so that those loads are free of bank conflicts. In bf16 the scores and AV
// run on mma.sync m16n8k16 (fp32 accumulation; wgmma's 64-row tile does not
// fit 17 tokens), each warp taking 16 query rows of its head. The softmax
// runs a warp per row, a lane per key, with shuffles, two rows a warp at a
// time over every warp of the block; padded keys are masked to -inf. The
// fp32 route (training, TF32 off) keeps exact fp32 FMAs on the CUDA cores
// with the same blocks, loads and softmax, reading its rows as float4 from
// 16-byte-aligned pitches (four partial sums a dot product).
//
// Grid: (B, heads / hb) blocks of 64 * hb threads.

#include "common.cuh"

namespace {

constexpr int kMaxTokens = 32;    // tokens a block pads to: two m16 tiles
constexpr int kMaxHeadDim = 128;  // head dims the bf16 layout takes
constexpr int kRow = kMaxTokens + 8;  // pitch of a token-indexed row
constexpr int kBatch = 8;  // 16-byte loads a thread keeps in flight

// Two rows of scores (fp32), one warp, a lane per key: the softmax over
// the first ``n`` keys, rounded to T, into ``p0`` and ``p1`` (their padded
// keys 0). The two rows' reductions interleave, which halves the chain of
// shuffles a warp waits on; ``two`` false leaves the second row alone. A
// lane reads only its own score before it writes, so ``p`` may be ``s``.
template <typename T>
__device__ __forceinline__ void softmax_rows(const float* s0, T* p0,
                                             const float* s1, T* p1,
                                             bool two, int n, int lane) {
  const bool in0 = lane < n;
  const bool in1 = two && lane < n;
  const float v0 = in0 ? s0[lane] : -INFINITY;
  const float v1 = in1 ? s1[lane] : -INFINITY;
  float m0 = v0, m1 = v1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  const float e0 = in0 ? expf(v0 - m0) : 0.f;
  const float e1 = in1 ? expf(v1 - m1) : 0.f;
  float d0 = e0, d1 = e1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
  }
  p0[lane] = capf::from_float<T>(e0 / d0);
  if (two) p1[lane] = capf::from_float<T>(e1 / d1);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The bf16 route. Per head of the block, in shared memory: Q and K (32 x
// hdp, pitch hdp + 8), V transposed (hdp x 32, pitch 40), the fp32 scores
// and the bf16 probabilities (32 x 32, pitch 40).
__global__ void __launch_bounds__(1024)
    attention_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                          __nv_bfloat16* __restrict__ out, int n, int d,
                          int heads, int hb) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = d / heads;
  const int hdp = (hd + 15) & ~15;
  const int qp = hdp + 8;
  const int head_bytes = (2 * kMaxTokens * qp + hdp * kRow +
                          kMaxTokens * kRow) * 2 + kMaxTokens * kRow * 4;
  auto sq = [&](int h) {
    return reinterpret_cast<bf16*>(smem + h * head_bytes);
  };
  auto sk = [&](int h) { return sq(h) + kMaxTokens * qp; };
  auto sv = [&](int h) { return sk(h) + kMaxTokens * qp; };  // transposed
  auto sp = [&](int h) { return sv(h) + hdp * kRow; };
  auto ss = [&](int h) {
    return reinterpret_cast<float*>(sp(h) + kMaxTokens * kRow);
  };

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * hb;  // first head of the block
  const int tid = threadIdx.x;
  const int threads = blockDim.x;

  // zeros for the padding, then q, k and v in 16-byte pieces
  uint4* all = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < hb * head_bytes / 16; i += threads) {
    all[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const int seg = hb * hd;  // values of q (k, v) a token has in the block
  const int vecs = seg / 8;
  const bf16* base = qkv + static_cast<size_t>(b) * n * 3 * d + h0 * hd;
  const int total = n * 3 * vecs;
  for (int i0 = tid; i0 < total; i0 += threads * kBatch) {
    uint4 vals[kBatch];  // kBatch loads in flight before any is stored
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * threads;
      if (i < total) {
        const int t = i / (3 * vecs);
        const int r = i - t * 3 * vecs;
        vals[u] = *reinterpret_cast<const uint4*>(
            base + static_cast<size_t>(t) * 3 * d + r / vecs * d +
            (r % vecs) * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * threads;
      if (i >= total) break;
      const int t = i / (3 * vecs);
      const int r = i - t * 3 * vecs;
      const int which = r / vecs;  // q, k, v
      const int e0 = (r - which * vecs) * 8;
      const uint32_t words[4] = {vals[u].x, vals[u].y, vals[u].z, vals[u].w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {  // a pair never straddles heads: hd even
        const int e = e0 + 2 * w;
        const int h = e / hd;
        const int c = e - h * hd;
        if (which < 2) {
          bf16* row = (which == 0 ? sq(h) : sk(h)) + t * qp;
          *reinterpret_cast<uint32_t*>(row + c) = words[w];
        } else {
          sv(h)[c * kRow + t] =
              __ushort_as_bfloat16(static_cast<unsigned short>(words[w]));
          sv(h)[(c + 1) * kRow + t] = __ushort_as_bfloat16(
              static_cast<unsigned short>(words[w] >> 16));
        }
      }
    }
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = warp / 2;
  const int m0 = (warp % 2) * 16;  // this warp's query rows
  const int g = lane / 4;
  const int tq = lane % 4;

  // scores: rows m0.. of Q against all 32 keys, 4 n-tiles of 8
  {
    float acc[4][4] = {};
    const bf16* q = sq(h) + m0 * qp;
    const bf16* k = sk(h);
    for (int ks = 0; ks < hdp; ks += 16) {
      const uint32_t a[4] = {lds32(q + g * qp + ks + 2 * tq),
                             lds32(q + (g + 8) * qp + ks + 2 * tq),
                             lds32(q + g * qp + ks + 8 + 2 * tq),
                             lds32(q + (g + 8) * qp + ks + 8 + 2 * tq)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* kr = k + (8 * nt + g) * qp + ks + 2 * tq;
        const uint32_t bb[2] = {lds32(kr), lds32(kr + 8)};
        capf::mma_bf16_16x8x16(acc[nt], a, bb);
      }
    }
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    float* s = ss(h);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(s + (m0 + g) * kRow + col) =
          make_float2(acc[nt][0] * scale, acc[nt][1] * scale);
      *reinterpret_cast<float2*>(s + (m0 + g + 8) * kRow + col) =
          make_float2(acc[nt][2] * scale, acc[nt][3] * scale);
    }
  }
  __syncthreads();

  // the softmax of the heads' real rows, two a warp at a time over every
  // warp of the block (the padded rows' probabilities stay zero)
  for (int row = 2 * warp; row < hb * n; row += 2 * (threads / 32)) {
    const int ha = row / n, ra = row - ha * n;
    const bool two = row + 1 < hb * n;
    const int hb2 = (row + 1) / n, rb = row + 1 - hb2 * n;
    softmax_rows<bf16>(ss(ha) + ra * kRow, sp(ha) + ra * kRow,
                       ss(hb2) + rb * kRow, sp(hb2) + rb * kRow, two, n,
                       lane);
  }
  __syncthreads();

  // out = P V: the warp's 16 rows, the head dim in n-tiles of 8
  {
    const bf16* p = sp(h) + m0 * kRow;
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int c = 16 * ks + 2 * tq;
      a[ks][0] = lds32(p + g * kRow + c);
      a[ks][1] = lds32(p + (g + 8) * kRow + c);
      a[ks][2] = lds32(p + g * kRow + c + 8);
      a[ks][3] = lds32(p + (g + 8) * kRow + c + 8);
    }
    const bf16* vt = sv(h);
    bf16* ob = out + static_cast<size_t>(b) * n * d + (h0 + h) * hd;
    for (int nt = 0; nt < hdp / 8; ++nt) {
      float o[4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const bf16* vr = vt + (8 * nt + g) * kRow + 16 * ks + 2 * tq;
        const uint32_t bb[2] = {lds32(vr), lds32(vr + 8)};
        capf::mma_bf16_16x8x16(o, a[ks], bb);
      }
      const int c = 8 * nt + 2 * tq;
      if (c >= hd) continue;  // the padded dims (c + 1 < hd too: hd even)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        if (r < n) {
          *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(r) * d +
                                             c) =
              __floats2bfloat162_rn(o[2 * half], o[2 * half + 1]);
        }
      }
    }
  }
}

// The fp32 route: per head, Q and K (n x hd4 + 4, hd4 = hd rounded up to
// 4: float4 rows, whose quarter-warp reads fall on distinct banks), V
// (n x hd4), the scores and then the probabilities in place (n x 33); the
// padded columns zero.
__global__ void __launch_bounds__(1024)
    attention_fp32_kernel(const float* __restrict__ qkv,
                          float* __restrict__ out, int n, int d, int heads,
                          int hb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = d / heads;
  const int hd4 = (hd + 3) & ~3;
  const int qp = hd4 + 4;
  // a head's floats, rounded to 4 so that every head's rows stay 16-byte
  // aligned
  const int head_floats =
      (2 * n * qp + n * hd4 + n * (kMaxTokens + 1) + 3) & ~3;
  float* sf = reinterpret_cast<float*>(smem);
  auto sq = [&](int h) { return sf + h * head_floats; };
  auto sk = [&](int h) { return sq(h) + n * qp; };
  auto sv = [&](int h) { return sk(h) + n * qp; };
  auto ss = [&](int h) { return sv(h) + n * hd4; };

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * hb;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  for (int i = tid; i < hb * head_floats; i += threads) sf[i] = 0.f;
  __syncthreads();
  const int seg = hb * hd;
  const int vecs = seg / 4;
  const float* base = qkv + static_cast<size_t>(b) * n * 3 * d + h0 * hd;
  const int total = n * 3 * vecs;
  for (int i0 = tid; i0 < total; i0 += threads * kBatch) {
    float4 vals[kBatch];  // kBatch loads in flight before any is stored
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * threads;
      if (i < total) {
        const int t = i / (3 * vecs);
        const int r = i - t * 3 * vecs;
        vals[u] = *reinterpret_cast<const float4*>(
            base + static_cast<size_t>(t) * 3 * d + r / vecs * d +
            (r % vecs) * 4);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * threads;
      if (i >= total) break;
      const int t = i / (3 * vecs);
      const int r = i - t * 3 * vecs;
      const int which = r / vecs;
      const int e0 = (r - which * vecs) * 4;
      const float v4[4] = {vals[u].x, vals[u].y, vals[u].z, vals[u].w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int e = e0 + w;
        const int h = e / hd;
        const int c = e - h * hd;
        if (which == 0) {
          sq(h)[t * qp + c] = v4[w];
        } else if (which == 1) {
          sk(h)[t * qp + c] = v4[w];
        } else {
          sv(h)[t * hd4 + c] = v4[w];
        }
      }
    }
  }
  __syncthreads();

  // scores: a thread per (head, query, key), the dot product in float4
  // steps (four partial sums of exact fp32 FMAs)
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  for (int i = tid; i < hb * n * n; i += threads) {
    const int h = i / (n * n);
    const int r = (i - h * n * n) / n;
    const int j = i - h * n * n - r * n;
    const float4* q = reinterpret_cast<const float4*>(sq(h) + r * qp);
    const float4* k = reinterpret_cast<const float4*>(sk(h) + j * qp);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = 0; e < hd4 / 4; ++e) {
      const float4 a = q[e], c = k[e];
      acc.x += a.x * c.x;
      acc.y += a.y * c.y;
      acc.z += a.z * c.z;
      acc.w += a.w * c.w;
    }
    ss(h)[r * (kMaxTokens + 1) + j] =
        ((acc.x + acc.y) + (acc.z + acc.w)) * scale;
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int row = 2 * warp; row < hb * n; row += 2 * (threads / 32)) {
    // probabilities in place of the scores, two rows a warp at a time
    const int ha = row / n;
    const int hb2 = (row + 1) / n;
    float* s0 = ss(ha) + (row - ha * n) * (kMaxTokens + 1);
    float* s1 = ss(hb2) + (row + 1 - hb2 * n) * (kMaxTokens + 1);
    softmax_rows<float>(s0, s0, s1, s1, row + 1 < hb * n, n, lane);
  }
  __syncthreads();

  // out = P V: a thread per (head, query, 4 dims)
  float* ob = out + static_cast<size_t>(b) * n * d + h0 * hd;
  const int quads = hd4 / 4;
  for (int i = tid; i < hb * n * quads; i += threads) {
    const int h = i / (n * quads);
    const int r = (i - h * n * quads) / quads;
    const int e = (i - h * n * quads - r * quads) * 4;
    const float* p = ss(h) + r * (kMaxTokens + 1);
    const float* v = sv(h) + e;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < n; ++j) {
      const float pj = p[j];
      const float4 vj = *reinterpret_cast<const float4*>(v + j * hd4);
      o.x += pj * vj.x;
      o.y += pj * vj.y;
      o.z += pj * vj.z;
      o.w += pj * vj.w;
    }
    float* dst = ob + static_cast<size_t>(r) * d + h * hd + e;
    const float os[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (e + w < hd) dst[w] = os[w];
    }
  }
}

}  // namespace

// hb: the heads a block takes (ops/joint_attention.py::heads_per_block),
// whose values of a token fill whole 16-byte pieces
extern "C" int capf_attention_middle(int dtype, const void* qkv, void* out,
                                     int batch, int n, int d, int heads,
                                     int hb, int device,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch < 1 || n < 1 || n > kMaxTokens || heads < 1 || d % heads ||
      d % 8 || (d / heads) % 2 || hb < 1 || heads % hb ||
      (hb * (d / heads)) % 8 || 64 * hb > 1024 || heads / hb > 65535) {
    return cudaErrorInvalidValue;
  }
  const int hd = d / heads;
  const dim3 grid(batch, heads / hb);
  const int threads = 64 * hb;
  size_t smem;
  if (dtype == capf::kBFloat16) {
    if (hd > kMaxHeadDim) return cudaErrorInvalidValue;
    const int hdp = (hd + 15) & ~15;
    smem = static_cast<size_t>(hb) *
           ((2 * kMaxTokens * (hdp + 8) + hdp * kRow + kMaxTokens * kRow) *
                2 +
            kMaxTokens * kRow * 4);
    err = capf::allow_smem(attention_bf16_kernel, smem);
    if (err != cudaSuccess) return err;
    attention_bf16_kernel<<<grid, threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv),
        static_cast<__nv_bfloat16*>(out), n, d, heads, hb);
  } else {
    const int hd4 = (hd + 3) & ~3;
    smem = static_cast<size_t>(hb) *
           ((2 * n * (hd4 + 4) + n * hd4 + n * (kMaxTokens + 1) + 3) & ~3) *
           4;
    err = capf::allow_smem(attention_fp32_kernel, smem);
    if (err != cudaSuccess) return err;
    attention_fp32_kernel<<<grid, threads, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), n, d,
        heads, hb);
  }
  return static_cast<int>(cudaGetLastError());
}
