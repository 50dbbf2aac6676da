// K9: the int8 HRNet layer1, one fused launch per Bottleneck block.
//
// Replaces contextaware_poseformer_tpu/ops/layer1_chain.py::_kernel (the
// four-block int8 chain of the deploy graph, HRNet._layer1_pallas). Block
// i takes int8 (B, H, W, 256) (block 0: the bf16 stem output (B, H, W, 64),
// quantized here with 127 / in_amax) and writes int8 (B, H, W, 256):
//
//   t1 = quant(relu(affine(conv1x1(x, w1))), t1)          64 channels
//   t2 = quant(relu(affine(conv3x3(t1, w2))), t2)         64 channels
//   y  = affine(conv1x1(t2, w3))                          256 channels
//   res = affine(conv1x1(x, wd)) (block 0) or bf16(x) * bf16(in / 127)
//   out = quant(relu(bf16(y + res)), out)
//
// with quant(v, a) = clip(round(v * (127 / a))) and each affine the folded
// bf16 one of K10 (common.cuh), all with the JAX package's rounding points,
// so the chain equals K10's per-conv chain bit for bit.
//
// What bounds it on the H100: at batch 64 a block reads 50 MB (block 0: 25
// MB of bf16) and writes 50 MB, and does ~27 GOP of int8 products, so HBM
// bounds it (~30 us a block at 3.35 TB/s) as long as the intermediates stay
// on chip. The TPU kernel keeps one image's whole chain
// in VMEM; one image's 256-channel int8 tensor (786 KB at 64x48) does not
// fit in the 227 KB a Hopper block has. So a block owns `rows` output rows
// of one image and keeps in shared memory the rows + 2 input rows the 3x3
// needs, t1 over those rows (recomputed for the halo), t2, and all four
// weight matrices (~70 KB); only x and out touch device memory. The three
// convs run as mma.sync m16n8k32 on 16-pixel tiles, 8 warps; rows of every
// shared operand are padded by 16 bytes so fragment reads are free of bank
// conflicts. Blocks 1-3 stage their output in place over their input rows
// (each element is read as the residual by the thread that then writes it).
//
// The floor build (capf_layer1_block_floor) is the counterpart of the TPU
// probe experiments/layer1_chain_floor.py::_kernel_mm: the same MMAs and bf16
// epilogues, with the requant stages (t1, t2, out) cut to a plain conversion
// and the 3x3's shifted, predicated window reads cut to the centre rows, so
// its numerics are wrong on purpose and its time bounds what the MMAs and
// epilogues cost.

#include "common.cuh"

using capf::affine_bf16;
using capf::folded_scale;
using capf::lds32;
using capf::round_to;
using capf::to_int8_rne;

// the entry point's argument block, passed by pointer from ctypes
extern "C" {
struct Layer1BlockArgs {  // mirrored by ops/layer1_chain.py::_BlockArgs
  const void* x;          // block 0: bf16 (B, H, W, 64); else int8 (.., 256)
  int8_t* out;            // int8 (B, H, W, 256)
  const int8_t* w1;       // (64, cin)
  const int8_t* w2;       // (64, 3 * 3 * 64), K ordered (kh, kw, c)
  const int8_t* w3;       // (256, 64)
  const int8_t* wd;       // (256, 64), block 0 only
  const float *ws1, *sc1, *bi1, *ws2, *sc2, *bi2, *ws3, *sc3, *bi3;
  const float *wsd, *scd, *bid;
  const float *a_in, *a_t1, *a_t2, *a_out;  // calibrated amax scalars
  int batch, h, w, cin, rows;
};
}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanes = 64;
constexpr int kExp = 256;
constexpr int kPad = 16;
constexpr int kTRow = kPlanes + kPad;          // t1, t2, w3, wd rows
constexpr int kW2Row = 9 * kPlanes + kPad;     // w2 rows
constexpr int kOutRow = kExp + kPad;           // staged output rows
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline int tiles16(int n) { return (n + 15) / 16 * 16; }

struct Layout {  // byte offsets into dynamic shared memory
  int m1, m2;    // pixels of the rows + 2 window and of the rows, in tiles
  int in_row;    // bytes a staged input row takes
  size_t in, t1, t2, w1, w2, w3, wd, out, vec, total;
};

// mirrored by ops/layer1_chain.py::smem_bytes
__host__ __device__ inline Layout layer1_layout(int w, int cin, int rows) {
  Layout l;
  l.m1 = tiles16((rows + 2) * w);
  l.m2 = tiles16(rows * w);
  l.in_row = cin + kPad;
  size_t o = 0;
  l.in = o;
  o += static_cast<size_t>(l.m1) * l.in_row;
  l.t1 = o;
  o += static_cast<size_t>(l.m1) * kTRow;
  l.t2 = o;
  o += static_cast<size_t>(l.m2) * kTRow;
  l.w1 = o;
  o += static_cast<size_t>(kPlanes) * l.in_row;
  l.w2 = o;
  o += static_cast<size_t>(kPlanes) * kW2Row;
  l.w3 = o;
  o += static_cast<size_t>(kExp) * kTRow;
  if (cin == kPlanes) {  // block 0: the downsample and its own output rows
    l.wd = o;
    o += static_cast<size_t>(kExp) * kTRow;
    l.out = o;
    o += static_cast<size_t>(l.m2) * kOutRow;
  } else {  // in place over the window's rows 1..rows
    l.wd = 0;
    l.out = l.in + static_cast<size_t>(w) * l.in_row;
  }
  l.vec = o;
  o += sizeof(float) * (4 * kPlanes + 4 * kExp);
  l.total = o;
  return l;
}

// copy `n` rows of `bytes` (a multiple of 16) to shared rows of `stride`
__device__ __forceinline__ void stage_rows(int8_t* dst, int stride,
                                           const int8_t* src, int bytes,
                                           int n) {
  const int chunks = bytes / 16;
  for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 16;
    *reinterpret_cast<int4*>(dst + r * stride + c) =
        *reinterpret_cast<const int4*>(src + static_cast<size_t>(r) * bytes +
                                       c);
  }
}

// 16 bf16 values (two 16-byte loads) -> 16 int8, clip(round(v * scale))
__device__ __forceinline__ int4 quantize16(int4 lo, int4 hi, float scale) {
  const __nv_bfloat16* v0 = reinterpret_cast<const __nv_bfloat16*>(&lo);
  const __nv_bfloat16* v1 = reinterpret_cast<const __nv_bfloat16*>(&hi);
  int4 out;
  int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[i] = to_int8_rne(__fmul_rn(__bfloat162float(v0[i]), scale));
    o[8 + i] = to_int8_rne(__fmul_rn(__bfloat162float(v1[i]), scale));
  }
  return out;
}

// D[8 n-tiles] += A(16 rows at a, row stride as) x B(8 x 8 rows at b, row
// stride bs), over k in [0, kdim)
__device__ __forceinline__ void mma_strip(int (&d)[8][4], const int8_t* a,
                                          int as, const int8_t* b, int bs,
                                          int kdim, int g, int t) {
  for (int k = 0; k < kdim; k += 32) {
    const int8_t* r0 = a + g * as + k + t * 4;
    const uint32_t af[4] = {lds32(r0), lds32(r0 + 8 * as), lds32(r0 + 16),
                            lds32(r0 + 8 * as + 16)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int8_t* col = b + (j * 8 + g) * bs + k + t * 4;
      const uint32_t bf[2] = {lds32(col), lds32(col + 16)};
      capf::mma_s8_16x8x32(d[j], af, bf);
    }
  }
}

__device__ __forceinline__ void zero(int (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0;
}

__device__ __forceinline__ void store2(int8_t* p, int8_t a, int8_t b) {
  char2 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<char2*>(p) = v;
}

// the floor build's stand-in for a requant: a plain conversion
__device__ __forceinline__ int8_t floor_cast(float v) {
  return static_cast<int8_t>(static_cast<int>(v));
}

template <bool kFloor>
__global__ void __launch_bounds__(kThreads, 1)
    layer1_block_kernel(const Layer1BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layer1_layout(a.w, a.cin, a.rows);
  int8_t* s_in = reinterpret_cast<int8_t*>(smem + L.in);
  int8_t* s_t1 = reinterpret_cast<int8_t*>(smem + L.t1);
  int8_t* s_t2 = reinterpret_cast<int8_t*>(smem + L.t2);
  int8_t* s_w1 = reinterpret_cast<int8_t*>(smem + L.w1);
  int8_t* s_w2 = reinterpret_cast<int8_t*>(smem + L.w2);
  int8_t* s_w3 = reinterpret_cast<int8_t*>(smem + L.w3);
  int8_t* s_wd = reinterpret_cast<int8_t*>(smem + L.wd);
  int8_t* s_out = reinterpret_cast<int8_t*>(smem + L.out);
  float* eff1 = reinterpret_cast<float*>(smem + L.vec);
  float* b1 = eff1 + kPlanes;
  float* eff2 = b1 + kPlanes;
  float* b2 = eff2 + kPlanes;
  float* eff3 = b2 + kPlanes;
  float* b3 = eff3 + kExp;
  float* effd = b3 + kExp;
  float* bd = effd + kExp;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int W = a.w, H = a.h, R = a.rows;
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * R;  // first output row
  const bool first = a.cin == kPlanes;
  const int in_row = L.in_row;
  const int window = (R + 2) * W;  // pixels of the input window
  const int owned = R * W;         // pixels of the output rows

  // the scales, in fp32 at the JAX package's rounding points
  const float a_in = fmaxf(*a.a_in, 1e-12f);
  const float a_t1 = fmaxf(*a.a_t1, 1e-12f);
  const float a_t2 = fmaxf(*a.a_t2, 1e-12f);
  const float a_out = fmaxf(*a.a_out, 1e-12f);
  const float step_in = __fmul_rn(a_in, capf::kRecip127);
  const float q_t1 = __fdiv_rn(127.f, a_t1);
  const float q_t2 = __fdiv_rn(127.f, a_t2);
  const float q_out = __fdiv_rn(127.f, a_out);
  for (int i = tid; i < kPlanes; i += kThreads) {
    eff1[i] = folded_scale(a.sc1[i], a.ws1[i], step_in);
    b1[i] = round_to<__nv_bfloat16>(a.bi1[i]);
    eff2[i] = folded_scale(a.sc2[i], a.ws2[i],
                           __fmul_rn(a_t1, capf::kRecip127));
    b2[i] = round_to<__nv_bfloat16>(a.bi2[i]);
  }
  for (int i = tid; i < kExp; i += kThreads) {
    eff3[i] = folded_scale(a.sc3[i], a.ws3[i],
                           __fmul_rn(a_t2, capf::kRecip127));
    b3[i] = round_to<__nv_bfloat16>(a.bi3[i]);
    if (first) {
      effd[i] = folded_scale(a.scd[i], a.wsd[i], step_in);
      bd[i] = round_to<__nv_bfloat16>(a.bid[i]);
    }
  }
  stage_rows(s_w1, in_row, a.w1, a.cin, kPlanes);
  stage_rows(s_w2, kW2Row, a.w2, 9 * kPlanes, kPlanes);
  stage_rows(s_w3, kTRow, a.w3, kPlanes, kExp);
  if (first) stage_rows(s_wd, kTRow, a.wd, kPlanes, kExp);

  // the input window: image rows r0 - 1 .. r0 + R, zero outside the image
  {
    const int chunks = a.cin / 16;
    const float q_in = __fdiv_rn(127.f, a_in);
    for (int i = tid; i < L.m1 * chunks; i += kThreads) {
      const int p = i / chunks;
      const int c = (i - p * chunks) * 16;
      const int wr = p / W;
      const int y = r0 - 1 + wr;
      int4 v = make_int4(0, 0, 0, 0);
      if (p < window && y >= 0 && y < H) {
        const size_t pix =
            (static_cast<size_t>(img) * H + y) * W + (p - wr * W);
        if (first) {
          const int4* src = reinterpret_cast<const int4*>(
              static_cast<const __nv_bfloat16*>(a.x) + pix * kPlanes + c);
          v = quantize16(src[0], src[1], q_in);
        } else {
          v = *reinterpret_cast<const int4*>(
              static_cast<const int8_t*>(a.x) + pix * kExp + c);
        }
      }
      *reinterpret_cast<int4*>(s_in + p * in_row + c) = v;
    }
  }
  __syncthreads();

  // conv1 over the window; t1 rows outside the image are the 3x3's zeros
  for (int u = warp; u < L.m1 / 16; u += kWarps) {
    int acc[8][4];
    zero(acc);
    mma_strip(acc, s_in + u * 16 * in_row, in_row, s_w1, in_row, a.cin, g,
              t);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = u * 16 + g + half * 8;
      const int y = r0 - 1 + p / W;
      const bool inside = p < window && y >= 0 && y < H;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = j * 8 + t * 2;
        int8_t q[2] = {0, 0};
        if (inside) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y1 = fmaxf(
                affine_bf16(acc[j][half * 2 + e], eff1[n + e], b1[n + e]),
                0.f);
            q[e] = kFloor ? floor_cast(y1)
                          : to_int8_rne(__fmul_rn(y1, q_t1));
          }
        }
        store2(s_t1 + p * kTRow + n, q[0], q[1]);
      }
    }
  }
  __syncthreads();

  // conv2 (3x3) over the owned rows: output pixel p = r * W + x reads
  // window pixel p + dy * W + x + dx - 1 for taps (dy, dx) in 3 x 3
  for (int u = warp; u < L.m2 / 16; u += kWarps) {
    int acc[8][4];
    zero(acc);
    const int p0 = u * 16 + g;
    const int p1 = p0 + 8;
    const int x0 = p0 % W;
    const int x1 = p1 % W;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3 - 1;
      const bool ok0 =
          kFloor || (p0 < owned && x0 + dx >= 0 && x0 + dx < W);
      const bool ok1 =
          kFloor || (p1 < owned && x1 + dx >= 0 && x1 + dx < W);
      // the floor reads the centre rows for every tap: no shift, no test
      const int s0 = kFloor ? p0 + W : (ok0 ? p0 + dy * W + dx : 0);
      const int s1 = kFloor ? p1 + W : (ok1 ? p1 + dy * W + dx : 0);
      const int8_t* ra0 = s_t1 + s0 * kTRow + t * 4;
      const int8_t* ra1 = s_t1 + s1 * kTRow + t * 4;
#pragma unroll
      for (int k = 0; k < kPlanes; k += 32) {
        const uint32_t af[4] = {ok0 ? lds32(ra0 + k) : 0u,
                                ok1 ? lds32(ra1 + k) : 0u,
                                ok0 ? lds32(ra0 + k + 16) : 0u,
                                ok1 ? lds32(ra1 + k + 16) : 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int8_t* col =
              s_w2 + (j * 8 + g) * kW2Row + tap * kPlanes + k + t * 4;
          const uint32_t bf[2] = {lds32(col), lds32(col + 16)};
          capf::mma_s8_16x8x32(acc[j], af, bf);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + half * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = j * 8 + t * 2;
        int8_t q[2] = {0, 0};
        if (p < owned) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y2 = fmaxf(
                affine_bf16(acc[j][half * 2 + e], eff2[n + e], b2[n + e]),
                0.f);
            q[e] = kFloor ? floor_cast(y2)
                          : to_int8_rne(__fmul_rn(y2, q_t2));
          }
        }
        store2(s_t2 + p * kTRow + n, q[0], q[1]);
      }
    }
  }
  __syncthreads();

  // conv3 + residual + ReLU + requant, 16 pixels x 64 channels a unit
  const float deq = round_to<__nv_bfloat16>(step_in);
  for (int u = warp; u < (L.m2 / 16) * (kExp / 64); u += kWarps) {
    const int mt = u / (kExp / 64);
    const int nq = (u - mt * (kExp / 64)) * 64;
    float res[8][4];
    if (first) {
      int accd[8][4];
      zero(accd);
      mma_strip(accd, s_in + (W + mt * 16) * in_row, in_row,
                s_wd + nq * kTRow, kTRow, kPlanes, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = nq + j * 8 + t * 2 + (e & 1);
          res[j][e] = affine_bf16(accd[j][e], effd[n], bd[n]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = mt * 16 + g + (e >> 1) * 8;
          const int n = nq + j * 8 + t * 2 + (e & 1);
          const float v =
              p < owned ? static_cast<float>(s_in[(W + p) * in_row + n]) : 0.f;
          res[j][e] = round_to<__nv_bfloat16>(__fmul_rn(v, deq));
        }
    }
    int acc[8][4];
    zero(acc);
    mma_strip(acc, s_t2 + mt * 16 * kTRow, kTRow, s_w3 + nq * kTRow, kTRow,
              kPlanes, g, t);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = mt * 16 + g + half * 8;
      if (p >= owned) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nq + j * 8 + t * 2;
        int8_t q[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = half * 2 + e;
          const float y3 = affine_bf16(acc[j][i], eff3[n + e], b3[n + e]);
          const float o =
              fmaxf(round_to<__nv_bfloat16>(__fadd_rn(y3, res[j][i])), 0.f);
          q[e] = kFloor ? floor_cast(o) : to_int8_rne(__fmul_rn(o, q_out));
        }
        store2(s_out + p * kOutRow + n, q[0], q[1]);
      }
    }
  }
  __syncthreads();

  // the owned rows inside the image, 16 bytes a thread
  const int valid = min(R, H - r0) * W;
  int8_t* dst = a.out + (static_cast<size_t>(img) * H + r0) * W * kExp;
  for (int i = tid; i < valid * (kExp / 16); i += kThreads) {
    const int p = i / (kExp / 16);
    const int c = (i - p * (kExp / 16)) * 16;
    *reinterpret_cast<int4*>(dst + static_cast<size_t>(p) * kExp + c) =
        *reinterpret_cast<const int4*>(s_out + p * kOutRow + c);
  }
}

}  // namespace

namespace {

template <bool kFloor>
int launch_block(const Layer1BlockArgs* args, int device,
                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Layer1BlockArgs& a = *args;
  const bool first = a.cin == kPlanes;
  if (a.batch < 1 || a.batch > 65535 || a.h < 1 || a.rows < 1 ||
      a.w < (kFloor ? 16 : 1) ||
      (a.cin != kPlanes && a.cin != kExp) || first != (a.wd != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Layout L = layer1_layout(a.w, a.cin, a.rows);
  if (L.total > kSmemLimit) return cudaErrorInvalidValue;
  err = capf::allow_smem(layer1_block_kernel<kFloor>, L.total);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.h + a.rows - 1) / a.rows, a.batch);
  layer1_block_kernel<kFloor><<<grid, kThreads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int capf_layer1_block(const Layer1BlockArgs* args, int device,
                                 cudaStream_t stream) {
  return launch_block<false>(args, device, stream);
}

extern "C" int capf_layer1_block_floor(const Layer1BlockArgs* args,
                                       int device, cudaStream_t stream) {
  return launch_block<true>(args, device, stream);
}
