// K3: full multi-head self-attention over very short sequences, qkv and
// output projections included.
//
// Replaces contextaware_poseformer_tpu/ops/small_attention.py::_attn_kernel
// (entry small_attention): x (R, N, D) -> qkv = x @ Wqkv + b ->
// softmax(q k^T / sqrt(hd)) v per head -> @ Wproj + b, for the lifter's res
// blocks (N = 5 level tokens, D = 128, 8 heads of 16; 3DHP D = 64, 96). qkv,
// the scores and the softmax stay fp32; the attention output is rounded to
// the call's dtype before the projection, as in the TPU kernel.
//
// What bounds it on the H100: per row the projections are 4*N*D^2 MACs and
// the attention itself only 2*N^2*D; at R = 1088 rows that is 0.71 GFLOP
// against 2.9 MB of rows and weights, a few microseconds either way. What
// costs more is reading the weights (128 KB in bf16 at D = 128) once for
// every few tokens, and idle SMs.
//
// bf16 (the served path), on Hopper's machinery (hopper.cuh): a persistent
// block an SM, two warpgroups. Each block copies Wqkv and Wproj ONCE by
// cp.async into 128-byte-swizzled K-major shared memory (the wrapper,
// ops/small_attention.py, hands them over cast to bf16, transposed, and
// Wqkv's rows permuted into head-group order, once per parameter state),
// the block's first 64-token tile arriving beside them. A tile holds whole
// rows of N tokens (12 rows of 5: 60 tokens, padded to wgmma's M of 64), so
// R = 1088 gives 91 tiles, one wave. Per tile:
// - qkv a head group at a time: the q, k and v columns of kGH heads make
//   one wgmma width (n96 at D = 128 and 64, n72 at D = 96), fp32 sums from
//   bf16 products; the warpgroups take alternate groups, so the whole
//   64 x 3D fp32 qkv is never held at once;
// - the group's qkv (+ bias) goes through a small fp32 exchange tile in
//   shared memory to the middle on CUDA cores, one thread a (token, head):
//   fp32 scores, softmax and AV, o rounded to bf16 into the swizzled A
//   operand of the projection;
// - the next tile's x is requested as soon as the qkv products have read
//   this one, and lands during the projection and the stores;
// - the projection by wgmma, each warpgroup half of D's columns, + bias,
//   staged as bf16 rows and written with 16-byte stores.
//
// fp32 (the lifter served in fp32, parity runs), and bf16 at widths the
// tensor-core body is not built for (the gate's tiny lifter, D = 32): a body
// on the CUDA cores, exact fp32 FMAs, 3D threads a block. Its products are
// register-tiled (f32_tile.cuh): a tile of kCoresBM = 48 tokens (whole rows:
// 9 rows of 5, so that R = 1088 makes 121 tiles, one wave on 132 SMs);
// qkv with 8 row groups x 3D/8 column groups, a thread 6 tokens x 8
// columns; the projection with 12 x D/4, a thread 4 x 4. The weights, fp32
// (their values cast to the call's dtype, made once per parameter state by
// ops/small_attention.py), stream through a ring of 3 slots of 16 K-rows
// by cp.async: Wqkv's slices, then Wproj's, the first of which land during
// the middle. The middle stays one thread a (token, head), 16-byte reads:
// fp32 scores, softmax and AV from the fp32 qkv tile, o rounded to the
// call's dtype.
// Blocks are persistent (min(tiles, SMs x the blocks an SM holds, at most
// 2)); the next tile's x is requested once the qkv products have read this
// one and lands during the middle and the projection. At D = 128 a tile is
// 3.9 M FMAs against 199 KB of shared memory (one block an SM). Needs D a
// multiple of 16 from 32 to 128 (two slices a weight or more: the next
// tile's x lands with the projection's third slice), a head dim that is a
// multiple of 4, N <= 20.

#include "common.cuh"
#include "f32_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace capf::sm90;
using bf16 = __nv_bfloat16;

// ---- CUDA cores ------------------------------------------------------------

using capf::f32::copy_block;
using capf::f32::copy_pieces;
using capf::f32::fma_slice;
using capf::f32::kStages;

constexpr int kMaxTok = 20;       // tokens a row on the CUDA cores
constexpr int kCoresBM = 48;      // tokens a tile (whole rows)
constexpr int kCoresBK = 16;      // K a slice
constexpr int kCoresMaxD = 128;   // 3D threads a block
constexpr int kQkvRG = 8, kQkvTM = kCoresBM / kQkvRG;     // 6 x 8 a thread
constexpr int kProjRG = 12, kProjTM = kCoresBM / kProjRG;  // 4 x 4

// the x, qkv and o tiles and the ring of Wqkv / Wproj slices;
// ops/small_attention.py::cores_smem_bytes mirrors it
__host__ __device__ constexpr int cores_smem(int d) {
  return 4 * (2 * kCoresBM * (d + 4) + kCoresBM * (3 * d + 4) +
              kStages * kCoresBK * 3 * d);
}

// ``rows`` rows of d values of x (token row tok0 on) into the fp32 tile
// (row pitch d + 4), rows from ``valid`` on zero: fp32 by cp.async (the
// caller's group), bf16 by 8-byte loads converted in registers
__device__ __forceinline__ void load_x(float* dst, const float* x,
                                       size_t tok0, int valid, int d,
                                       int tokens) {
  copy_block(dst, d + 4, x, d, static_cast<int>(tok0), 0,
             capf::f32::walk(kCoresBM, d / 4), tokens, d / 4);
  (void)valid;
}
__device__ __forceinline__ void load_x(float* dst, const bf16* x, size_t tok0,
                                       int valid, int d, int tokens) {
  (void)tokens;
  const int pieces = d / 4;
  for (int p = threadIdx.x; p < kCoresBM * pieces; p += blockDim.x) {
    const int r = p / pieces;
    const int c = 4 * (p - r * pieces);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      const uint2 w = *reinterpret_cast<const uint2*>(x + (tok0 + r) * d + c);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w.y));
      v = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    *reinterpret_cast<float4*>(dst + r * (d + 4) + c) = v;
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

template <typename T>
__global__ void __launch_bounds__(3 * kCoresMaxD)
    small_attention_cores_kernel(const T* __restrict__ x,
                                 const float* __restrict__ wqkv,
                                 const float* __restrict__ bqkv,
                                 const float* __restrict__ wproj,
                                 const float* __restrict__ bproj,
                                 T* __restrict__ out, int rows, int n, int d,
                                 int heads) {
  extern __shared__ __align__(16) float smem_f[];
  const int d3 = 3 * d;
  float* s_x = smem_f;                        // (48, d + 4): x
  float* s_qkv = s_x + kCoresBM * (d + 4);    // (48, 3d + 4): qkv + bias
  float* s_o = s_qkv + kCoresBM * (d3 + 4);   // (48, d + 4): o
  float* ring = s_o + kCoresBM * (d + 4);     // kStages slots of 16 x 3d
  const int tid = threadIdx.x;
  const int rows_per_tile = kCoresBM / n;
  const int tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  const int tokens = rows * n;
  const int nq = d / kCoresBK;  // slices of each weight; 2 nq a tile
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  // slice s of the block's stream: for each of its tiles, Wqkv's K-slices
  // (16 x 3d, contiguous), then Wproj's (16 x d)
  auto issue = [&](int s) {
    if (s < my_tiles * 2 * nq) {
      const int k = s % (2 * nq);
      float* slot = ring + (s % kStages) * kCoresBK * d3;
      if (k < nq) {
        copy_pieces(slot, wqkv + static_cast<size_t>(k) * kCoresBK * d3,
                    kCoresBK * d3 / 4);
      } else {
        copy_pieces(slot, wproj + static_cast<size_t>(k - nq) * kCoresBK * d,
                    kCoresBK * d / 4);
      }
    }
    cp_async_commit();
  };
  auto tile_valid = [&](int tile) {
    return min(rows_per_tile, rows - tile * rows_per_tile) * n;
  };
  const int hd = d / heads;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const capf::f32::Place qp = capf::f32::place(kQkvRG, d3 / 8);
  const capf::f32::Place pp = capf::f32::place(kProjRG, d / 4);
  const int qr = qp.tr, qc = qp.tc, pr = pp.tr, pc = pp.tc;

  load_x(s_x, x, static_cast<size_t>(blockIdx.x) * rows_per_tile * n,
         tile_valid(blockIdx.x), d, tokens);
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  int base = 0;  // the stream's first slice of this tile
  for (int tile = blockIdx.x; tile < tiles;
       tile += gridDim.x, base += 2 * nq) {
    const int valid = tile_valid(tile);
    const size_t tok0 = static_cast<size_t>(tile) * rows_per_tile * n;

    // qkv = x Wqkv + bqkv
    float acc[kQkvTM][8];
    capf::f32::zero(acc);
    for (int k = 0; k < nq; ++k) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // (the first: x, with this slice or before it)
      issue(base + k + kStages - 1);
      fma_slice<kQkvTM, 8, kCoresBK>(
          acc, s_x + qr * (d + 4) + k * kCoresBK, kQkvRG * (d + 4),
          ring + ((base + k) % kStages) * kCoresBK * d3 + qc * 4, d3,
          d3 / 2);
    }
#pragma unroll
    for (int i = 0; i < kQkvTM; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = half * (d3 / 2) + qc * 4;
        const float* v = acc[i] + 4 * half;
        *reinterpret_cast<float4*>(s_qkv + (qr + kQkvRG * i) * (d3 + 4) +
                                   c) =
            make_float4(v[0] + bqkv[c], v[1] + bqkv[c + 1],
                        v[2] + bqkv[c + 2], v[3] + bqkv[c + 3]);
      }
    }
    __syncthreads();  // qkv complete; every product has read x
    const int next = tile + gridDim.x;
    if (next < tiles) {  // lands with the next slice issued
      load_x(s_x, x, static_cast<size_t>(next) * rows_per_tile * n,
             tile_valid(next), d, tokens);
    }

    // scores, softmax and AV: one thread a (token, head), the tokens
    // fastest (a quarter warp's 16-byte reads of 8 tokens' rows, pitch =
    // 4 mod 32 values, hit distinct banks); 4 values of the head at a time
    for (int i = tid; i < valid * heads; i += blockDim.x) {
      const int h = i / valid;
      const int t = i - h * valid;
      const int first = (t / n) * n;  // first token of this row
      const float* q = s_qkv + t * (d3 + 4) + h * hd;
      const float* kv = s_qkv + first * (d3 + 4) + d + h * hd;
      // p[] is indexed only in loops unrolled over kMaxTok (guarded by n),
      // so it stays in registers instead of local memory
      float p[kMaxTok];
#pragma unroll
      for (int j = 0; j < kMaxTok; ++j) p[j] = 0.f;
      for (int e = 0; e < hd; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q + e);
#pragma unroll
        for (int j = 0; j < kMaxTok; ++j) {
          if (j < n) {
            const float4 kj =
                *reinterpret_cast<const float4*>(kv + j * (d3 + 4) + e);
            p[j] += qv.x * kj.x + qv.y * kj.y + qv.z * kj.z + qv.w * kj.w;
          }
        }
      }
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxTok; ++j) {
        if (j < n) {
          p[j] *= scale;
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
      for (int e = 0; e < hd; e += 4) {
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < kMaxTok; ++j) {
          if (j < n) {
            const float w = p[j] * inv;
            const float4 vj =
                *reinterpret_cast<const float4*>(kv + j * (d3 + 4) + d + e);
            o.x += w * vj.x;
            o.y += w * vj.y;
            o.z += w * vj.z;
            o.w += w * vj.w;
          }
        }
        *reinterpret_cast<float4*>(s_o + t * (d + 4) + h * hd + e) =
            make_float4(capf::round_to<T>(o.x), capf::round_to<T>(o.y),
                        capf::round_to<T>(o.z), capf::round_to<T>(o.w));
      }
    }

    // out = o Wproj + bproj (rows past ``valid`` compute, unstored)
    float acc2[kProjTM][4];
    capf::f32::zero(acc2);
    for (int k = 0; k < nq; ++k) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // (the first: o complete)
      issue(base + nq + k + kStages - 1);
      fma_slice<kProjTM, 4, kCoresBK>(
          acc2, s_o + pr * (d + 4) + k * kCoresBK, kProjRG * (d + 4),
          ring + ((base + nq + k) % kStages) * kCoresBK * d3 + pc * 4, d, 0);
    }
    const int c = pc * 4;
#pragma unroll
    for (int i = 0; i < kProjTM; ++i) {
      const int r = pr + kProjRG * i;
      if (r >= valid) continue;
      store4(out + (tok0 + r) * d + c, acc2[i][0] + bproj[c],
             acc2[i][1] + bproj[c + 1], acc2[i][2] + bproj[c + 2],
             acc2[i][3] + bproj[c + 3]);
    }
    // the next tile's first barrier keeps its qkv writes behind this
    // tile's middle, and the ring's refills behind these products
  }
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int kWg = 128;                 // threads of a warpgroup
constexpr int kTcThreads = 2 * kWg;      // two warpgroups
constexpr int kBM = 64;                  // tokens of a tile: wgmma's M
constexpr int kChunk = kSwizzleRow;      // bytes of K in a swizzled chunk
constexpr int kATile = kBM * kChunk;     // one 64-row chunk of A: 8 KB
constexpr int kAlign = 1024;
constexpr int kMaxN = 16;                // tokens a row on this route

// The shared memory of the tensor-core route at width D, head dim HD and
// NG = 3 * kGH * HD qkv columns a head group: Wqkv^T (3D rows, permuted)
// and Wproj^T (D rows), swizzled K-major in chunks of 64 values; the x and
// o tiles (A operands, the same layout); one fp32 exchange tile a
// warpgroup (rows padded by 4 values, so that a quarter warp's 16-byte
// reads of 4 tokens x 2 heads hit distinct banks), which the output tile,
// staged as bf16 rows, reuses. ops/small_attention.py::smem_bytes mirrors
// kSmem.
template <int D, int HD, int NG>
struct Tc {
  static constexpr int kGH = NG / (3 * HD);  // heads a group
  static constexpr int kGroups = D / HD / kGH;
  static constexpr int kKc = (D + 63) / 64;  // chunks of K
  static constexpr int kWqkv = kKc * 3 * D * kChunk;
  static constexpr int kWproj = kKc * D * kChunk;
  static constexpr int kTile = kKc * kATile;
  static constexpr int kEPitch = NG + 4;
  static constexpr int kE = kBM * kEPitch * 4;
  static constexpr int kOutPitch = D + 8;  // bf16 values a staged row
  static constexpr int kSmem = kAlign + kWqkv + kWproj + 2 * kTile + 2 * kE;
  static_assert(NG % (3 * HD) == 0 && (D / HD) % kGH == 0 && NG % 8 == 0 &&
                    NG <= 256 && D % 16 == 0 && (D / 2) % 8 == 0 &&
                    HD % 4 == 0,
                "widths the wgmma shapes and the 16-byte reads take");
  static_assert(2 * kE >= kBM * kOutPitch * 2, "the output tile fits");
  static_assert(kSmem <= 232448, "fits one block's shared memory");
};

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + kAlign - 1) & ~uintptr_t(kAlign - 1));
}

// the byte of value k of row r in a swizzled K-major operand of 64-row
// (or ``rows``-row) chunks
__device__ __forceinline__ int sw_byte(int r, int k, int chunk_bytes) {
  return (k / 64) * chunk_bytes + sw128_offset(r, (k % 64) / 8) +
         (k % 8) * 2;
}

// ``rows`` rows of D bf16 values from ``src`` (row-major) into a swizzled
// K-major operand of chunks of ``chunk_rows`` rows; rows from ``valid`` on
// are zero-filled (src-size 0). One 16-byte cp.async a piece.
template <int D>
__device__ __forceinline__ void load_swizzled(unsigned char* dst,
                                              const bf16* src, int rows,
                                              int valid, int chunk_rows) {
  constexpr int kPieces = D / 8;
  for (int i = threadIdx.x; i < rows * kPieces; i += kTcThreads) {
    const int r = i / kPieces;
    const int q = i - r * kPieces;
    const bool in = r < valid;
    cp_async16(dst + (q / 8) * chunk_rows * kChunk + sw128_offset(r, q % 8),
               in ? src + static_cast<size_t>(r) * D + q * 8 : src,
               in ? 16 : 0);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// wgmma's accumulator layout (hopper.cuh): thread t of a warpgroup holds,
// for each 8 columns j, columns 8j + 2(t%4) + {0, 1} of row
// 16(t/32) + (t%32)/4 (acc[4j], acc[4j+1]) and 8 rows further down.
struct AccPos {
  int row, col;
  __device__ __forceinline__ AccPos()
      : row(16 * (threadIdx.x % kWg / 32) + (threadIdx.x % 32) / 4),
        col(2 * (threadIdx.x % 4)) {}
};

template <int D, int HD, int NG>
__global__ void __launch_bounds__(kTcThreads, 1)
    small_attention_tc_kernel(const bf16* __restrict__ x,
                              const bf16* __restrict__ wqkv,
                              const float* __restrict__ bqkv,
                              const bf16* __restrict__ wproj,
                              const float* __restrict__ bproj,
                              bf16* __restrict__ out, int rows, int n) {
  using L = Tc<D, HD, NG>;
  constexpr int kGH = L::kGH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* s_wqkv = align_smem(smem_raw);
  unsigned char* s_wproj = s_wqkv + L::kWqkv;
  unsigned char* s_x = s_wproj + L::kWproj;
  unsigned char* s_o = s_x + L::kTile;
  float* s_e = reinterpret_cast<float*>(s_o + L::kTile);  // two, then out
  bf16* s_out = reinterpret_cast<bf16*>(s_e);

  const int tid = threadIdx.x;
  const int wg = tid / kWg;
  const int wt = tid % kWg;  // thread of the warpgroup
  const int rows_per_tile = kBM / n;
  const int tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const AccPos pos;
  float* e = s_e + wg * kBM * L::kEPitch;

  auto valid_tokens = [&](int tile) {
    return min(rows_per_tile, rows - tile * rows_per_tile) * n;
  };
  auto tile_x = [&](int tile) {
    return x + static_cast<size_t>(tile) * rows_per_tile * n * D;
  };

  // the first tile and Wqkv, then Wproj: two cp.async groups
  int tile = blockIdx.x;
  load_swizzled<D>(s_x, tile_x(tile), kBM, valid_tokens(tile), kBM);
  load_swizzled<D>(s_wqkv, wqkv, 3 * D, 3 * D, 3 * D);
  cp_async_commit();
  load_swizzled<D>(s_wproj, wproj, D, D, D);
  cp_async_commit();

  for (bool first = true; tile < tiles; tile += gridDim.x, first = false) {
    const int valid = valid_tokens(tile);
    if (first) {
      cp_async_wait<1>();  // x and Wqkv; Wproj may still be in flight
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // qkv, the middle and o, a head group at a time
#pragma unroll 1
    for (int g = wg; g < L::kGroups; g += 2) {
      float acc[NG / 2];
      zero(acc);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        wgmma_bf16<NG>(
            acc, sw128_desc(s_x + (ks / 4) * kATile + (ks % 4) * 32),
            sw128_desc(s_wqkv + (ks / 4) * 3 * D * kChunk + g * NG * kChunk +
                       (ks % 4) * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      const float* bias = bqkv + g * NG;
#pragma unroll
      for (int j = 0; j < NG / 8; ++j) {
        const int c = 8 * j + pos.col;
        const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(e + (pos.row + 8 * h) * L::kEPitch +
                                     c) =
              make_float2(acc[4 * j + 2 * h] + b0,
                          acc[4 * j + 2 * h + 1] + b1);
        }
      }
      named_sync(1 + wg, kWg);

      // one thread a (token, head of the group)
      for (int i = wt; i < kBM * kGH; i += kWg) {
        const int t = i / kGH;
        const int hh = i - t * kGH;
        const int col = (g * kGH + hh) * HD;  // o's columns
        if (t >= valid) {
          for (int c = 0; c < HD; c += 2) {
            *reinterpret_cast<__nv_bfloat162*>(
                s_o + sw_byte(t, col + c, kATile)) =
                __floats2bfloat162_rn(0.f, 0.f);
          }
          continue;
        }
        const int first_tok = (t / n) * n;
        float q[HD];
#pragma unroll
        for (int c = 0; c < HD; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              e + t * L::kEPitch + hh * HD + c);
          q[c] = v.x;
          q[c + 1] = v.y;
          q[c + 2] = v.z;
          q[c + 3] = v.w;
        }
        float p[kMaxN];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          if (j < n) {
            const float* kj =
                e + (first_tok + j) * L::kEPitch + (kGH + hh) * HD;
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < HD; c += 4) {
              const float4 v = *reinterpret_cast<const float4*>(kj + c);
              s += q[c] * v.x;
              s += q[c + 1] * v.y;
              s += q[c + 2] * v.z;
              s += q[c + 3] * v.w;
            }
            p[j] = s * scale;
            m = fmaxf(m, p[j]);
          }
        }
        float den = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          if (j < n) {
            p[j] = expf(p[j] - m);
            den += p[j];
          }
        }
        const float inv = 1.f / den;
        float o[HD];
#pragma unroll
        for (int c = 0; c < HD; ++c) o[c] = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          if (j < n) {
            const float w = p[j] * inv;
            const float* vj =
                e + (first_tok + j) * L::kEPitch + (2 * kGH + hh) * HD;
#pragma unroll
            for (int c = 0; c < HD; c += 4) {
              const float4 v = *reinterpret_cast<const float4*>(vj + c);
              o[c] += w * v.x;
              o[c + 1] += w * v.y;
              o[c + 2] += w * v.z;
              o[c + 3] += w * v.w;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < HD; c += 2) {
          *reinterpret_cast<__nv_bfloat162*>(
              s_o + sw_byte(t, col + c, kATile)) =
              __floats2bfloat162_rn(o[c], o[c + 1]);
        }
      }
      named_sync(1 + wg, kWg);  // the exchange tile is refilled next group
    }
    fence_proxy_async();
    __syncthreads();  // o complete; every qkv product has read x

    // the next tile's x lands during the projection and the stores
    const int next = tile + gridDim.x;
    if (next < tiles) {
      load_swizzled<D>(s_x, tile_x(next), kBM, valid_tokens(next), kBM);
    }
    cp_async_commit();
    if (first) {  // Wproj
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
    }

    // the projection, each warpgroup D / 2 output columns
    constexpr int kN = D / 2;
    float acc[kN / 2];
    zero(acc);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_bf16<kN>(acc,
                     sw128_desc(s_o + (ks / 4) * kATile + (ks % 4) * 32),
                     sw128_desc(s_wproj + (ks / 4) * D * kChunk +
                                wg * kN * kChunk + (ks % 4) * 32));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int c = wg * kN + 8 * j + pos.col;
      const float b0 = __ldg(bproj + c), b1 = __ldg(bproj + c + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<__nv_bfloat162*>(
            s_out + (pos.row + 8 * h) * L::kOutPitch + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] + b0,
                                  acc[4 * j + 2 * h + 1] + b1);
      }
    }
    __syncthreads();
    constexpr int kPieces = D / 8;
    bf16* dst = out + static_cast<size_t>(tile) * rows_per_tile * n * D;
    for (int i = tid; i < valid * kPieces; i += kTcThreads) {
      const int r = i / kPieces;
      const int q = i - r * kPieces;
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * D + q * 8) =
          *reinterpret_cast<const uint4*>(s_out + r * L::kOutPitch + q * 8);
    }
    // the next tile's first barrier keeps its exchange writes behind these
    // reads of the staged output
  }
}

template <int D, int HD, int NG>
cudaError_t launch_tc(const void* x, const void* wqkv, const void* bqkv,
                      const void* wproj, const void* bproj, void* out,
                      int rows, int n, int device, cudaStream_t stream) {
  using L = Tc<D, HD, NG>;
  auto kernel = small_attention_tc_kernel<D, HD, NG>;
  static bool opted = false;  // once per instantiation (one device)
  if (!opted) {
    const cudaError_t err = capf::allow_smem(kernel, L::kSmem);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const int rows_per_tile = kBM / n;
  const int tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  const int blocks = tiles < sm_count(device) ? tiles : sm_count(device);
  kernel<<<blocks, kTcThreads, L::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wproj),
      static_cast<const float*>(bproj), static_cast<bf16*>(out), rows, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cores(const void* x, const void* wqkv, const void* bqkv,
                         const void* wproj, const void* bproj, void* out,
                         int rows, int n, int d, int heads, int device,
                         cudaStream_t stream) {
  const int smem = cores_smem(d);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = small_attention_cores_kernel<T>;
  static int opted = 0;  // the largest opted in so far (one device)
  if (smem > opted) {
    const cudaError_t err = capf::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const int rows_per_tile = kCoresBM / n;
  const int tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  const int per_sm = 232448 / smem < 2 ? 1 : 2;
  const int slots = per_sm * sm_count(device);
  kernel<<<tiles < slots ? tiles : slots, 3 * d, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(wproj),
      static_cast<const float*>(bproj), static_cast<T*>(out), rows, n, d,
      heads);
  return cudaGetLastError();
}

}  // namespace

// group > 0 (bf16 on the tensor cores): wqkv is Wqkv^T (3D, D) bf16 with
// its rows in head-group order (``group`` heads a group), bqkv fp32 in the
// same order, wproj Wproj^T (D, D) bf16, bproj fp32
// (ops/small_attention.py::kernel_operands). group 0 (the CUDA cores): the
// weights as the model holds them, (D, 3D) and (D, D), and the biases, in
// fp32 holding their values cast to the call's dtype
// (ops/small_attention.py::cores_operands).
extern "C" int capf_small_attention(int dtype, const void* x, const void* wqkv,
                                    const void* bqkv, const void* wproj,
                                    const void* bproj, void* out, int rows,
                                    int n, int d, int heads, int group,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows < 1 || n < 1 || heads < 1 || d % heads != 0 ||
      (dtype != capf::kFloat32 && dtype != capf::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  if (group == 0) {
    if (n > kMaxTok || d % kCoresBK != 0 || d < 2 * kCoresBK ||
        d > kCoresMaxD || (d / heads) % 4 != 0) {
      return cudaErrorInvalidValue;
    }
    err = dtype == capf::kFloat32
              ? launch_cores<float>(x, wqkv, bqkv, wproj, bproj, out, rows,
                                    n, d, heads, device, stream)
              : launch_cores<bf16>(x, wqkv, bqkv, wproj, bproj, out, rows, n,
                                   d, heads, device, stream);
    return static_cast<int>(err);
  }
  if (dtype != capf::kBFloat16 || n > kMaxN) return cudaErrorInvalidValue;
  const int hd = d / heads;
  // the instantiations ops/small_attention.py::TC_SHAPES lists
  if (d == 128 && hd == 16 && group == 2) {
    err = launch_tc<128, 16, 96>(x, wqkv, bqkv, wproj, bproj, out, rows, n,
                                 device, stream);
  } else if (d == 64 && hd == 8 && group == 4) {
    err = launch_tc<64, 8, 96>(x, wqkv, bqkv, wproj, bproj, out, rows, n,
                               device, stream);
  } else if (d == 96 && hd == 12 && group == 2) {
    err = launch_tc<96, 12, 72>(x, wqkv, bqkv, wproj, bproj, out, rows, n,
                                device, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
