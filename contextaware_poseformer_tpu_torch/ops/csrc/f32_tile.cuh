// fp32 register-tiled products on the CUDA cores, shared by K2's fp32
// routes (fused_mlp.cu) and K3's CUDA-core body (small_attention.cu).
//
// A block computes an output tile C (BM rows x N columns) = A (BM x K) B
// (K x N) with exact fp32 FMAs. Its threads form RG row groups x CG column
// groups (``place``): thread (tr, tc) owns rows tr + RG * i (i < TM) and
// the columns tc * 4 + {0..3}, plus, with TN = 8, the same four N / 2
// further on. A is row-major in shared
// memory (row pitch P = K-width + 4 floats, so that P = 4 mod 32 and the
// rows a warp reads at one k fall in distinct banks) and is read 4 values
// of k at a time (one 16-byte load a row); B is row-major (k, n) and is
// read as 16-byte pieces of a row. Per 4 values of k a thread issues TM +
// TN 16-byte shared loads for 4 * TM * TN FMAs.
//
// B (a weight) arrives in K-slices through a ring of kStages slots filled
// by 16-byte cp.asyncs: every thread commits one cp.async group per slice
// (an empty one past the end), so that ``cp_async_wait<kStages - 2>``
// before slice s means slice s has landed.
#pragma once

#include "hopper.cuh"

namespace capf {
namespace f32 {

constexpr int kStages = 3;  // slots of a slice ring

// A thread's row group and column group in an RG x CG thread tile. Where
// RG is a multiple of 4 and CG of 8, a warp covers 4 row groups x 8 column
// groups, so that each 16-byte shared load of A serves 8 lanes and each of
// B 4 (a quarter of the bytes a warp of 32 distinct pieces moves); else
// the column group runs fastest in the thread index.
struct Place {
  int tr, tc;
};
__device__ __forceinline__ Place place(int rg, int cg) {
  const int t = threadIdx.x;
  if (rg % 4 == 0 && cg % 8 == 0) {
    const int w = t / 32, lane = t % 32, wr = rg / 4;
    return {(w % wr) * 4 + lane / 8, (w / wr) * 8 + lane % 8};
  }
  return {t / cg, t % cg};
}

// acc[i][j] += sum over KS values of k of A[row i][k] * B[k][col j]: ``a``
// points at A[tr][k0] (row i at a + i * a_step), ``b`` at B[k0][tc * 4]
// (row pitch ldb; the second four columns ``half`` further on). ptxas
// schedules the unrolled slice's loads itself: requesting the next
// fragments a step ahead by hand took the same registers and time.
template <int TM, int TN, int KS>
__device__ __forceinline__ void fma_slice(float (&acc)[TM][TN],
                                          const float* a, int a_step,
                                          const float* b, int ldb,
                                          int half) {
  static_assert(TN == 4 || TN == 8, "four or eight columns a thread");
  static_assert(KS % 4 == 0, "k in steps of 4");
#pragma unroll
  for (int k = 0; k < KS; k += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + i * a_step + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* br = b + (k + kk) * ldb;
      float bv[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(br);
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 = *reinterpret_cast<const float4*>(br + half);
        bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ai = kk == 0   ? av[i].x
                         : kk == 1 ? av[i].y
                         : kk == 2 ? av[i].z
                                   : av[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
      }
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
}

// ``pieces`` 16-byte pieces, contiguous in device memory, into shared
// memory by cp.async, the block's threads on consecutive pieces
__device__ __forceinline__ void copy_pieces(float* dst, const float* src,
                                            int pieces) {
  for (int p = threadIdx.x; p < pieces; p += blockDim.x) {
    sm90::cp_async16(dst + 4 * p, src + 4 * p, 16);
  }
}

// A thread's walk over the 16-byte pieces of a block of ``rows`` rows x
// ``cols4`` pieces, the block's threads on consecutive pieces: its first
// piece and the step to its next, so that a copy divides once a kernel,
// not once a piece.
struct Walk {
  int r, c, dr, dc, cols4, rows;
};
__device__ __forceinline__ Walk walk(int rows, int cols4) {
  const int t = threadIdx.x, n = blockDim.x;
  return {t / cols4, t % cols4, n / cols4, n % cols4, cols4, rows};
}

// The block (``w``'s rows x pieces) at (r0, c0) of a row-major matrix
// ``base`` (row pitch ``ld`` floats) into shared memory (row pitch
// ``pitch``); rows from ``nrows`` on and pieces from ``ncols4`` on (of the
// matrix) are zero-filled by cp.async's src-size 0, which reads nothing
// (``base`` stands in as the address)
__device__ __forceinline__ void copy_block(float* dst, int pitch,
                                           const float* base, size_t ld,
                                           int r0, int c0, Walk w,
                                           int nrows, int ncols4) {
  int r = w.r, c = w.c;
  while (r < w.rows) {
    const bool in = r0 + r < nrows && c0 / 4 + c < ncols4;
    sm90::cp_async16(dst + r * pitch + 4 * c,
                     in ? base + (r0 + r) * ld + c0 + 4 * c : base,
                     in ? 16 : 0);
    r += w.dr;
    c += w.dc;
    if (c >= w.cols4) {
      c -= w.cols4;
      ++r;
    }
  }
}

}  // namespace f32
}  // namespace capf
