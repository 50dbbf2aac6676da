// The counterpart of the TPU probe experiments/int8_primitives.py
// (kernel_bitcast / kernel_slice): two ways to shift an int8 window by one
// image row before an int8 matmul.
//
// The probe packs a 64x48x32 map as M = 768 rows of 4 pixels x 32 channels
// (12 rows an image row) and builds each row's int8 window of 192 lanes:
// the left neighbour's last 32 channels, the row's 128, the right
// neighbour's first 32 (zero at the image row's ends), quantized as
// clip(round(x * (127 / amax))). It then computes
//     out = xwin @ w + roll(xwin, -12) @ w          (M, 128) int32, exact
// where roll(xwin, -12) is the window one image row down (circular). On the
// TPU the shift is either a roll of the window bitcast to int32 (4 rows a
// sublane word) or a slice of a VMEM scratch copy.
//
// Here a block owns 64 output rows and stages the 76 window rows they read
// (row i and row i + 12), quantized from the fp32 rows, in shared memory,
// with w (128 x 192, k contiguous) beside them; four warps run mma.sync
// m16n8k32 over 16 rows x 128 outputs each. The two ways to the shifted
// operand:
//   kOffset: the window is row-major; the shifted product's A fragments
//            are read 12 rows further on: an address offset.
//   kWords:  the window is stored 4 rows to a 32-bit word, byte j of word
//            (g, k) holding row 4g + j at lane k (the TPU's int32 bitcast
//            layout), so the 12-row shift is a shift by 3 words; an A
//            fragment (4 lanes of one row) is gathered from 4 words by
//            __byte_perm.
// What bounds it: nothing here is large (75 MOP, 0.4 MB at the probe's
// shape); it measures the two shifts, and both must give the same exact
// result.

#include "common.cuh"

using capf::lds32;
using capf::to_int8_rne;

namespace {

constexpr int kM = 768;       // rows: 64 image rows x 12 groups
constexpr int kGroups = 12;   // rows an image row takes (the shift)
constexpr int kIn = 128;      // fp32 lanes a row holds (4 pixels x 32)
constexpr int kK = 192;       // window lanes
constexpr int kN = 128;       // outputs
constexpr int kRows = 64;     // output rows a block owns
constexpr int kStaged = kRows + kGroups;  // window rows a block reads
constexpr int kRow = kK + 16;             // bytes a staged row takes
constexpr int kThreads = 128;

// the window lane k of row r (mod M), quantized
__device__ __forceinline__ int8_t window_lane(const float* xf, int r, int k,
                                              float q) {
  r = (r + kM) % kM;
  const int grp = r % kGroups;
  float v;
  if (k < 32) {
    v = grp == 0 ? 0.f : xf[static_cast<size_t>((r + kM - 1) % kM) * kIn +
                            96 + k];
  } else if (k < 32 + kIn) {
    v = xf[static_cast<size_t>(r) * kIn + k - 32];
  } else {
    v = grp == kGroups - 1
            ? 0.f
            : xf[static_cast<size_t>((r + 1) % kM) * kIn + k - 32 - kIn];
  }
  return to_int8_rne(__fmul_rn(v, q));
}

// lanes k..k+3 of row r from the 4-rows-a-word layout: byte (r % 4) of
// the words (r / 4, k .. k + 3)
__device__ __forceinline__ uint32_t gather4(const uint32_t* words, int r,
                                            int k) {
  const uint32_t* w = words + (r >> 2) * kK + k;
  const uint32_t j = r & 3;
  const uint32_t sel = j | ((j + 4) << 4);  // byte j of a, byte j of b
  const uint32_t lo = __byte_perm(w[0], w[1], sel);
  const uint32_t hi = __byte_perm(w[2], w[3], sel);
  return __byte_perm(lo, hi, 0x5410);
}

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
    window_matmul_kernel(const float* xf, const int8_t* wt, const float* amax,
                         int* out) {
  // the window in one layout or the other (kStaged * kRow bytes >= the
  // words' kStaged * kK)
  __shared__ __align__(16) int8_t s_w[kN * kRow];
  __shared__ __align__(16) int8_t s_win[kStaged * kRow];
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_win);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = blockIdx.x * kRows;
  const float q = __fdiv_rn(127.f, *amax);

  for (int i = tid; i < kN * (kK / 16); i += kThreads) {
    const int n = i / (kK / 16);
    const int c = (i - n * (kK / 16)) * 16;
    *reinterpret_cast<int4*>(s_w + n * kRow + c) =
        *reinterpret_cast<const int4*>(wt + n * kK + c);
  }
  if (kWords) {
    for (int i = tid; i < kStaged / 4 * kK; i += kThreads) {
      const int grp = i / kK;
      const int k = i - grp * kK;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t b = static_cast<uint8_t>(
            window_lane(xf, r0 + 4 * grp + j, k, q));
        word |= static_cast<uint32_t>(b) << (8 * j);
      }
      s_words[i] = word;
    }
  } else {
    for (int i = tid; i < kStaged * kK; i += kThreads) {
      const int r = i / kK;
      const int k = i - r * kK;
      s_win[r * kRow + k] = window_lane(xf, r0 + r, k, q);
    }
  }
  __syncthreads();

  int acc[kN / 8][4] = {};
  const int wr = warp * 16;
#pragma unroll
  for (int shift = 0; shift <= kGroups; shift += kGroups) {
    for (int k = 0; k < kK; k += 32) {
      const int ra = wr + shift + g;
      uint32_t af[4];
      if (kWords) {
        af[0] = gather4(s_words, ra, k + t * 4);
        af[1] = gather4(s_words, ra + 8, k + t * 4);
        af[2] = gather4(s_words, ra, k + 16 + t * 4);
        af[3] = gather4(s_words, ra + 8, k + 16 + t * 4);
      } else {
        const int8_t* p0 = s_win + ra * kRow + k + t * 4;
        af[0] = lds32(p0);
        af[1] = lds32(p0 + 8 * kRow);
        af[2] = lds32(p0 + 16);
        af[3] = lds32(p0 + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int8_t* col = s_w + (j * 8 + g) * kRow + k + t * 4;
        const uint32_t bf[2] = {lds32(col), lds32(col + 16)};
        capf::mma_s8_16x8x32(acc[j], af, bf);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + wr + g + half * 8;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      *reinterpret_cast<int2*>(out + static_cast<size_t>(r) * kN + j * 8 +
                               t * 2) =
          make_int2(acc[j][half * 2], acc[j][half * 2 + 1]);
    }
  }
}

}  // namespace

// xf (768, 128) fp32, wt (128, 192) int8 (w transposed), amax scalar, out
// (768, 128) int32; words: 0 the address offset, 1 the word shift
extern "C" int capf_window_matmul(const float* xf, const int8_t* wt,
                                  const float* amax, int* out, int words,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid(kM / kRows);
  if (words) {
    window_matmul_kernel<true><<<grid, kThreads, 0, stream>>>(xf, wt, amax,
                                                              out);
  } else {
    window_matmul_kernel<false><<<grid, kThreads, 0, stream>>>(xf, wt, amax,
                                                               out);
  }
  return static_cast<int>(cudaGetLastError());
}
