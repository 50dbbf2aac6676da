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
// Here a block owns a tile of 16 output rows x 64 outputs (a grid of 48 x
// 2 = 96 blocks on the 132 SMs) and stages the 28 window rows its rows read
// (row i and row i + 12) in shared memory, quantized from the fp32 rows,
// beside its 64 columns of w (192 x 64, staged by cp.async before anything
// else, so that they are in flight while the window is built). A thread
// builds 4 x 4 blocks of the window (4 rows x 4 lanes: 4 float4 loads, 16
// quantizes, 4 packed 32-bit words). Each of the four warps then gathers the
// B fragments of its 16 columns once (w is row-major (k, n): 4 bytes of
// column n from 4 rows) and runs mma.sync m16n8k32 s8 over its 16 rows x
// 16 outputs for both terms. The two ways to the shifted operand differ
// only in the window's layout and the A fragments' reads:
//   kOffset: the window is row-major; the shifted product's A fragments
//            are read 12 rows further on: an address offset.
//   kWords:  the window is stored 4 rows to a 32-bit word, byte j of word
//            (g, k) holding row 4g + j at lane k (the TPU's int32 bitcast
//            layout; a 4 x 4 block's row words transposed by __byte_perm),
//            so the 12-row shift is a shift by 3 words; an A fragment (4
//            lanes of one row) is unpacked from one 16-byte load of 4 words
//            by __byte_perm.
// What bounds it: nothing here is large (75 MOP, 0.4 MB at the probe's
// shape); it is a chain of latencies (the loads, the quantize, one
// barrier, 24 dependent mma.sync a warp, the stores), so the design keeps
// the chain short and the card's SMs busy. Both forms must give the same
// exact result.

#include "common.cuh"
#include "hopper.cuh"

using capf::lds32;
using capf::to_int8_rne;

namespace {

constexpr int kM = 768;       // rows: 64 image rows x 12 groups
constexpr int kGroups = 12;   // rows an image row takes (the shift)
constexpr int kIn = 128;      // fp32 lanes a row holds (4 pixels x 32)
constexpr int kK = 192;       // window lanes
constexpr int kN = 128;       // outputs
constexpr int kRows = 16;     // output rows a block owns
constexpr int kCols = 64;     // outputs a block owns
constexpr int kStaged = kRows + kGroups;  // window rows a block reads
constexpr int kRow = kK + 16;             // bytes a staged row takes
constexpr int kWordPitch = kK + 16;       // words a staged group of 4 rows
constexpr int kWPitch = kCols + 16;       // bytes a staged row of w
constexpr int kThreads = 128;
constexpr int kBlocks4 = kStaged / 4 * (kK / 4);  // 4 x 4 window blocks
static_assert(kStaged * kRow == kStaged / 4 * kWordPitch * 4,
              "both layouts take the same bytes");

// the fp32 sources of lanes 4 kc .. 4 kc + 3 of window row r (0 <= r <
// M): one 16-byte load, or zeros at the ends of an image row
__device__ __forceinline__ float4 window_src(const float* xf, int r, int kc) {
  const int grp = r % kGroups;
  const float* src;
  if (kc < 8) {  // the left neighbour's last 32 channels
    if (grp == 0) return make_float4(0.f, 0.f, 0.f, 0.f);
    src = xf + static_cast<size_t>(r - 1) * kIn + 96 + 4 * kc;
  } else if (kc < 40) {
    src = xf + static_cast<size_t>(r) * kIn + 4 * kc - 32;
  } else {  // the right neighbour's first 32 channels
    if (grp == kGroups - 1) return make_float4(0.f, 0.f, 0.f, 0.f);
    src = xf + static_cast<size_t>(r + 1) * kIn + 4 * kc - 32 - kIn;
  }
  return *reinterpret_cast<const float4*>(src);
}

// four lanes quantized, packed into a word (the first in the low byte)
__device__ __forceinline__ uint32_t quantize4(float4 v, float q) {
  const float e[4] = {v.x, v.y, v.z, v.w};
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    word |= static_cast<uint32_t>(static_cast<uint8_t>(
                to_int8_rne(__fmul_rn(e[j], q))))
            << (8 * j);
  }
  return word;
}

// lanes k..k+3 of row r from the 4-rows-a-word layout: byte (r % 4) of
// the words (r / 4, k .. k + 3), one 16-byte load
__device__ __forceinline__ uint32_t gather4(const uint32_t* words, int r,
                                            int k) {
  const uint4 w = *reinterpret_cast<const uint4*>(
      words + (r >> 2) * kWordPitch + k);
  const uint32_t j = r & 3;
  const uint32_t sel = j | ((j + 4) << 4);  // byte j of a, byte j of b
  const uint32_t lo = __byte_perm(w.x, w.y, sel);
  const uint32_t hi = __byte_perm(w.z, w.w, sel);
  return __byte_perm(lo, hi, 0x5410);
}

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
    window_matmul_kernel(const float* xf, const int8_t* w, const float* amax,
                         int* out) {
  __shared__ __align__(16) int8_t s_w[kK * kWPitch];
  // the window in one layout or the other
  __shared__ __align__(16) int8_t s_win[kStaged * kRow];
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_win);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols;

  // w's 64 columns, in flight while the window is built
  for (int i = tid; i < kK * (kCols / 16); i += kThreads) {
    const int k = i / (kCols / 16), c = i % (kCols / 16);
    capf::sm90::cp_async16(s_w + k * kWPitch + 16 * c,
                           w + k * kN + n0 + 16 * c, 16);
  }
  capf::sm90::cp_async_commit();
  const float q = __fdiv_rn(127.f, *amax);

  // the window: 4 x 4 blocks (rows 4 gb .. 4 gb + 3, lanes 4 kc .. + 3),
  // every block's loads issued before any is quantized
  constexpr int kIters = (kBlocks4 + kThreads - 1) / kThreads;
  float4 v[kIters][4];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int b = tid + it * kThreads;
    if (b < kBlocks4) {
      const int gb = b / (kK / 4), kc = b % (kK / 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int r = r0 + 4 * gb + j;
        if (r >= kM) r -= kM;
        v[it][j] = window_src(xf, r, kc);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int b = tid + it * kThreads;
    if (b < kBlocks4) {
      const int gb = b / (kK / 4), kc = b % (kK / 4);
      uint32_t row[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) row[j] = quantize4(v[it][j], q);
      if (kWords) {  // transpose: word e holds lane 4 kc + e of the 4 rows
        const uint32_t t0 = __byte_perm(row[0], row[1], 0x5140);
        const uint32_t t1 = __byte_perm(row[0], row[1], 0x7362);
        const uint32_t t2 = __byte_perm(row[2], row[3], 0x5140);
        const uint32_t t3 = __byte_perm(row[2], row[3], 0x7362);
        *reinterpret_cast<uint4*>(s_words + gb * kWordPitch + 4 * kc) =
            make_uint4(__byte_perm(t0, t2, 0x5410),
                       __byte_perm(t0, t2, 0x7632),
                       __byte_perm(t1, t3, 0x5410),
                       __byte_perm(t1, t3, 0x7632));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<uint32_t*>(s_win + (4 * gb + j) * kRow +
                                       4 * kc) = row[j];
        }
      }
    }
  }
  capf::sm90::cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 columns: B fragments of the 6 k-steps, 4 bytes of
  // column n from rows k .. k + 3 (k = 4 t, and 16 further on)
  const int nw = 16 * warp;
  uint32_t bf[kK / 32][2][2];
#pragma unroll
  for (int ks = 0; ks < kK / 32; ++ks) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* col = reinterpret_cast<const uint8_t*>(s_w) +
                             (32 * ks + 16 * h + 4 * t) * kWPitch + nw +
                             8 * j + g;
        bf[ks][j][h] = static_cast<uint32_t>(col[0]) |
                       static_cast<uint32_t>(col[kWPitch]) << 8 |
                       static_cast<uint32_t>(col[2 * kWPitch]) << 16 |
                       static_cast<uint32_t>(col[3 * kWPitch]) << 24;
      }
    }
  }

  int acc[2][4] = {};
#pragma unroll
  for (int shift = 0; shift <= kGroups; shift += kGroups) {
#pragma unroll
    for (int ks = 0; ks < kK / 32; ++ks) {
      const int ra = shift + g, k = 32 * ks + 4 * t;
      uint32_t af[4];
      if (kWords) {
        af[0] = gather4(s_words, ra, k);
        af[1] = gather4(s_words, ra + 8, k);
        af[2] = gather4(s_words, ra, k + 16);
        af[3] = gather4(s_words, ra + 8, k + 16);
      } else {
        const int8_t* p0 = s_win + ra * kRow + k;
        af[0] = lds32(p0);
        af[1] = lds32(p0 + 8 * kRow);
        af[2] = lds32(p0 + 16);
        af[3] = lds32(p0 + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        capf::mma_s8_16x8x32(acc[j], af, bf[ks][j]);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<int2*>(out + static_cast<size_t>(r) * kN + n0 + nw +
                               8 * j + 2 * t) =
          make_int2(acc[j][half * 2], acc[j][half * 2 + 1]);
    }
  }
}

}  // namespace

// xf (768, 128) fp32, w (192, 128) int8, amax scalar, out (768, 128)
// int32, all 16-byte aligned; words: 0 the address offset, 1 the word
// shift
extern "C" int capf_window_matmul(const float* xf, const int8_t* w,
                                  const float* amax, int* out, int words,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid(kM / kRows, kN / kCols);
  if (words) {
    window_matmul_kernel<true><<<grid, kThreads, 0, stream>>>(xf, w, amax,
                                                              out);
  } else {
    window_matmul_kernel<false><<<grid, kThreads, 0, stream>>>(xf, w, amax,
                                                               out);
  }
  return static_cast<int>(cudaGetLastError());
}
