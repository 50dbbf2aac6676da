// K10s: the CPN's int8 stem on raw uint8 frames (cpn_fold_normalize).
//
// Replaces the XLA graph of contextaware_poseformer_tpu/models/cpn.py:
// 214-223 over backbone_common.py:204-213 (no Pallas kernel, no PyTorch
// CUDA counterpart): the normalization folded into the stem conv. For a
// frame of uint8 BGR pixels u8,
//   s8 = u8 ^ 0x80 (= u8 - 128, exact), read as RGB;
//   acc = conv(s8, kernel_q): 7x7, stride 2, zero padding 3, int32, exact;
//   ys = E(acc) * E(scale * wscale * step) + E(bias)   (affine<E>, two
//        roundings, step the s8 frame's dequant step, fl32(127/255) / 127);
//   out = relu(E(ys + bias_map)), the bias map (Ho, Wo, 64) in E the conv of
//        the constant offset image (128 - mean) / 255 under the same zero
//        padding (ops/int8_conv.py::stem_bias_map), the same for every
//        frame of the batch.
// E is the backbone's dtype, bf16 or fp32 (a template parameter). The zero
// padding is zero in s8: it is staged as raw 0x80 bytes, which the xor
// turns into 0, and the bias map carries the offset's own border, so the
// border ring is exact.
//
// What bounds it on the H100: bytes. At batch 64 and 256x192 frames the
// input is 9.4 MB, the output 100.7 MB in bf16 (201 MB in fp32) and the
// work 14.8 GOP (0.0075 ms at the int8 tensor-core rate). The design keeps
// a row's loads in flight while the row before it computes:
// - K = 7 x 7 x 3 = 147 fits no tile of K10 (Cin a multiple of 16, 1x1 or
//   3x3). For one kernel row, the 7 taps x 3 channels of output pixel ox
//   are the 21 contiguous bytes of the input row starting at byte
//   6 ox - 9: one s8 k-step of 32 a kernel row, 7 k-steps in all. B, the
//   weights, is that k-step's 21 bytes padded to 32 with zeros
//   (ops/int8_conv.py::stem_weight_steps), so A's bytes past 21 (the next
//   pixels' bytes) add nothing and need no mask. The BGR flip is folded
//   into B (channels reversed), never applied to the image. The offsets
//   6 ox - 9 are odd, so a lane builds each 4-byte A fragment from two
//   aligned shared-memory words with __byte_perm (neither ldmatrix nor a
//   wgmma descriptor can address them), then applies the xor.
// - The products are wgmma m64n64k32 s8 with A from registers (a warp's
//   16 rows of the warpgroup's 64, in mma.sync's fragment layout) and B,
//   the 64 x 224-byte weights, staged once a block in the 128-byte-swizzled
//   K-major layout the descriptors name. A warpgroup reads B from shared
//   memory once a k-step for its 64 pixels, where mma.sync makes every
//   warp load all of B for its 16: a quarter of the shared-memory traffic
//   for B.
// - A persistent block owns a segment of an output row's columns (the
//   whole row at the served width) and walks a band of consecutive output
//   rows of the batch (ops/int8_conv.py::stem_plan). Its input rows live in
//   a ring of kSlots staged rows (raw u8, the zero padding around them as
//   0x80): an output row needs only its 2 new input rows, which cp.async
//   brings in rows ahead, with the row's bias-map row, issued by the warps
//   past the segment's tiles where there are any. The frame is read from
//   device memory about once; the map, 1.6 MB in bf16, is read from L2
//   once per output row (100 MB over the batch at 256x192, bf16).
// - In bf16 a warp keeps the A fragments it builds (16 bytes a lane a
//   kernel row, kFragSlots rows): each input row's are built once and read
//   by the 3 or 4 output rows whose windows hold it.
// - A warp owns 16 output pixels of the row and all 64 channels (the
//   warps past the segment's tiles, which fill the last warpgroup, give
//   zero A rows and store nothing); a kernel row outside the frame gives
//   a zero A. The epilogue applies the affine and adds the bias map in the
//   accumulator layout (bf16: bf16x2 operations, each rounded once, which
//   is the fp32 operation rounded to bf16), writes the result over the
//   staged map row and leaves by 16-byte stores.
#include "common.cuh"
#include "hopper.cuh"

using capf::folded_scale;
using capf::round_to;
using capf::sm90::cp_async16;
using capf::sm90::cp_async_commit;
using capf::sm90::cp_async_wait;
using capf::sm90::sw128_desc;
using capf::sm90::sw128_offset;

extern "C" {
struct StemConvArgs {  // mirrored by ops/int8_conv.py::_StemArgs
  const void* x;         // (B, H, W, 3) uint8 BGR
  const void* wk;        // (7, 64, 32) int8: ops/int8_conv.py::stem_weight_steps
  const float* wscale;   // (64,)
  const float* scale;    // (64,) BN scale
  const float* bias;     // (64,) BN bias
  const void* bias_map;  // (Ho, Wo, 64) E
  void* out;             // (B, Ho, Wo, 64) E
  float step;            // the s8 frame's dequant step
  int batch, h, w, ho, wo;
  int f32;               // E: 1 fp32, 0 bf16
  // the plan (ops/int8_conv.py::stem_plan)
  int seg;     // output pixels of a segment, a multiple of 16
  int segs;    // segments of a row: ceil(Wo / seg)
  int bands;   // bands of consecutive rows each segment is cut into
  int period;  // an image's rows in the ring's slot numbers: 2 Ho
  int smem;    // dynamic shared memory a block takes
};
}  // extern "C"

namespace {

constexpr int kCout = 64;
constexpr int kTaps = 7;        // kernel rows (and columns)
constexpr int kStage = kCout * capf::sm90::kSwizzleRow;  // 4 k-steps of B
constexpr int kWBytes = 2 * kStage;  // the 7 k-steps in two stages
constexpr int kAlign = 1024;  // the swizzled stages' alignment (slack)
constexpr int kLead = 16;       // staged bytes before a segment's pixels
constexpr int kTail = 32;       // staged bytes after them
constexpr int kSlots = 16;      // the ring's staged input rows
constexpr int kPitchE = kCout + 8;  // a staged map pixel's E values
constexpr int kMaxWarps = 8;  // 16-pixel tiles of a segment, at most
constexpr int kSmemLimit = 232448;  // the 227 KB a Hopper block may use
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23: its fp32 step is 1
constexpr int kMagicBits = 0x4B400000;

// a block's threads: whole warpgroups, a warp for each 16-pixel tile
__host__ __device__ constexpr int threads(int seg) {
  return 128 * ((seg + 63) / 64);
}

// a staged input row's bytes: the lead, 6 seg bytes of pixels, the tail
__host__ __device__ constexpr int row_pitch(int seg) {
  return kLead + 6 * seg + kTail;
}

// rows staged ahead of the one computing (bf16 2; fp32 1, which keeps two
// blocks an SM), and the bias-map rows staged: those, this row's and the
// last row's (a warp may still read it)
// A bf16 block also keeps each lane's A fragments of the kernel rows it
// has built, kFragSlots input rows deep (a row is built once and read by
// the 3 or 4 output rows whose windows hold it); an fp32 block has no room
// for them beside its fp32 map rows and two blocks an SM.
template <typename E>
struct Ring {
  static constexpr int kAhead = sizeof(E) == 2 ? 2 : 1;
  static constexpr int kMapSlots = kAhead + 2;
  static constexpr bool kKeepA = sizeof(E) == 2;
};
constexpr int kFragSlots = 8;  // a warp's kept input rows: the 7 of a window

template <typename E>
__host__ __device__ constexpr int frag_bytes(int seg) {
  return Ring<E>::kKeepA ? seg / 16 * kFragSlots * 32 * 16 : 0;
}

template <typename E>
__host__ __device__ constexpr int smem_bytes(int seg) {
  return kAlign + kWBytes + kCout * 2 * static_cast<int>(sizeof(E)) +
         kSlots * row_pitch(seg) +
         Ring<E>::kMapSlots * seg * kPitchE * static_cast<int>(sizeof(E)) +
         frag_bytes<E>(seg);
}

// 4 bytes of a staged row at any byte offset, from two aligned words, as
// s8 (the xor of the raw u8)
__device__ __forceinline__ uint32_t bytes4(const unsigned char* row,
                                           int off) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row) + (off >> 2);
  return __byte_perm(p[0], p[1], 0x3210u + 0x1111u * (off & 3)) ^
         0x80808080u;
}

// the fp32 value of an int with |v| < 2^22 (|acc| <= 147 * 128 * 127),
// exactly, by a full-rate add on the bits of 1.5 * 2^23
__device__ __forceinline__ float exact_float(int v) {
  return __fsub_rn(__int_as_float(kMagicBits + v), kMagic);
}

using bf2 = __nv_bfloat162;

// The epilogue of two channels of one pixel, relu(E(E(E(acc) eff + bias)
// + map)). bf16: each bf16x2 operation rounds once, which is the fp32
// operation rounded to bf16 (a product of two bf16 values is exact in
// fp32, and so is a sum whose terms lie within 16 binades; a sum further
// apart moves the larger term by less than a quarter of its bf16 step);
// the _rn forms keep the compiler from contracting a multiply and an add
// into one FMA.
template <typename E>
struct Epi;
template <>
struct Epi<__nv_bfloat16> {
  using T = bf2;  // two channels
  __device__ static T pair(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  __device__ static T finish(int a0, int a1, T eff, T bias, T m) {
    const bf2 y = __hadd2_rn(
        __hmul2_rn(__floats2bfloat162_rn(exact_float(a0), exact_float(a1)),
                   eff),
        bias);
    return __hmax2(__hadd2_rn(y, m), __floats2bfloat162_rn(0.f, 0.f));
  }
};
template <>
struct Epi<float> {
  using T = float2;
  __device__ static T pair(float a, float b) { return make_float2(a, b); }
  __device__ static T finish(int a0, int a1, T eff, T bias, T m) {
    const float y0 = __fadd_rn(__fmul_rn(exact_float(a0), eff.x), bias.x);
    const float y1 = __fadd_rn(__fmul_rn(exact_float(a1), eff.y), bias.y);
    return make_float2(fmaxf(__fadd_rn(y0, m.x), 0.f),
                       fmaxf(__fadd_rn(y1, m.y), 0.f));
  }
};

// D (64 x 64, s32) += A (64 x 32 s8, registers) B (64 x 32 s8)^T, B
// K-major in shared memory; A and D in mma.sync's layout, a warp's 16 rows
__device__ __forceinline__ void wgmma_s8_n64_ra(int (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <typename E>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    stem_conv_kernel(const StemConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kAlign - (capf::sm90::smem_u32(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1));
  using T = typename Epi<E>::T;
  constexpr int kAhead = Ring<E>::kAhead, kMapSlots = Ring<E>::kMapSlots;
  // a channel pair's E(scale * wscale * step), then its E(bias)
  T* s_eb = reinterpret_cast<T*>(smem + kWBytes);
  unsigned char* s_ring = smem + kWBytes + kCout * 2 * sizeof(E);
  const int pitch = row_pitch(a.seg);
  E* s_map = reinterpret_cast<E*>(s_ring + kSlots * pitch);
  uint4* s_frag = reinterpret_cast<uint4*>(
      s_map + Ring<E>::kMapSlots * a.seg * kPitchE);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;

  // the weights as wgmma's B: output channel n's k-steps ky in row n of
  // stage ky / 4, 32 (ky % 4) bytes in, 128-byte swizzled (the last
  // stage's fourth k-step is never read)
  const uint4* wk = static_cast<const uint4*>(a.wk);
  for (int i = tid; i < kTaps * kCout * 2; i += nthreads) {
    const int half = i % 2, n = (i / 2) % kCout, ky = i / (2 * kCout);
    *reinterpret_cast<uint4*>(smem + (ky / 4) * kStage +
                              sw128_offset(n, 2 * (ky % 4) + half)) =
        __ldg(wk + i);
  }
  for (int c = 2 * tid; c < kCout; c += 2 * nthreads) {
    s_eb[c] = Epi<E>::pair(folded_scale<E>(a.scale[c], a.wscale[c], a.step),
                           folded_scale<E>(a.scale[c + 1], a.wscale[c + 1],
                                           a.step));
    s_eb[c + 1] = Epi<E>::pair(round_to<E>(a.bias[c]),
                               round_to<E>(a.bias[c + 1]));
  }
  const int seg_i = static_cast<int>(blockIdx.x) % a.segs;
  const int band = static_cast<int>(blockIdx.x) / a.segs;
  const int c0 = seg_i * a.seg;  // the segment's first output column
  const int npx = min(a.seg, a.wo - c0);
  const int tiles = npx / 16;
  // the warps past the segment's tiles, where there are any, stage the
  // rows; the others only compute
  const int spare = nthreads - 32 * tiles;
  const int stager = spare > 0 ? tid - 32 * tiles : tid;
  const int stagers = spare > 0 ? spare : nthreads;
  const int row_bytes = 3 * a.w;  // a multiple of 16 (W % 32 == 0)
  const int pieces = pitch / 16;
  // input byte of a staged row's byte 0 (16-byte aligned: c0 % 16 == 0)
  const int x0 = 6 * c0 - kLead;
  capf::sm90::fence_proxy_async();  // B is read through the async proxy
  // a staged piece outside the row is zero padding: raw 0x80, written once
  for (int i = tid; i < kSlots * pieces; i += nthreads) {
    const int p = i % pieces, xb = x0 + 16 * p;
    if (xb < 0 || xb >= row_bytes) {
      reinterpret_cast<uint4*>(s_ring + (i / pieces) * pitch)[p] =
          make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
    }
  }
  const unsigned char* frames = static_cast<const unsigned char*>(a.x);
  const E* map = static_cast<const E*>(a.bias_map);
  E* out = static_cast<E*>(a.out);
  constexpr int kMapPieces = kCout * static_cast<int>(sizeof(E)) / 16;
  // input rows lo..hi of image b (those inside the frame) into their ring
  // slots, then bias-map row oy into map slot ms; one cp.async group
  auto stage = [&](int b, int lo, int hi, int oy, int ms) {
    if (stager < 0) return;
    lo = max(lo, 0);
    hi = min(hi, a.h - 1);
    const unsigned char* frame =
        frames + static_cast<size_t>(b) * a.h * row_bytes;
    for (int i = stager; i < (hi - lo + 1) * pieces; i += stagers) {
      const int iy = lo + i / pieces, p = i % pieces, xb = x0 + 16 * p;
      if (xb >= 0 && xb < row_bytes) {
        const int slot = (b * a.period + iy) & (kSlots - 1);
        cp_async16(s_ring + slot * pitch + 16 * p,
                   frame + static_cast<size_t>(iy) * row_bytes + xb, 16);
      }
    }
    const E* src = map + (static_cast<size_t>(oy) * a.wo + c0) * kCout;
    E* dst = s_map + ms * a.seg * kPitchE;
    for (int i = stager; i < npx * kMapPieces; i += stagers) {
      const int px = i / kMapPieces, p = i % kMapPieces;
      cp_async16(dst + px * kPitchE + p * (16 / sizeof(E)),
                 src + px * kCout + p * (16 / sizeof(E)), 16);
    }
  };

  const long long rows = 1LL * a.batch * a.ho;
  const long long r0 = rows * band / a.bands;
  const long long r1 = rows * (band + 1) / a.bands;
  int b = static_cast<int>(r0 / a.ho);
  int oy = static_cast<int>(r0 - 1LL * b * a.ho);
  // row s of the band (image bs, output row oys): its window's rows that
  // row s - 1's lacks (all 7 for the band's first row or an image's
  // first), and its map row; one cp.async group a row, empty past the band
  int bs = b, oys = oy;
  auto stage_next = [&](long long s) {
    if (s < r1) {
      const int ms = static_cast<int>(s % kMapSlots);
      if (s == r0 || oys == 0) {
        stage(bs, 2 * oys - 3, 2 * oys + 3, oys, ms);
      } else {
        stage(bs, 2 * oys + 2, 2 * oys + 3, oys, ms);
      }
      if (++oys == a.ho) oys = 0, ++bs;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kAhead; ++k) stage_next(r0 + k);
  for (long long r = r0; r < r1; ++r) {
    const int ms = static_cast<int>(r % kMapSlots);
    stage_next(r + kAhead);  // while this row computes
    cp_async_wait<kAhead>();  // this row's group has landed
    __syncthreads();
    E* m_row = s_map + ms * a.seg * kPitchE;
    // warp w's tile is the row's 16 pixels 16 w on; its A row g = lane / 4
    // is output pixel 16 w + g (rows g + 8: + 8), whose k-step's byte k
    // sits at 6 ox - 9 + k past the segment's pixels
    const int t = warp;
    uint32_t af[kTaps][4];
    const int off = kLead - 9 + 6 * (16 * t + lane / 4) + 4 * (lane % 4);
    auto build = [&](int iy) {  // the lane's A fragment of kernel row iy
      const unsigned char* row =
          s_ring + ((b * a.period + iy) & (kSlots - 1)) * pitch;
      return make_uint4(bytes4(row, off), bytes4(row, off + 48),
                        bytes4(row, off + 16), bytes4(row, off + 64));
    };
    uint4* frag = s_frag + t * kFragSlots * 32 + lane;
    if (Ring<E>::kKeepA && t < tiles) {
      // the rows this row's window adds (all of it at the band's or an
      // image's first row), built once into the lane's own slots
      const int first = r == r0 || oy == 0 ? 2 * oy - 3 : 2 * oy + 2;
      for (int iy = max(first, 0); iy <= min(2 * oy + 3, a.h - 1); ++iy) {
        frag[((b * a.period + iy) & (kFragSlots - 1)) * 32] = build(iy);
      }
    }
#pragma unroll
    for (int ky = 0; ky < kTaps; ++ky) {
      const int iy = 2 * oy - 3 + ky;
      uint4 v = make_uint4(0, 0, 0, 0);  // outside the frame or no tile
      if (t < tiles && iy >= 0 && iy < a.h) {
        v = Ring<E>::kKeepA
                ? frag[((b * a.period + iy) & (kFragSlots - 1)) * 32]
                : build(iy);
      }
      af[ky][0] = v.x, af[ky][1] = v.y, af[ky][2] = v.z, af[ky][3] = v.w;
    }
    int d[4 * (kCout / 8)];
#pragma unroll
    for (int i = 0; i < 4 * (kCout / 8); ++i) d[i] = 0;
    capf::sm90::wgmma_fence();
#pragma unroll
    for (int ky = 0; ky < kTaps; ++ky) {
      wgmma_s8_n64_ra(d, af[ky],
                      sw128_desc(smem + (ky / 4) * kStage + 32 * (ky % 4)));
    }
    capf::sm90::wgmma_commit();
    capf::sm90::wgmma_wait<0>();
    capf::sm90::fence_regs(d);
    if (t < tiles) {
      // the affine and the map in the accumulator layout (rows g and
      // g + 8, channels 8 j + 2 (lane % 4) and + 1: d[4 j] .. d[4 j + 3]),
      // over the staged map: all its pairs loaded, then all stored
      T* m0 = reinterpret_cast<T*>(m_row + (16 * t + lane / 4) * kPitchE) +
              lane % 4;
      T* m1 = m0 + 4 * kPitchE;  // 8 pixels on
      T m[kCout / 4];
#pragma unroll
      for (int j = 0; j < kCout / 8; ++j) {
        m[2 * j] = m0[4 * j], m[2 * j + 1] = m1[4 * j];
      }
#pragma unroll
      for (int j = 0; j < kCout / 8; ++j) {
        const T eff = s_eb[8 * j + 2 * (lane % 4)];
        const T bias = s_eb[8 * j + 2 * (lane % 4) + 1];
        m[2 * j] = Epi<E>::finish(d[4 * j], d[4 * j + 1], eff, bias,
                                  m[2 * j]);
        m[2 * j + 1] = Epi<E>::finish(d[4 * j + 2], d[4 * j + 3], eff, bias,
                                      m[2 * j + 1]);
      }
#pragma unroll
      for (int j = 0; j < kCout / 8; ++j) {
        m0[4 * j] = m[2 * j], m1[4 * j] = m[2 * j + 1];
      }
      __syncwarp();
      // 16 pixels x 64 channels out, 16 bytes a store
      constexpr int kPieces = kCout * static_cast<int>(sizeof(E)) / 16;
      E* dst = out + ((static_cast<size_t>(b) * a.ho + oy) * a.wo + c0 +
                      16 * t) * kCout;
      for (int i = lane; i < 16 * kPieces; i += 32) {
        const int px = i / kPieces, p = i % kPieces;
        *reinterpret_cast<uint4*>(dst + px * kCout + p * (16 / sizeof(E))) =
            *reinterpret_cast<const uint4*>(m_row + (16 * t + px) * kPitchE +
                                            p * (16 / sizeof(E)));
      }
    }
    if (++oy == a.ho) oy = 0, ++b;
  }
  cp_async_wait<0>();
}

template <typename E>
cudaError_t launch(const StemConvArgs& a, cudaStream_t stream) {
  static bool opted = false;  // once per instantiation (one device)
  if (!opted) {
    const cudaError_t err = capf::allow_smem(stem_conv_kernel<E>, kSmemLimit);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  stem_conv_kernel<E><<<a.segs * a.bands, threads(a.seg), a.smem, stream>>>(
      a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_stem_conv(const StemConvArgs* args, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const StemConvArgs& a = *args;
  // W a multiple of 32: whole 16-byte pieces of a row, whole 16-pixel
  // tiles of an output row; the plan's numbers are the ones this kernel
  // reads its geometry from
  const long long rows = 1LL * a.batch * a.ho;
  if (a.batch < 1 || a.h < 1 || a.w < 32 || a.w % 32 ||
      a.ho != (a.h + 1) / 2 || a.wo != a.w / 2 || (a.f32 != 0 && a.f32 != 1) ||
      a.seg < 16 || a.seg % 16 || a.seg > 16 * kMaxWarps ||
      a.segs != (a.wo + a.seg - 1) / a.seg || a.bands < 1 ||
      a.bands > rows || 1LL * a.segs * a.bands > (1LL << 31) - 1 ||
      a.period != 2 * a.ho ||
      a.smem != (a.f32 ? smem_bytes<float>(a.seg)
                       : smem_bytes<__nv_bfloat16>(a.seg)) ||
      a.smem > kSmemLimit || 1LL * a.batch * a.h * a.w * 3 > (1LL << 40) ||
      1LL * a.batch * a.period > (1LL << 30) || 3LL * a.w >= (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(a.f32 ? launch<float>(a, stream)
                                 : launch<__nv_bfloat16>(a, stream));
}
