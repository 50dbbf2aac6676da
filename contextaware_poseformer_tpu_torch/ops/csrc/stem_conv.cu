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
// padding is zero in s8: the xor comes before the zero fill, and the bias
// map carries the offset's own border, so the border ring is exact.
//
// What bounds it on the H100: bytes. At batch 64 and 256x192 frames the
// input is 9.4 MB, the output 100.7 MB in bf16 (201 MB in fp32) and the
// work 14.8 GOP (0.0075 ms at the int8 tensor-core rate). The design:
// - K = 7 x 7 x 3 = 147 fits no tile of K10 (Cin a multiple of 16, 1x1 or
//   3x3). For one kernel row, the 7 taps x 3 channels of output pixel ox
//   are the 21 contiguous bytes of the input row starting at byte
//   6 ox - 9: one mma.sync m16n8k32 s8 k-step a kernel row, 7 k-steps in
//   all. B, the weights, is that k-step's 21 bytes padded to 32 with zeros
//   (ops/int8_conv.py::stem_weight_steps), so A's bytes past 21 (the next
//   pixels' bytes) add nothing and need no mask. The BGR flip is folded
//   into B (channels reversed), never applied to the image.
// - A block owns whole output rows (a grid-stride loop over the batch's
//   rows) and stages a row's 7 input rows as s8 in shared memory with the
//   zero padding around them (16-byte loads, xor 0x80 in registers); the
//   weights (14 KB) and the folded scales are staged once a block. The
//   offsets 6 ox - 9 are odd, so a lane builds each 4-byte A fragment from
//   two aligned shared-memory words with __byte_perm (ldmatrix cannot take
//   them).
// - A warp owns 16 output pixels and all 64 channels: 8 n-tiles of
//   mma.sync, 7 k-steps each. The epilogue applies the affine in the
//   accumulator layout, stages the warp's 16 x 64 tile in E in shared
//   memory, then each lane adds the bias map (16-byte loads; the map is
//   1.6 MB and stays in L2), applies the ReLU and stores 16 bytes at a time.
#include "common.cuh"
#include "hopper.cuh"

using capf::affine;
using capf::folded_scale;
using capf::load8;
using capf::round_to;
using capf::stage2;
using capf::store8;

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
};
}  // extern "C"

namespace {

constexpr int kCout = 64;
constexpr int kTaps = 7;        // kernel rows (and columns)
constexpr int kStepBytes = 32;  // a kernel row's k-step: 21 taps, zero to 32
constexpr int kWBytes = kTaps * kCout * kStepBytes;
constexpr int kLead = 16;       // bytes of zero before a staged row's pixels
constexpr int kTail = 32;       // bytes of zero after them
constexpr int kPitchE = kCout + 8;  // a staged output row's E values
constexpr int kMaxWarps = 8;
constexpr int kSmemLimit = 232448;  // the 227 KB a Hopper block may use

// the staged row's bytes: the zero lead, 3W bytes of pixels, the zero tail
__host__ __device__ constexpr int row_pitch(int w) {
  return kLead + 3 * w + kTail;
}

template <typename E>
__host__ __device__ constexpr int smem_bytes(int w, int warps) {
  return kWBytes + 2 * kCout * static_cast<int>(sizeof(float)) +
         kTaps * row_pitch(w) +
         warps * 16 * kPitchE * static_cast<int>(sizeof(E));
}

// 4 bytes of a staged row at any byte offset, from two aligned words
__device__ __forceinline__ uint32_t bytes4(const unsigned char* row,
                                           int off) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row) + (off >> 2);
  return __byte_perm(p[0], p[1], 0x3210u + 0x1111u * (off & 3));
}

template <typename E>
__global__ void __launch_bounds__(kMaxWarps * 32)
    stem_conv_kernel(const StemConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int8_t* s_w = reinterpret_cast<const int8_t*>(smem);
  float* s_eff = reinterpret_cast<float*>(smem + kWBytes);
  float* s_bias = s_eff + kCout;
  unsigned char* s_in = smem + kWBytes + 2 * kCout * sizeof(float);
  const int pitch = row_pitch(a.w);
  E* s_stage = reinterpret_cast<E*>(s_in + kTaps * pitch);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, warps = nthreads / 32;

  for (int i = tid; i < kWBytes / 16; i += nthreads) {
    reinterpret_cast<uint4*>(smem)[i] =
        reinterpret_cast<const uint4*>(a.wk)[i];
  }
  for (int c = tid; c < kCout; c += nthreads) {
    s_eff[c] = folded_scale<E>(a.scale[c], a.wscale[c], a.step);
    s_bias[c] = round_to<E>(a.bias[c]);
  }
  const int row_bytes = 3 * a.w;  // a multiple of 16 (W % 32 == 0)
  const int pieces = pitch / 16;  // 16-byte pieces of a staged row
  const int tiles = a.wo / 16;    // 16-pixel tiles of an output row
  const long long rows = 1LL * a.batch * a.ho;
  const E* map = static_cast<const E*>(a.bias_map);
  E* stage = s_stage + warp * 16 * kPitchE;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int b = static_cast<int>(r / a.ho);
    const int oy = static_cast<int>(r - 1LL * b * a.ho);
    __syncthreads();  // the last row's readers are done with s_in
    const unsigned char* frame =
        static_cast<const unsigned char*>(a.x) +
        static_cast<size_t>(b) * a.h * row_bytes;
    for (int i = tid; i < kTaps * pieces; i += nthreads) {
      const int ky = i / pieces;
      const int piece = i - ky * pieces - kLead / 16;
      const int iy = 2 * oy - 3 + ky;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (iy >= 0 && iy < a.h && piece >= 0 && 16 * piece < row_bytes) {
        v = __ldg(reinterpret_cast<const uint4*>(
            frame + static_cast<size_t>(iy) * row_bytes + 16 * piece));
        v.x ^= 0x80808080u, v.y ^= 0x80808080u;
        v.z ^= 0x80808080u, v.w ^= 0x80808080u;
      }
      reinterpret_cast<uint4*>(s_in + ky * pitch)[piece + kLead / 16] = v;
    }
    __syncthreads();
    for (int t = warp; t < tiles; t += warps) {
      int acc[kCout / 8][4];
#pragma unroll
      for (int j = 0; j < kCout / 8; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      }
      // A row g = lane / 4 is output pixel 16 t + g (rows g + 8: + 8); its
      // k-step's byte k sits at 6 ox - 9 + k past the row's pixels
      const int k0 = 4 * (lane % 4);
      const int off = kLead - 9 + 6 * (16 * t + lane / 4) + k0;
#pragma unroll
      for (int ky = 0; ky < kTaps; ++ky) {
        const unsigned char* row = s_in + ky * pitch;
        const uint32_t af[4] = {bytes4(row, off), bytes4(row, off + 48),
                                bytes4(row, off + 16),
                                bytes4(row, off + 64)};
        const int8_t* wrow = s_w + (ky * kCout + lane / 4) * kStepBytes + k0;
#pragma unroll
        for (int j = 0; j < kCout / 8; ++j) {
          const int8_t* wb = wrow + 8 * j * kStepBytes;
          const uint32_t bf[2] = {capf::lds32(wb), capf::lds32(wb + 16)};
          capf::mma_s8_16x8x32(acc[j], af, bf);
        }
      }
      // the affine in the accumulator layout (rows g and g + 8, channels
      // 8 j + 2 (lane % 4) and + 1), staged in E
      const int g = lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kCout / 8; ++j) {
        const int c = 8 * j + c0;
        const float e0 = s_eff[c], e1 = s_eff[c + 1];
        const float b0 = s_bias[c], b1 = s_bias[c + 1];
        stage2(stage + g * kPitchE + c, affine<E>(acc[j][0], e0, b0),
               affine<E>(acc[j][1], e1, b1));
        stage2(stage + (g + 8) * kPitchE + c, affine<E>(acc[j][2], e0, b0),
               affine<E>(acc[j][3], e1, b1));
      }
      __syncwarp();
      // the bias map added in E, the ReLU, 8 channels (16 or 32 bytes) a
      // store: 16 pixels x 8 pieces, 4 a lane
      for (int i = lane; i < 16 * (kCout / 8); i += 32) {
        const int px = i / (kCout / 8), c8 = 8 * (i % (kCout / 8));
        const int ox = 16 * t + px;
        float y[8], m[8];
        load8(stage + px * kPitchE + c8, y);
        load8(map + (static_cast<size_t>(oy) * a.wo + ox) * kCout + c8, m);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          y[e] = fmaxf(round_to<E>(__fadd_rn(y[e], m[e])), 0.f);
        }
        store8(static_cast<E*>(a.out) +
                   ((static_cast<size_t>(b) * a.ho + oy) * a.wo + ox) *
                       kCout +
                   c8,
               y);
      }
      __syncwarp();  // the stage is the warp's next tile's
    }
  }
}

template <typename E>
cudaError_t launch(const StemConvArgs& a, int device, cudaStream_t stream) {
  const int tiles = a.wo / 16;
  const int warps = tiles < kMaxWarps ? tiles : kMaxWarps;
  const int smem = smem_bytes<E>(a.w, warps);
  static bool opted = false;  // once per instantiation (one device)
  if (!opted) {
    const cudaError_t err = capf::allow_smem(stem_conv_kernel<E>, kSmemLimit);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const long long rows = 1LL * a.batch * a.ho;
  const long long most = 4LL * capf::sm90::sm_count(device);
  const unsigned grid = static_cast<unsigned>(rows < most ? rows : most);
  stem_conv_kernel<E><<<grid, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_stem_conv(const StemConvArgs* args, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const StemConvArgs& a = *args;
  // W a multiple of 32: whole 16-byte pieces of a row, whole 16-pixel
  // tiles of an output row; the staged rows must fit a block with the rest
  if (a.batch < 1 || a.h < 1 || a.w < 32 || a.w % 32 ||
      a.ho != (a.h + 1) / 2 || a.wo != a.w / 2 || (a.f32 != 0 && a.f32 != 1) ||
      smem_bytes<float>(a.w, kMaxWarps) > kSmemLimit ||
      1LL * a.batch * a.h * a.w * 3 > (1LL << 40)) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(a.f32 ? launch<float>(a, device, stream)
                                 : launch<__nv_bfloat16>(a, device, stream));
}
