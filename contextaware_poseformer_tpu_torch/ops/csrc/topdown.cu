// K10u: the CPN's s8 top-down hop (cpn_int8_topdown), the x2 upsample of
// the requantized up-conv output fused with the lateral add.
//
// Replaces the XLA graph of contextaware_poseformer_tpu/models/cpn.py:
// 334-338 and the add at cpn.py:289, over backbone_common.py:266-280 (no
// Pallas kernel, no PyTorch CUDA counterpart). For q (B, h, w, C) int8 (the
// up-conv's output, requantized in K10's epilogue with the hop's calibrated
// amax ua) and the next level's lateral lat (B, 2h, 2w, C) in E:
//   r   = E(wr0 * q[i0] + wr1 * q[i1])        the row pass (align-corners)
//   u   = E(wc0 * r[:, j0] + wc1 * r[:, j1])  the column pass
//   out = E(lat + E(u * E(ua / 127)))
// with the JAX package's rounding points: its separable resize is two
// dense interpolation matmuls in E with the weights rounded to E, and
// each output element of a pass has two taps (a clipped edge tap folded
// into one weight), so a pass is the sum of two fp32 products rounded
// once to E (in bf16 every product is exact). The taps and weights are the
// host's tables (ops/int8_conv.py::interp_table), the same the plain
// version reads. E is bf16 or fp32 (a template parameter); no FMA, as the
// plain version computes each product and sum apart.
//
// What bounds it on the H100: bytes. At batch 64 and C 256 the three hops
// of a request move 16.5 MB of int8, 132.1 MB of lateral and 132.1 MB of
// output in bf16: 0.0838 ms at 3.35 TB/s (fp32: 0.1627). The upsampled
// tensor never reaches HBM, and the design cuts the instructions an output
// byte costs (ops/int8_conv.py::topdown_plan):
// - A block owns a strip of 2 output rows of one image, at full width where
//   it fits (a tile of the columns where it does not) and a slice of at most
//   256 channels; its place comes from blockIdx, in 32-bit arithmetic, and
//   its loops walk rows, columns and channels with no division. At x2 with
//   align corners the source position moves by (h - 1) / (2h - 1) < 1/2 a
//   row, so two output rows read at most 3 source rows.
// - It stages those s8 rows (8-byte cp.async) and its tap tables in shared
//   memory, then computes the row pass once per (output row, source column,
//   channel) into shared memory in E (s8 unpacked by prmt into the bits of
//   1.5 * 2^23 + 128 + v, then one add), so each row-pass value is
//   computed once and read by the two output columns that tap it.
// - The column pass takes 8 channels of one output pixel a thread (the
//   channels on threadIdx.x, the pixels on threadIdx.y): two 16-byte reads
//   of the row pass, the lateral by 16-byte loads, 4 pixels' loads in
//   flight a thread, and 16-byte stores. In bf16 the dequantize and the add
//   are bf16x2 operations, each rounded once, which is the fp32 operation
//   rounded to bf16 (a product of two bf16 values is exact in fp32, and so
//   is a sum whose terms lie within 16 binades; a sum further apart moves
//   the larger term by less than a quarter of its bf16 step).
#include "common.cuh"
#include "hopper.cuh"

using capf::round_to;
using capf::sm90::cp_async8;
using capf::sm90::cp_async_commit;
using capf::sm90::cp_async_wait;

extern "C" {
struct TopdownArgs {  // mirrored by ops/int8_conv.py::_TopdownArgs
  const void* q;        // (B, h, w, C) int8
  const float* ua;      // (1,) the hop's calibrated amax
  const void* lat;      // (B, 2h, 2w, C) E
  void* out;            // (B, 2h, 2w, C) E
  const int* row_idx;   // (2h, 2) the row taps
  const float* row_w;   // (2h, 2) their weights (E values)
  const int* col_idx;   // (2w, 2) the column taps
  const float* col_w;   // (2w, 2)
  int batch, h, w, c;
  int f32;              // E: 1 fp32, 0 bf16
  // the plan (ops/int8_conv.py::topdown_plan)
  int rows;      // output rows of a strip
  int cols;      // output columns of a tile
  int chans;     // channels of a slice, a multiple of 8
  int src_rows;  // staged source rows, at most
  int src_cols;  // staged source columns, at most
  int smem;      // dynamic shared memory a block takes
};
}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChans = 256;      // a slice: 32 groups of 8 channels
constexpr int kInFlight = 4;        // output pixels' loads a thread issues
constexpr int kSmemLimit = 232448;  // the 227 KB a Hopper block may use
constexpr float kMagic = 12583040.f;  // 1.5 * 2^23 + 128: fp32 step 1

struct Tap {  // a strip row's or a tile column's taps, from the staged ones
  int i0, i1;
  float w0, w1;
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

template <typename E>
__host__ __device__ constexpr int smem_bytes(int rows, int cols, int chans,
                                             int src_rows, int src_cols) {
  return align16(src_rows * src_cols * chans) +
         rows * src_cols * chans * static_cast<int>(sizeof(E)) +
         static_cast<int>(sizeof(Tap)) * (rows + cols);
}

// 4 s8 values as floats: v ^ 0x80 = v + 128 in the low bits of
// 1.5 * 2^23's significand, then one exact subtraction
__device__ __forceinline__ void s8x4(uint32_t v, float* y) {
  v ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    y[i] = __fsub_rn(__int_as_float(__byte_perm(v, 0x4B40u, 0x5460u + i)),
                     kMagic);
  }
}

// w0 * a + w1 * b: two products and their sum in fp32 (Vec8::set rounds
// it once to E)
__device__ __forceinline__ float blend(float w0, float a, float w1,
                                       float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// 8 E values of the row pass or of the lateral: one 16-byte word (bf16) or
// two (fp32)
template <typename E>
struct Vec8;
template <>
struct Vec8<__nv_bfloat16> {
  uint4 v;
  __device__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = v;
  }
  __device__ float at(int e) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    return __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
  }
  __device__ void set(const float* y) {  // 8 floats, each rounded to bf16
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec8<float> {
  float4 lo, hi;
  __device__ void load(const float* p) {
    lo = *reinterpret_cast<const float4*>(p);
    hi = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = lo;
    *reinterpret_cast<float4*>(p + 4) = hi;
  }
  __device__ float at(int e) const {
    const float y[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    return y[e];
  }
  __device__ void set(const float* y) {
    lo = make_float4(y[0], y[1], y[2], y[3]);
    hi = make_float4(y[4], y[5], y[6], y[7]);
  }
};

// out = E(lat + E(u * s)) for 8 channels; u holds the column pass, E
// values; s = E(ua / 127)
__device__ __forceinline__ Vec8<__nv_bfloat16> finish(
    const Vec8<__nv_bfloat16>& lat, const Vec8<__nv_bfloat16>& u, float s) {
  const __nv_bfloat162 s2 = __floats2bfloat162_rn(s, s);
  const uint32_t l[4] = {lat.v.x, lat.v.y, lat.v.z, lat.v.w};
  const uint32_t x[4] = {u.v.x, u.v.y, u.v.z, u.v.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 r = __hadd2_rn(
        *reinterpret_cast<const __nv_bfloat162*>(&l[i]),
        __hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(&x[i]), s2));
    o[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  Vec8<__nv_bfloat16> y;
  y.v = make_uint4(o[0], o[1], o[2], o[3]);
  return y;
}
__device__ __forceinline__ Vec8<float> finish(const Vec8<float>& lat,
                                              const Vec8<float>& u, float s) {
  float y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    y[e] = __fadd_rn(lat.at(e), __fmul_rn(u.at(e), s));
  }
  Vec8<float> v;
  v.set(y);
  return v;
}

template <typename E>
__global__ void __launch_bounds__(kThreads, sizeof(E) == 2 ? 4 : 3)
    topdown_kernel(const TopdownArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int oh = 2 * a.h, ow = 2 * a.w;
  const int strips = (oh + a.rows - 1) / a.rows;
  const int tiles = (ow + a.cols - 1) / a.cols;
  const int slices = (a.c + a.chans - 1) / a.chans;
  int t = static_cast<int>(blockIdx.x);
  const int slice = t % slices;
  t /= slices;
  const int tile = t % tiles;
  t /= tiles;
  const int strip = t % strips;
  const int b = t / strips;
  const int oy0 = strip * a.rows, ox0 = tile * a.cols, c0 = slice * a.chans;
  const int nrows = min(a.rows, oh - oy0), ncols_out = min(a.cols, ow - ox0);
  const int groups = min(a.chans, a.c - c0) / 8;  // 8-channel groups
  const int lo = a.row_idx[2 * oy0];
  const int nsrc = a.row_idx[2 * (oy0 + nrows - 1) + 1] - lo + 1;
  const int jlo = a.col_idx[2 * ox0];
  const int ncols = a.col_idx[2 * (ox0 + ncols_out - 1) + 1] - jlo + 1;
  if (nsrc > a.src_rows || ncols > a.src_cols) __trap();  // a wrong plan

  int8_t* s_q = reinterpret_cast<int8_t*>(smem);
  E* s_r = reinterpret_cast<E*>(smem + align16(a.src_rows * a.src_cols *
                                               a.chans));
  Tap* s_rt = reinterpret_cast<Tap*>(s_r + a.rows * a.src_cols * a.chans);
  Tap* s_ct = s_rt + a.rows;
  const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * ny;

  // the strip's source rows: 8 channels a copy
  const int8_t* q = static_cast<const int8_t*>(a.q) +
                    (static_cast<size_t>(b) * a.h + lo) * a.w * a.c + c0;
  if (tx < groups) {
    for (int sr = 0; sr < nsrc; ++sr) {
      for (int j = ty; j < ncols; j += ny) {
        cp_async8(s_q + (sr * a.src_cols + j) * a.chans + 8 * tx,
                  q + (static_cast<size_t>(sr) * a.w + jlo + j) * a.c +
                      8 * tx);
      }
    }
  }
  cp_async_commit();
  for (int i = tid; i < nrows + ncols_out; i += nthreads) {
    const bool row = i < nrows;
    const int o = row ? oy0 + i : ox0 + i - nrows, base = row ? lo : jlo;
    const int* idx = row ? a.row_idx : a.col_idx;
    const float* wt = row ? a.row_w : a.col_w;
    *(row ? s_rt + i : s_ct + i - nrows) = {idx[2 * o] - base,
                                            idx[2 * o + 1] - base,
                                            wt[2 * o], wt[2 * o + 1]};
  }
  const float s = round_to<E>(__fmul_rn(fmaxf(*a.ua, 1e-12f),
                                        capf::kRecip127));
  cp_async_wait<0>();
  __syncthreads();

  // the row pass, once per (output row, source column, channel)
  if (tx < groups) {
    for (int y = 0; y < nrows; ++y) {
      const Tap rt = s_rt[y];
      for (int j = ty; j < ncols; j += ny) {
        const uint2 v0 = *reinterpret_cast<const uint2*>(
            s_q + (rt.i0 * a.src_cols + j) * a.chans + 8 * tx);
        const uint2 v1 = *reinterpret_cast<const uint2*>(
            s_q + (rt.i1 * a.src_cols + j) * a.chans + 8 * tx);
        float f0[8], f1[8], r[8];
        s8x4(v0.x, f0), s8x4(v0.y, f0 + 4);
        s8x4(v1.x, f1), s8x4(v1.y, f1 + 4);
#pragma unroll
        for (int e = 0; e < 8; ++e) r[e] = blend(rt.w0, f0[e], rt.w1, f1[e]);
        Vec8<E> rv;
        rv.set(r);
        rv.store(s_r + (y * a.src_cols + j) * a.chans + 8 * tx);
      }
    }
  }
  __syncthreads();

  // the column pass, the dequantize and the lateral add: 8 channels of one
  // output pixel an item, kInFlight pixels' lateral loads in flight
  if (tx >= groups) return;
  const E* lat = static_cast<const E*>(a.lat);
  E* out = static_cast<E*>(a.out);
  for (int y = 0; y < nrows; ++y) {
    const size_t pix0 =
        (static_cast<size_t>(b) * oh + oy0 + y) * ow + ox0;  // the tile's
    const E* r_row = s_r + y * a.src_cols * a.chans + 8 * tx;
    for (int x0 = ty; x0 < ncols_out; x0 += kInFlight * ny) {
      Vec8<E> l[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int x = x0 + k * ny;
        if (x < ncols_out) l[k].load(lat + (pix0 + x) * a.c + c0 + 8 * tx);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int x = x0 + k * ny;
        if (x >= ncols_out) break;
        const Tap ct = s_ct[x];
        Vec8<E> r0, r1, u;
        r0.load(r_row + ct.i0 * a.chans);
        r1.load(r_row + ct.i1 * a.chans);
        float y8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          y8[e] = blend(ct.w0, r0.at(e), ct.w1, r1.at(e));
        }
        u.set(y8);
        finish(l[k], u, s).store(out + (pix0 + x) * a.c + c0 + 8 * tx);
      }
    }
  }
}

template <typename E>
cudaError_t launch(const TopdownArgs& a, cudaStream_t stream) {
  static bool opted = false;  // once per instantiation (one device)
  if (!opted) {
    const cudaError_t err = capf::allow_smem(topdown_kernel<E>, kSmemLimit);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const long long grid = 1LL * a.batch * ((2 * a.h + a.rows - 1) / a.rows) *
                         ((2 * a.w + a.cols - 1) / a.cols) *
                         ((a.c + a.chans - 1) / a.chans);
  const int gx = a.chans / 8;
  topdown_kernel<E><<<static_cast<unsigned>(grid), dim3(gx, kThreads / gx),
                      a.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_topdown(const TopdownArgs* args, int device,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const TopdownArgs& a = *args;
  // the plan's numbers are the ones this kernel reads its geometry from
  // (its source spans are checked by each block against the tables)
  if (a.batch < 1 || a.h < 1 || a.w < 1 || a.c < 8 || a.c % 8 ||
      (a.f32 != 0 && a.f32 != 1) || a.rows < 1 || a.rows > 2 * a.h ||
      a.cols < 1 || a.cols > 2 * a.w || a.chans < 8 || a.chans % 8 ||
      a.chans > kMaxChans || a.chans > a.c || a.src_rows < 1 ||
      a.src_cols < 1 ||
      a.smem != (a.f32 ? smem_bytes<float>(a.rows, a.cols, a.chans,
                                            a.src_rows, a.src_cols)
                       : smem_bytes<__nv_bfloat16>(a.rows, a.cols, a.chans,
                                                   a.src_rows, a.src_cols)) ||
      a.smem > kSmemLimit || 1LL * a.batch * 4 * a.h * a.w * a.c > (1LL << 40) ||
      1LL * a.batch * ((2 * a.h + a.rows - 1) / a.rows) *
              ((2 * a.w + a.cols - 1) / a.cols) *
              ((a.c + a.chans - 1) / a.chans) > (1LL << 31) - 1) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(a.f32 ? launch<float>(a, stream)
                                 : launch<__nv_bfloat16>(a, stream));
}
