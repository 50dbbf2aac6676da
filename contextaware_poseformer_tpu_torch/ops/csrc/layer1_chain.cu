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
// so the chain equals K10's per-conv chain bit for bit (int32 sums are exact
// in any order).
//
// What bounds it on the H100: at batch 64 a block does ~27 GOP of int8
// products (14 us at 1979 TOP/s) and must read 50 MB (block 0: 25 MB of
// bf16) and write 50 MB (30 us at 3.35 TB/s), as long as t1 and t2 stay on
// chip. The TPU kernel keeps one image's whole chain in VMEM; one image's
// 256-channel int8 tensor (786 KB at 64x48) does not fit the 227 KB a Hopper
// block has, and the four blocks' weights (~280 KB) do not either, so the
// chain stays one launch a block. A launch is a persistent grid, at most one
// block an SM (ops/layer1_chain.py::plan picks the schedule):
//
// - each block stages the Bottleneck's weights ONCE (~70 KB, cp.async), then
//   walks strips of `strip_rows` whole rows of one image, 64 pixels (wgmma's
//   M) a step; the pixels of a strip are one sequence, so W need not divide
//   into tiles;
// - conv1 runs `lead` = ceil((W + 1) / 64) tiles ahead of the output, and t1
//   stays in a ring of 2 lead + 1 tiles: the 3x3's halo rows are carried
//   from step to step, so conv1 runs once per input pixel (plus 2 lead tiles
//   a strip);
// - input tiles arrive by 16-byte cp.async `depth` steps ahead into a ring
//   (lead + 1 + depth tiles: the residual's, conv1's and the ones in
//   flight); block 0's bf16 tile is quantized in place when it lands;
// - four warpgroups share a step, so that 16 warps hide each other's
//   latencies (registers capped at 128 a thread): conv1, conv3 and the
//   downsample are wgmma m64nNk32 s8 from 128-byte-swizzled K-major shared
//   memory, a quarter of the columns a warpgroup (conv1 n16, conv3 and the
//   downsample n64; w3 and wd share one operand region, w3 in the first 64
//   bytes of K and wd in the next 64);
// - conv2 (K = 9 x 64) reads t1 shifted by a row and a pixel, which a wgmma
//   descriptor cannot offset: it runs on mma.sync m16n8k32 with every
//   fragment gathered by ldmatrix (a lane gives its shifted row's address, or
//   a zero row past the image's sides), a warp 16 pixels x 16 channels;
// - the epilogues run two channels at once in bf16x2 arithmetic with the
//   JAX package's rounding points (affine2) and quantize in fp32, with
//   full-rate adds in place of int <-> float conversions (exact_float,
//   quant_bits);
// - the output tile is staged in shared memory and leaves by 16-byte stores.
//
// The floor build (capf_layer1_block_floor) is the counterpart of the TPU
// probe experiments/layer1_chain_floor.py::_kernel_mm: the same loads,
// products and bf16 epilogues, with the requant stages (t1, t2, out) cut to a
// plain conversion and conv2's shifted, masked gathers cut to the centre
// pixel, so its numerics are wrong on purpose and its time bounds what the
// products and epilogues cost.

#include "common.cuh"
#include "hopper.cuh"

using capf::folded_scale;

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
  int batch, h, w, cin;
  int strip_rows, lead, depth, grid;  // ops/layer1_chain.py::plan
};
}  // extern "C"

namespace {

using namespace capf::sm90;

constexpr int kWg = 128;             // threads of a warpgroup
constexpr int kWgs = 4;              // warpgroups a block
constexpr int kThreads = kWgs * kWg;
constexpr int kPlanes = 64;
constexpr int kExp = 256;
constexpr int kBM = 64;                  // pixels a step: wgmma's M
constexpr int kChunk = kSwizzleRow;      // bytes of K in a swizzled chunk
constexpr int kATile = kBM * kChunk;     // one 64-row chunk: 8 KB
constexpr int kT1Pitch = kPlanes + 16;   // t1 rows (ldmatrix: no conflicts)
constexpr int kW2Pitch = 9 * kPlanes + 16;
constexpr int kOutPitch = kExp + 16;     // the staged output tile's rows
constexpr int kAlign = 1024;
constexpr size_t kSmemLimit = 232448;

struct Layout {  // byte offsets from the 1024-byte-aligned base
  int in_slots, t1_slots, stage;
  size_t w1, w3d, ring, t2, w2, t1, zero, out, vec, total;
};

// mirrored by ops/layer1_chain.py::smem_bytes
__host__ __device__ inline Layout layer1_layout(int cin, int lead,
                                                int depth) {
  Layout l;
  l.in_slots = lead + 1 + depth;  // the residual's .. conv1's .. in flight
  l.t1_slots = 2 * lead + 1;      // conv2's window
  l.stage = kBM * (cin == kPlanes ? 2 * kPlanes : kExp);  // raw input bytes
  size_t o = 0;
  l.w1 = o;  // swizzled, K-major; block 0: 64 bytes of each 128-byte row
  o += (cin == kPlanes ? 1 : 2) * kATile;
  l.w3d = o;  // 256 rows: w3 in bytes 0-63, wd in bytes 64-127
  o += kExp * kChunk;
  l.ring = o;  // input tiles, swizzled (block 0: bf16, quantized in place)
  o += static_cast<size_t>(l.in_slots) * l.stage;
  l.t2 = o;  // conv3's A: 64 bytes of each 128-byte row
  o += kATile;
  l.w2 = o;  // row-major, padded: ldmatrix's B
  o += kPlanes * kW2Pitch;
  l.t1 = o;  // row-major, padded: ldmatrix's A
  o += static_cast<size_t>(l.t1_slots) * kBM * kT1Pitch;
  l.zero = o;  // a zero t1 row: the 3x3's padding at the image's sides
  o += kT1Pitch;
  l.out = o;
  o += kBM * kOutPitch;
  l.vec = o;
  o += 2 * (4 * kPlanes + 4 * kExp);  // bf16 scales and biases
  l.total = o + kAlign;  // slack to align the dynamic base
  return l;
}

// The epilogues are made of int <-> float conversions, which run at a
// quarter of the FP32 rate on Hopper; these helpers do the same exact
// arithmetic with full-rate adds on the bits of 1.5 * 2^23, whose fp32 step
// is 1 on [2^23, 2^24).
constexpr float kMagic = 12582912.f;
constexpr int kMagicBits = 0x4B400000;

// the fp32 value of an int with -2^22 <= v < 2^22 (the 1x1 convs' sums:
// |acc| <= 256 * 127 * 128), exactly
__device__ __forceinline__ float exact_float(int v) {
  return __fsub_rn(__int_as_float(kMagicBits + v), kMagic);
}

// clip(round(v * scale), -127, 127), round half to even, in the low byte
// of the result: the product is clipped (which commutes with rounding at
// integer bounds), and the fp32 add of 1.5 * 2^23 rounds it to an integer.
// kRelu: v >= 0, no lower clip.
template <bool kRelu = false>
__device__ __forceinline__ int quant_bits(float v, float scale) {
  float p = fminf(__fmul_rn(v, scale), 127.f);
  if constexpr (!kRelu) p = fmaxf(p, -127.f);
  return __float_as_int(__fadd_rn(p, kMagic));
}

// 16 bf16 values (two 16-byte pieces) -> 16 int8, clip(round(v * scale))
__device__ __forceinline__ int4 quantize16(int4 lo, int4 hi, float scale) {
  const __nv_bfloat16* v0 = reinterpret_cast<const __nv_bfloat16*>(&lo);
  const __nv_bfloat16* v1 = reinterpret_cast<const __nv_bfloat16*>(&hi);
  int4 out;
  int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[i] = static_cast<int8_t>(quant_bits(__bfloat162float(v0[i]), scale));
    o[8 + i] =
        static_cast<int8_t>(quant_bits(__bfloat162float(v1[i]), scale));
  }
  return out;
}

using bf2 = __nv_bfloat162;

// K10's folded affine (common.cuh's affine<bf16>) on two channels at once:
// bf16(acc) from its exact fp32 value, times the bf16 scale, plus the bf16
// bias, each rounded once to bf16. A product of two bf16 values is exact in
// fp32, and so is a sum whose terms lie within 16 binades; a sum further
// apart moves the larger term by less than a quarter of its bf16 step. So
// rounding each bf16 operation once is the fp32 operation rounded to bf16,
// bit for bit, at half the instructions. The _rn forms keep the compiler
// from contracting the multiply and the add into one FMA (one rounding
// instead of two).
__device__ __forceinline__ bf2 affine2(float a0, float a1, bf2 eff,
                                       bf2 bias) {
  return __hadd2_rn(__hmul2_rn(__floats2bfloat162_rn(a0, a1), eff), bias);
}

// quant(relu(v)) of two bf16 values (quant_bits); the floor build's
// stand-in is the low bytes of their bits
template <bool kFloor>
__device__ __forceinline__ char2 relu_quant2(bf2 v, float scale) {
  char2 q;
  v = __hmax2(v, __floats2bfloat162_rn(0.f, 0.f));
  if constexpr (kFloor) {
    const uint32_t bits = *reinterpret_cast<const uint32_t*>(&v);
    q.x = static_cast<int8_t>(bits);
    q.y = static_cast<int8_t>(bits >> 16);
  } else {
    const float2 f = __bfloat1622float2(v);
    q.x = static_cast<int8_t>(quant_bits<true>(f.x, scale));
    q.y = static_cast<int8_t>(quant_bits<true>(f.y, scale));
  }
  return q;
}

__device__ __forceinline__ bf2 pair(const __nv_bfloat16* v, int n) {
  return *reinterpret_cast<const bf2*>(v + n);
}

template <int N>
__device__ __forceinline__ void zero(int (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0;
}

// copy ``rows`` rows of ``bytes`` (a multiple of 16) into a swizzled
// K-major region of 128-byte rows, at K byte offset ``k0`` (0 or 64)
__device__ __forceinline__ void stage_swizzled(unsigned char* dst, int rows,
                                               int row_chunk_bytes,
                                               const int8_t* src, int bytes,
                                               int k0) {
  const int pieces = bytes / 16;
  for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
    const int r = i / pieces;
    const int q = i - r * pieces + k0 / 16;
    cp_async16(dst + (q / 8) * row_chunk_bytes + sw128_offset(r, q % 8),
               src + static_cast<size_t>(i) * 16, 16);
  }
}

template <bool kFirst, bool kFloor>
__global__ void __launch_bounds__(kThreads, 1)
    layer1_block_kernel(const Layer1BlockArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~uintptr_t(kAlign - 1));
  constexpr int kCin = kFirst ? kPlanes : kExp;
  const Layout L = layer1_layout(kCin, a.lead, a.depth);
  unsigned char* s_w1 = base + L.w1;
  unsigned char* s_w3d = base + L.w3d;
  unsigned char* s_ring = base + L.ring;
  unsigned char* s_t2 = base + L.t2;
  int8_t* s_w2 = reinterpret_cast<int8_t*>(base + L.w2);
  int8_t* s_t1 = reinterpret_cast<int8_t*>(base + L.t1);
  int8_t* s_zero = reinterpret_cast<int8_t*>(base + L.zero);
  int8_t* s_out = reinterpret_cast<int8_t*>(base + L.out);
  __nv_bfloat16* eff1 = reinterpret_cast<__nv_bfloat16*>(base + L.vec);
  __nv_bfloat16* b1 = eff1 + kPlanes;
  __nv_bfloat16* eff2 = b1 + kPlanes;
  __nv_bfloat16* b2 = eff2 + kPlanes;
  __nv_bfloat16* eff3 = b2 + kPlanes;
  __nv_bfloat16* b3 = eff3 + kExp;
  __nv_bfloat16* effd = b3 + kExp;
  __nv_bfloat16* bd = effd + kExp;

  const int tid = threadIdx.x;
  const int wg = tid / kWg;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int W = a.w, H = a.h;
  const int hw = H * W;
  const int lead = a.lead, depth = a.depth;
  const int strips_per_image = (H + a.strip_rows - 1) / a.strip_rows;
  const int strips = a.batch * strips_per_image;
  // wgmma's accumulator layout (hopper.cuh): rows acc_row + {0, 8},
  // columns 8j + acc_col + {0, 1}
  const int acc_row = 16 * (tid % kWg / 32) + lane / 4;
  const int acc_col = 2 * (lane % 4);

  // the scales, in fp32 at the JAX package's rounding points
  const float a_in = fmaxf(*a.a_in, 1e-12f);
  const float a_t1 = fmaxf(*a.a_t1, 1e-12f);
  const float a_t2 = fmaxf(*a.a_t2, 1e-12f);
  const float a_out = fmaxf(*a.a_out, 1e-12f);
  const float step_in = __fmul_rn(a_in, capf::kRecip127);
  const float q_in = __fdiv_rn(127.f, a_in);
  const float q_t1 = __fdiv_rn(127.f, a_t1);
  const float q_t2 = __fdiv_rn(127.f, a_t2);
  const float q_out = __fdiv_rn(127.f, a_out);
  const __nv_bfloat16 deq1 = __float2bfloat16(step_in);
  const bf2 deq = {deq1, deq1};
  // the folded scales and biases, bf16 values (folded_scale rounds)
  auto bf = [](float v) { return __float2bfloat16(v); };
  for (int i = tid; i < kPlanes; i += kThreads) {
    eff1[i] = bf(folded_scale<__nv_bfloat16>(a.sc1[i], a.ws1[i], step_in));
    b1[i] = bf(a.bi1[i]);
    eff2[i] = bf(folded_scale<__nv_bfloat16>(a.sc2[i], a.ws2[i],
                              __fmul_rn(a_t1, capf::kRecip127)));
    b2[i] = bf(a.bi2[i]);
  }
  for (int i = tid; i < kExp; i += kThreads) {
    eff3[i] = bf(folded_scale<__nv_bfloat16>(a.sc3[i], a.ws3[i],
                              __fmul_rn(a_t2, capf::kRecip127)));
    b3[i] = bf(a.bi3[i]);
    if constexpr (kFirst) {
      effd[i] = bf(folded_scale<__nv_bfloat16>(a.scd[i], a.wsd[i], step_in));
      bd[i] = bf(a.bid[i]);
    }
  }
  if (tid < kT1Pitch / 16) {
    reinterpret_cast<int4*>(s_zero)[tid] = make_int4(0, 0, 0, 0);
  }
  // the weights, once: they join the first strip's first input tile's group
  stage_swizzled(s_w1, kPlanes, kATile, a.w1, kCin, 0);
  for (int i = tid; i < kPlanes * (9 * kPlanes / 16); i += kThreads) {
    const int r = i / (9 * kPlanes / 16);
    const int q = i - r * (9 * kPlanes / 16);
    cp_async16(s_w2 + r * kW2Pitch + q * 16, a.w2 + i * 16, 16);
  }
  stage_swizzled(s_w3d, kExp, 0, a.w3, kPlanes, 0);
  if constexpr (kFirst) {
    stage_swizzled(s_w3d, kExp, 0, a.wd, kPlanes, kPlanes);
  }

  for (int strip = blockIdx.x; strip < strips; strip += gridDim.x) {
    const int img = strip / strips_per_image;
    const int r0 = (strip - img * strips_per_image) * a.strip_rows;
    const int p0 = r0 * W;  // the strip's first pixel in its image
    const int owned = min(a.strip_rows, H - r0) * W;
    const int tiles = (owned + kBM - 1) / kBM;
    const int n_in = tiles + 2 * lead;  // input and t1 tiles of the strip
    const unsigned char* img_in =
        static_cast<const unsigned char*>(a.x) +
        static_cast<size_t>(img) * hw * (L.stage / kBM);

    // step i's input tile: the strip's tile i - lead (pixels outside the
    // image are zeros), into ring slot i % in_slots
    auto load_input = [&](int i) {
      constexpr int kPieces = kFirst ? 2 * kPlanes / 16 : kExp / 16;
      unsigned char* slot = s_ring + (i % L.in_slots) * L.stage;
      const int pix0 = p0 + (i - lead) * kBM;
      for (int e = tid; e < kBM * kPieces; e += kThreads) {
        const int r = e / kPieces;
        const int q = e - r * kPieces;
        const int p = pix0 + r;
        const bool in = p >= 0 && p < hw;
        cp_async16(slot + (q / 8) * kATile + sw128_offset(r, q % 8),
                   in ? img_in + static_cast<size_t>(p) * (L.stage / kBM) +
                            q * 16
                      : img_in,
                   in ? 16 : 0);
      }
    };
    for (int i = 0; i < depth; ++i) {
      if (i < n_in) load_input(i);
      cp_async_commit();
    }

#pragma unroll 1
    for (int i = 0; i < n_in; ++i) {
      if (i + depth < n_in) load_input(i + depth);
      cp_async_commit();
      if (depth == 1) {
        cp_async_wait<1>();
      } else if (depth == 2) {
        cp_async_wait<2>();
      } else {
        cp_async_wait<3>();
      }
      fence_proxy_async();
      __syncthreads();  // step i's input tile (and the weights) landed
      unsigned char* in_tile = s_ring + (i % L.in_slots) * L.stage;
      if constexpr (kFirst) {
        // bf16 -> int8 in place: 4 lanes a pixel, 16 channels each (the
        // first 8 warps; a warp holds whole pixels)
        if (tid < 4 * kBM) {
          const int r = tid / 4, q = tid % 4;
          const int4 lo = *reinterpret_cast<const int4*>(
              in_tile + sw128_offset(r, 2 * q));
          const int4 hi = *reinterpret_cast<const int4*>(
              in_tile + sw128_offset(r, 2 * q + 1));
          __syncwarp();  // a pixel's pieces are read before any is written
          *reinterpret_cast<int4*>(in_tile + sw128_offset(r, q)) =
              quantize16(lo, hi, q_in);
        }
        fence_proxy_async();
        __syncthreads();
      }

      // conv1 over input tile i - lead -> t1 slot i % t1_slots; each
      // warpgroup 16 of the 64 channels
      {
        int acc[8];
        zero(acc);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kCin / 32; ++ks) {
          wgmma_s8_n16(
              acc, sw128_desc(in_tile + (ks / 4) * kATile + (ks % 4) * 32),
              sw128_desc(s_w1 + (ks / 4) * kATile + wg * 16 * kChunk +
                         (ks % 4) * 32));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        int8_t* t1 = s_t1 + (i % L.t1_slots) * kBM * kT1Pitch;
        const int pix0 = p0 + (i - lead) * kBM;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = wg * 16 + 8 * j + acc_col;
          const bf2 eff = pair(eff1, n), bias = pair(b1, n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = acc_row + 8 * h;
            char2 q = {0, 0};
            if (pix0 + r >= 0 && pix0 + r < hw) {
              q = relu_quant2<kFloor>(
                  affine2(exact_float(acc[4 * j + 2 * h]),
                          exact_float(acc[4 * j + 2 * h + 1]), eff, bias),
                  q_t1);
            }
            *reinterpret_cast<char2*>(t1 + r * kT1Pitch + n) = q;
          }
        }
      }
      __syncthreads();  // t1 tile i - lead complete
      if (i < 2 * lead) continue;  // the strip's first t1 tiles

      // conv2 for output tile k = i - 2 lead: pixel p reads t1 at
      // p + dy W + dx for taps (dy, dx) in {-1, 0, 1}^2, zero past the
      // image's sides (the rows above and below are zero tiles of t1); a
      // warp takes 16 pixels x 16 channels
      const int k = i - 2 * lead;
      {
        const int mt = warp % 4;  // 16 pixels
        const int nq = warp / 4;  // 16 channels
        const int ar = 16 * mt + lane % 8 + 8 * ((lane / 8) % 2);
        const int a_byte = 16 * (lane / 16);
        const int rel = (k + lead) * kBM + ar;  // in t1 ring positions
        const int px = (p0 + k * kBM + ar) % W;
        const int slot0 = k % L.t1_slots;  // of ring tile k
        // ring position s in [k * 64, (k + 2 lead + 1) * 64) -> its row
        auto t1_row = [&](int s) {
          int slot = slot0 + (s / kBM - k);
          slot -= slot >= L.t1_slots ? L.t1_slots : 0;
          return s_t1 + (slot * kBM + s % kBM) * kT1Pitch;
        };
        const int8_t* b_row = s_w2 +
                              (16 * nq + 8 * (lane / 16) + lane % 8) *
                                  kW2Pitch +
                              16 * ((lane / 8) % 2);
        int acc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3 - 1;
          const int dx = tap % 3 - 1;
          const int8_t* src;
          if (kFloor) {
            src = t1_row(rel);
          } else {
            const bool ok = px + dx >= 0 && px + dx < W;
            src = ok ? t1_row(rel + dy * W + dx) : s_zero;
          }
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            uint32_t af[4], bf[4];
            ldmatrix_x4(af, src + kh * 32 + a_byte);
            ldmatrix_x4(bf, b_row + tap * kPlanes + kh * 32);
            const uint32_t b0[2] = {bf[0], bf[1]};
            const uint32_t b1f[2] = {bf[2], bf[3]};
            capf::mma_s8_16x8x32(acc[0], af, b0);
            capf::mma_s8_16x8x32(acc[1], af, b1f);
          }
        }
        // t2 (conv3's A: swizzled, 64 bytes of each row); conv2's sums reach
        // 576 * 127 * 128 > 2^22, past exact_float's range
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 16 * nq + 8 * j + 2 * (lane % 4);
          const bf2 eff = pair(eff2, n), bias = pair(b2, n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + lane / 4 + 8 * h;
            *reinterpret_cast<char2*>(s_t2 + sw128_offset(r, n / 16) +
                                      n % 16) =
                relu_quant2<kFloor>(
                    affine2(__int2float_rn(acc[j][2 * h]),
                            __int2float_rn(acc[j][2 * h + 1]), eff, bias),
                    q_t2);
          }
        }
      }
      fence_proxy_async();
      __syncthreads();  // t2 complete

      // conv3 (+ the downsample) + residual + ReLU + requant, each
      // warpgroup 64 of the 256 channels
      {
        const unsigned char* res_tile =
            s_ring + ((i - lead) % L.in_slots) * L.stage;
        int accd[32];  // the downsample (block 0)
        int acc[32];
        zero(acc);
        fence_regs(acc);
        if constexpr (kFirst) {
          zero(accd);
          fence_regs(accd);
        }
        wgmma_fence();
        if constexpr (kFirst) {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            wgmma_s8_n64(accd, sw128_desc(res_tile + ks * 32),
                         sw128_desc(s_w3d + wg * 64 * kChunk + kPlanes +
                                    ks * 32));
          }
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          wgmma_s8_n64(acc, sw128_desc(s_t2 + ks * 32),
                       sw128_desc(s_w3d + wg * 64 * kChunk + ks * 32));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if constexpr (kFirst) fence_regs(accd);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = wg * 64 + 8 * j + acc_col;
          const bf2 eff = pair(eff3, n), bias = pair(b3, n);
          bf2 effr, biasr;
          if constexpr (kFirst) {
            effr = pair(effd, n);
            biasr = pair(bd, n);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = acc_row + 8 * h;
            const int e = 4 * j + 2 * h;
            bf2 res;
            if constexpr (kFirst) {
              res = affine2(exact_float(accd[e]), exact_float(accd[e + 1]),
                            effr, biasr);
            } else {
              const char2 v = *reinterpret_cast<const char2*>(
                  res_tile + (n / 128) * kATile +
                  sw128_offset(r, (n % 128) / 16) + n % 16);
              res = __hmul2_rn(
                  __floats2bfloat162_rn(exact_float(v.x), exact_float(v.y)),
                  deq);
            }
            const bf2 y3 = affine2(exact_float(acc[e]),
                                   exact_float(acc[e + 1]), eff, bias);
            *reinterpret_cast<char2*>(s_out + r * kOutPitch + n) =
                relu_quant2<kFloor>(__hadd2_rn(y3, res), q_out);
          }
        }
      }
      __syncthreads();  // the output tile is staged

      // the tile's owned pixels, 16 bytes a thread
      const int valid = min(kBM, owned - k * kBM);
      int8_t* dst = a.out + (static_cast<size_t>(img) * hw + p0 +
                             static_cast<size_t>(k) * kBM) *
                                kExp;
      for (int e = tid; e < valid * (kExp / 16); e += kThreads) {
        const int r = e / (kExp / 16);
        const int c = (e - r * (kExp / 16)) * 16;
        *reinterpret_cast<int4*>(dst + static_cast<size_t>(r) * kExp + c) =
            *reinterpret_cast<const int4*>(s_out + r * kOutPitch + c);
      }
      // the next step's first barrier keeps the staged tile, t2 and the
      // ring slots read here from being refilled before these reads
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

template <bool kFirst, bool kFloor>
int launch_block(const Layer1BlockArgs& a, cudaStream_t stream) {
  const Layout L = layer1_layout(kFirst ? kPlanes : kExp, a.lead, a.depth);
  if (L.total > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = layer1_block_kernel<kFirst, kFloor>;
  cudaError_t err = capf::allow_smem(kernel, L.total);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid, kThreads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Layer1BlockArgs* args, bool floor, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Layer1BlockArgs& a = *args;
  const bool first = a.cin == kPlanes;
  // the schedule ops/layer1_chain.py::plan makes: conv1 leads by enough
  // tiles for the 3x3's halo (lead * 64 >= W + 1)
  if (a.batch < 1 || a.h < 1 || a.w < 1 || a.strip_rows < 1 ||
      a.lead < 1 || a.lead * kBM < a.w + 1 || a.depth < 1 || a.depth > 3 ||
      a.grid < 1 || (a.cin != kPlanes && a.cin != kExp) ||
      first != (a.wd != nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (first) {
    return floor ? launch_block<true, true>(a, stream)
                 : launch_block<true, false>(a, stream);
  }
  return floor ? launch_block<false, true>(a, stream)
               : launch_block<false, false>(a, stream);
}

}  // namespace

extern "C" int capf_layer1_block(const Layer1BlockArgs* args, int device,
                                 cudaStream_t stream) {
  return launch(args, false, device, stream);
}

extern "C" int capf_layer1_block_floor(const Layer1BlockArgs* args,
                                       int device, cudaStream_t stream) {
  return launch(args, true, device, stream);
}
