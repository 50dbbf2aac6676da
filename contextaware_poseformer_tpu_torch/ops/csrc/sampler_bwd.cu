// K6: backward of the multi-level bilinear point sampler (K1).
//
// Replaces contextaware_poseformer_tpu/ops/deformable.py::_bwd_kernel_multi
// (body _sample_bwd_body, reached through _multi_bwd_pallas), the JAX
// package's Pallas backward of sample_points_multi.
//
// Contract (ops/deformable.py sample_points_multi_backward_reference): given
// the upstream gradient g (B, P, C) of each level's samples,
//   dF[tap]  += w_tap * g                      (only when dF is requested)
//   dx        = sum_c g * ((1-wy)(F01-F00) + wy(F11-F10)) * sx * mx
//   dy        = sum_c g * ((1-wx)(F10-F00) + wx(F11-F01)) * sy * my
// where F_k is tap k's row (zero for a tap outside the map, zeros padding),
// sx = dx_pixel/dx_normalized and mx the gradient of the border clamp with
// jnp.clip's 0.5 tie at an exact edge (1 in zeros mode).
//
// What bounds it on the H100: the tap reads, as in K1 (4 rows of C channels
// per point, 16 bytes a lane), plus with dF one fp32 atomic add per tap and
// channel. The TPU kernel builds one-hot (HW, P) mixing matrices for its
// matrix unit, ~HW/4 times the needed work on a GPU; here each point
// recomputes K1's unnormalize, clamp and floor and touches only its 4 taps.
// A warp takes one point at a time: its lanes read consecutive 16-byte
// channel groups, and d(point) is a warp reduction over the channels. dF
// goes through atomics into a zeroed fp32 buffer because the 16 samples
// around a joint land on the same pixels; the wrapper casts it to the map
// dtype afterwards. Needs C divisible by 8 (bf16) or 4 (fp32) and 16-byte
// aligned maps and gradients.
//
// Grid: (point tiles, levels, batch); block: kThreads threads.

#include "common.cuh"

using capf::to_float;
using capf::unnormalize;
using capf::warp_sum;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // points per block

}  // namespace

extern "C" {

struct CapfSampleBwdLevel {
  const void* feat;  // (B, H, W, C) NHWC, in the call's dtype
  const void* grad;  // (B, P, C) upstream gradient, in the call's dtype
  float* dfeat;      // (B, H, W, C) fp32, zeroed by the caller, or null
  int h, w, c;
};

struct CapfSampleBwdArgs {
  const float* points;  // (B, L, P, 2) fp32, x then y
  float* dpoints;       // (B, L, P, 2) fp32
  CapfSampleBwdLevel levels[kMaxLevels];
  int num_levels, batch, num_points, border, align_corners, dtype;
};

}  // extern "C"

namespace {

// Gradient of jnp.clip(v, 0, top) at v: 1 inside, 0 outside, 0.5 at an
// exact edge (min and max split a tie evenly).
__device__ __forceinline__ float clip_grad(float v, float top) {
  const float up = 0.5f * ((v < top ? 1.f : 0.f) + (v <= top ? 1.f : 0.f));
  const float lo = 0.5f * ((v > 0.f ? 1.f : 0.f) + (v >= 0.f ? 1.f : 0.f));
  return up * lo;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = to_float(v[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sample_levels_bwd_kernel(const CapfSampleBwdArgs args) {
  constexpr int kVec = 16 / sizeof(T);
  const int lvl = blockIdx.y;
  const int b = blockIdx.z;
  const int tile0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const CapfSampleBwdLevel lv = args.levels[lvl];
  const int num_points = args.num_points;
  const int h = lv.h, w = lv.w, c = lv.c;
  const bool border = args.border != 0;
  const bool align = args.align_corners != 0;
  const int n_tile = min(kTile, num_points - tile0);
  const int groups = c / kVec;

  const T* feat = static_cast<const T*>(lv.feat) +
                  static_cast<size_t>(b) * h * w * c;
  float* dfeat = lv.dfeat == nullptr
                     ? nullptr
                     : lv.dfeat + static_cast<size_t>(b) * h * w * c;

  for (int pl = warp; pl < n_tile; pl += kWarps) {
    const int p = tile0 + pl;
    const size_t pidx =
        (static_cast<size_t>(b) * args.num_levels + lvl) * num_points + p;
    float x = unnormalize(args.points[pidx * 2], w, align);
    float y = unnormalize(args.points[pidx * 2 + 1], h, align);
    const float sx = align ? 0.5f * static_cast<float>(w - 1) : 0.5f * w;
    const float sy = align ? 0.5f * static_cast<float>(h - 1) : 0.5f * h;
    float mx = 1.f, my = 1.f;
    if (border) {
      mx = clip_grad(x, static_cast<float>(w - 1));
      my = clip_grad(y, static_cast<float>(h - 1));
      x = fminf(fmaxf(x, 0.f), static_cast<float>(w - 1));
      y = fminf(fmaxf(y, 0.f), static_cast<float>(h - 1));
    } else {
      // as in K1: keeps the int conversion defined; beyond one step outside
      // the map every tap is outside, so the gradient is 0 either way
      x = fminf(fmaxf(x, -2.f), static_cast<float>(w + 1));
      y = fminf(fmaxf(y, -2.f), static_cast<float>(h + 1));
    }
    const float x0f = floorf(x), y0f = floorf(y);
    const float wx = x - x0f, wy = y - y0f;
    const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
    // taps 00, 01, 10, 11 = (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1)
    const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
    const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
    const float ws[4] = {(1.f - wy) * (1.f - wx), (1.f - wy) * wx,
                         wy * (1.f - wx), wy * wx};
    bool in[4];
    size_t rows[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      in[k] = ys[k] >= 0 && ys[k] < h && xs[k] >= 0 && xs[k] < w;
      rows[k] = in[k] ? static_cast<size_t>(ys[k] * w + xs[k]) * c : 0;
    }

    const T* g = static_cast<const T*>(lv.grad) +
                 (static_cast<size_t>(b) * num_points + p) * c;
    float gx = 0.f, gy = 0.f;
    for (int grp = lane; grp < groups; grp += 32) {
      const int ch = grp * kVec;
      float gv[kVec];
      load_vec(g + ch, gv);
      float f[4][kVec];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (in[k]) {
          load_vec(feat + rows[k] + ch, f[k]);
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v) f[k][v] = 0.f;
        }
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        gx += gv[v] * ((1.f - wy) * (f[1][v] - f[0][v]) +
                       wy * (f[3][v] - f[2][v]));
        gy += gv[v] * ((1.f - wx) * (f[2][v] - f[0][v]) +
                       wx * (f[3][v] - f[1][v]));
      }
      if (dfeat != nullptr) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!in[k]) continue;
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            atomicAdd(dfeat + rows[k] + ch + v, ws[k] * gv[v]);
          }
        }
      }
    }
    gx = warp_sum(gx);
    gy = warp_sum(gy);
    if (lane == 0) {
      args.dpoints[pidx * 2] = gx * (sx * mx);
      args.dpoints[pidx * 2 + 1] = gy * (sy * my);
    }
  }
}

template <typename T>
cudaError_t launch(const CapfSampleBwdArgs& args, cudaStream_t stream) {
  const dim3 grid((args.num_points + kTile - 1) / kTile, args.num_levels,
                  args.batch);
  sample_levels_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int capf_sample_levels_bwd(const CapfSampleBwdArgs* args,
                                      int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (args->num_levels < 1 || args->num_levels > kMaxLevels ||
      args->num_points < 1 || args->batch < 1) {
    return cudaErrorInvalidValue;
  }
  const int vec = args->dtype == capf::kBFloat16 ? 8 : 4;
  for (int l = 0; l < args->num_levels; ++l) {
    if (args->levels[l].c % vec != 0) return cudaErrorInvalidValue;
  }
  if (args->dtype == capf::kBFloat16) {
    err = launch<__nv_bfloat16>(*args, stream);
  } else {
    err = launch<float>(*args, stream);
  }
  return static_cast<int>(err);
}
