// The float convolutions' epilogue: BN affine, optional residual add and
// optional ReLU in one pass over a dense NHWC tensor of T (bf16 or fp32):
//
//   out = relu?(T(T(y * scale + bias) + residual?))
//
// It replaces no TPU kernel. The JAX package's ConvBN
// (contextaware_poseformer_tpu/models/backbone_common.py) and its block
// tails (models/hrnet.py, models/cpn.py: relu(y + residual)) leave this
// chain to XLA, which fuses it into the convolution's output; in PyTorch
// it ran as up to four elementwise passes after cuDNN's convolution
// (addcmul, add, relu), each reading and writing the whole tensor.
//
// Arithmetic: the chain's, bit for bit. torch.addcmul on the card computes
// bias + y * scale from the T operands as one fp32 FMA (its kernel's
// a + value * b * c, contracted; value is 1), rounded once to T: measured
// equal to the exact product and sum rounded once on every fp32 element
// of a stem-sized tensor, and not to a multiply then an add (72.6%). For
// bf16 operands the product is exact in fp32, so both agree there. The
// residual add is an fp32 add of two T values rounded to T; the ReLU is
// torch.relu's clamp_min, which passes a NaN through and takes
// fmaxf(v, 0) otherwise (so -0 comes out as fmaxf gives it).
//
// Bound: bytes. y and the residual are read once and out written once,
// (2 or 3) * numel * sizeof(T) bytes at 3.35 TB/s; scale and bias are C
// values each. What the design does about it:
// - 16-byte loads and stores (8 bf16 or 4 fp32 values), neighbouring
//   threads on neighbouring vectors;
// - a thread takes kUnroll vectors of one channel group (one vector of a
//   pixel): they lie a stride apart that is a multiple of the groups a
//   pixel (ops/conv_epilogue.py::plan), so it loads that group's scale and
//   bias once, into fp32 registers;
// - the kUnroll loads of y (and of the residual) are issued before any
//   arithmetic, so each thread has that many 16-byte loads in flight;
// - one pass a thread, on as many blocks as the tensor takes: the SMs
//   take up new blocks as others drain. A grid of 3 blocks an SM walking
//   the tensor in a loop ran 3-8% slower at the served shapes (a thread's
//   next loads cannot pass its stores, which may alias them), and neither
//   2 nor 8 vectors a thread, nor a register cap, moved the time by more
//   than 2%;
// - where C is not a multiple of the vector's values, or a tensor does not
//   start on a 16-byte boundary, a scalar body takes a value a thread.
// out may be y itself: ConvBN writes in place into the convolution's fresh
// output (each element is read before the same thread writes it).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // ops/conv_epilogue.py THREADS
constexpr int kUnroll = 4;     // ops/conv_epilogue.py UNROLL

template <typename T>
struct Vec {
  static constexpr int kValues = 16 / sizeof(T);
};

// 16 bytes of T -> floats
__device__ __forceinline__ void unpack(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float* f,
                                       __nv_bfloat16) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = words[i];
    const float2 p = __bfloat1622float2(h);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// floats (each already a T value) -> 16 bytes of T
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint32_t words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    words[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// one value: the affine (one FMA) rounded to T, the residual added and
// rounded to T, the ReLU; the result is a T value
template <typename T, bool kRes, bool kRelu>
__device__ __forceinline__ float epilogue(float y, float s, float b,
                                          float r) {
  float v = capf::round_to<T>(__fmaf_rn(y, s, b));
  if (kRes) v = capf::round_to<T>(__fadd_rn(v, r));
  if (kRelu && !isnan(v)) v = fmaxf(v, 0.f);
  return v;
}

// the vector body: vecs 16-byte vectors, groups of them a pixel; thread t
// (t < stride) takes vectors t + k * stride (k < kUnroll) of channel group
// t % groups, since stride is a multiple of groups
template <typename T, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(const uint4* y, const T* __restrict__ scale,
                         const T* __restrict__ bias,
                         const uint4* __restrict__ res, uint4* out,
                         long long vecs, int groups, long long stride) {
  constexpr int kN = Vec<T>::kValues;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= stride) return;
  uint4 yv[kUnroll], rv[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = t + k * stride;
    if (i < vecs) {
      yv[k] = y[i];
      if (kRes) rv[k] = res[i];
    }
  }
  const int c0 = static_cast<int>(t % groups) * kN;
  float s[kN], b[kN];
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    s[e] = capf::to_float(scale[c0 + e]);
    b[e] = capf::to_float(bias[c0 + e]);
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = t + k * stride;
    if (i >= vecs) break;
    float f[kN], r[kN] = {};
    unpack(yv[k], f, T());
    if (kRes) unpack(rv[k], r, T());
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      f[e] = epilogue<T, kRes, kRelu>(f[e], s[e], b[e], r[e]);
    }
    out[i] = pack(f, T());
  }
}

// the scalar body: a thread a value of n, of c channels
template <typename T, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_scalar_kernel(const T* y, const T* __restrict__ scale,
                                const T* __restrict__ bias,
                                const T* __restrict__ res, T* out,
                                long long n, int c) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int ch = static_cast<int>(i % c);
  const float v = epilogue<T, kRes, kRelu>(
      capf::to_float(y[i]), capf::to_float(scale[ch]),
      capf::to_float(bias[ch]), kRes ? capf::to_float(res[i]) : 0.f);
  out[i] = capf::from_float<T>(v);
}

template <typename T, bool kRes, bool kRelu>
void launch(const void* y, const void* scale, const void* bias,
            const void* res, void* out, long long pixels, int c, int width,
            long long stride, int blocks, cudaStream_t stream) {
  const T* sc = static_cast<const T*>(scale);
  const T* bi = static_cast<const T*>(bias);
  if (width == 1) {
    conv_epilogue_scalar_kernel<T, kRes, kRelu><<<blocks, kThreads, 0,
                                                  stream>>>(
        static_cast<const T*>(y), sc, bi, static_cast<const T*>(res),
        static_cast<T*>(out), pixels * c, c);
  } else {
    const int groups = c / width;
    conv_epilogue_kernel<T, kRes, kRelu><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint4*>(y), sc, bi, static_cast<const uint4*>(res),
        static_cast<uint4*>(out), pixels * groups, groups, stride);
  }
}

template <typename T>
int run(const void* y, const void* scale, const void* bias, const void* res,
        void* out, long long pixels, int c, int relu, int width,
        long long stride, int blocks, cudaStream_t stream) {
  // the plan (ops/conv_epilogue.py::plan) as this build reads it: a vector
  // of 16 bytes on aligned tensors whose C it divides, stride a multiple of
  // the groups a pixel and kUnroll vectors a thread covering the tensor;
  // or the scalar body, a thread a value
  const bool vec = width == Vec<T>::kValues;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  const long long work = vec ? stride : pixels * c;
  if (pixels < 1 || c < 1 || stride < 1 || (width != 1 && !vec) ||
      1LL * blocks * kThreads < work ||
      (vec && (c % width || stride % (c / width) ||
               kUnroll * stride < pixels * (c / width) || misaligned(y) ||
               misaligned(out) || (res && misaligned(res))))) {
    return cudaErrorInvalidValue;
  }
  if (res) {
    if (relu) {
      launch<T, true, true>(y, scale, bias, res, out, pixels, c, width,
                            stride, blocks, stream);
    } else {
      launch<T, true, false>(y, scale, bias, res, out, pixels, c, width,
                             stride, blocks, stream);
    }
  } else if (relu) {
    launch<T, false, true>(y, scale, bias, res, out, pixels, c, width, stride,
                           blocks, stream);
  } else {
    launch<T, false, false>(y, scale, bias, res, out, pixels, c, width,
                            stride, blocks, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (y, scale, bias, residual or null, out, pixels, C, dtype (common.cuh
// DType), relu, width, stride, blocks, device, stream); out may be y
extern "C" int capf_conv_epilogue(const void* y, const void* scale,
                                  const void* bias, const void* res,
                                  void* out, long long pixels, int c,
                                  int dtype, int relu, int width,
                                  long long stride, int blocks, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype == capf::kBFloat16) {
    return run<__nv_bfloat16>(y, scale, bias, res, out, pixels, c, relu,
                              width, stride, blocks, stream);
  }
  if (dtype == capf::kFloat32) {
    return run<float>(y, scale, bias, res, out, pixels, c, relu, width,
                      stride, blocks, stream);
  }
  return cudaErrorInvalidValue;
}
