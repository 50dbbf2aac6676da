// Error text for the codes the kernel entry points return, and an empty
// kernel: the launch floor that a timer of this library's kernels reads
// (chip_smoke.py times it beside K8, whose calls are launch latency).
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* capf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// one block of 32 threads that does nothing, on the caller's stream
extern "C" int capf_empty(int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
