// Error text for the codes the kernel entry points return.
#include "common.cuh"

extern "C" const char* capf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
