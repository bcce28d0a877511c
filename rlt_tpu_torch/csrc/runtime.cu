// Helpers of the kernels' shared library that are not kernels.

#include <cuda_runtime.h>

// The CUDA runtime's message for an error code a launcher returned.
extern "C" const char* rlt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
