// Shared C entry point of the port's kernel library: turns the
// cudaError_t that every launcher returns into its message.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
