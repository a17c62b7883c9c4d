// The text of a CUDA error code, for the Python wrappers' exceptions.
#include "common.cuh"

MMSEG_API const char* mmseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
