// Shared by every kernel library of this package.
#pragma once
#include <cuda_runtime.h>

// Each library exports this so its Python wrapper can name a failed launch.
extern "C" const char* ey_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
