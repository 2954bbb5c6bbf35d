// Shared by every kernel library of this package.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// A value of a kernel's input type as f32 (a bf16 widens exactly), and an f32
// result stored in the output's type (bf16 rounded to nearest even).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Each library exports this so its Python wrapper can name a failed launch.
extern "C" const char* ey_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
