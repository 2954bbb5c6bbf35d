// The bf16 type the shared header names; the emulated kernels do not compute in it.
#pragma once
struct __nv_bfloat16 { unsigned short bits; };
inline float __bfloat162float(__nv_bfloat16) { return 0.f; }
inline __nv_bfloat16 __float2bfloat16_rn(float) { return {}; }
