// DFL decode: softmax expectation over reg_max bins, read in place from the
// box channels of an NCHW Detect head map, and its analytic backward.
//
// Replaces experiment_yolo_tpu/ops/pallas/dfl_decode.py:_fwd_kernel and
// _bwd_kernel (reached through dfl_decode_pallas). The TPU kernels packed two
// anchors per 128-lane row and reduced with a segment matmul; on Hopper that
// packing buys nothing.
//
// Bound: memory. Each (anchor, side) reads reg_max floats once and writes one
// float; the arithmetic (a max, reg_max exps, two sums) is far below the
// card's rate. Design: one thread per (anchor, side), neighbouring threads on
// neighbouring anchors, so each of the reg_max bin loads of a warp is one
// contiguous 128-byte line of the channel plane (channel stride A = H*W in the
// NCHW map, no transpose or copy first). Max, exp, both sums in f32 registers,
// one division.
//
// bf16 forms (the maps of a bf16 model): the same kernels templated on the
// map's type. A bf16 logit is widened exactly (__bfloat162float) and every
// operation after it is the f32 form's, as the Pallas kernels widen a bf16
// input first; the forward writes f32 distances, the backward rounds dx once
// to bf16 (__float2bfloat16_rn). They read half the map's bytes.
#include <math.h>
#include "common.cuh"

template <typename T>
__global__ void dfl_decode_kernel(const T* __restrict__ x, float* __restrict__ out,
                                  int A, long long batch_stride, int reg_max) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int side = blockIdx.y;
  const int b = blockIdx.z;
  if (a >= A) return;
  const T* p = x + b * batch_stride + static_cast<long long>(side) * reg_max * A + a;
  float m = -INFINITY;
  for (int r = 0; r < reg_max; ++r) m = fmaxf(m, widen(p[static_cast<long long>(r) * A]));
  float num = 0.f, den = 0.f;
  for (int r = 0; r < reg_max; ++r) {
    const float e = expf(widen(p[static_cast<long long>(r) * A]) - m);
    num += e * static_cast<float>(r);
    den += e;
  }
  out[(static_cast<long long>(b) * A + a) * 4 + side] = num / den;
}

template <typename T>
static int dfl_decode_run(const T* x, float* out, int B, int A, long long batch_stride, int reg_max,
                          cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((A + threads - 1) / threads, 4, B);
  dfl_decode_kernel<T><<<grid, threads, 0, stream>>>(x, out, A, batch_stride, reg_max);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, no, H, W) f32 contiguous, box channels first (no >= 4*reg_max);
// out: (B, A, 4) f32 with A = H*W.
extern "C" int dfl_decode_launch(const float* x, float* out, int B, int A,
                                 long long batch_stride, int reg_max, cudaStream_t stream) {
  return dfl_decode_run(x, out, B, A, batch_stride, reg_max, stream);
}

// The same with x bf16; out stays f32.
extern "C" int dfl_decode_bf16_launch(const __nv_bfloat16* x, float* out, int B, int A,
                                      long long batch_stride, int reg_max, cudaStream_t stream) {
  return dfl_decode_run(x, out, B, A, batch_stride, reg_max, stream);
}

// Backward: with p = softmax(x) over one (anchor, side) group and y its
// expectation, d x_r = p_r * g * (r - y). Nothing of the forward's softmax is
// saved: each thread recomputes its group's max and denominator from x, reads
// the saved y and the incoming g once, and writes reg_max gradients into the
// box channels of an NCHW map of the head's shape (the caller zeroes the
// class channels). Bound: memory, about 2*reg_max + 2 floats per group; the
// layout is the forward's, so every bin load and store of a warp is one
// contiguous line.
template <typename T>
__global__ void dfl_decode_bwd_kernel(const T* __restrict__ x, const float* __restrict__ y,
                                      const float* __restrict__ g, T* __restrict__ dx,
                                      int A, long long batch_stride, int reg_max) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int side = blockIdx.y;
  const int b = blockIdx.z;
  if (a >= A) return;
  const long long base = b * batch_stride + static_cast<long long>(side) * reg_max * A + a;
  const T* p = x + base;
  T* d = dx + base;
  float m = -INFINITY;
  for (int r = 0; r < reg_max; ++r) m = fmaxf(m, widen(p[static_cast<long long>(r) * A]));
  float den = 0.f;
  for (int r = 0; r < reg_max; ++r) den += expf(widen(p[static_cast<long long>(r) * A]) - m);
  const long long o = (static_cast<long long>(b) * A + a) * 4 + side;
  const float yv = y[o], gv = g[o];
  const float inv_den = 1.f / den;
  for (int r = 0; r < reg_max; ++r) {
    const float pr = expf(widen(p[static_cast<long long>(r) * A]) - m) * inv_den;
    store(d + static_cast<long long>(r) * A, pr * gv * (static_cast<float>(r) - yv));
  }
}

template <typename T>
static int dfl_decode_bwd_run(const T* x, const float* y, const float* g, T* dx, int B, int A,
                              long long batch_stride, int reg_max, cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((A + threads - 1) / threads, 4, B);
  dfl_decode_bwd_kernel<T><<<grid, threads, 0, stream>>>(x, y, g, dx, A, batch_stride, reg_max);
  return static_cast<int>(cudaGetLastError());
}

// x, dx: (B, no, H, W) f32 contiguous, box channels first; y, g: (B, A, 4) f32.
extern "C" int dfl_decode_bwd_launch(const float* x, const float* y, const float* g, float* dx, int B, int A,
                                     long long batch_stride, int reg_max, cudaStream_t stream) {
  return dfl_decode_bwd_run(x, y, g, dx, B, A, batch_stride, reg_max, stream);
}

// The same with x and dx bf16; y and g stay f32.
extern "C" int dfl_decode_bwd_bf16_launch(const __nv_bfloat16* x, const float* y, const float* g, __nv_bfloat16* dx,
                                          int B, int A, long long batch_stride, int reg_max, cudaStream_t stream) {
  return dfl_decode_bwd_run(x, y, g, dx, B, A, batch_stride, reg_max, stream);
}
