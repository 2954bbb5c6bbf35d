// DFL decode: softmax expectation over reg_max bins, read in place from the
// box channels of an NCHW Detect head map.
//
// Replaces experiment_yolo_tpu/ops/pallas/dfl_decode.py:_fwd_kernel (reached
// through dfl_decode_pallas). The TPU kernel packed two anchors per 128-lane
// row and reduced with a segment matmul; on Hopper that packing buys nothing.
//
// Bound: memory. Each (anchor, side) reads reg_max floats once and writes one
// float; the arithmetic (a max, reg_max exps, two sums) is far below the
// card's rate. Design: one thread per (anchor, side), neighbouring threads on
// neighbouring anchors, so each of the reg_max bin loads of a warp is one
// contiguous 128-byte line of the channel plane (channel stride A = H*W in the
// NCHW map, no transpose or copy first). Max, exp, both sums in f32 registers,
// one division.
#include <math.h>
#include "common.cuh"

__global__ void dfl_decode_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  int A, long long batch_stride, int reg_max) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int side = blockIdx.y;
  const int b = blockIdx.z;
  if (a >= A) return;
  const float* p = x + b * batch_stride + static_cast<long long>(side) * reg_max * A + a;
  float m = -INFINITY;
  for (int r = 0; r < reg_max; ++r) m = fmaxf(m, p[static_cast<long long>(r) * A]);
  float num = 0.f, den = 0.f;
  for (int r = 0; r < reg_max; ++r) {
    const float e = expf(p[static_cast<long long>(r) * A] - m);
    num += e * static_cast<float>(r);
    den += e;
  }
  out[(static_cast<long long>(b) * A + a) * 4 + side] = num / den;
}

// x: (B, no, H, W) f32 contiguous, box channels first (no >= 4*reg_max);
// out: (B, A, 4) f32 with A = H*W.
extern "C" int dfl_decode_launch(const float* x, float* out, int B, int A,
                                 long long batch_stride, int reg_max, cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((A + threads - 1) / threads, 4, B);
  dfl_decode_kernel<<<grid, threads, 0, stream>>>(x, out, A, batch_stride, reg_max);
  return static_cast<int>(cudaGetLastError());
}
