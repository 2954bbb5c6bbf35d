// LDConv bilinear gather: offsets -> positions -> clamped corners -> bilinear
// weights x the border multiplier -> sampled features, in one pass.
//
// Replaces experiment_yolo_tpu/ops/pallas/ldconv_kernel.py:_gather_kernel
// (reached through bilinear_gather_single) with the semantics the JAX LDConv
// runs in production: ldconv_gather_packed's forward (nn/modules.py:457)
// times LDConv._border_mul (nn/modules.py:665), in the float order of
// LDConv._gather_all. For output pixel (i, j) and sampling point n with grid
// point (gn_r, gn_c) and learned offset (o_r, o_c), in the coordinates of the
// source edge-padded by R rows/cols before and pad_r/pad_c after:
//   pr  = float(i*stride + R + gn_r) + o_r,   prc = clamp(pr, 0, Hp-1)
//   r0  = floor(prc),  r1 = min(r0+1, Hp-1),  wr1 = prc - r0,  wr0 = 1 - wr1
// (columns alike); the padded row r reads source row clamp(r - R, 0, H-1), and
// the sample is scaled by 2 for each axis whose pr - R lies outside [0, H-1)
// (the reference fork's out-of-border double count).
//
// Bound: memory. Each output value costs four source loads and a handful of
// flops. Design: one thread per (output pixel, n, channel), channels
// innermost, so a warp writes one contiguous run of the (B, h*w, N*C)
// n-major output and the threads of one (pixel, n) share their offset loads.
// The source stays NCHW as the convolutions leave it, so neighbouring
// channels of a corner sit H*W apart; the four corner reads are not
// coalesced and lean on L1/L2 for the reuse between neighbouring pixels.
// Every weight and product is rounded explicitly (no contracted multiply-add)
// so the kernel agrees with the plain PyTorch version bit for bit.
//
// The backward (ldconv_gather_bwd_launch) is the counterpart of the JAX
// custom VJP _ldconv_gather_bwd (nn/modules.py:469), composed with the border
// multiplier, which is a step function and has no gradient of its own. With
// d = dy * multiplier for one (pixel, n, channel):
//   dx[corner] += d * corner weight   (scatter-add into the unpadded source:
//                                      clamped corners land on the edge pixel,
//                                      the transpose of the edge padding)
//   dpr += d * ((x10 - x00) * wc0 + (x11 - x01) * wc1)
//   dpc += d * ((x01 - x00) * wr0 + (x11 - x10) * wr1)
// summed over channels; each offset gradient is kept where its unclamped
// padded position lies in [0, size_padded - 1], inclusive (on a rail it
// passes whole), and is 0 outside. Bound: memory. Design: one thread per
// (pixel, n), pixels innermost so that a warp's offset loads, corner loads
// and atomics fall on neighbouring pixels of one channel plane; each thread
// loops over the C channels with dpr and dpc in registers and issues four f32
// atomicAdds per channel, whose order varies from run to run.
#include <math.h>
#include "common.cuh"

struct Geom {
  int B, C, H, W, h, w, N, base, stride, R, Hp, Wp;
};

// Where sample n of output pixel p = (i, j) reads: unclamped padded position,
// bilinear weights, source corners (row-major offsets into one channel plane)
// and the border multiplier.
struct Sample {
  float pr, pc, wr0, wr1, wc0, wc1, mul;
  int i00, i01, i10, i11;
};

__device__ __forceinline__ Sample sample_at(const float* __restrict__ off, const Geom& g, int b, int p, int n) {
  const int hw = g.h * g.w;
  const int i = p / g.w, j = p % g.w;
  // the grid point of n: row-major over `base` columns, remainder on the last row
  const int full = (g.N / g.base) * g.base;
  const int gn_r = n < full ? n / g.base : g.N / g.base;
  const int gn_c = n < full ? n % g.base : n - full;

  const float* ob = off + static_cast<long long>(b) * 2 * g.N * hw;
  const float o_r = ob[static_cast<long long>(n) * hw + p];
  const float o_c = ob[static_cast<long long>(g.N + n) * hw + p];
  Sample s;
  s.pr = __fadd_rn(static_cast<float>(i * g.stride + g.R + gn_r), o_r);
  s.pc = __fadd_rn(static_cast<float>(j * g.stride + g.R + gn_c), o_c);

  const float prc = fminf(fmaxf(s.pr, 0.f), static_cast<float>(g.Hp - 1));
  const float pcc = fminf(fmaxf(s.pc, 0.f), static_cast<float>(g.Wp - 1));
  const float r0f = floorf(prc), c0f = floorf(pcc);
  s.wr1 = __fsub_rn(prc, r0f);
  s.wc1 = __fsub_rn(pcc, c0f);
  s.wr0 = __fsub_rn(1.f, s.wr1);
  s.wc0 = __fsub_rn(1.f, s.wc1);
  const int r0 = static_cast<int>(r0f), c0 = static_cast<int>(c0f);
  const int r1 = min(r0 + 1, g.Hp - 1), c1 = min(c0 + 1, g.Wp - 1);
  // padded -> source rows/cols (edge padding is a clamp)
  const int sr0 = min(max(r0 - g.R, 0), g.H - 1), sr1 = min(max(r1 - g.R, 0), g.H - 1);
  const int sc0 = min(max(c0 - g.R, 0), g.W - 1), sc1 = min(max(c1 - g.R, 0), g.W - 1);
  s.i00 = sr0 * g.W + sc0;
  s.i01 = sr0 * g.W + sc1;
  s.i10 = sr1 * g.W + sc0;
  s.i11 = sr1 * g.W + sc1;

  const float ar = __fsub_rn(s.pr, static_cast<float>(g.R)), ac = __fsub_rn(s.pc, static_cast<float>(g.R));
  const float mr = (ar < 0.f || ar >= static_cast<float>(g.H - 1)) ? 2.f : 1.f;
  const float mc = (ac < 0.f || ac >= static_cast<float>(g.W - 1)) ? 2.f : 1.f;
  s.mul = __fmul_rn(mr, mc);
  return s;
}

__global__ void ldconv_gather_kernel(const float* __restrict__ x, const float* __restrict__ off,
                                     float* __restrict__ out, Geom g, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = static_cast<int>(t % g.C);
  long long q = t / g.C;
  const int n = static_cast<int>(q % g.N);
  q /= g.N;
  const int hw = g.h * g.w;
  const int p = static_cast<int>(q % hw);
  const int b = static_cast<int>(q / hw);
  const Sample s = sample_at(off, g, b, p, n);

  const float* xc = x + (static_cast<long long>(b) * g.C + c) * g.H * g.W;
  float v = __fmul_rn(__fmul_rn(s.wr0, s.wc0), xc[s.i00]);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(s.wr0, s.wc1), xc[s.i01]));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(s.wr1, s.wc0), xc[s.i10]));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(s.wr1, s.wc1), xc[s.i11]));
  out[t] = __fmul_rn(v, s.mul);
}

__global__ void ldconv_gather_bwd_kernel(const float* __restrict__ x, const float* __restrict__ off,
                                         const float* __restrict__ dy, float* __restrict__ dx,
                                         float* __restrict__ doff, Geom g, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int hw = g.h * g.w;
  const int p = static_cast<int>(t % hw);
  const long long q = t / hw;
  const int n = static_cast<int>(q % g.N);
  const int b = static_cast<int>(q / g.N);
  const Sample s = sample_at(off, g, b, p, n);
  const float w00 = __fmul_rn(s.wr0, s.wc0), w01 = __fmul_rn(s.wr0, s.wc1);
  const float w10 = __fmul_rn(s.wr1, s.wc0), w11 = __fmul_rn(s.wr1, s.wc1);

  const long long plane = static_cast<long long>(g.H) * g.W;
  const float* xb = x + static_cast<long long>(b) * g.C * plane;
  float* dxb = dx + static_cast<long long>(b) * g.C * plane;
  const float* dyp = dy + (static_cast<long long>(b) * hw + p) * g.N * g.C + static_cast<long long>(n) * g.C;
  float dpr = 0.f, dpc = 0.f;
  for (int c = 0; c < g.C; ++c) {
    const float d = dyp[c] * s.mul;
    const float* xc = xb + c * plane;
    const float v00 = xc[s.i00], v01 = xc[s.i01], v10 = xc[s.i10], v11 = xc[s.i11];
    dpr += d * ((v10 - v00) * s.wc0 + (v11 - v01) * s.wc1);
    dpc += d * ((v01 - v00) * s.wr0 + (v11 - v10) * s.wr1);
    float* dxc = dxb + c * plane;
    atomicAdd(dxc + s.i00, w00 * d);
    atomicAdd(dxc + s.i01, w01 * d);
    atomicAdd(dxc + s.i10, w10 * d);
    atomicAdd(dxc + s.i11, w11 * d);
  }
  const bool in_r = s.pr >= 0.f && s.pr <= static_cast<float>(g.Hp - 1);
  const bool in_c = s.pc >= 0.f && s.pc <= static_cast<float>(g.Wp - 1);
  float* db = doff + static_cast<long long>(b) * 2 * g.N * hw;
  db[static_cast<long long>(n) * hw + p] = in_r ? dpr : 0.f;
  db[static_cast<long long>(g.N + n) * hw + p] = in_c ? dpc : 0.f;
}

// x: (B, C, H, W) f32; off: (B, 2N, h, w) f32, the first N channels row
// offsets and the last N column offsets; out: (B, h*w, N*C) f32, n-major.
extern "C" int ldconv_gather_launch(const float* x, const float* off, float* out, int B, int C, int H, int W,
                                    int h, int w, int N, int base, int stride, int R, int Hp, int Wp,
                                    cudaStream_t stream) {
  const Geom g{B, C, H, W, h, w, N, base, stride, R, Hp, Wp};
  const long long total = static_cast<long long>(B) * h * w * N * C;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks > 0) ldconv_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(x, off, out, g, total);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, C, H, W) f32; off: (B, 2N, h, w) f32; dy: (B, h*w, N*C) f32, n-major;
// dx: (B, C, H, W) f32, zeroed by the caller (the kernel adds into it);
// doff: (B, 2N, h, w) f32, every element written.
extern "C" int ldconv_gather_bwd_launch(const float* x, const float* off, const float* dy, float* dx, float* doff,
                                        int B, int C, int H, int W, int h, int w, int N, int base, int stride, int R,
                                        int Hp, int Wp, cudaStream_t stream) {
  const Geom g{B, C, H, W, h, w, N, base, stride, R, Hp, Wp};
  const long long total = static_cast<long long>(B) * N * h * w;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks > 0)
    ldconv_gather_bwd_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(x, off, dy, dx, doff, g, total);
  return static_cast<int>(cudaGetLastError());
}
