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
// Bound: memory (the ten layers of yolov8-LD-P2 at batch 8, 640 px move 446
// MB, 0.13 ms at the card's rate). Each output value costs four source loads
// and nine float operations; the positions, weights and corners cost some 150
// operations more, but only once per (pixel, n). Measured on an H100: 0.26 ms on
// the seeded model's smooth offsets (F.grid_sample on the same positions: 0.39
// ms), 0.53 ms on offsets that scatter a warp's corners over many lines
// (F.grid_sample: 0.49 ms), where the L1 hit rate of the corner loads decides.
// An earlier kernel ran one thread per (pixel, n, channel) with channels
// innermost: every thread redid the positions, and a warp's corner loads fell
// on 32 channel planes, one sector each; it took 0.73 ms on either.
//
// Design: one block per tile of T consecutive output pixels of one image,
// all N points, all C channels.
// 1. T*N threads compute one sample each (positions, the four products of
//    weights, the four corners, the multiplier) into shared memory; their
//    offset loads run along pixels, as the offsets lie.
// 2. A warp takes 32 neighbouring pixels of one sampling point, keeps their
//    samples in registers and loops over channels: the four corner loads of
//    a warp fall into a few sectors of one or two rows of one channel plane,
//    as the library's grid_sample reads. Each value goes into a [T][N*C]
//    tile in shared memory (row length odd, so the column writes spread over
//    the banks).
// 3. out is (B, h*w, N*C), so the tile is one contiguous run of T*N*C
//    floats: the block writes it with neighbouring lanes on neighbouring
//    addresses.
// T is the largest of 256, 128, 64, 32 whose tile stays within 16 KB: eight
// blocks then share an SM and leave half of its 256 KB as L1, which offsets
// that scatter a warp's corners over many lines need (a 32 KB tile was as fast
// on the model's smooth offsets and 19% slower on random ones). Every weight and product is rounded
// explicitly, in the order of the plain PyTorch version (no contracted
// multiply-add), so the kernel agrees with it bit for bit.
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

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_WARPS = GATHER_THREADS / 32;
constexpr int SAMPLE_WORDS = 9;  // per (pixel, n) in shared memory: 4 weights, 4 corners, the multiplier

// The row length of the shared-memory tile: odd, so that 32 pixels of one column hit 32 banks.
__host__ __device__ inline int tile_row(int nc) { return nc | 1; }

// T: pixels per tile, a multiple of 32. slices: the channels of a (32 pixels, n) unit are dealt to this
// many warps, so that every warp of the block has work.
__global__ void __launch_bounds__(GATHER_THREADS)
ldconv_gather_kernel(const float* __restrict__ x, const float* __restrict__ off, float* __restrict__ out, Geom g,
                     int T, int slices) {
  extern __shared__ __align__(16) float smem[];
  const int NC = g.N * g.C, hw = g.h * g.w, row = tile_row(NC), TN = T * g.N;
  float* tile = smem;  // [T][row]
  float* w00 = tile + T * row;
  float* w01 = w00 + TN;
  float* w10 = w01 + TN;
  float* w11 = w10 + TN;
  float* mul = w11 + TN;
  int* i00 = reinterpret_cast<int*>(mul + TN);
  int* i01 = i00 + TN;
  int* i10 = i01 + TN;
  int* i11 = i10 + TN;
  const int b = blockIdx.y, p0 = blockIdx.x * T;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // 1. the samples, n-major: q = n * T + pixel. Past the image's last pixel the last one again.
  for (int q = threadIdx.x; q < TN; q += GATHER_THREADS) {
    const int n = q / T;
    const Sample s = sample_at(off, g, b, min(p0 + q - n * T, hw - 1), n);
    w00[q] = __fmul_rn(s.wr0, s.wc0);
    w01[q] = __fmul_rn(s.wr0, s.wc1);
    w10[q] = __fmul_rn(s.wr1, s.wc0);
    w11[q] = __fmul_rn(s.wr1, s.wc1);
    mul[q] = s.mul;
    i00[q] = s.i00;
    i01[q] = s.i01;
    i10[q] = s.i10;
    i11[q] = s.i11;
  }
  __syncthreads();

  // 2. the values: a unit is 32 neighbouring pixels of one n, an item one slice of a unit's channels
  const int units = TN / 32;
  const long long plane = static_cast<long long>(g.H) * g.W;
  for (int item = warp; item < units * slices; item += GATHER_WARPS) {
    const int q = (item % units) * 32 + lane, first = item / units;
    const int n = q / T;
    const float a00 = w00[q], a01 = w01[q], a10 = w10[q], a11 = w11[q], m = mul[q];
    const int j00 = i00[q], j01 = i01[q], j10 = i10[q], j11 = i11[q];
    float* cell = tile + (q - n * T) * row + n * g.C;
    const float* xc = x + (static_cast<long long>(b) * g.C + first) * plane;
#pragma unroll 4
    for (int c = first; c < g.C; c += slices, xc += slices * plane) {
      float v = __fmul_rn(a00, xc[j00]);
      v = __fadd_rn(v, __fmul_rn(a01, xc[j01]));
      v = __fadd_rn(v, __fmul_rn(a10, xc[j10]));
      v = __fadd_rn(v, __fmul_rn(a11, xc[j11]));
      cell[c] = __fmul_rn(v, m);
    }
  }
  __syncthreads();

  // 3. the tile is one contiguous run of out
  const int pixels = min(T, hw - p0);
  float* o = out + (static_cast<long long>(b) * hw + p0) * NC;
  if (row == NC) {
    for (int i = threadIdx.x; i < pixels * NC; i += GATHER_THREADS) o[i] = tile[i];
  } else {
    for (int p = warp; p < pixels; p += GATHER_WARPS)
      for (int j = lane; j < NC; j += 32) o[p * NC + j] = tile[p * row + j];
  }
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
  if (B == 0 || h * w == 0 || N * C == 0) return static_cast<int>(cudaSuccess);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int NC = N * C;
  int T = 256;  // the largest tile of at most 16 KB: what shared memory leaves is L1, which scattered offsets need
  while (T > 32 && T * NC > 4096) T /= 2;
  const size_t smem = (static_cast<size_t>(T) * tile_row(NC) + static_cast<size_t>(SAMPLE_WORDS) * T * N) * sizeof(float);
  if (smem > 48 * 1024) {  // wide layers: above 227 KB (N*C beyond about 1,800) the launch is refused
    const cudaError_t e = cudaFuncSetAttribute(ldconv_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // units * slices is the least common multiple of the units and the block's warps
  const int units = T * N / 32;
  int gcd = units, r = GATHER_WARPS;
  while (r) {
    const int t = gcd % r;
    gcd = r;
    r = t;
  }
  const dim3 grid((h * w + T - 1) / T, B);
  ldconv_gather_kernel<<<grid, GATHER_THREADS, smem, stream>>>(x, off, out, g, T, GATHER_WARPS / gcd);
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
