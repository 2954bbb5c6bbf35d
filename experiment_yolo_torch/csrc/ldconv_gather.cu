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
// passes whole), and is 0 outside.
//
// What bounds it: the adds into dx. The first kernel ran one thread
// per (pixel, n) over all C channels with four f32 atomics to device memory
// per (sample, channel); on an H100, of its 0.84 ms per training step (the dx
// fill included) the atomics took 0.35 ms on smooth offsets, 2.1 of 2.8 ms on
// offsets that scatter a warp's corners, and 7.1 of 7.7 ms when most samples
// land on a few source pixels (adds to one address queue in L2, layer 0
// alone 3.1 ms). An atomic add costs L2 one operation per 32-byte sector it
// touches, so the design cuts the adds and the sectors they touch:
// 1. One thread per (pixel, n, slice of channels), pixels fastest, as before:
//    a warp's offset loads, corner loads and adds fall on neighbouring pixels
//    of one channel plane. Wide layers of few pixels (C = 64, 128 at 40 x 40)
//    split their channels over threads until the layer has 270,336 of them
//    (two thousand a SM), at least 8 channels each; the slices' offset
//    gradients then meet in doff by atomic adds after a zero fill. Where h*w
//    is no multiple of 32 a warp holds pixels of two images, sampling points
//    or slices; every lane runs the same number of channels, and the
//    exchanges below compare cells by their place in dx, the slice's first
//    channel plane included, so lanes of two slices never merge.
// 2. Each sample's two corners of a row are neighbouring cells A, A + 1, and
//    neighbouring lanes' cells follow each other. Decided once per thread
//    from its neighbours' corners (shuffles), then applied per channel: a
//    lane whose B cell is the next lane's A takes that lane's value (stride
//    1: one add where there were two), a lane whose A is even adds A and B as
//    one 8-byte reduction, and a lane whose B is even and whose next lane's A
//    is B + 1 adds that pair as one (stride 2, odd A). Smooth offsets so turn
//    four 4-byte adds a sample into two 8-byte ones that fill their sectors.
// What bounds it now, as measured on the H100: still the adds. On the
// model's smooth offsets the ten LD-P2 layers take about three times their
// bytes bound, the dx fill a tenth of that; on scattered offsets the adds
// still fall on one sector each, about ten times the bound. PERF.md has the
// times per layer.
// Two other designs were slower and were left out: a warp-level combine of
// lanes that add into one pixel (__match_any_sync, one add per pixel), which
// cut the time by a third when four source pixels took most of a layer's
// samples but cost every warp its check; and a window per tile in shared
// memory, flushed with 16-byte adds (a float atomic add on shared memory is a
// compare-and-swap loop on this card, and the windows' set-up, clearing and
// flushing cost more than the sectors they saved). PERF.md has the times.
// dx is zeroed by the caller. The products per channel are those of the
// plain version; sums run in another order, and the adds' order varies from
// run to run.
//
// bf16 forms (the sources of a bf16 model, ldconv_gather_bf16_launch and
// ldconv_gather_bwd_bf16_launch). The JAX LDConv's bf16 gather
// (nn/modules.py:694-704, 800-805) widens the bf16 corners and weighs them
// with f32 weights, so the sums and the border multiplier stay f32: the
// forward widens each corner exactly, does the f32 form's arithmetic bit for
// bit and rounds the product with the multiplier once to bf16 (the rounding
// the JAX LDConv's bf16 projection makes of its input); the backward reads
// the bf16 incoming gradient and source widened, sums dx in f32 and rounds it
// once to bf16 (the JAX VJP's astype), and writes doff in f32.
//
// The bf16 forward (ldconv_gather_bf16_kernel): the f32 form's three steps
// with a bf16 tile (rows of an odd number of 4-byte words; T by bytes, so a
// 16 KB tile holds twice the pixels, halved while the grid has fewer than two
// blocks a SM), samples packed in five words and taken one pixel a thread
// (one division a thread), and the tile leaving as 16-byte stores (4-byte
// reads of the tile where N*C is a multiple of 8). Measured on an H100 (the
// ten LD-P2 layers at batch 8, 640, smooth offsets, the earlier bf16 form in
// the same process): 0.217 ms against 0.222, the f32 form on the same
// positions 0.226; the bound is 0.071 ms (bytes). What bounds it is neither
// its bytes nor what changed: with parts of the earlier form removed, the
// samples alone took 0.078 ms, the stores 0.04, the corner loads 0.07; here
// 8 and 32 KB tiles moved the total by under 3%, and a row's two corners read
// as one 4-byte pair where every lane of a warp had (even A, A + 1) by 0.6%
// (left out). Left: a block's three dependent steps (offsets, then corners,
// then stores, a barrier between) at eight blocks a SM.
//
// The bf16 backward: the f32 form's kernel on bf16 data, its adds into f32
// sums in a scratch that the launch zeroes, then one rounding pass into dx
// (16-byte stores) in the same launch; where a lane's 8-byte add starts on a
// 16-byte boundary and the next lane's follows it, the two go as one 16-byte
// add (quads, row_plan). What bounds it: the adds (operations in L2), then
// zeroing and rounding the sums at device-memory rate. Measured as above:
// 0.686-0.702 ms against 0.718-0.728 for the earlier bf16 form (the same
// adds, its wrapper's f32 fill and cast); the quads 0.025 ms of that; the
// bound is 0.114 ms. Tried and left out, each slower on every kind of
// offsets: a dx cell owned by one block, written once in bf16 (a count, scan
// and fill put each sample in the bucket of each 4 x 16 source tile its
// corners touch; one block a tile sums its bucket in 64-bit fixed point, so
// any order of the adds gives the same bits, and each sample's doff comes
// from the tile of its corner 00): 1.33-2.92 ms on smooth offsets over four
// versions (64-bit shared-memory atomics, which are a compare-and-swap loop
// here, ATOMS.CAST.SPIN.64; cells owned by lanes, every warp walking every
// entry; two native 32-bit atomics an add), 8-24 ms on seam offsets, whose
// buckets hold thousands of entries for one block. Its walk took 0.5 ms of
// 1.17, the rest a block's fixed costs at about 64 entries a tile. And
// chunks of images whose sums stay in L2 (12 to 40 MB): 0.694-0.812 ms.
#include <math.h>

#include <type_traits>

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
  int sr0, sr1, sc0, sc1;  // the corners' source rows and columns
};

// The grid point (row, col) of sampling point n: row-major over `base` columns, remainder on the last row.
__device__ __forceinline__ int2 grid_point(const Geom& g, int n) {
  const int full = (g.N / g.base) * g.base;
  return n < full ? make_int2(n / g.base, n % g.base) : make_int2(g.N / g.base, n - full);
}

// The sample of output pixel (i, j) at grid point gn with raw offsets (o_r, o_c).
__device__ __forceinline__ Sample sample_from(float o_r, float o_c, int i, int j, int2 gn, const Geom& g) {
  const int gn_r = gn.x, gn_c = gn.y;
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
  s.sr0 = sr0;
  s.sr1 = sr1;
  s.sc0 = sc0;
  s.sc1 = sc1;

  const float ar = __fsub_rn(s.pr, static_cast<float>(g.R)), ac = __fsub_rn(s.pc, static_cast<float>(g.R));
  const float mr = (ar < 0.f || ar >= static_cast<float>(g.H - 1)) ? 2.f : 1.f;
  const float mc = (ac < 0.f || ac >= static_cast<float>(g.W - 1)) ? 2.f : 1.f;
  s.mul = __fmul_rn(mr, mc);
  return s;
}

__device__ __forceinline__ Sample sample_at(const float* __restrict__ off, const Geom& g, int b, int p, int n) {
  const int hw = g.h * g.w;
  const float* ob = off + static_cast<long long>(b) * 2 * g.N * hw;
  return sample_from(ob[static_cast<long long>(n) * hw + p], ob[static_cast<long long>(g.N + n) * hw + p], p / g.w,
                     p % g.w, grid_point(g, n), g);
}

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_WARPS = GATHER_THREADS / 32;
constexpr int SAMPLE_WORDS = 9;  // per (pixel, n) in shared memory: 4 weights, 4 corners, the multiplier

// The row length of the shared-memory tile: odd, so that 32 pixels of one column hit 32 banks.
__host__ __device__ inline int tile_row(int nc) { return nc | 1; }

// T: pixels per tile, a multiple of 32. slices: the channels of a (32 pixels, n) unit are dealt to this
// many warps, so that every warp of the block has work.
template <typename TX, typename TO>
__global__ void __launch_bounds__(GATHER_THREADS)
ldconv_gather_kernel(const TX* __restrict__ x, const float* __restrict__ off, TO* __restrict__ out, Geom g,
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
    const TX* xc = x + (static_cast<long long>(b) * g.C + first) * plane;
#pragma unroll 4
    for (int c = first; c < g.C; c += slices, xc += slices * plane) {
      float v = __fmul_rn(a00, widen(xc[j00]));
      v = __fadd_rn(v, __fmul_rn(a01, widen(xc[j01])));
      v = __fadd_rn(v, __fmul_rn(a10, widen(xc[j10])));
      v = __fadd_rn(v, __fmul_rn(a11, widen(xc[j11])));
      cell[c] = __fmul_rn(v, m);
    }
  }
  __syncthreads();

  // 3. the tile is one contiguous run of out
  const int pixels = min(T, hw - p0);
  TO* o = out + (static_cast<long long>(b) * hw + p0) * NC;
  if (row == NC) {
    for (int i = threadIdx.x; i < pixels * NC; i += GATHER_THREADS) store(o + i, tile[i]);
  } else {
    for (int p = warp; p < pixels; p += GATHER_WARPS)
      for (int j = lane; j < NC; j += 32) store(o + p * NC + j, tile[p * row + j]);
  }
}

// ---- backward ----

constexpr int BWD_THREADS = 256;
constexpr int BWD_MIN_THREADS = 270336;  // channels are split until a layer has this many threads (132 SMs x 2048)
constexpr int BWD_MIN_CHANNELS = 8;      // ... but a thread keeps at least this many

// One row's two cells of a sample, A (column c0) and B (column c1 = c0 + 1, or c0 where clamped), with
// values va and vb, added into the channel plane dxc. Neighbouring lanes hold neighbouring pixels of one
// row of the output, so their cells mostly follow each other: a lane whose B is the next lane's A takes
// that lane's value (merge), a lane whose A is even adds A and B as one 8-byte value (pair), and a lane
// whose B is even and whose next lane's A follows it adds B and that A as one (cross). row_plan decides
// once per thread; every value is added exactly once.
struct RowPlan {
  bool merge, pair, cross, taken;  // taken: this lane's A goes with the lane before it
  bool quad, quad_taken;  // bf16 form: this lane's 8-byte add and the next lane's as one 16-byte add
};

// QUADS (the bf16 form): a lane whose 8-byte add (pair or cross) starts on a 16-byte boundary, and whose next
// lane's starts two cells on, adds both as one 16-byte value, and the next lane skips its own.
template <bool QUADS>
__device__ __forceinline__ RowPlan row_plan(long long A, long long B, bool live, int lane, bool aligned,
                                            bool aligned4) {
  constexpr unsigned FULL = 0xffffffffu;
  const long long nextA = __shfl_down_sync(FULL, A, 1);
  const bool next_live = __shfl_down_sync(FULL, live, 1) && lane < 31;
  RowPlan r;
  r.merge = live && next_live && nextA == B;
  r.pair = aligned && live && B == A + 1 && (A & 1) == 0;
  r.cross = aligned && live && next_live && !r.merge && !r.pair && (B & 1) == 0 && nextA == B + 1;
  // a lane whose left neighbour merged or crossed gives its A to it; a lane with a pair keeps its A
  const bool left = __shfl_up_sync(FULL, r.merge || r.cross, 1) && lane > 0;
  r.taken = left;
  if (r.taken) r.pair = false;
  r.quad = r.quad_taken = false;
  if (QUADS) {
    const bool has2 = r.pair || r.cross;
    const long long X = r.pair ? A : B, nextX = __shfl_down_sync(FULL, X, 1);
    const bool next_has2 = __shfl_down_sync(FULL, has2, 1) && lane < 31;
    r.quad = aligned4 && has2 && next_has2 && nextX == X + 2 && (X & 3) == 0;
    r.quad_taken = __shfl_up_sync(FULL, r.quad, 1) && lane > 0;
  }
  return r;
}

template <bool QUADS>
__device__ __forceinline__ void add_row(float* __restrict__ dx, long long A, long long B, float va, float vb,
                                        const RowPlan& r, bool live) {
  constexpr unsigned FULL = 0xffffffffu;
  const float next_va = __shfl_down_sync(FULL, va, 1);
  const float b_sum = r.merge ? vb + next_va : vb;
  float n0 = 0.f, n1 = 0.f;  // the next lane's 8-byte add
  if (QUADS) {
    n0 = __shfl_down_sync(FULL, r.pair ? va : vb, 1);
    n1 = __shfl_down_sync(FULL, r.pair ? b_sum : next_va, 1);
  }
  if (!live) return;
  if (r.pair) {
    if (QUADS && r.quad)
      atomicAdd(reinterpret_cast<float4*>(dx + A), make_float4(va, b_sum, n0, n1));
    else if (!(QUADS && r.quad_taken))
      atomicAdd(reinterpret_cast<float2*>(dx + A), make_float2(va, b_sum));
    return;
  }
  if (!r.taken) atomicAdd(dx + A, va);
  if (r.cross) {
    if (QUADS && r.quad)
      atomicAdd(reinterpret_cast<float4*>(dx + B), make_float4(vb, next_va, n0, n1));
    else if (!(QUADS && r.quad_taken))
      atomicAdd(reinterpret_cast<float2*>(dx + B), make_float2(vb, next_va));
  } else {
    atomicAdd(dx + B, b_sum);
  }
}

// One thread per (pixel, n, slice of channels), pixels fastest: a warp's offset loads, corner loads and adds
// fall on neighbouring pixels of one channel plane.
template <typename TX, typename TD>
__global__ void __launch_bounds__(BWD_THREADS)
ldconv_gather_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ off, const TD* __restrict__ dy,
                         float* __restrict__ dx, float* __restrict__ doff, Geom g, long long total, int per_thread,
                         int slices) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const bool live = t < total;  // no early return: the lanes of a warp exchange values below
  const int hw = g.h * g.w;
  const long long tt = live ? t : total - 1;
  const int p = static_cast<int>(tt % hw);
  long long q = tt / hw;
  const int slice = static_cast<int>(q % slices);
  q /= slices;
  const int n = static_cast<int>(q % g.N);
  const int b = static_cast<int>(q / g.N);
  const Sample s = sample_at(off, g, b, p, n);
  const float w00 = __fmul_rn(s.wr0, s.wc0), w01 = __fmul_rn(s.wr0, s.wc1);
  const float w10 = __fmul_rn(s.wr1, s.wc0), w11 = __fmul_rn(s.wr1, s.wc1);

  const long long plane = static_cast<long long>(g.H) * g.W;
  const int c0 = slice * per_thread, c1 = min(g.C, c0 + per_thread);
  // The corners as offsets into dx from its plane of (image b, channel c0): a warp of a layer whose h*w is no
  // multiple of 32 holds two images or two channel slices, and their lanes' corners must never match.
  const long long first = (static_cast<long long>(b) * g.C + c0) * plane;
  const long long k00 = first + s.i00, k01 = first + s.i01, k10 = first + s.i10, k11 = first + s.i11;
  // 8-byte adds need every channel plane to start on an even float, 16-byte ones on a multiple of 4 floats
  const bool aligned = (plane & 1) == 0, aligned4 = (plane & 3) == 0;
  constexpr bool quads = !std::is_same<TX, float>::value;
  const RowPlan top = row_plan<quads>(k00, k01, live, lane, aligned, aligned4);
  const RowPlan bottom = row_plan<quads>(k10, k11, live, lane, aligned, aligned4);

  const TD* dyp = dy + (static_cast<long long>(b) * hw + p) * g.N * g.C + static_cast<long long>(n) * g.C + c0;
  const TX* xc = x + first;
  float* dxc = dx;  // plus a corner's offset: its cell in the plane of channel c0 + k
  float dpr = 0.f, dpc = 0.f;
  // Every lane runs per_thread channels, idle past c1 (the last slice may hold fewer), so that add_row's
  // shuffles find the whole warp. Lanes that exchange values share a slice, so they are idle together.
  for (int k = 0; k < per_thread; ++k, xc += plane, dxc += plane) {
    const bool on = live && c0 + k < c1;
    float d = 0.f;
    if (on) {
      d = widen(dyp[k]) * s.mul;
      const float v00 = widen(xc[s.i00]), v01 = widen(xc[s.i01]), v10 = widen(xc[s.i10]), v11 = widen(xc[s.i11]);
      dpr += d * ((v10 - v00) * s.wc0 + (v11 - v01) * s.wc1);
      dpc += d * ((v01 - v00) * s.wr0 + (v11 - v10) * s.wr1);
    }
    add_row<quads>(dxc, k00, k01, w00 * d, w01 * d, top, on);
    add_row<quads>(dxc, k10, k11, w10 * d, w11 * d, bottom, on);
  }
  if (!live) return;
  const bool in_r = s.pr >= 0.f && s.pr <= static_cast<float>(g.Hp - 1);
  const bool in_c = s.pc >= 0.f && s.pc <= static_cast<float>(g.Wp - 1);
  float* db = doff + static_cast<long long>(b) * 2 * g.N * hw;
  float* dr = db + static_cast<long long>(n) * hw + p;
  float* dc = db + static_cast<long long>(g.N + n) * hw + p;
  if (slices == 1) {
    *dr = in_r ? dpr : 0.f;
    *dc = in_c ? dpc : 0.f;
  } else {  // the slices' sums meet in doff, which the launch zeroed
    if (in_r) atomicAdd(dr, dpr);
    if (in_c) atomicAdd(dc, dpc);
  }
}

// ---- bf16 forms ----

// The row length of a bf16 [pixel][N*C] tile in shared memory, in elements: even, with an odd number of
// 4-byte words, so that 32 pixels of one column fall on 32 banks.
__host__ __device__ inline int tile_row_bf16(int nc) {
  const int r = (nc + 1) & ~1;
  return (r / 2) % 2 ? r : r + 2;
}

// A sample in shared memory: the four weight products, and one word holding corner 00 (bits 0-27), the column
// and row steps to the other corners (bits 28, 29: 0 where clamped) and log2 of the multiplier (bits 30-31).
constexpr int PACKED_WORDS = 5;

__device__ __forceinline__ int pack_corners(const Sample& s) {
  const unsigned mul_log2 = s.mul == 1.f ? 0u : s.mul == 2.f ? 1u : 2u;
  return static_cast<int>(static_cast<unsigned>(s.i00) | static_cast<unsigned>(s.sc1 - s.sc0) << 28 |
                          static_cast<unsigned>(s.sr1 - s.sr0) << 29 | mul_log2 << 30);
}

// The samples of T pixels of image b from p0 (T a power of two, at most GATHER_THREADS): each thread takes one
// pixel and every (GATHER_THREADS / T)-th sampling point, so its row and column divide once and its offset
// loads run along pixels. Past the image's last pixel the last one again.
__device__ __forceinline__ void packed_samples(const float* __restrict__ off, const Geom& g, int b, int p0, int T,
                                               float* w, int* corner) {
  const int hw = g.h * g.w, TN = T * g.N;
  const int px = threadIdx.x % T, p = min(p0 + px, hw - 1), i = p / g.w, j = p - i * g.w;
  const float* ob = off + static_cast<long long>(b) * 2 * g.N * hw + p;
  for (int n = threadIdx.x / T; n < g.N; n += GATHER_THREADS / T) {
    const Sample s = sample_from(ob[static_cast<long long>(n) * hw], ob[static_cast<long long>(g.N + n) * hw], i, j,
                                 grid_point(g, n), g);
    const int q = n * T + px;
    w[q] = __fmul_rn(s.wr0, s.wc0);
    w[TN + q] = __fmul_rn(s.wr0, s.wc1);
    w[2 * TN + q] = __fmul_rn(s.wr1, s.wc0);
    w[3 * TN + q] = __fmul_rn(s.wr1, s.wc1);
    corner[q] = pack_corners(s);
  }
}

// The bf16 forward: the f32 form's three steps with a bf16 tile. T: pixels per tile, a power of two from 32 to
// 256; slices as in the f32 form.
__global__ void __launch_bounds__(GATHER_THREADS)
ldconv_gather_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ off,
                          __nv_bfloat16* __restrict__ out, Geom g, int T, int slices) {
  extern __shared__ __align__(16) float smem[];
  const int NC = g.N * g.C, hw = g.h * g.w, row = tile_row_bf16(NC), TN = T * g.N;
  float* w = smem;                                                        // [4][TN] weight products
  int* corner = reinterpret_cast<int*>(w + 4 * TN);                       // [TN] packed corners
  unsigned short* tile = reinterpret_cast<unsigned short*>(corner + TN);  // [T][row] bf16 values
  const int b = blockIdx.y, p0 = blockIdx.x * T;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  packed_samples(off, g, b, p0, T, w, corner);
  __syncthreads();

  const int units = TN / 32;
  const long long plane = static_cast<long long>(g.H) * g.W;
  for (int item = warp; item < units * slices; item += GATHER_WARPS) {
    const int q = (item % units) * 32 + lane, first = item / units;
    const int n = q / T;
    const float a00 = w[q], a01 = w[TN + q], a10 = w[2 * TN + q], a11 = w[3 * TN + q];
    const unsigned pk = static_cast<unsigned>(corner[q]);
    const int j00 = pk & 0x0fffffff, j01 = j00 + (pk >> 28 & 1), j10 = j00 + static_cast<int>(pk >> 29 & 1) * g.W;
    const int j11 = j10 + (pk >> 28 & 1);
    const float m = static_cast<float>(1 << (pk >> 30));
    unsigned short* cell = tile + (q - n * T) * row + n * g.C;
    const __nv_bfloat16* xc = x + (static_cast<long long>(b) * g.C + first) * plane;
#pragma unroll 4
    for (int c = first; c < g.C; c += slices, xc += slices * plane) {
      float v = __fmul_rn(a00, __bfloat162float(xc[j00]));
      v = __fadd_rn(v, __fmul_rn(a01, __bfloat162float(xc[j01])));
      v = __fadd_rn(v, __fmul_rn(a10, __bfloat162float(xc[j10])));
      v = __fadd_rn(v, __fmul_rn(a11, __bfloat162float(xc[j11])));
      cell[c] = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(v, m)));
    }
  }
  __syncthreads();

  // 3. the tile's contiguous run of out as 16-byte stores of 8 values; the head before the first 16-byte
  // boundary and the ragged tail one by one
  const int total = min(T, hw - p0) * NC;
  unsigned short* o = reinterpret_cast<unsigned short*>(out + (static_cast<long long>(b) * hw + p0) * NC);
  const int head = min(total, static_cast<int>((16 - (reinterpret_cast<size_t>(o) & 15)) & 15) / 2);
  const int vecs = (total - head) / 8;
  if (NC % 8 == 0 && head == 0) {  // every piece lies in one row of the tile, at a 4-byte boundary (row is even)
    for (int v = threadIdx.x; v < vecs; v += GATHER_THREADS) {
      const int e = v * 8, p = e / NC;
      const unsigned* t = reinterpret_cast<const unsigned*>(tile + p * row + e - p * NC);
      *reinterpret_cast<uint4*>(o + e) = make_uint4(t[0], t[1], t[2], t[3]);
    }
    return;
  }
  for (int i = threadIdx.x; i < head; i += GATHER_THREADS) o[i] = tile[i / NC * row + i % NC];
  for (int v = threadIdx.x; v < vecs; v += GATHER_THREADS) {
    const int e = head + v * 8;
    int p = e / NC, j = e - p * NC;
    unsigned u[4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned t = tile[p * row + j];
      u[k / 2] = k % 2 ? u[k / 2] | t << 16 : t;
      if (++j == NC) {
        j = 0;
        ++p;
      }
    }
    *reinterpret_cast<uint4*>(o + e) = make_uint4(u[0], u[1], u[2], u[3]);
  }
  for (int i = head + vecs * 8 + threadIdx.x; i < total; i += GATHER_THREADS) o[i] = tile[i / NC * row + i % NC];
}

static int ldconv_gather_bf16_run(const __nv_bfloat16* x, const float* off, __nv_bfloat16* out, const Geom& g,
                                  cudaStream_t stream) {
  const int B = g.B, C = g.C, h = g.h, w = g.w, N = g.N;
  if (B == 0 || h * w == 0 || N * C == 0) return static_cast<int>(cudaSuccess);
  // corner 00 of a packed sample has 28 bits
  if (B > 65535 || static_cast<long long>(g.H) * g.W > (1 << 28)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int NC = N * C;
  // the largest tile of at most 16 KB of bf16 values, and at least two blocks a SM (small layers)
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    const cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (sms == 0) return static_cast<int>(e == cudaSuccess ? cudaErrorInvalidDevice : e);
  }
  int T = 256;
  while (T > 32 && (T * NC > 8192 || static_cast<long long>(B) * ((h * w + T - 1) / T) < 2LL * sms)) T /= 2;
  const size_t smem = static_cast<size_t>(PACKED_WORDS) * T * N * sizeof(float) +
                      static_cast<size_t>(T) * tile_row_bf16(NC) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(ldconv_gather_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int units = T * N / 32;
  int gcd = units, r = GATHER_WARPS;
  while (r) {
    const int t = gcd % r;
    gcd = r;
    r = t;
  }
  const dim3 grid((h * w + T - 1) / T, B);
  ldconv_gather_bf16_kernel<<<grid, GATHER_THREADS, smem, stream>>>(x, off, out, g, T, GATHER_WARPS / gcd);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 backward ----

// f32 sums of dx rounded once to bf16, 8 a thread: two 16-byte loads, one 16-byte store (src starts on a 16-byte
// boundary; where dst does not, and at the ragged end, one by one).
__global__ void __launch_bounds__(256)
ldconv_gather_bwd_bf16_round_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, long long n) {
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 8;
  if (i + 8 <= n && reinterpret_cast<size_t>(dst) % 16 == 0) {
    const float4 a = reinterpret_cast<const float4*>(src + i)[0], b = reinterpret_cast<const float4*>(src + i)[1];
    const __nv_bfloat162 q[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                                 __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
    *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(q);
  } else {
    for (long long j = i; j < n && j < i + 8; ++j) dst[j] = __float2bfloat16_rn(src[j]);
  }
}

template <typename TX, typename TO>
static int ldconv_gather_run(const TX* x, const float* off, TO* out, const Geom& g, cudaStream_t stream) {
  const int B = g.B, C = g.C, h = g.h, w = g.w, N = g.N;
  if (B == 0 || h * w == 0 || N * C == 0) return static_cast<int>(cudaSuccess);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int NC = N * C;
  int T = 256;  // the largest tile of at most 16 KB: what shared memory leaves is L1, which scattered offsets need
  while (T > 32 && T * NC > 4096) T /= 2;
  const size_t smem = (static_cast<size_t>(T) * tile_row(NC) + static_cast<size_t>(SAMPLE_WORDS) * T * N) * sizeof(float);
  if (smem > 48 * 1024) {  // wide layers: above 227 KB (N*C beyond about 1,800) the launch is refused
    const cudaError_t e = cudaFuncSetAttribute(ldconv_gather_kernel<TX, TO>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
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
  ldconv_gather_kernel<TX, TO><<<grid, GATHER_THREADS, smem, stream>>>(x, off, out, g, T, GATHER_WARPS / gcd);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, C, H, W) f32; off: (B, 2N, h, w) f32, the first N channels row
// offsets and the last N column offsets; out: (B, h*w, N*C) f32, n-major.
extern "C" int ldconv_gather_launch(const float* x, const float* off, float* out, int B, int C, int H, int W,
                                    int h, int w, int N, int base, int stride, int R, int Hp, int Wp,
                                    cudaStream_t stream) {
  return ldconv_gather_run(x, off, out, Geom{B, C, H, W, h, w, N, base, stride, R, Hp, Wp}, stream);
}

// The same with x and out bf16; off stays f32.
extern "C" int ldconv_gather_bf16_launch(const __nv_bfloat16* x, const float* off, __nv_bfloat16* out, int B, int C,
                                         int H, int W, int h, int w, int N, int base, int stride, int R, int Hp,
                                         int Wp, cudaStream_t stream) {
  return ldconv_gather_bf16_run(x, off, out, Geom{B, C, H, W, h, w, N, base, stride, R, Hp, Wp}, stream);
}

template <typename TX, typename TD>
static int ldconv_gather_bwd_run(const TX* x, const float* off, const TD* dy, float* dx, float* doff, const Geom& g,
                                 cudaStream_t stream) {
  const int B = g.B, C = g.C, h = g.h, w = g.w, N = g.N;
  if (B == 0 || h * w == 0 || N * C == 0) return static_cast<int>(cudaSuccess);
  // channels split over threads until the layer fills the card, each thread keeping BWD_MIN_CHANNELS or more
  const long long samples = static_cast<long long>(B) * N * h * w;
  const long long by_channels = (C + BWD_MIN_CHANNELS - 1) / BWD_MIN_CHANNELS;
  const long long by_threads = (BWD_MIN_THREADS + samples - 1) / samples;
  int slices = static_cast<int>(by_channels < by_threads ? by_channels : by_threads);
  if (slices < 1) slices = 1;
  const int per_thread = (C + slices - 1) / slices;
  slices = (C + per_thread - 1) / per_thread;
  const long long total = samples * slices;
  const long long blocks = (total + BWD_THREADS - 1) / BWD_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (slices > 1) {
    const cudaError_t e = cudaMemsetAsync(doff, 0, static_cast<size_t>(B) * 2 * N * h * w * sizeof(float), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ldconv_gather_bwd_kernel<TX, TD><<<static_cast<unsigned>(blocks), BWD_THREADS, 0, stream>>>(
      x, off, dy, dx, doff, g, total, per_thread, slices);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: the f32 sums of dx in the scratch, zeroed here, the adds above (with 16-byte quads), then one
// rounding pass into dx.
static int ldconv_gather_bwd_bf16_run(const __nv_bfloat16* x, const float* off, const __nv_bfloat16* dy,
                                      __nv_bfloat16* dx, float* doff, float* sums, long long sums_size, const Geom& g,
                                      cudaStream_t stream) {
  const long long n = static_cast<long long>(g.B) * g.C * g.H * g.W;
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (sums_size < n || reinterpret_cast<size_t>(sums) % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(sums, 0, static_cast<size_t>(n) * sizeof(float), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = ldconv_gather_bwd_run(x, off, dy, sums, doff, g, stream);
  if (rc) return rc;
  ldconv_gather_bwd_bf16_round_kernel<<<static_cast<unsigned>((n + 2047) / 2048), 256, 0, stream>>>(sums, dx, n);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, C, H, W) f32; off: (B, 2N, h, w) f32; dy: (B, h*w, N*C) f32, n-major;
// dx: (B, C, H, W) f32, zeroed by the caller (the kernel adds into it);
// doff: (B, 2N, h, w) f32, every element written.
extern "C" int ldconv_gather_bwd_launch(const float* x, const float* off, const float* dy, float* dx, float* doff,
                                        int B, int C, int H, int W, int h, int w, int N, int base, int stride, int R,
                                        int Hp, int Wp, cudaStream_t stream) {
  return ldconv_gather_bwd_run(x, off, dy, dx, doff, Geom{B, C, H, W, h, w, N, base, stride, R, Hp, Wp}, stream);
}

// x, dy, dx bf16 (dx: every element written); off, doff f32; sums: sums_size floats, 16-byte aligned, at least
// one per element of x (scratch for dx's f32 sums).
extern "C" int ldconv_gather_bwd_bf16_launch(const __nv_bfloat16* x, const float* off, const __nv_bfloat16* dy,
                                             __nv_bfloat16* dx, float* doff, float* sums, long long sums_size,
                                             int B, int C, int H, int W, int h, int w, int N, int base, int stride,
                                             int R, int Hp, int Wp, cudaStream_t stream) {
  return ldconv_gather_bwd_bf16_run(x, off, dy, dx, doff, sums, sums_size,
                                    Geom{B, C, H, W, h, w, N, base, stride, R, Hp, Wp}, stream);
}
