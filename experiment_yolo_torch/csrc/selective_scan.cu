// Selective scan (the Mamba state-space recurrence), all directions of a
// block in one call:
//
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t      state (D, N) per sequence
//   y_t = C_t . h_t + Dskip * x_t
//
// Replaces experiment_yolo_tpu/ops/pallas/selective_scan.py:_scan_kernel
// (reached through selective_scan_pallas), together with the D*x term that
// the JAX function adds outside its kernel, and with the reversal of the
// backward directions and the B/C slicing that SS2D does around it. The TPU
// kernel holds one whole (L, D) sequence and the (D, N) state in VMEM per
// program and walks L with a fori_loop.
//
// Bound on this card (H100 SXM, measured at B = 8, G = 4, L = 25,600, D = 32, where the call must
// move 367 MB: 0.11 ms at the card's memory rate): no single unit. The three passes take 0.27-0.31 ms
// there. Each of the two scans keeps the special-function units busy for 0.10 ms (one exp per (state,
// step), 16 a clock per SM, and a chunked scan computes each twice), reads its inputs from device
// memory again, and pulls B_t and C_t, 32 floats a step, out of shared memory into every lane. In
// throwaway builds (kernel_variants.py) the call was 8-16% faster without its exps, 3-5% without those
// shared-memory reads, 10-19% without its copies from device memory, and 1.7-2.4 times without all
// three: what bounds a pass is how well a scheduler's six warps overlap the three, not one of them.
// An earlier kernel ran one thread per (sequence, channel, state) and spent about 27 operations per
// (state, step) on repeated shared loads, expf's range reduction and a shuffle butterfly for the sum
// over states; it took 0.38-0.52 ms.
//
// Design:
// - One thread per (sequence, channel, chunk of L) with the channel's 16 states in registers: x_t and
//   dt_t are read once per channel, B_t and C_t are broadcast reads of shared memory, y_t is summed
//   inside the thread. exp(dt*A) is one multiply and one ex2.approx with A scaled by log2(e)
//   beforehand (expf, with its range reduction, made the call 1.65-1.78 times slower); for |dt*A| < 0.35
//   that is the very operation expf ends in, and a larger decay forgets its error within three steps.
//   Five operations per (state, step).
// - That leaves only B*G*D threads, so L is cut into chunks that run side by side, as many as fill
//   the card's resident warps once (the wrapper chooses the length). Pass 1
//   (selective_scan_kernel_ends) scans every chunk but the last from h = 0 and keeps its end state and
//   its sum of dt; pass 2 (selective_scan_kernel_carry) walks the chunks of each (sequence, channel,
//   state) in order, start_{c+1} = exp(A * sum dt_c) * start_c + end_c; pass 3
//   (selective_scan_kernel_outputs) scans every chunk again from its true start state and writes y. A
//   single chunk is pass 3 alone.
// - A warp is 32 neighbouring channels of one chunk and shares nothing with other warps. It streams
//   its steps through its own ring of STAGES tiles of TILE steps in shared memory, filled by cp.async
//   two tiles ahead, so no step waits for device memory and a block needs no barrier. A whole tile is
//   one branch-free block of code, so that the compiler overlaps neighbouring steps; only a chunk's
//   ragged last tile checks each step.
// - A reversed direction walks its steps from L-1 down and reads and writes index t, so its inputs
//   and its y are in the forward order and nobody flips them. x comes through a direction-to-source
//   index: a reversed direction reads its forward partner's x. B and C come with strides, straight out
//   of the projection that holds dt, B and C side by side; they are copied 16, 8 or 4 bytes at a time,
//   whatever their pointer and strides allow.
// - Tried and dropped, with their times at the four pyramid levels in PERF.md: two channels a thread
//   (half the shared-memory reads, but 128 registers and fewer warps), two stages, tiles of 4 steps,
//   four warps a block, a check on every step.
//
// The chunks change the float order of the carried state, and y is summed with fused multiply-adds,
// so the result agrees with the plain PyTorch version to about 3e-6 of the largest value on the seeded
// model's inputs (step sizes of 0.01), not bit for bit. The slower the decay, the longer a difference
// between ex2.approx and the plain version's exp lives in the state.
#include <math.h>
#include "common.cuh"

constexpr int N_STATE = 16;  // states per channel, all in one thread's registers
constexpr int LANES = 32;    // channels per warp
constexpr int WARPS = 2;     // warps per block, each on its own (chunk, channel group)
constexpr int TILE = 8;      // steps per stage of a warp's shared-memory ring
constexpr int STAGES = 3;    // stages: STAGES - 1 tiles are in flight while one is consumed
constexpr int CARRY = N_STATE + 1;  // floats kept per (chunk, channel): the end state and the sum of dt
constexpr float LOG2E = 1.4426950408889634f;

struct __align__(16) Stage {  // 3 KB: a block's 2 warps x 3 stages take 18 KB, and 12 blocks (24 warps) fit an SM
  float x[TILE][LANES], dt[TILE][LANES], b[TILE][N_STATE], c[TILE][N_STATE];
};

struct ScanArgs {
  const float *x, *dt, *A, *Bm, *Cm, *Dskip;
  float *y, *carry;
  int G, Gx, L, D;
  int b_sb, b_sg, b_sl, c_sb, c_sg, c_sl;  // strides of B and C in floats: batch, direction, step
  int reverse_mask, source_pack;           // bit g: direction g runs backwards; nibble g: its x direction
  int chunk_len, chunks;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// What one warp works on: 32 channels of one chunk of one (image, direction).
struct Work {
  const float *xs, *dts, *bs, *cs;  // at step 0 of the sequence, this lane's channel
  int lane, d, seq, g, chunk, s0, s1;
  bool live, rev;
};

__device__ __forceinline__ bool find_work(const ScanArgs& a, int chunks_run, Work& w) {
  const int groups = (a.D + LANES - 1) / LANES;
  const int item = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (item >= chunks_run * groups) return false;
  w.lane = threadIdx.x % LANES;
  w.chunk = item / groups;
  const int d = (item % groups) * LANES + w.lane;
  w.live = d < a.D;  // a ragged last group keeps its lanes for the copies
  w.d = w.live ? d : a.D - 1;
  w.seq = blockIdx.y;  // b * G + g
  w.g = w.seq % a.G;
  const long long b = w.seq / a.G;
  w.rev = (a.reverse_mask >> w.g) & 1;
  const int gx = (a.source_pack >> (4 * w.g)) & 15;
  w.s0 = w.chunk * a.chunk_len;
  w.s1 = min(w.s0 + a.chunk_len, a.L);
  w.xs = a.x + (b * a.Gx + gx) * a.L * a.D + w.d;
  w.dts = a.dt + static_cast<long long>(w.seq) * a.L * a.D + w.d;
  w.bs = a.Bm + b * a.b_sb + static_cast<long long>(w.g) * a.b_sg;
  w.cs = a.Cm + b * a.c_sb + static_cast<long long>(w.g) * a.c_sg;
  return true;
}

// Step s of a direction sits at index s of its sequence, or at L-1-s when it runs backwards.
__device__ __forceinline__ long long index_of(const Work& w, int s, int L) { return w.rev ? L - 1 - s : s; }

// Start the copy of steps s .. s+TILE-1 into one stage. Past the end of the chunk the last step is
// copied again and never used. VEC floats of B and C go in one copy.
template <int VEC, bool WITH_C>
__device__ __forceinline__ void load_tile(Stage& st, const ScanArgs& a, const Work& w, int s) {
  const long long t = index_of(w, s, a.L);
  const int dir = w.rev ? -1 : 1, last = min(TILE, w.s1 - s) - 1;
  const float* px = w.xs + t * a.D;
  const float* pdt = w.dts + t * a.D;
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    const int at = min(i, last) * dir * a.D;
    cp_async<4>(&st.x[i][w.lane], px + at);
    cp_async<4>(&st.dt[i][w.lane], pdt + at);
  }
  constexpr int PER_STEP = N_STATE / VEC;
  const float* pb = w.bs + t * a.b_sl;
  const float* pc = w.cs + t * a.c_sl;
#pragma unroll
  for (int k = w.lane; k < TILE * PER_STEP; k += LANES) {
    const int i = min(k / PER_STEP, last) * dir, j = (k % PER_STEP) * VEC;
    cp_async<4 * VEC>(&st.b[k / PER_STEP][j], pb + i * a.b_sl + j);
    if (WITH_C) cp_async<4 * VEC>(&st.c[k / PER_STEP][j], pc + i * a.c_sl + j);
  }
}

// The per-lane state of a scan: one channel's 16 states, their decays, its skip and its sum of dt.
struct Lane {
  float a2[N_STATE], h[N_STATE], dskip, dt_sum;
};

// The first `steps` steps of one tile, or all TILE of them when GUARD is false: the compiler then sees
// one block of TILE steps and overlaps the reads, exps and multiply-adds of neighbouring steps.
template <bool OUT, bool GUARD>
__device__ __forceinline__ void scan_tile(const ScanArgs& a, const Work& w, const Stage& st, Lane& r, int s,
                                          int steps, float* ys) {
  float tile_sum = 0.f;
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    if (GUARD && i >= steps) break;
    const float dtv = st.dt[i][w.lane], xv = st.x[i][w.lane];
    const float u = dtv * xv;
    const float4* b4 = reinterpret_cast<const float4*>(st.b[i]);
    const float4* c4 = reinterpret_cast<const float4*>(st.c[i]);
    float acc[4] = {r.dskip * xv, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < N_STATE / 4; ++q) {
      const float4 bq = b4[q];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
      float cv[4] = {0.f, 0.f, 0.f, 0.f};
      if (OUT) {
        const float4 cq = c4[q];
        cv[0] = cq.x, cv[1] = cq.y, cv[2] = cq.z, cv[3] = cq.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * q + j;
        r.h[n] = fmaf(r.h[n], ex2(dtv * r.a2[n]), u * bv[j]);
        if (OUT) acc[j] = fmaf(r.h[n], cv[j], acc[j]);
      }
    }
    if (OUT) {
      if (w.live) ys[index_of(w, s + i, a.L) * a.D] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    } else {
      tile_sum += dtv;
    }
  }
  r.dt_sum += tile_sum;  // tile by tile: the sum of 264 steps keeps the rounding of some 40 additions
}

// One chunk of 32 channels. OUT: from the chunk's true start state, writing y (pass 3). Otherwise from
// h = 0, keeping the end state and the sum of dt (pass 1).
template <int VEC, bool OUT>
__device__ __forceinline__ void scan_chunk(const ScanArgs& a, const Work& w, Stage* ring) {
  Lane r;
  // slot c of the carry: pass 1 leaves chunk c's end state there, pass 2 turns it into chunk c+1's start
  float* slot = a.carry + (static_cast<long long>(w.seq) * (a.chunks - 1) + (OUT ? w.chunk - 1 : w.chunk)) * CARRY * a.D + w.d;
  const float* arow = a.A + (static_cast<long long>(w.g) * a.D + w.d) * N_STATE;
#pragma unroll
  for (int n = 0; n < N_STATE; ++n) {
    r.a2[n] = arow[n] * LOG2E;
    r.h[n] = (OUT && w.chunk > 0) ? slot[static_cast<long long>(n) * a.D] : 0.f;
  }
  r.dskip = (OUT && a.Dskip) ? a.Dskip[static_cast<long long>(w.g) * a.D + w.d] : 0.f;
  r.dt_sum = 0.f;
  float* ys = a.y + static_cast<long long>(w.seq) * a.L * a.D + w.d;

  const int tiles = (w.s1 - w.s0 + TILE - 1) / TILE;
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < tiles) load_tile<VEC, OUT>(ring[k], a, w, w.s0 + k * TILE);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = 0; k < tiles; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));  // this lane's copies of tile k have landed
    __syncwarp();  // so have the other lanes', and every lane is done with tile k-1, whose stage is refilled next
    if (k + STAGES - 1 < tiles)
      load_tile<VEC, OUT>(ring[(k + STAGES - 1) % STAGES], a, w, w.s0 + (k + STAGES - 1) * TILE);
    asm volatile("cp.async.commit_group;\n" ::);
    const int s = w.s0 + k * TILE;
    if (s + TILE <= w.s1)
      scan_tile<OUT, false>(a, w, ring[k % STAGES], r, s, TILE, ys);
    else
      scan_tile<OUT, true>(a, w, ring[k % STAGES], r, s, w.s1 - s, ys);
  }
  if (!OUT && w.live) {
#pragma unroll
    for (int n = 0; n < N_STATE; ++n) slot[static_cast<long long>(n) * a.D] = r.h[n];
    slot[static_cast<long long>(N_STATE) * a.D] = r.dt_sum;
  }
}

template <int VEC>
__global__ void __launch_bounds__(WARPS * LANES) selective_scan_kernel_ends(ScanArgs a) {
  __shared__ Stage ring[WARPS][STAGES];
  Work w;
  if (find_work(a, a.chunks - 1, w)) scan_chunk<VEC, false>(a, w, ring[threadIdx.x / LANES]);
}

template <int VEC>
__global__ void __launch_bounds__(WARPS * LANES) selective_scan_kernel_outputs(ScanArgs a) {
  __shared__ Stage ring[WARPS][STAGES];
  Work w;
  if (find_work(a, a.chunks, w)) scan_chunk<VEC, true>(a, w, ring[threadIdx.x / LANES]);
}

// One thread per (sequence, state, channel), channels innermost as in the carry: the chunks in order,
// eight loaded ahead of the chain of multiply-adds.
__global__ void selective_scan_kernel_carry(ScanArgs a, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int d = static_cast<int>(t % a.D);
  const int n = static_cast<int>(t / a.D % N_STATE);
  const long long seq = t / a.D / N_STATE;
  const float an = a.A[((seq % a.G) * a.D + d) * N_STATE + n];
  const long long chunk_stride = static_cast<long long>(CARRY) * a.D;
  float* state = a.carry + seq * (a.chunks - 1) * chunk_stride + static_cast<long long>(n) * a.D + d;
  const float* sums = a.carry + seq * (a.chunks - 1) * chunk_stride + static_cast<long long>(N_STATE) * a.D + d;
  constexpr int AHEAD = 8;
  float h = 0.f;
  for (int c0 = 0; c0 < a.chunks - 1; c0 += AHEAD) {
    float end[AHEAD], sum[AHEAD];
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      const int c = min(c0 + j, a.chunks - 2);
      end[j] = state[c * chunk_stride];
      sum[j] = sums[c * chunk_stride];
    }
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      if (c0 + j < a.chunks - 1) {
        h = fmaf(expf(an * sum[j]), h, end[j]);
        state[(c0 + j) * chunk_stride] = h;
      }
    }
  }
}

template <int VEC>
static int launch_passes(const ScanArgs& a, int B, cudaStream_t stream) {
  const int groups = (a.D + LANES - 1) / LANES;
  const dim3 block(WARPS * LANES);
  if (a.chunks > 1) {
    const dim3 grid(((a.chunks - 1) * groups + WARPS - 1) / WARPS, B * a.G);
    selective_scan_kernel_ends<VEC><<<grid, block, 0, stream>>>(a);
    const long long total = static_cast<long long>(B) * a.G * N_STATE * a.D;
    selective_scan_kernel_carry<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(a, total);
  }
  const dim3 grid((a.chunks * groups + WARPS - 1) / WARPS, B * a.G);
  selective_scan_kernel_outputs<VEC><<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, Gx, L, D); dt, y: (B, G, L, D); A: (G, D, N); Dskip: (G, D) or null (no skip term): f32 contiguous,
// N = 16. Bm, Cm: (B, G, L, N) f32 with unit stride over N and the given strides, in floats, over batch,
// direction and step. G is the number of scan directions that share the call (at most 8). Direction g
// runs backwards when bit g of reverse_mask is set and reads the x of direction (source_pack >> 4g) & 15.
// L is cut into chunks of chunk_len steps; carry: ceil(L / chunk_len) - 1 slots of 17 * D floats per
// (image, direction) of scratch, or null for a single chunk.
extern "C" int selective_scan_launch(const float* x, const float* dt, const float* A, const float* Bm,
                                     const float* Cm, const float* Dskip, float* y, float* carry, int B, int G,
                                     int Gx, int L, int D, int N, int b_sb, int b_sg, int b_sl, int c_sb, int c_sg,
                                     int c_sl, int reverse_mask, int source_pack, int chunk_len,
                                     cudaStream_t stream) {
  if (N != N_STATE || G > 8 || chunk_len < 1 || B * G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (L + chunk_len - 1) / chunk_len;
  if (chunks > 1 && !carry) return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{x, dt, A, Bm, Cm, Dskip, y, carry, G, Gx, L, D, b_sb, b_sg, b_sl, c_sb, c_sg, c_sl,
                   reverse_mask, source_pack, chunk_len, chunks};
  // the widest copy of B and C that every row's address allows
  const auto bits = reinterpret_cast<unsigned long long>(Bm) | reinterpret_cast<unsigned long long>(Cm) |
                    static_cast<unsigned long long>(4LL * (b_sb | b_sg | b_sl | c_sb | c_sg | c_sl));
  if (bits % 16 == 0) return launch_passes<4>(a, B, stream);
  if (bits % 8 == 0) return launch_passes<2>(a, B, stream);
  return launch_passes<1>(a, B, stream);
}

// ---------------------------------------------------------------------------------------------------------
// Backward. Replaces JAX's autodiff of experiment_yolo_tpu/ops/pallas/selective_scan.py:selective_scan_reference
// (the Pallas kernel has no backward; the JAX package trains through the associative scan). With
// a_t = exp(dt_t A) and, per state, g_t = C_t dy_t + a_{t+1} g_{t+1} (the gradient reaching h_t), in reverse
// over each direction's steps:
//   dC_t = sum_d h_t dy_t             dB_t = sum_d g_t dt_t x_t        dx_t = dt_t sum_n g_t B_t + D dy_t
//   ddt_t = sum_n g_t (A a_t h_{t-1} + B_t x_t)     dA = sum_{b,t} g_t dt_t a_t h_{t-1}     dD = sum_{b,t} x_t dy_t
//
// Bound on this card: bytes. At the widest level (B = 8, G = 4, L = 25,600, D = 32) the call must read x, dt, B,
// C and dy and write dx, ddt, dB and dC, about 630 MB: 0.19 ms at 3.35 TB/s; its one exp per (state, step) on
// the special-function units takes 0.10 ms and its 18 other operations per (state, step) 0.11 ms at the f32 rate.
// This first kernel is far from it (kernel_variants.py k4bwd, H100 SXM at 700 W, one call a level on inputs like
// the seeded model's): 4.45 ms at the widest level, of it 3.51 in pass 3 and 0.67 in pass 1, and 8.33 ms for one
// call at each of the four levels. It walks every step three times (below) and computes three exps per (state,
// step), but neither bounds it: without the exps a call is 2-3% faster, and with one block an SM instead of two
// no slower. An earlier form that held the states of 64-step stretches and of 8-step tiles in registers (128
// registers, one block an SM, four walks) took 6.85 and 12.99 ms.
//
// Design, what is hard and what it does about it:
// - The reverse walk needs h_{t-1} in reverse order. Storing h for every step, (B, G, L, D, N), would take 1.68
//   GB at the widest level, and running the recurrence backwards by division, h_{t-1} = (h_t - b_t) / a_t, blows
//   up where a_t underflows (dt A near -16 gives 1e-7). So h is recomputed forwards from the chunk start states
//   that the forward's passes 1-2 left in its carry buffer (the autograd Function keeps it): one walk over the
//   chunk keeps the state at the start of every 8-step tile in shared memory (chunk_len * 256 bytes a block,
//   at most 128 KB: the wrapper caps the chunk length at 512 steps); then for each tile, last first, a walk
//   keeps each step's previous state and decay in registers, and the reverse walk over that tile computes the
//   gradients, reading the tile's x, dt and B again from L1.
// - One thread per (image and direction, chunk, state, channel): a block is 16 warps, warp n holds state n of
//   32 neighbouring channels, so a thread's state is one register and its history of a tile eight. x, dt and
//   dy are read by the 32 lanes of a warp side by side, B_t and C_t as one broadcast word a warp.
// - g is a linear recurrence like h, run backwards. Chunks run side by side as the forward's do: pass 1
//   (selective_scan_bwd_kernel_gends) walks every chunk but the first backwards from g = 0 and keeps
//   e_c = a_{s0} g_{s0}; pass 2 (selective_scan_bwd_kernel_gcarry) walks the chunks of each (sequence, state,
//   channel) from the last, q_{c-1} = exp(A sum dt_c) q_c + e_c, with the sums of dt the forward kept; pass 3
//   (selective_scan_bwd_kernel_main) starts each chunk's reverse walk from q_c.
// - Sums, each in a fixed order, so that two calls give the same bits: over the 32 channels of a warp with
//   shuffles (dB, dC), over the 16 states through shared memory once a tile (dx, ddt), then over channel groups
//   (dB, dC where D > 32), over the images and chunks (dA, dD, from per-chunk partials) and over the directions
//   that share an x (dx) in finishing kernels. No atomics.
// - exp is ex2.approx with A scaled by log2(e), as in the forward, so that the recomputed h follows the
//   forward's; the carry of g uses expf, as the forward's carry does.
constexpr int BWD_TILE = 8;           // steps whose previous state and decay a thread holds in registers
constexpr int BWD_MAX_CHUNK = 512;    // steps of a chunk: its tiles' start states fill at most 128 KB
constexpr int BWD_THREADS = N_STATE * LANES;  // 16 warps: warp n holds state n of 32 channels

struct BwdArgs {
  const float *x, *dt, *A, *Bm, *Cm, *Dskip, *dy, *fcarry;
  float *gcarry, *dxg, *ddt, *dBp, *dCp, *dA_part, *dD_part;
  int G, Gx, L, D;
  int b_sb, b_sg, b_sl, c_sb, c_sg, c_sl;
  int reverse_mask, source_pack, chunk_len, chunks, groups;
};

// What one thread works on: state n of channel d in one chunk of one (image, direction).
struct BwdLane {
  const float *xs, *dts, *dys, *bs, *cs;  // at step 0 of the sequence: x, dt, dy at channel d; B, C at state n
  int n, lane, group, d, seq, g, chunk, s0, s1;
  bool live, rev;
};

__device__ __forceinline__ BwdLane bwd_lane(const BwdArgs& a, int first_chunk) {
  BwdLane w;
  w.n = threadIdx.x / LANES;
  w.lane = threadIdx.x % LANES;
  w.group = blockIdx.x % a.groups;
  w.chunk = blockIdx.x / a.groups + first_chunk;
  const int d = w.group * LANES + w.lane;
  w.live = d < a.D;  // a ragged last group keeps its lanes for the sums and the barriers
  w.d = w.live ? d : a.D - 1;
  w.seq = blockIdx.y;  // b * G + g
  w.g = w.seq % a.G;
  const long long b = w.seq / a.G;
  w.rev = (a.reverse_mask >> w.g) & 1;
  const int gx = (a.source_pack >> (4 * w.g)) & 15;
  w.s0 = w.chunk * a.chunk_len;
  w.s1 = min(w.s0 + a.chunk_len, a.L);
  w.xs = a.x + (b * a.Gx + gx) * a.L * a.D + w.d;
  w.dts = a.dt + static_cast<long long>(w.seq) * a.L * a.D + w.d;
  w.dys = a.dy + static_cast<long long>(w.seq) * a.L * a.D + w.d;
  w.bs = a.Bm + b * a.b_sb + static_cast<long long>(w.g) * a.b_sg + w.n;
  w.cs = a.Cm + b * a.c_sb + static_cast<long long>(w.g) * a.c_sg + w.n;
  return w;
}

__device__ __forceinline__ long long bwd_index(const BwdLane& w, int s, int L) { return w.rev ? L - 1 - s : s; }

// h after steps s0 .. s1-1 from h, computed as the forward's pass 3 computes it.
__device__ __forceinline__ float walk_h(const BwdArgs& a, const BwdLane& w, float a2, int s0, int s1, float h) {
#pragma unroll 8
  for (int s = s0; s < s1; ++s) {
    const long long t = bwd_index(w, s, a.L);
    const float dtv = __ldg(w.dts + t * a.D), xv = __ldg(w.xs + t * a.D), bv = __ldg(w.bs + t * a.b_sl);
    h = fmaf(h, ex2(dtv * a2), (dtv * xv) * bv);
  }
  return h;
}

// Pass 1: every chunk c > 0 backwards from g = 0; e_c = a_{s0} g_{s0} goes to carry slot c - 1.
__global__ void __launch_bounds__(BWD_THREADS) selective_scan_bwd_kernel_gends(BwdArgs a) {
  const BwdLane w = bwd_lane(a, 1);
  const float a2 = a.A[(static_cast<long long>(w.g) * a.D + w.d) * N_STATE + w.n] * LOG2E;
  float ga = 0.f;
#pragma unroll 8
  for (int s = w.s1 - 1; s >= w.s0; --s) {
    const long long t = bwd_index(w, s, a.L);
    const float dtv = __ldg(w.dts + t * a.D), dyv = __ldg(w.dys + t * a.D), cv = __ldg(w.cs + t * a.c_sl);
    ga = ex2(dtv * a2) * fmaf(cv, dyv, ga);
  }
  if (w.live)
    a.gcarry[((static_cast<long long>(w.seq) * (a.chunks - 1) + w.chunk - 1) * N_STATE + w.n) * a.D + w.d] = ga;
}

// Pass 2: one thread per (sequence, state, channel), the chunks from the last: slot j becomes q_j, the term
// a_{s1} g_{s1} that enters chunk j at its last step.
__global__ void selective_scan_bwd_kernel_gcarry(BwdArgs a, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int d = static_cast<int>(i % a.D);
  const int n = static_cast<int>(i / a.D % N_STATE);
  const long long seq = i / a.D / N_STATE;
  const float an = a.A[((seq % a.G) * a.D + d) * N_STATE + n];
  const long long q_stride = static_cast<long long>(N_STATE) * a.D, f_stride = static_cast<long long>(CARRY) * a.D;
  float* q = a.gcarry + seq * (a.chunks - 1) * q_stride + static_cast<long long>(n) * a.D + d;
  const float* sums = a.fcarry + seq * (a.chunks - 1) * f_stride + static_cast<long long>(N_STATE) * a.D + d;
  float v = 0.f;
  for (int j = a.chunks - 2; j >= 0; --j) {
    const float e = q[j * q_stride];
    // the forward's slot j + 1 holds the sum of dt over chunk j + 1; the last chunk passes nothing on
    v = (j == a.chunks - 2) ? e : fmaf(expf(an * sums[(j + 1) * f_stride]), v, e);
    q[j * q_stride] = v;
  }
}

// Pass 3: the gradients, chunk by chunk, each chunk backwards from its true g. Two blocks fit an SM where the
// chunk's tile states leave room (at most 64 registers a thread).
__global__ void __launch_bounds__(BWD_THREADS, 2) selective_scan_bwd_kernel_main(BwdArgs a) {
  extern __shared__ float at_tile[];                   // [tile][thread]: the state at the start of each tile
  __shared__ float red[BWD_TILE][2][N_STATE][LANES];  // a tile's shares of dx / dt and of ddt, by state and channel
  __shared__ float bc[BWD_TILE][2][N_STATE];           // a tile's dB and dC over the block's channels
  const BwdLane w = bwd_lane(a, 0);
  const float an = a.A[(static_cast<long long>(w.g) * a.D + w.d) * N_STATE + w.n], a2 = an * LOG2E;
  const float dskip = a.Dskip ? a.Dskip[static_cast<long long>(w.g) * a.D + w.d] : 0.f;
  const long long slot = static_cast<long long>(w.seq) * (a.chunks - 1) + w.chunk;  // this chunk's g carry
  float h = w.chunk > 0 ? a.fcarry[((slot - 1) * CARRY + w.n) * a.D + w.d] : 0.f;
  float ga = w.chunk < a.chunks - 1 ? a.gcarry[(slot * N_STATE + w.n) * a.D + w.d] : 0.f;

  // walk 1: the state at the start of each tile
  const int tiles = (w.s1 - w.s0 + BWD_TILE - 1) / BWD_TILE;
  for (int j = 0; j < tiles; ++j) {
    at_tile[j * BWD_THREADS + threadIdx.x] = h;
    h = walk_h(a, w, a2, w.s0 + j * BWD_TILE, min(w.s0 + (j + 1) * BWD_TILE, w.s1), h);
  }
  float dA = 0.f, dD = 0.f;
  for (int j = tiles - 1; j >= 0; --j) {
    const int s = w.s0 + j * BWD_TILE, steps = min(BWD_TILE, w.s1 - s);
    // walk 2: each step's decay and previous state (past a ragged end: the last step again, unused)
    float hprev[BWD_TILE], dec[BWD_TILE];
    h = at_tile[j * BWD_THREADS + threadIdx.x];
#pragma unroll
    for (int i = 0; i < BWD_TILE; ++i) {
      const long long t = bwd_index(w, s + min(i, steps - 1), a.L);
      const float dtv = __ldg(w.dts + t * a.D), xv = __ldg(w.xs + t * a.D), bv = __ldg(w.bs + t * a.b_sl);
      dec[i] = ex2(dtv * a2);
      hprev[i] = h;
      h = fmaf(h, dec[i], (dtv * xv) * bv);
    }
    // walk 3: back over the tile (steps is the same for the whole block, so the shuffles see every lane)
#pragma unroll
    for (int i = BWD_TILE - 1; i >= 0; --i) {
      if (i < steps) {
        const long long t = bwd_index(w, s + i, a.L);
        const float dtv = __ldg(w.dts + t * a.D), xv = __ldg(w.xs + t * a.D), bv = __ldg(w.bs + t * a.b_sl);
        const float dyv = __ldg(w.dys + t * a.D), cv = __ldg(w.cs + t * a.c_sl);
        const float g = fmaf(cv, dyv, ga);
        const float u = dtv * xv;
        const float ah = dec[i] * hprev[i];
        const float ht = fmaf(hprev[i], dec[i], u * bv);
        // dB and dC over the warp's channels: lanes 0-15 carry dB, 16-31 dC, and lanes 0 and 16 end with the sums
        const float pb = w.live ? g * u : 0.f, pc = w.live ? ht * dyv : 0.f;
        float sum = (w.lane < 16 ? pb : pc) + __shfl_xor_sync(0xffffffffu, w.lane < 16 ? pc : pb, 16);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if ((w.lane & 15) == 0) bc[i][w.lane >> 4][w.n] = sum;
        red[i][0][w.n][w.lane] = g * bv;
        red[i][1][w.n][w.lane] = g * fmaf(an, ah, bv * xv);
        dA = fmaf(g * dtv, ah, dA);
        dD = fmaf(xv, dyv, dD);
        ga = dec[i] * g;
      }
    }
    __syncthreads();
    {  // each thread sums one (step, output, channel) over the 16 states: 8 x 2 x 32 = the block's 512 threads
      const int i = threadIdx.x / (2 * LANES), kind = threadIdx.x / LANES % 2;
      if (i < steps && w.live) {
        float v = 0.f;
#pragma unroll
        for (int n = 0; n < N_STATE; ++n) v += red[i][kind][n][w.lane];
        const long long at = (static_cast<long long>(w.seq) * a.L + bwd_index(w, s + i, a.L)) * a.D + w.d;
        if (kind == 0)
          a.dxg[at] = fmaf(__ldg(a.dt + at), v, dskip * __ldg(a.dy + at));
        else
          a.ddt[at] = v;
      }
      if (threadIdx.x < BWD_TILE * 2 * N_STATE) {  // dB and dC of the tile's steps: 8 x 2 x 16
        const int i2 = threadIdx.x / (2 * N_STATE), kind2 = threadIdx.x / N_STATE % 2, n2 = threadIdx.x % N_STATE;
        if (i2 < steps) {
          const long long at = ((static_cast<long long>(w.group) * gridDim.y + w.seq) * a.L +
                                bwd_index(w, s + i2, a.L)) * N_STATE + n2;
          (kind2 ? a.dCp : a.dBp)[at] = bc[i2][kind2][n2];
        }
      }
    }
    __syncthreads();  // the next tile writes red and bc again
  }
  const long long part = static_cast<long long>(w.seq) * a.chunks + w.chunk;
  if (w.live) {
    a.dA_part[(part * N_STATE + w.n) * a.D + w.d] = dA;
    if (w.n == 0) a.dD_part[part * a.D + w.d] = dD;
  }
}

// dx of each x direction: the sum, in direction order, of the directions that read it (0 where none does).
__global__ void selective_scan_bwd_kernel_dx(BwdArgs a, float* dx, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long per = static_cast<long long>(a.L) * a.D;
  const long long rest = i % per, bx = i / per;  // bx = b * Gx + gx
  const int gx = static_cast<int>(bx % a.Gx);
  const long long b = bx / a.Gx;
  float v = 0.f;
  for (int g = 0; g < a.G; ++g)
    if (((a.source_pack >> (4 * g)) & 15) == gx) v += a.dxg[(b * a.G + g) * per + rest];
  dx[i] = v;
}

// dB and dC where D > 32: the channel groups' partial sums in group order.
__global__ void selective_scan_bwd_kernel_bc(BwdArgs a, float* dB, float* dC, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * total) return;
  const bool is_c = i >= total;
  const long long j = is_c ? i - total : i;
  const float* part = is_c ? a.dCp : a.dBp;
  float v = 0.f;
  for (int k = 0; k < a.groups; ++k) v += part[k * total + j];
  (is_c ? dC : dB)[j] = v;
}

// dA (G, D, N) and dD (G, D): the per-chunk partials summed over images, then chunks, in order.
__global__ void selective_scan_bwd_kernel_params(BwdArgs a, float* dA, float* dD, int B) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(a.G) * N_STATE * a.D) return;
  const int d = static_cast<int>(i % a.D), n = static_cast<int>(i / a.D % N_STATE);
  const int g = static_cast<int>(i / a.D / N_STATE);
  float va = 0.f, vd = 0.f;
  for (int b = 0; b < B; ++b) {
    const long long seq = static_cast<long long>(b) * a.G + g;
    for (int c = 0; c < a.chunks; ++c) {
      va += a.dA_part[((seq * a.chunks + c) * N_STATE + n) * a.D + d];
      if (n == 0) vd += a.dD_part[(seq * a.chunks + c) * a.D + d];
    }
  }
  dA[(static_cast<long long>(g) * a.D + d) * N_STATE + n] = va;
  if (n == 0 && dD) dD[static_cast<long long>(g) * a.D + d] = vd;
}

// The gradients of sum(y * dy) for selective_scan_launch's inputs, with its shapes, strides, flags and sources,
// and chunk_len the length it was called with. fcarry: its carry buffer after the call (chunk c + 1's start
// state and chunk c's sum of dt in slot c), or null for a single chunk; dy, dx (B, Gx, L, D), ddt, dA, dB, dC
// (B, G, L, N, dense), dD (or null with Dskip): f32 contiguous. Scratch: gcarry (B * G * (chunks - 1) * N * D,
// or null for a single chunk), dxg (B * G * L * D), dBp and dCp (groups * B * G * L * N with groups =
// ceil(D / 32); dB and dC themselves where groups is 1), dA_part (B * G * chunks * N * D), dD_part
// (B * G * chunks * D).
extern "C" int selective_scan_bwd_launch(const float* x, const float* dt, const float* A, const float* Bm,
                                         const float* Cm, const float* Dskip, const float* dy, const float* fcarry,
                                         float* gcarry, float* dxg, float* dBp, float* dCp, float* dA_part,
                                         float* dD_part, float* dx, float* ddt, float* dA, float* dB, float* dC,
                                         float* dD, int B, int G, int Gx, int L, int D, int N, int b_sb, int b_sg,
                                         int b_sl, int c_sb, int c_sg, int c_sl, int reverse_mask, int source_pack,
                                         int chunk_len, cudaStream_t stream) {
  if (N != N_STATE || G > 8 || chunk_len < 1 || chunk_len > BWD_MAX_CHUNK || B * G > 65535 ||
      (Dskip == nullptr) != (dD == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (L + chunk_len - 1) / chunk_len, groups = (D + LANES - 1) / LANES;
  if (chunks > 1 && (!fcarry || !gcarry)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, dt, A, Bm, Cm, Dskip, dy, fcarry, gcarry, dxg, ddt, dBp, dCp, dA_part, dD_part, G, Gx, L, D,
                  b_sb, b_sg, b_sl, c_sb, c_sg, c_sl, reverse_mask, source_pack, chunk_len, chunks, groups};
  if (chunks > 1) {
    selective_scan_bwd_kernel_gends<<<dim3((chunks - 1) * groups, B * G), BWD_THREADS, 0, stream>>>(a);
    const long long total = static_cast<long long>(B) * G * N_STATE * D;
    selective_scan_bwd_kernel_gcarry<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(a, total);
  }
  const int tile_bytes = (chunk_len + BWD_TILE - 1) / BWD_TILE * BWD_THREADS * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(selective_scan_bwd_kernel_main, cudaFuncAttributeMaxDynamicSharedMemorySize, tile_bytes);
  selective_scan_bwd_kernel_main<<<dim3(chunks * groups, B * G), BWD_THREADS, tile_bytes, stream>>>(a);
  const long long nx = static_cast<long long>(B) * Gx * L * D;
  selective_scan_bwd_kernel_dx<<<static_cast<unsigned>((nx + 255) / 256), 256, 0, stream>>>(a, dx, nx);
  if (groups > 1) {
    const long long nbc = static_cast<long long>(B) * G * L * N_STATE;
    selective_scan_bwd_kernel_bc<<<static_cast<unsigned>((2 * nbc + 255) / 256), 256, 0, stream>>>(a, dB, dC, nbc);
  }
  const long long np = static_cast<long long>(G) * N_STATE * D;
  selective_scan_bwd_kernel_params<<<static_cast<unsigned>((np + 255) / 256), 256, 0, stream>>>(a, dA, dD, B);
  return static_cast<int>(cudaGetLastError());
}
