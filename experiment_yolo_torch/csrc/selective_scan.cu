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

#include <type_traits>

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
// Measured (kernel_variants.py k4bwd, H100 SXM 80 GB at 700 W, one call a level on inputs like the seeded model's,
// one process): 0.93 ms at the widest level, 5x its bound (0.54 in the main pass, 0.31 in pass 1), and 1.87 ms for
// one call at each of the four levels, against 4.47 and 8.35 ms for the first design, which ran one thread per
// (state, channel) and paid each channel's loads, index arithmetic and sums 16 times. No single part bounds it:
// the main pass is 2.5% faster without its exps (two a state and step there, one in pass 1), 16% without its
// sums over channels and 10% without its copies from device memory; pass 1 is twice as fast without its copies
// (0.16 ms), besides which it writes the tile start states, 0.42 GB at the widest level, which the main pass
// reads back. What sets the tile length is shared
// memory: tiles of 8 steps (30 KB a warp, 7 warps an SM) made the main pass 0.89 ms, of 2 steps (start states
// four times as dense) pass 1 0.47 ms; a history without its row pad (bank conflicts in the sums) 1.30 ms; a
// third ring stage, two warps a block or a cap of 96 registers (spills) were slower too.
//
// Design, what is hard and what it does about it:
// - The reverse walk needs h_{t-1} in reverse order. Storing h for every step, (B, G, L, D, N), would take 1.68
//   GB at the widest level, and running the recurrence backwards by division, h_{t-1} = (h_t - b_t) / a_t, blows
//   up where a_t underflows (dt A near -16 gives 1e-7). So h is recomputed forwards: pass 1
//   (selective_scan_bwd_kernel_starts) walks every chunk from the start state that the forward's passes 1-2
//   left in its carry buffer (the autograd Function keeps it), as the forward's pass 3 walks it, and writes the
//   state at the start of every BWD_TILE-step tile to scratch; the main pass walks each tile again from there,
//   keeps its h_t in shared memory, and walks it backwards.
// - One thread per (image and direction, chunk, channel) with the channel's 16 states in registers, as K4's
//   forward: x, dt and dy are read, and the index arithmetic and the loop paid, once a channel and step; the
//   sums over states of dx and ddt and the partials of dA stay in registers. A warp is 32 neighbouring channels
//   of one chunk and shares nothing with other warps: no block barrier, only __syncwarp.
// - Each walk streams its tiles through the warp's own ring in shared memory, filled by cp.async ahead of use
//   (x, dt, dy of its 32 channels, B and C 16, 8 or 4 bytes at a time, and in the main pass the tile's start
//   state), so each input is read from device memory once per walk, chunk and channel group: the main pass
//   takes its tiles of BWD_TILE steps last first, one in flight; pass 1 tiles of WALK_TILE steps, two in
//   flight. The main pass's ring and history take 17 KB a warp: 12 warps an SM.
// - The sums over the warp's 32 channels (dB, dC) are taken once a tile from the history in shared memory, a
//   (step, state) row of 32 channels for each output, a lane taking two states of one step: dC_t from h_t right
//   after the tile's forward walk, dB_t from g_t, which the reverse walk writes over h_t, and dt_t x_t, which it
//   writes over x_t. A row is 36 floats, so that eight lanes' 16-byte reads of eight rows fall in distinct banks.
// - g is a linear recurrence like h, run backwards. Chunks run side by side as the forward's do: pass 1 also sums
//   e_c = sum_t (a_{s0} ... a_t) C_t dy_t, the g that chunk c passes back when nothing enters it from later
//   steps, multiplied by a_{s0}; pass 2 (selective_scan_bwd_kernel_gcarry) walks the chunks of each (sequence,
//   state, channel) from the last, q_{c-1} = exp(A sum dt_c) q_c + e_c, with the sums of dt the forward kept;
//   the main pass (selective_scan_bwd_kernel_main) starts each chunk's reverse walk from q_c.
// - Sums, each in a fixed order, so that two calls give the same bits: over the 32 channels of a warp once a
//   tile (dB, dC), over the 16 states in registers (dx, ddt), then over channel groups (dB, dC where D > 32),
//   over the images and chunks (dA, dD, from per-chunk partials) and over the directions that share an x (dx)
//   in finishing kernels. No atomics.
// - exp is ex2.approx with A scaled by log2(e), as in the forward, so that the recomputed h is the forward's;
//   the carry of g uses expf, as the forward's carry does.
constexpr int BWD_TILE = 4;      // steps of a tile: a ring stage, and the stretch whose h_t a warp keeps
constexpr int BWD_STAGES = 2;    // tiles in a warp's ring: one consumed while the next lands
constexpr int BWD_WARPS = 1;     // warps a block of the main pass, each with its own shared memory
constexpr int WALK_TILE = 8;     // steps of a tile of pass 1's ring (a multiple of BWD_TILE)
constexpr int WALK_STAGES = 3;   // tiles in a warp's ring in pass 1: two in flight while one is consumed
constexpr int WALK_WARPS = 2;    // warps a block of pass 1
constexpr int HIST_ROW = LANES + 4;  // floats a row of the history: 32 channels and a pad of 4
constexpr float LN2 = 0.6931471805599453f;

template <int T>
struct __align__(16) InTile {  // T steps of a warp's inputs: 512 bytes a step
  float x[T][LANES], dt[T][LANES], dy[T][LANES], b[T][N_STATE], c[T][N_STATE];
};
using BwdTile = InTile<BWD_TILE>;

struct __align__(16) BwdStage {  // the main pass's ring stage: a tile and the state before its first step
  BwdTile in;
  float h0[N_STATE][LANES];
};

struct __align__(16) BwdWarp {  // the main pass's shared memory a warp: 17 KB
  BwdStage ring[BWD_STAGES];
  float hist[BWD_TILE][N_STATE][HIST_ROW];  // h_t after the tile's forward walk, g_t after its reverse walk
};

struct BwdArgs {
  const float *x, *dt, *A, *Bm, *Cm, *Dskip, *dy, *fcarry;
  float *gcarry, *hs, *dxg, *ddt, *dBp, *dCp, *dA_part, *dD_part;
  int G, Gx, L, D;
  int b_sb, b_sg, b_sl, c_sb, c_sg, c_sl;
  int reverse_mask, source_pack, chunk_len, chunks, groups, tiles;  // tiles: of a chunk, ceil(chunk_len / BWD_TILE)
};

// What one warp works on: 32 channels of one chunk of one (image, direction).
struct BwdWork {
  const float *xs, *dts, *dys, *bs, *cs;  // at step 0 of the sequence: x, dt, dy at this lane's channel; B, C
  float* hs;                              // the start states of this (sequence, chunk, channel group)'s tiles
  int lane, group, d, seq, g, chunk, s0, s1;
  bool live, rev;
};

__device__ __forceinline__ bool bwd_work(const BwdArgs& a, int warps, BwdWork& w) {
  const int item = blockIdx.x * warps + threadIdx.x / LANES;
  if (item >= a.chunks * a.groups) return false;
  w.lane = threadIdx.x % LANES;
  w.chunk = item / a.groups;
  w.group = item % a.groups;
  const int d = w.group * LANES + w.lane;
  w.live = d < a.D;  // a ragged last group keeps its lanes for the copies and the sums, with x = dy = 0
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
  w.bs = a.Bm + b * a.b_sb + static_cast<long long>(w.g) * a.b_sg;
  w.cs = a.Cm + b * a.c_sb + static_cast<long long>(w.g) * a.c_sg;
  w.hs = a.hs + ((static_cast<long long>(w.seq) * a.chunks + w.chunk) * a.groups + w.group) * a.tiles * N_STATE * LANES;
  return true;
}

__device__ __forceinline__ long long bwd_index(const BwdWork& w, int s, int L) { return w.rev ? L - 1 - s : s; }

// Start the copy of steps s .. s+T-1 into one tile. Past the end of the chunk the last step is copied again and
// never used. VEC floats of B and C go in one copy.
template <int VEC, int T>
__device__ __forceinline__ void load_bwd_tile(InTile<T>& st, const BwdArgs& a, const BwdWork& w, int s) {
  const long long t = bwd_index(w, s, a.L);
  const int dir = w.rev ? -1 : 1, last = min(T, w.s1 - s) - 1;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const long long at = (t + min(i, last) * dir) * a.D;
    cp_async<4>(&st.x[i][w.lane], w.xs + at);
    cp_async<4>(&st.dt[i][w.lane], w.dts + at);
    cp_async<4>(&st.dy[i][w.lane], w.dys + at);
  }
  constexpr int PER_STEP = N_STATE / VEC;
#pragma unroll
  for (int k = w.lane; k < T * PER_STEP; k += LANES) {
    const long long row = t + min(k / PER_STEP, last) * dir;
    const int j = (k % PER_STEP) * VEC;
    cp_async<4 * VEC>(&st.b[k / PER_STEP][j], w.bs + row * a.b_sl + j);
    cp_async<4 * VEC>(&st.c[k / PER_STEP][j], w.cs + row * a.c_sl + j);
  }
}

// A walk's per-lane state: the channel's 16 states, their scaled decay rates and the sums the walk carries.
struct BwdLane {
  float a2[N_STATE], h[N_STATE], p[N_STATE], e[N_STATE];  // pass 1: p the product of the decays so far
};

// Pass 1, one tile of its ring from step s: h as the forward's pass 3 computes it, and e; the state before
// every BWD_TILE-th step of the chunk goes to hs.
template <bool GUARD>
__device__ __forceinline__ void starts_tile(const BwdWork& w, const InTile<WALK_TILE>& st, BwdLane& r, int s,
                                            int steps) {
#pragma unroll
  for (int i = 0; i < WALK_TILE; ++i) {
    if (GUARD && i >= steps) break;
    if (i % BWD_TILE == 0) {
      float* out = w.hs + static_cast<long long>((s + i - w.s0) / BWD_TILE) * N_STATE * LANES + w.lane;
#pragma unroll
      for (int n = 0; n < N_STATE; ++n) out[n * LANES] = r.h[n];
    }
    const float dtv = st.dt[i][w.lane];
    const float xv = w.live ? st.x[i][w.lane] : 0.f, dyv = w.live ? st.dy[i][w.lane] : 0.f;
    const float u = dtv * xv;
    const float4* b4 = reinterpret_cast<const float4*>(st.b[i]);
    const float4* c4 = reinterpret_cast<const float4*>(st.c[i]);
#pragma unroll
    for (int q = 0; q < N_STATE / 4; ++q) {
      const float4 bq = b4[q], cq = c4[q];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w}, cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * q + j;
        const float dec = ex2(dtv * r.a2[n]);
        r.h[n] = fmaf(r.h[n], dec, u * bv[j]);
        r.p[n] *= dec;
        r.e[n] = fmaf(r.p[n], cv[j] * dyv, r.e[n]);
      }
    }
  }
}

// Pass 1: every chunk forwards from its true start state. The state before each of the main pass's tiles goes to
// hs, and for c > 0, e_c = sum_t (a_{s0} ... a_t) C_t dy_t to carry slot c - 1.
template <int VEC>
__global__ void __launch_bounds__(WALK_WARPS * LANES) selective_scan_bwd_kernel_starts(BwdArgs a) {
  static_assert(WALK_TILE % BWD_TILE == 0, "pass 1's tiles hold whole tiles of the main pass");
  __shared__ InTile<WALK_TILE> ring[WALK_WARPS][WALK_STAGES];
  BwdWork w;
  if (!bwd_work(a, WALK_WARPS, w)) return;
  InTile<WALK_TILE>* st = ring[threadIdx.x / LANES];
  BwdLane r;
  const float* arow = a.A + (static_cast<long long>(w.g) * a.D + w.d) * N_STATE;
  const long long slot = static_cast<long long>(w.seq) * (a.chunks - 1) + w.chunk - 1;  // chunk c's carry: c - 1
#pragma unroll
  for (int n = 0; n < N_STATE; ++n) {
    r.a2[n] = arow[n] * LOG2E;
    r.h[n] = (w.chunk > 0 && w.live) ? a.fcarry[(slot * CARRY + n) * a.D + w.d] : 0.f;
    r.p[n] = 1.f;
    r.e[n] = 0.f;
  }
  const int tiles = (w.s1 - w.s0 + WALK_TILE - 1) / WALK_TILE;
  for (int k = 0; k < WALK_STAGES - 1; ++k) {
    if (k < tiles) load_bwd_tile<VEC>(st[k], a, w, w.s0 + k * WALK_TILE);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = 0; k < tiles; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(WALK_STAGES - 2));  // this lane's copies of tile k have landed
    __syncwarp();  // so have the other lanes', and every lane is done with tile k-1, whose stage is refilled next
    if (k + WALK_STAGES - 1 < tiles)
      load_bwd_tile<VEC>(st[(k + WALK_STAGES - 1) % WALK_STAGES], a, w, w.s0 + (k + WALK_STAGES - 1) * WALK_TILE);
    asm volatile("cp.async.commit_group;\n" ::);
    const int s = w.s0 + k * WALK_TILE;
    if (s + WALK_TILE <= w.s1)
      starts_tile<false>(w, st[k % WALK_STAGES], r, s, WALK_TILE);
    else
      starts_tile<true>(w, st[k % WALK_STAGES], r, s, w.s1 - s);
  }
  if (w.chunk > 0 && w.live) {
#pragma unroll
    for (int n = 0; n < N_STATE; ++n) a.gcarry[(slot * N_STATE + n) * a.D + w.d] = r.e[n];
  }
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
  constexpr int AHEAD = 8;
  float v = 0.f;
  for (int j0 = a.chunks - 2; j0 >= 0; j0 -= AHEAD) {
    float e[AHEAD], sum[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int j = max(j0 - k, 0);
      e[k] = q[j * q_stride];
      sum[k] = sums[min(j + 1, a.chunks - 2) * f_stride];  // the forward's slot j + 1: the sum of dt over chunk j + 1
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int j = j0 - k;
      if (j >= 0) {
        v = (j == a.chunks - 2) ? e[k] : fmaf(expf(an * sum[k]), v, e[k]);  // the last chunk passes nothing on
        q[j * q_stride] = v;
      }
    }
  }
}

// The main pass's per-lane state: the scaled decay rates, a_{t+1} g_{t+1} and dA's partial sums of 16 states.
struct RevLane {
  float a2[N_STATE], ga[N_STATE], dA[N_STATE], dskip, dD;
};

// The sums over the warp's 32 channels of hist[i][n][channel] * v[i][channel] for the steps i of the tile and
// the 16 states n (dB or dC of this channel group). A lane takes BWD_TILE / 2 states of one step, n = r, r + R,
// ... with R = 32 / BWD_TILE lanes a step, and reads that step's row of v once for them; the eight lanes of a
// quarter-warp read eight neighbouring rows of the history, whose pad puts them in distinct banks.
template <bool GUARD>
__device__ __forceinline__ void channel_sums(const BwdArgs& a, const BwdWork& w, const BwdWarp& sw,
                                             const float (*v)[LANES], float* out, int s, int steps) {
  constexpr int R = LANES / BWD_TILE, PER_LANE = N_STATE / R;
  const int i = w.lane / R, r = w.lane % R;
  if (GUARD && i >= steps) return;
  const float4* vr = reinterpret_cast<const float4*>(v[i]);
  float acc[PER_LANE][2];
#pragma unroll
  for (int m = 0; m < PER_LANE; ++m) acc[m][0] = acc[m][1] = 0.f;
#pragma unroll
  for (int q = 0; q < LANES / 4; ++q) {
    const float4 vq = vr[q];
#pragma unroll
    for (int m = 0; m < PER_LANE; ++m) {
      const float4 hq = reinterpret_cast<const float4*>(sw.hist[i][r + R * m])[q];
      acc[m][0] = fmaf(hq.x, vq.x, fmaf(hq.z, vq.z, acc[m][0]));
      acc[m][1] = fmaf(hq.y, vq.y, fmaf(hq.w, vq.w, acc[m][1]));
    }
  }
  float* row = out + ((static_cast<long long>(w.group) * gridDim.y + w.seq) * a.L + bwd_index(w, s + i, a.L)) * N_STATE;
#pragma unroll
  for (int m = 0; m < PER_LANE; ++m) row[r + R * m] = acc[m][0] + acc[m][1];
}

// One tile of the main pass, the first `steps` steps of it (all BWD_TILE when GUARD is false).
template <bool GUARD>
__device__ __forceinline__ void reverse_tile(const BwdArgs& a, const BwdWork& w, BwdWarp& sw, BwdStage& st,
                                             RevLane& r, int s, int steps) {
  // the tile forwards from its start state: h_t into the history
  float h[N_STATE];
#pragma unroll
  for (int n = 0; n < N_STATE; ++n) h[n] = st.h0[n][w.lane];
#pragma unroll
  for (int i = 0; i < BWD_TILE; ++i) {
    if (GUARD && i >= steps) break;
    const float dtv = st.in.dt[i][w.lane];
    const float u = dtv * (w.live ? st.in.x[i][w.lane] : 0.f);
    const float4* b4 = reinterpret_cast<const float4*>(st.in.b[i]);
#pragma unroll
    for (int q = 0; q < N_STATE / 4; ++q) {
      const float4 bq = b4[q];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * q + j;
        h[n] = fmaf(h[n], ex2(dtv * r.a2[n]), u * bv[j]);
        sw.hist[i][n][w.lane] = h[n];
      }
    }
  }
  __syncwarp();
  channel_sums<GUARD>(a, w, sw, st.in.dy, a.dCp, s, steps);  // dC_t = sum_d h_t dy_t
  __syncwarp();  // every lane has read the rows that the reverse walk overwrites
  // the tile backwards
#pragma unroll
  for (int i = BWD_TILE - 1; i >= 0; --i) {
    if (GUARD && i >= steps) continue;
    const float dtv = st.in.dt[i][w.lane];
    const float xv = w.live ? st.in.x[i][w.lane] : 0.f, dyv = w.live ? st.in.dy[i][w.lane] : 0.f;
    const float4* b4 = reinterpret_cast<const float4*>(st.in.b[i]);
    const float4* c4 = reinterpret_cast<const float4*>(st.in.c[i]);
    float sb[4] = {0.f, 0.f, 0.f, 0.f}, sa[4] = {0.f, 0.f, 0.f, 0.f};  // sum_n g B_n and sum_n g A_n a h_{t-1} / ln 2
#pragma unroll
    for (int q = 0; q < N_STATE / 4; ++q) {
      const float4 bq = b4[q], cq = c4[q];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w}, cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * q + j;
        const float hp = i > 0 ? sw.hist[i - 1][n][w.lane] : st.h0[n][w.lane];  // h_{t-1}
        const float dec = ex2(dtv * r.a2[n]);
        const float g = fmaf(cv[j], dyv, r.ga[n]);
        const float p = g * (dec * hp);
        sb[j] = fmaf(g, bv[j], sb[j]);
        sa[j] = fmaf(r.a2[n], p, sa[j]);
        r.dA[n] = fmaf(dtv, p, r.dA[n]);
        r.ga[n] = dec * g;
        sw.hist[i][n][w.lane] = g;
      }
    }
    st.in.x[i][w.lane] = dtv * xv;  // dB's dt_t x_t
    const float sB = (sb[0] + sb[1]) + (sb[2] + sb[3]), sA = (sa[0] + sa[1]) + (sa[2] + sa[3]);
    if (w.live) {
      const long long at = (static_cast<long long>(w.seq) * a.L + bwd_index(w, s + i, a.L)) * a.D + w.d;
      a.dxg[at] = fmaf(dtv, sB, r.dskip * dyv);
      a.ddt[at] = fmaf(LN2, sA, xv * sB);
    }
    r.dD = fmaf(xv, dyv, r.dD);
  }
  __syncwarp();
  channel_sums<GUARD>(a, w, sw, st.in.x, a.dBp, s, steps);  // dB_t = sum_d g_t dt_t x_t
}

// Pass 3: the gradients, each chunk backwards from its true g, a tile at a time from the last.
template <int VEC>
__global__ void __launch_bounds__(BWD_WARPS * LANES) selective_scan_bwd_kernel_main(BwdArgs a) {
  extern __shared__ __align__(16) float bwd_smem[];
  BwdWork w;
  if (!bwd_work(a, BWD_WARPS, w)) return;
  BwdWarp& sw = reinterpret_cast<BwdWarp*>(bwd_smem)[threadIdx.x / LANES];
  RevLane r;
  const long long gd = static_cast<long long>(w.g) * a.D + w.d;
  const long long slot = static_cast<long long>(w.seq) * (a.chunks - 1) + w.chunk;  // this chunk's g carry
  const bool carried = w.live && w.chunk < a.chunks - 1;
#pragma unroll
  for (int n = 0; n < N_STATE; ++n) {
    r.a2[n] = a.A[gd * N_STATE + n] * LOG2E;
    r.ga[n] = carried ? a.gcarry[(slot * N_STATE + n) * a.D + w.d] : 0.f;
    r.dA[n] = 0.f;
  }
  r.dskip = a.Dskip ? a.Dskip[gd] : 0.f;
  r.dD = 0.f;
  const int tiles = (w.s1 - w.s0 + BWD_TILE - 1) / BWD_TILE;
  auto load = [&](int k) {  // the k-th tile taken, tile tiles - 1 - k of the chunk, into its stage
    BwdStage& dst = sw.ring[k % BWD_STAGES];
    const int j = tiles - 1 - k;
    load_bwd_tile<VEC>(dst.in, a, w, w.s0 + j * BWD_TILE);
    const float* src = w.hs + static_cast<long long>(j) * N_STATE * LANES;
#pragma unroll
    for (int m = w.lane; m < N_STATE * LANES / 4; m += LANES) cp_async<16>(&dst.h0[0][0] + 4 * m, src + 4 * m);
  };
  for (int k = 0; k < BWD_STAGES - 1; ++k) {
    if (k < tiles) load(k);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = 0; k < tiles; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(BWD_STAGES - 2));  // this lane's copies of tile k have landed
    __syncwarp();  // so have the other lanes', and every lane is done with the last tile's stage and history
    if (k + BWD_STAGES - 1 < tiles) load(k + BWD_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const int s = w.s0 + (tiles - 1 - k) * BWD_TILE;
    if (s + BWD_TILE <= w.s1)
      reverse_tile<false>(a, w, sw, sw.ring[k % BWD_STAGES], r, s, BWD_TILE);
    else
      reverse_tile<true>(a, w, sw, sw.ring[k % BWD_STAGES], r, s, w.s1 - s);
  }
  const long long part = static_cast<long long>(w.seq) * a.chunks + w.chunk;
  if (w.live) {
#pragma unroll
    for (int n = 0; n < N_STATE; ++n) a.dA_part[(part * N_STATE + n) * a.D + w.d] = r.dA[n];
    a.dD_part[part * a.D + w.d] = r.dD;
  }
}

// dx of each x direction: the sum, in direction order, of the directions that read it (0 where none does). One
// block row (blockIdx.y) per (image, x direction); VEC floats a thread.
template <int VEC>
__global__ void selective_scan_bwd_kernel_dx(BwdArgs a, float* dx) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const int per = a.L * a.D / VEC, j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= per) return;
  const int gx = blockIdx.y % a.Gx, b = blockIdx.y / a.Gx;
  V v = {};
  for (int g = 0; g < a.G; ++g) {
    if (((a.source_pack >> (4 * g)) & 15) != gx) continue;
    const V u = reinterpret_cast<const V*>(a.dxg)[(static_cast<long long>(b) * a.G + g) * per + j];
    if constexpr (VEC == 4) {
      v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
    } else {
      v += u;
    }
  }
  reinterpret_cast<V*>(dx)[static_cast<long long>(blockIdx.y) * per + j] = v;
}

// dB and dC where D > 32: the channel groups' partial sums in group order, four floats a thread (total: float4s
// of each).
__global__ void selective_scan_bwd_kernel_bc(BwdArgs a, float* dB, float* dC, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * total) return;
  const bool is_c = i >= total;
  const long long j = is_c ? i - total : i;
  const float4* part = reinterpret_cast<const float4*>(is_c ? a.dCp : a.dBp);
  float4 v = part[j];
  for (int k = 1; k < a.groups; ++k) {
    const float4 u = part[k * total + j];
    v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
  }
  reinterpret_cast<float4*>(is_c ? dC : dB)[j] = v;
}

// dA (G, D, N) and dD (G, D): the per-chunk partials summed over images and chunks in a fixed order. A block is
// 32 channels of one (direction, state); warp k sums the (image, chunk) items k, k + PARAM_WARPS, ... in order,
// then the warps' sums are added in warp order.
constexpr int PARAM_WARPS = 32;
__global__ void __launch_bounds__(PARAM_WARPS * LANES) selective_scan_bwd_kernel_params(BwdArgs a, float* dA,
                                                                                       float* dD, int B) {
  __shared__ float sums[PARAM_WARPS][2][LANES];
  const int lane = threadIdx.x % LANES, k0 = threadIdx.x / LANES, d = blockIdx.x * LANES + lane;
  const int n = blockIdx.y % N_STATE, g = blockIdx.y / N_STATE;
  float va = 0.f, vd = 0.f;
  if (d < a.D) {
#pragma unroll 4
    for (int k = k0; k < B * a.chunks; k += PARAM_WARPS) {  // k = b * chunks + c
      const long long part = (static_cast<long long>(k / a.chunks) * a.G + g) * a.chunks + k % a.chunks;
      va += a.dA_part[(part * N_STATE + n) * a.D + d];
      if (n == 0) vd += a.dD_part[part * a.D + d];
    }
  }
  sums[k0][0][lane] = va;
  sums[k0][1][lane] = vd;
  __syncthreads();
  if (k0 == 0 && d < a.D) {
    for (int k = 1; k < PARAM_WARPS; ++k) va += sums[k][0][lane], vd += sums[k][1][lane];
    dA[(static_cast<long long>(g) * a.D + d) * N_STATE + n] = va;
    if (n == 0 && dD) dD[static_cast<long long>(g) * a.D + d] = vd;
  }
}

template <int VEC>
static int launch_bwd_passes(const BwdArgs& a, int B, float* dx, float* dA, float* dB, float* dC, float* dD,
                             cudaStream_t stream) {
  const int items = a.chunks * a.groups;
  selective_scan_bwd_kernel_starts<VEC><<<dim3((items + WALK_WARPS - 1) / WALK_WARPS, B * a.G), WALK_WARPS * LANES,
                                          0, stream>>>(a);
  if (a.chunks > 1) {
    const long long total = static_cast<long long>(B) * a.G * N_STATE * a.D;
    selective_scan_bwd_kernel_gcarry<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(a, total);
  }
  const int smem = BWD_WARPS * static_cast<int>(sizeof(BwdWarp));
  cudaFuncSetAttribute(selective_scan_bwd_kernel_main<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  selective_scan_bwd_kernel_main<VEC><<<dim3((items + BWD_WARPS - 1) / BWD_WARPS, B * a.G), BWD_WARPS * LANES, smem,
                                        stream>>>(a);
  const bool by4 = (a.L * a.D) % 4 == 0;  // rows of L * D floats: dxg and dx come from the allocator 16-byte aligned
  const dim3 dx_grid((a.L * a.D / (by4 ? 4 : 1) + 255) / 256, B * a.Gx);
  if (by4)
    selective_scan_bwd_kernel_dx<4><<<dx_grid, 256, 0, stream>>>(a, dx);
  else
    selective_scan_bwd_kernel_dx<1><<<dx_grid, 256, 0, stream>>>(a, dx);
  if (a.groups > 1) {
    const long long nbc = static_cast<long long>(B) * a.G * a.L * N_STATE / 4;
    selective_scan_bwd_kernel_bc<<<static_cast<unsigned>((2 * nbc + 255) / 256), 256, 0, stream>>>(a, dB, dC, nbc);
  }
  selective_scan_bwd_kernel_params<<<dim3((a.D + LANES - 1) / LANES, a.G * N_STATE), PARAM_WARPS * LANES, 0,
                                     stream>>>(a, dA, dD, B);
  return static_cast<int>(cudaGetLastError());
}

// The gradients of sum(y * dy) for selective_scan_launch's inputs, with its shapes, strides, flags and sources,
// and chunk_len the length it was called with. fcarry: its carry buffer after the call (chunk
// c + 1's start state and chunk c's sum of dt in slot c), or null for a single chunk; dy, dx (B, Gx, L, D), ddt,
// dA, dB, dC (B, G, L, N, dense), dD (or null with Dskip): f32 contiguous. Scratch: gcarry (B * G * (chunks - 1)
// * N * D, or null for a single chunk), hs (B * G * chunks * groups * ceil(chunk_len / BWD_TILE) * N * 32,
// 16-byte aligned), dxg (B * G * L * D), dBp and dCp (groups * B * G * L * N with groups = ceil(D / 32); dB and dC
// themselves where groups is 1), dA_part (B * G * chunks * N * D), dD_part (B * G * chunks * D).
extern "C" int selective_scan_bwd_launch(const float* x, const float* dt, const float* A, const float* Bm,
                                         const float* Cm, const float* Dskip, const float* dy, const float* fcarry,
                                         float* gcarry, float* hs, float* dxg, float* dBp, float* dCp, float* dA_part,
                                         float* dD_part, float* dx, float* ddt, float* dA, float* dB, float* dC,
                                         float* dD, int B, int G, int Gx, int L, int D, int N, int b_sb, int b_sg,
                                         int b_sl, int c_sb, int c_sg, int c_sl, int reverse_mask, int source_pack,
                                         int chunk_len, cudaStream_t stream) {
  if (N != N_STATE || G > 8 || chunk_len < 1 || B * G > 65535 || B * Gx > 65535 ||
      static_cast<long long>(L) * D >= (1LL << 31) || !hs || (Dskip == nullptr) != (dD == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (L + chunk_len - 1) / chunk_len, groups = (D + LANES - 1) / LANES;
  if (chunks > 1 && (!fcarry || !gcarry)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, dt, A, Bm, Cm, Dskip, dy, fcarry, gcarry, hs, dxg, ddt, dBp, dCp, dA_part, dD_part, G, Gx, L, D,
                  b_sb, b_sg, b_sl, c_sb, c_sg, c_sl, reverse_mask, source_pack, chunk_len, chunks, groups,
                  (chunk_len + BWD_TILE - 1) / BWD_TILE};
  const auto bits = reinterpret_cast<unsigned long long>(Bm) | reinterpret_cast<unsigned long long>(Cm) |
                    static_cast<unsigned long long>(4LL * (b_sb | b_sg | b_sl | c_sb | c_sg | c_sl));
  if (bits % 16 == 0) return launch_bwd_passes<4>(a, B, dx, dA, dB, dC, dD, stream);
  if (bits % 8 == 0) return launch_bwd_passes<2>(a, B, dx, dA, dB, dC, dD, stream);
  return launch_bwd_passes<1>(a, B, dx, dA, dB, dC, dD, stream);
}
