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
