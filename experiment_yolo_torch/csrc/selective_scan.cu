// Selective scan (the Mamba state-space recurrence), all directions of a
// block in one launch:
//
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t      state (D, N) per sequence
//   y_t = C_t . h_t + Dskip * x_t
//
// Replaces experiment_yolo_tpu/ops/pallas/selective_scan.py:_scan_kernel
// (reached through selective_scan_pallas), together with the D*x term that
// the JAX function adds outside its kernel. The TPU kernel holds one whole
// (L, D) sequence and the (D, N) state in VMEM per program and walks L with
// a fori_loop; a sequence of 25,600 steps does not fit a block's shared
// memory here, and nothing needs it to: the state is one register.
//
// Bound: the chain of L dependent steps, far more than bytes. One launch over
// (B, G, L, D) at B = 8, G = 4, L = 25,600, D = 32 moves 420 MB (0.13 ms at
// the card's memory rate), but every (sequence, channel, state) must take its
// L steps in order, and at that shape the launch has only about one warp per
// SM scheduler, so nothing hides a step's latency but the kernel's own code.
//
// Design: one thread per (sequence, channel, state), the N = 16 states of a
// channel in 16 neighbouring lanes, 8 channels (128 threads) per block, the
// loop over L inside the kernel.
// - The chain itself is one multiply and one add per step; exp(dt*A), dt*B*x
//   and the sum of C*h over the 16 lanes do not depend on h_{t-1}, and the
//   loop is unrolled by 16 so that they overlap across steps.
// - No step waits for device memory. The block streams its x, dt (8 channels:
//   one 32-byte sector per step) and B, C (one 64-byte line per step, shared
//   by every channel of the sequence) through a ring of STAGES tiles of TILE
//   steps in shared memory, filled by cp.async: while one tile is consumed
//   the next STAGES - 1 are in flight, 128 steps ahead. A first version that
//   loaded 8 steps ahead into registers spent a device-memory latency on
//   every 8 steps and was several times slower.
// - The sums over the 16 lanes are taken 16 steps at a time: at each of the
//   four butterfly stages a lane keeps half of its values and hands the other
//   half to its partner, so 15 shuffles do the work of 64, and lane n ends
//   with the sum of step n and stores it. The additions are those of the
//   plain butterfly, pair for pair.
//
// The recurrence uses expf and explicitly rounded multiplies and adds (no
// fused multiply-add, no fast-math): the state matches the plain PyTorch
// version's float32 state bit for bit over all L steps.
#include <math.h>
#include "common.cuh"

constexpr int N_STATE = 16;       // states per channel, one lane each
constexpr int CH_PER_BLOCK = 8;   // channels per block
constexpr int THREADS = N_STATE * CH_PER_BLOCK;
constexpr int TILE = 64;          // steps per stage of the shared-memory ring (12 KB a stage)
constexpr int STAGES = 3;         // stages: STAGES - 1 tiles are in flight while one is consumed
constexpr int GROUP = 16;         // steps whose 16-lane sums are taken together
static_assert(GROUP == N_STATE && TILE % GROUP == 0, "lane n of a channel ends a group with step n");

struct Stage {
  float x[TILE][CH_PER_BLOCK], dt[TILE][CH_PER_BLOCK], b[TILE][N_STATE], c[TILE][N_STATE];
};

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}

// Start the copy of steps t0 .. t0+TILE-1 of the block's channels into one stage; past the end of the
// sequence or of the channels the last one is copied again (its results are never stored).
__device__ __forceinline__ void load_tile(Stage& s, const float* __restrict__ xs, const float* __restrict__ dts,
                                          const float* __restrict__ bs, const float* __restrict__ cs,
                                          int t0, int d0, int L, int D) {
  for (int i = threadIdx.x; i < TILE * CH_PER_BLOCK; i += THREADS) {
    const int t = i / CH_PER_BLOCK, ch = i % CH_PER_BLOCK;
    const long long at = static_cast<long long>(min(t0 + t, L - 1)) * D + min(d0 + ch, D - 1);
    cp_async_4(&s.x[t][ch], xs + at);
    cp_async_4(&s.dt[t][ch], dts + at);
  }
  for (int i = threadIdx.x; i < TILE * (N_STATE / 4); i += THREADS) {
    const int t = i / (N_STATE / 4), j = 4 * (i % (N_STATE / 4));
    const long long at = static_cast<long long>(min(t0 + t, L - 1)) * N_STATE + j;
    cp_async_16(&s.b[t][j], bs + at);
    cp_async_16(&s.c[t][j], cs + at);
  }
}

__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ Dskip,
                      float* __restrict__ y, int G, int L, int D) {
  __shared__ __align__(16) Stage ring[STAGES];
  const int n = threadIdx.x % N_STATE, ch = threadIdx.x / N_STATE;
  const int d0 = blockIdx.x * CH_PER_BLOCK;
  const bool live = d0 + ch < D;         // a ragged last block keeps its lanes in the shuffles
  const int d = live ? d0 + ch : D - 1;
  const long long seq = blockIdx.y;      // b * G + g
  const int g = static_cast<int>(seq % G);

  const float* xs = x + seq * L * D;
  const float* dts = dt + seq * L * D;
  const float* bs = Bm + seq * L * N_STATE;
  const float* cs = Cm + seq * L * N_STATE;
  float* ys = y + seq * L * D + d;
  const float a = A[(static_cast<long long>(g) * D + d) * N_STATE + n];
  const float dskip = Dskip ? Dskip[static_cast<long long>(g) * D + d] : 0.f;
  const bool up8 = n & 8, up4 = n & 4, up2 = n & 2, up1 = n & 1;

  const int tiles = (L + TILE - 1) / TILE;
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < tiles) load_tile(ring[k], xs, dts, bs, cs, k * TILE, d0, L, D);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  float h = 0.f;
  for (int k = 0; k < tiles; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));  // this thread's copies of tile k have landed
    __syncthreads();  // so have everyone's, and everyone is done with tile k-1, whose stage is refilled next
    if (k + STAGES - 1 < tiles)
      load_tile(ring[(k + STAGES - 1) % STAGES], xs, dts, bs, cs, (k + STAGES - 1) * TILE, d0, L, D);
    asm volatile("cp.async.commit_group;\n" ::);
    const Stage& s = ring[k % STAGES];
#pragma unroll
    for (int g0 = 0; g0 < TILE; g0 += GROUP) {
      float q[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const float dtv = s.dt[g0 + i][ch];
        const float da = expf(__fmul_rn(dtv, a));
        const float dbx = __fmul_rn(__fmul_rn(dtv, s.b[g0 + i][n]), s.x[g0 + i][ch]);
        h = __fadd_rn(__fmul_rn(h, da), dbx);
        q[i] = __fmul_rn(h, s.c[g0 + i][n]);
      }
      // the sums over the 16 lanes, 16 steps at once: at each stage a lane keeps half of its values and
      // hands the other half to its partner, so 15 shuffles do what 64 would, and lane n ends with step n
      float r8[8], r4[4], r2[2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r8[j] = (up8 ? q[j + 8] : q[j]) + __shfl_xor_sync(0xffffffffu, up8 ? q[j] : q[j + 8], 8, N_STATE);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r4[j] = (up4 ? r8[j + 4] : r8[j]) + __shfl_xor_sync(0xffffffffu, up4 ? r8[j] : r8[j + 4], 4, N_STATE);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        r2[j] = (up2 ? r4[j + 2] : r4[j]) + __shfl_xor_sync(0xffffffffu, up2 ? r4[j] : r4[j + 2], 2, N_STATE);
      float r = (up1 ? r2[1] : r2[0]) + __shfl_xor_sync(0xffffffffu, up1 ? r2[0] : r2[1], 1, N_STATE);
      const int t = k * TILE + g0 + n;
      if (live && t < L) {
        if (Dskip) r = __fadd_rn(r, __fmul_rn(s.x[g0 + n][ch], dskip));
        ys[static_cast<long long>(t) * D] = r;
      }
    }
  }
}

// x, dt, y: (B, G, L, D); A: (G, D, N); Bm, Cm: (B, G, L, N), 16-byte aligned;
// Dskip: (G, D) or null (no skip term); all f32 contiguous, N = 16. G is the
// number of scan directions that share the launch (1 for a single scan).
extern "C" int selective_scan_launch(const float* x, const float* dt, const float* A, const float* Bm,
                                     const float* Cm, const float* Dskip, float* y, int B, int G, int L, int D,
                                     int N, cudaStream_t stream) {
  if (N != N_STATE) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((D + CH_PER_BLOCK - 1) / CH_PER_BLOCK, B * G);
  selective_scan_kernel<<<grid, THREADS, 0, stream>>>(x, dt, A, Bm, Cm, Dskip, y, G, L, D);
  return static_cast<int>(cudaGetLastError());
}
