// A CPU stand-in for the parts of CUDA that the port's kernels use, so that a kernel source can be compiled with
// g++ and run on small inputs in the CPU tests (tests/test_torch_port_scan_emulated.py).
//
// Each CUDA thread of a block is a coroutine (ucontext); the blocks of a launch run one after another, so a
// kernel's __shared__ arrays become function-local statics and its dynamic shared memory one buffer a launch.
// __syncthreads, __syncwarp and every shuffle are barriers: a thread that reaches one yields until every thread
// of its block (or warp) has reached it. A kernel that races, or that lets the lanes of a warp take a shuffle
// apart, deadlocks here (and aborts) where the card would give wrong values. Inline PTX has no stand-in: the
// test rewrites it (cp.async into a copy, ex2.approx into exp2f) and the <<<...>>> launches into emu::launch.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "invalid value" : "no error"; }
template <class T>
T __ldg(const T* p) {
  return *p;
}

namespace emu {
enum State { RUNNING, WAITING, DONE };
enum Barrier { NONE, WARP, BLOCK };

struct Thread {
  ucontext_t ctx;
  std::vector<char> stack;
  State state;
  Barrier waiting;
};

inline std::vector<Thread> threads;  // the threads of the block that runs
inline ucontext_t scheduler;
inline int current = -1;
inline std::function<void()> body;  // the kernel call of the launch
inline int block_arrived = 0;
inline std::vector<int> warp_arrived;
inline std::vector<float> shuffled[2];  // each lane's value of the last two shuffles
inline std::vector<int> shuffles;       // shuffles each thread has taken
inline std::vector<float> dynamic_smem;

inline void wait_here(Barrier b) {
  const int me = current;
  threads[me].state = WAITING;
  threads[me].waiting = b;
  swapcontext(&threads[me].ctx, &scheduler);
  current = me;
  threadIdx.x = me;
}

// The last thread to arrive releases the others and goes on.
inline void arrive(Barrier b) {
  const int n = static_cast<int>(threads.size());
  int first = 0, last = n, *count = &block_arrived;
  if (b == WARP) {
    first = current / 32 * 32;
    last = min(first + 32, n);
    count = &warp_arrived[current / 32];
  }
  if (++*count < last - first) return wait_here(b);
  *count = 0;
  for (int i = first; i < last; ++i)
    if (threads[i].state == WAITING && threads[i].waiting == b) threads[i].state = RUNNING;
}

inline void run_thread() {
  body();
  threads[current].state = DONE;
}

inline void run_block(int n) {
  threads.assign(n, Thread{});
  warp_arrived.assign((n + 31) / 32, 0);
  shuffled[0].assign(n, 0.f);
  shuffled[1].assign(n, 0.f);
  shuffles.assign(n, 0);
  block_arrived = 0;
  for (auto& t : threads) {
    t.stack.resize(1 << 16);
    getcontext(&t.ctx);
    t.ctx.uc_stack.ss_sp = t.stack.data();
    t.ctx.uc_stack.ss_size = t.stack.size();
    t.ctx.uc_link = &scheduler;
    makecontext(&t.ctx, run_thread, 0);
  }
  for (;;) {
    bool ran = false, done = true;
    for (int i = 0; i < n; ++i) {
      if (threads[i].state == RUNNING) {
        current = i;
        threadIdx.x = i;
        swapcontext(&scheduler, &threads[i].ctx);
        ran = true;
      }
      done = done && threads[i].state == DONE;
    }
    if (done) return;
    if (!ran) {
      fprintf(stderr, "emulated kernel: every thread of block (%u, %u) waits at a barrier\n", blockIdx.x, blockIdx.y);
      abort();
    }
  }
}

inline void launch(dim3 grid, dim3 block, std::function<void()> kernel, size_t smem_bytes) {
  dynamic_smem.assign(smem_bytes / sizeof(float) + 1, 0.f);
  gridDim = grid;
  blockDim = block;
  body = kernel;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      run_block(static_cast<int>(block.x));
    }
}
}  // namespace emu

inline void __syncthreads() { emu::arrive(emu::BLOCK); }
inline void __syncwarp() { emu::arrive(emu::WARP); }

// Every lane posts its value, waits for the warp, then reads its partner's. Two buffers in turn: a lane can be
// one shuffle ahead of the slowest, never two, since the next shuffle's barrier waits for it.
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int me = emu::current, k = emu::shuffles[me]++ & 1;
  emu::shuffled[k][me] = v;
  emu::arrive(emu::WARP);
  return emu::shuffled[k][(me & ~31) | ((me & 31) ^ mask)];
}
