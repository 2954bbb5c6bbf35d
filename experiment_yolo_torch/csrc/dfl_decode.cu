// DFL decode: softmax expectation over reg_max bins, read in place from the
// box channels of an NCHW Detect head map, and its analytic backward.
//
// Replaces experiment_yolo_tpu/ops/pallas/dfl_decode.py:_fwd_kernel and
// _bwd_kernel (reached through dfl_decode_pallas). The TPU kernels packed two
// anchors per 128-lane row and reduced with a segment matmul; on Hopper that
// packing buys nothing.
//
// Forward. Bound: memory for f32 maps; for bf16 maps the arithmetic comes
// close. Each (anchor, side) reads reg_max logits once and writes one float,
// and each logit costs a widening, a max, a subtraction, an accurate expf
// (seven f32 operations and one MUFU.EX2) and two sums: about 12 issue slots
// against 2 bytes in bf16 (4 in f32), near the bytes' time at the card's
// rates. Design:
// - one launch decodes every level of a head (up to MAX_LEVELS). The launch
//   gets a level table (each level's map, anchor count, batch stride, first
//   anchor in the concatenated (B, sum A_i, 4) output, anchors a thread, and
//   the running sum of its blocks); a block finds its level by comparing
//   blockIdx.x with that sum, and blockIdx.y is the image;
// - a thread owns `width` consecutive anchors and all four sides: one 4-byte
//   load a bin (two bf16 anchors, one f32 anchor), so each bin load of a warp
//   is one whole 128-byte line of a channel plane, and it writes each anchor's
//   four distances as one float4. The host takes a narrower width where a
//   level's anchor count, batch stride or address is no multiple of the load
//   (ops/kernels/dfl_decode.py:level_width). Wider loads lost on the card
//   (kernel_variants k1 / k1bf16): every width the kernel may take is
//   instantiated in it and its registers are the widest one's, and a thread
//   of 8 or 16 bytes a load runs its side groups one after another;
// - reg_max = 16 is a template constant: the bin loops unroll, a thread's
//   loads go out ahead of the arithmetic and the logits stay in registers
//   through the max and the exp, so each is read from device memory once. Any
//   other reg_max runs the same template with a runtime count (reading each
//   logit twice, as the first design did).
// The arithmetic of a group is the first design's, in the same order: m = max,
// e = expf(x - m), num += e * r and den += e in bin order, then num / den; the
// output is bit-equal to it.
//
// bf16 forms (the maps of a bf16 model): the same kernels templated on the
// map's type. A bf16 logit is widened exactly (to the f32 whose top half it
// is, as __bfloat162float does) and every operation after it is the f32
// form's, as the Pallas kernels widen a bf16 input first; the forward writes
// f32 distances, the backward rounds dx once to bf16 (__float2bfloat16_rn).
// They read half the map's bytes.
#include <math.h>
#include "common.cuh"

constexpr int MAX_LEVELS = 4;
constexpr int DECODE_THREADS = 128;  // ops/kernels/dfl_decode.py:THREADS
constexpr int MAX_LOAD_BYTES = 4;    // a thread's load a bin at most (ops/kernels/dfl_decode.py:MAX_LOAD_BYTES)
constexpr int REG_MAX = 16;  // the compile-time bin count; others take the runtime instance

struct Levels {
  const void* x[MAX_LEVELS];
  long long batch_stride[MAX_LEVELS];  // elements
  int anchors[MAX_LEVELS];
  int first[MAX_LEVELS];      // the level's first anchor in the output
  int width[MAX_LEVELS];      // anchors a thread: 1, 2, 4 or 8, at most MAX_LOAD_BYTES a load
  int block_end[MAX_LEVELS];  // blocks of this level and those before it
  int n;
};

// `V` consecutive logits of one channel plane as 32-bit words, loaded as one
// access of V * sizeof(T) bytes (a 2-byte load fills the low half of a word).
template <typename T, int V>
struct Run {
  static constexpr int BYTES = V * static_cast<int>(sizeof(T));
  static constexpr int WORDS = (BYTES + 3) / 4;
  unsigned w[WORDS];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (BYTES == 2) {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    } else if constexpr (BYTES == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else if constexpr (BYTES == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else {
      static_assert(BYTES == 16, "a load is 2, 4, 8 or 16 bytes");
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    }
  }

  // logit j widened exactly to f32 (a bf16 is the top half of its f32)
  __device__ __forceinline__ float operator[](int j) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[j]);
    else return __uint_as_float(j & 1 ? w[j >> 1] & 0xffff0000u : w[j >> 1] << 16);
  }
};

// One thread's `V` anchors, all four sides: x points at its first anchor in
// the first box channel of its image, out at that anchor's row of the output.
template <typename T, int REG, int V>
__device__ __forceinline__ void decode_anchors(const T* __restrict__ x, float* __restrict__ out, long long A,
                                               int reg_max) {
  using R = Run<T, V>;
  float res[4][V];
  if constexpr (REG > 0) {
    constexpr int SIDES = 4 / R::WORDS;  // sides whose loads go out together: 64 words of logits
#pragma unroll
    for (int s0 = 0; s0 < 4; s0 += SIDES) {
      R v[SIDES][REG];
#pragma unroll
      for (int s = 0; s < SIDES; ++s)
#pragma unroll
        for (int r = 0; r < REG; ++r) v[s][r].load(x + ((s0 + s) * REG + r) * A);
#pragma unroll
      for (int s = 0; s < SIDES; ++s)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float m = -INFINITY;
#pragma unroll
          for (int r = 0; r < REG; ++r) m = fmaxf(m, v[s][r][j]);
          float num = 0.f, den = 0.f;
#pragma unroll
          for (int r = 0; r < REG; ++r) {
            const float e = expf(v[s][r][j] - m);
            num += e * static_cast<float>(r);
            den += e;
          }
          res[s0 + s][j] = num / den;
        }
    }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const T* p = x + static_cast<long long>(s) * reg_max * A;
      float m[V], num[V], den[V];
#pragma unroll
      for (int j = 0; j < V; ++j) m[j] = -INFINITY, num[j] = 0.f, den[j] = 0.f;
      for (int r = 0; r < reg_max; ++r) {
        R v;
        v.load(p + r * A);
#pragma unroll
        for (int j = 0; j < V; ++j) m[j] = fmaxf(m[j], v[j]);
      }
      for (int r = 0; r < reg_max; ++r) {
        R v;
        v.load(p + r * A);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float e = expf(v[j] - m[j]);
          num[j] += e * static_cast<float>(r);
          den[j] += e;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) res[s][j] = num[j] / den[j];
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    reinterpret_cast<float4*>(out)[j] = make_float4(res[0][j], res[1][j], res[2][j], res[3][j]);
}

template <typename T, int REG>
__global__ void __launch_bounds__(DECODE_THREADS) dfl_decode_kernel(const Levels lv, float* __restrict__ out,
                                                                    int total, int reg_max) {
  const int bx = blockIdx.x;
  int l = 0;  // the block's level: levels whose blocks all come before bx
#pragma unroll
  for (int i = 0; i < MAX_LEVELS - 1; ++i) l += i < lv.n - 1 && bx >= lv.block_end[i];
  const void* xp = lv.x[0];
  long long stride = lv.batch_stride[0];
  int A = lv.anchors[0], first = lv.first[0], width = lv.width[0], start = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (l == i) {
      xp = lv.x[i], stride = lv.batch_stride[i], A = lv.anchors[i], first = lv.first[i], width = lv.width[i];
      start = lv.block_end[i - 1];
    }
  const int a0 = ((bx - start) * DECODE_THREADS + static_cast<int>(threadIdx.x)) * width;
  if (a0 >= A) return;  // A is a multiple of width: a thread has all its anchors or none
  const int b = blockIdx.y;
  const T* x = static_cast<const T*>(xp) + b * stride + a0;
  float* o = out + (static_cast<long long>(b) * total + first + a0) * 4;
  // each width a level may take is instantiated: the kernel's registers are the widest one's
  switch (width) {
    case 1: decode_anchors<T, REG, 1>(x, o, A, reg_max); break;
    case 2: if constexpr (2 * sizeof(T) <= MAX_LOAD_BYTES) decode_anchors<T, REG, 2>(x, o, A, reg_max); break;
    case 4: if constexpr (4 * sizeof(T) <= MAX_LOAD_BYTES) decode_anchors<T, REG, 4>(x, o, A, reg_max); break;
    case 8: if constexpr (8 * sizeof(T) <= MAX_LOAD_BYTES) decode_anchors<T, REG, 8>(x, o, A, reg_max); break;
  }
}

template <typename T>
static int dfl_decode_run(const T* const* x, float* out, int B, int total, int n, int reg_max, const int* anchors,
                          const long long* stride, const int* width, const int* first, const int* block_end,
                          cudaStream_t stream) {
  if (n < 1 || n > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  lv.n = n;
  for (int i = 0; i < n; ++i) {
    lv.x[i] = x[i], lv.batch_stride[i] = stride[i], lv.anchors[i] = anchors[i], lv.first[i] = first[i];
    lv.width[i] = width[i], lv.block_end[i] = block_end[i];
  }
  const dim3 grid(block_end[n - 1], B);
  if (reg_max == REG_MAX)
    dfl_decode_kernel<T, REG_MAX><<<grid, DECODE_THREADS, 0, stream>>>(lv, out, total, reg_max);
  else
    dfl_decode_kernel<T, 0><<<grid, DECODE_THREADS, 0, stream>>>(lv, out, total, reg_max);
  return static_cast<int>(cudaGetLastError());
}

// Every level of a head in one launch. x0..x3: the levels' (B, no, H_i, W_i)
// maps, box channels first (no >= 4*reg_max), f32, in output order, those past
// `levels` unused; out: (B, total, 4) f32, total = sum A_i. Per level: A_i =
// H_i*W_i anchors, its batch stride in elements, anchors a thread (A_i, the
// stride and the address multiples of it, at most MAX_LOAD_BYTES a load), its
// first anchor in out, and the blocks of it and the levels before it.
extern "C" int dfl_decode_launch(const float* x0, const float* x1, const float* x2, const float* x3, float* out,
                                 int B, int total, int levels, int reg_max, int A0, int A1, int A2, int A3,
                                 long long s0, long long s1, long long s2, long long s3, int w0, int w1, int w2,
                                 int w3, int f0, int f1, int f2, int f3, int e0, int e1, int e2, int e3,
                                 cudaStream_t stream) {
  const float* const x[] = {x0, x1, x2, x3};
  const int A[] = {A0, A1, A2, A3}, w[] = {w0, w1, w2, w3}, f[] = {f0, f1, f2, f3}, e[] = {e0, e1, e2, e3};
  const long long s[] = {s0, s1, s2, s3};
  return dfl_decode_run(x, out, B, total, levels, reg_max, A, s, w, f, e, stream);
}

// The same with bf16 maps; out stays f32.
extern "C" int dfl_decode_bf16_launch(const __nv_bfloat16* x0, const __nv_bfloat16* x1, const __nv_bfloat16* x2,
                                      const __nv_bfloat16* x3, float* out, int B, int total, int levels, int reg_max,
                                      int A0, int A1, int A2, int A3, long long s0, long long s1, long long s2,
                                      long long s3, int w0, int w1, int w2, int w3, int f0, int f1, int f2, int f3,
                                      int e0, int e1, int e2, int e3, cudaStream_t stream) {
  const __nv_bfloat16* const x[] = {x0, x1, x2, x3};
  const int A[] = {A0, A1, A2, A3}, w[] = {w0, w1, w2, w3}, f[] = {f0, f1, f2, f3}, e[] = {e0, e1, e2, e3};
  const long long s[] = {s0, s1, s2, s3};
  return dfl_decode_run(x, out, B, total, levels, reg_max, A, s, w, f, e, stream);
}

// Backward: with p = softmax(x) over one (anchor, side) group and y its
// expectation, d x_r = p_r * g * (r - y), one launch a level. Nothing of the forward's softmax is
// saved: each thread recomputes its group's max and denominator from x, reads
// the saved y and the incoming g once, and writes reg_max gradients into the
// box channels of an NCHW map of the head's shape (the caller zeroes the
// class channels). y and g are the forward's concatenated (B, total, 4)
// tensors, read in place at the level's first anchor. Bound: memory, about 2*reg_max + 2 floats per group; the
// layout is the forward's, so every bin load and store of a warp is one
// contiguous line.
template <typename T>
__global__ void dfl_decode_bwd_kernel(const T* __restrict__ x, const float* __restrict__ y,
                                      const float* __restrict__ g, T* __restrict__ dx,
                                      int A, long long batch_stride, int reg_max, int total, int first) {
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
  const long long o = (static_cast<long long>(b) * total + first + a) * 4 + side;
  const float yv = y[o], gv = g[o];
  const float inv_den = 1.f / den;
  for (int r = 0; r < reg_max; ++r) {
    const float pr = expf(widen(p[static_cast<long long>(r) * A]) - m) * inv_den;
    store(d + static_cast<long long>(r) * A, pr * gv * (static_cast<float>(r) - yv));
  }
}

template <typename T>
static int dfl_decode_bwd_run(const T* x, const float* y, const float* g, T* dx, int B, int A,
                              long long batch_stride, int reg_max, int total, int first, cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((A + threads - 1) / threads, 4, B);
  dfl_decode_bwd_kernel<T><<<grid, threads, 0, stream>>>(x, y, g, dx, A, batch_stride, reg_max, total, first);
  return static_cast<int>(cudaGetLastError());
}

// x, dx: (B, no, H, W) f32 contiguous, box channels first; y, g: (B, total, 4)
// f32, the level's A = H*W anchors from `first` on.
extern "C" int dfl_decode_bwd_launch(const float* x, const float* y, const float* g, float* dx, int B, int A,
                                     long long batch_stride, int reg_max, int total, int first,
                                     cudaStream_t stream) {
  return dfl_decode_bwd_run(x, y, g, dx, B, A, batch_stride, reg_max, total, first, stream);
}

// The same with x and dx bf16; y and g stay f32.
extern "C" int dfl_decode_bwd_bf16_launch(const __nv_bfloat16* x, const float* y, const float* g, __nv_bfloat16* dx,
                                          int B, int A, long long batch_stride, int reg_max, int total, int first,
                                          cudaStream_t stream) {
  return dfl_decode_bwd_run(x, y, g, dx, B, A, batch_stride, reg_max, total, first, stream);
}
