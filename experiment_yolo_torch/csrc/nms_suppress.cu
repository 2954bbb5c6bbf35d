// Greedy hard-NMS keep mask over K score-sorted, class-offset candidates.
//
// Replaces experiment_yolo_tpu/ops/pallas/nms_kernel.py:_nms_suppress_kernel
// (reached through nms_suppress). Box i suppresses every later j with
// IoU(i, j) > thr, provided i is itself still kept; `valid` is the keep set
// the walk starts from.
//
// What bounds it: a chain. Whether i may suppress depends on every decision
// before it, so an image costs K dependent decisions whatever the card's
// width; the IoU arithmetic (K(K-1)/2 pairs) and the bytes are small. An
// earlier kernel ran one block per image and, for every kept box, had all its
// threads test one later box each against it and meet at a barrier: some 300
// clocks per decision (a barrier, an IEEE division, a shared-memory read of
// the flag), 0.21 ms for a batch of 8 at K = 1,024 on an H100, with 8 of the
// card's 132 SMs at work.
//
// Design: the bitmask form of greedy NMS, in two launches.
// 1. nms_suppress_kernel_pairs, over the whole card: a block per (image, 128
//    rows, 64 columns) of the upper triangle, the 64 column boxes in shared
//    memory; a thread owns row i and writes one 64-bit word whose bit t is
//    set where j = 64 * word + t > i and IoU(i, j) > thr. The mask is
//    B x K x ceil(K / 64) words (1 MB for 8 images at K = 1,024: it stays in
//    L2); words left of a row's own word are never written or read.
// 2. nms_suppress_kernel_chain, one warp per image: the "removed" bits live in
//    registers, lane l holding words l, l + 32, ... . The words are walked in
//    order; for word w every lane learns the word's removed and valid bits
//    (a shuffle from the owner lane, two ballots), then the warp runs through
//    the word's surviving candidates only: the lowest alive bit t is kept and
//    its diagonal word (row 64w + t, already in lane t mod 32's registers) is
//    shuffled in and ORed into the word, a few integer operations and one
//    shuffle per kept box. Then every lane ORs the kept rows' words of its own
//    later columns into its registers, eight independent loads at a time. The
//    next word's diagonal words and valid flags are loaded while the current
//    one is resolved. The keep mask is written once.
//
// The IoU is inter / (area_i + area_j - inter + 1e-7), computed with
// explicitly rounded operations so that no multiply-add is contracted: it
// equals the JAX package's and the plain PyTorch version's float32 IoU bit
// for bit, and ties at the threshold break the same way. Every operation in
// it (min, max, the rounded add, subtract and multiply) is commutative in its
// two boxes, so IoU(i, j) = IoU(j, i) exactly and the row-major mask decides
// as the column-wise plain version does.
//
// Kernel K7, rotated boxes (nms_rotated_suppress_launch below), replaces the
// greedy loop of experiment_yolo_tpu/ops/nms.py:_nms_rotated_single (a
// fori_loop over the ProbIoU matrix, not Pallas). It is this file's chain
// behind a pair pass of its own: the bit for (i, j > i) is set where
// ProbIoU(i, j) > thr. The ProbIoU is the plain version's float32 expression
// (ops/boxes.py:probiou, JAX's order and eps placements, both clips, NaN
// passed through as torch.maximum and torch.minimum pass it) in explicitly
// rounded operations, and its scalar divisions are multiplications by the
// rounded reciprocal, as PyTorch's CUDA division by a Python number computes
// them; logf, expf, cosf and sinf are the functions PyTorch's CUDA kernels
// call. So the card's bits equal the plain version's on the card. Swapping
// the two boxes changes no rounded value: the sums and products are
// commutative, (y1 - y2)^2 and (x1 - x2)^2 are squares of exact negations,
// (x2 - x1) * (y1 - y2) negates both factors, and det1 * det2 commutes; so
// ProbIoU(i, j) = ProbIoU(j, i) bit for bit, and the row-major mask decides
// as the plain version's walk over row i does.
#include "common.cuh"

constexpr int PAIR_ROWS = 128;  // rows (threads) per block of the pair pass; its columns are one 64-bit word

__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
}

__global__ void __launch_bounds__(PAIR_ROWS)
nms_suppress_kernel_pairs(const float* __restrict__ boxes, unsigned long long* __restrict__ mask, int K, int W,
                          float thr) {
  const int img = blockIdx.z, word = blockIdx.x, r0 = blockIdx.y * PAIR_ROWS;
  if (word < r0 / 64) return;  // every row of the block lies right of this word: below the diagonal
  __shared__ float x1[64], y1[64], x2[64], y2[64], area[64];
  const float4* bx = reinterpret_cast<const float4*>(boxes) + static_cast<long long>(img) * K;
  const int j0 = word * 64, cols = min(64, K - j0);
  if (threadIdx.x < cols) {
    const float4 b = bx[j0 + threadIdx.x];
    x1[threadIdx.x] = b.x; y1[threadIdx.x] = b.y; x2[threadIdx.x] = b.z; y2[threadIdx.x] = b.w;
    area[threadIdx.x] = area_of(b.x, b.y, b.z, b.w);
  }
  __syncthreads();
  const int i = r0 + threadIdx.x;
  if (i >= K || word < i / 64) return;
  const float4 b = bx[i];
  const float ia = area_of(b.x, b.y, b.z, b.w);
  unsigned long long bits = 0;
  for (int t = max(0, i - j0 + 1); t < cols; ++t) {  // j > i only
    const float iw = fmaxf(__fsub_rn(fminf(x2[t], b.z), fmaxf(x1[t], b.x)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(y2[t], b.w), fmaxf(y1[t], b.y)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float iou = __fdiv_rn(inter, __fadd_rn(__fsub_rn(__fadd_rn(ia, area[t]), inter), 1e-7f));
    if (iou > thr) bits |= 1ull << t;
  }
  mask[(static_cast<long long>(img) * K + i) * W + word] = bits;
}

// WPL: 64-bit words of removed bits per lane, ceil(W / 32).
template <int WPL>
__global__ void __launch_bounds__(32)
nms_suppress_kernel_chain(const unsigned long long* __restrict__ mask, const unsigned char* __restrict__ valid,
                          unsigned char* __restrict__ keep, int K, int W) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  const long long img = blockIdx.x;
  const unsigned long long* m = mask + img * K * W;
  const unsigned char* v = valid + img * K;
  unsigned char* out = keep + img * K;

  unsigned long long removed[WPL];
#pragma unroll
  for (int q = 0; q < WPL; ++q) removed[q] = 0;

  // row r's diagonal word and valid flag; rows past K are invalid and suppress nothing
  auto diag = [&](int r, int w) { return r < K ? m[static_cast<long long>(r) * W + w] : 0ull; };
  auto is_valid = [&](int r) { return r < K && v[r]; };
  unsigned long long d_lo = diag(lane, 0), d_hi = diag(32 + lane, 0);
  bool v_lo = is_valid(lane), v_hi = is_valid(32 + lane);

  for (int w = 0; w < W; ++w) {
    const int row0 = w * 64;
    const unsigned long long cd_lo = d_lo, cd_hi = d_hi;
    const unsigned long long vb = (static_cast<unsigned long long>(__ballot_sync(FULL, v_hi)) << 32) |
                                  __ballot_sync(FULL, v_lo);
    if (w + 1 < W) {  // the next word's loads, in flight while this one is resolved
      d_lo = diag(row0 + 64 + lane, w + 1);
      d_hi = diag(row0 + 96 + lane, w + 1);
      v_lo = is_valid(row0 + 64 + lane);
      v_hi = is_valid(row0 + 96 + lane);
    }
    unsigned long long mine = 0;
#pragma unroll
    for (int q = 0; q < WPL; ++q)
      if (q == (w >> 5)) mine = removed[q];
    unsigned long long cur = __shfl_sync(FULL, mine, w & 31) | ~vb;

    // the word's own candidates, in order; only survivors cost a step
    unsigned long long kept = 0, live = ~cur;
    while (live) {
      const int t = __ffsll(static_cast<long long>(live)) - 1;
      kept |= 1ull << t;
      cur |= __shfl_sync(FULL, t < 32 ? cd_lo : cd_hi, t & 31);
      live = t == 63 ? 0 : ~cur & (~0ull << (t + 1));
    }
    if (row0 + lane < K) out[row0 + lane] = static_cast<unsigned char>((kept >> lane) & 1);
    if (row0 + 32 + lane < K) out[row0 + 32 + lane] = static_cast<unsigned char>((kept >> (32 + lane)) & 1);

    // the kept rows' words of this lane's later columns, eight rows' loads in flight at a time
    for (unsigned long long rest = kept; rest;) {
      int t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        t[u] = rest ? __ffsll(static_cast<long long>(rest)) - 1 : -1;
        rest &= rest - 1;
      }
#pragma unroll
      for (int q = 0; q < WPL; ++q) {
        const int word = lane + 32 * q;
        if (word > w && word < W) {
          unsigned long long acc = 0;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (t[u] >= 0) acc |= m[static_cast<long long>(row0 + t[u]) * W + word];
          removed[q] |= acc;
        }
      }
    }
  }
}

// ---- K7: the pair pass on the ProbIoU of xywhr boxes -------------------------------------------------------------

constexpr float PROBIOU_EPS = 1e-7f;

// torch.maximum / torch.minimum against a bound: NaN passes through
__device__ __forceinline__ float clip_lo(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clip_hi(float v, float hi) { return v != v ? v : fminf(v, hi); }

// A box's covariance terms a, b, c and its determinant clipped at 0.
struct Cov { float x, y, a, b, c, det; };

__device__ __forceinline__ Cov cov_of(const float* box) {
  const float inv12 = 1.0f / 12.0f;  // x / 12.0 on the card: x times the rounded reciprocal
  const float w = box[2], h = box[3], r = box[4];
  const float a = __fmul_rn(__fmul_rn(w, w), inv12), b = __fmul_rn(__fmul_rn(h, h), inv12);
  const float co = cosf(r), si = sinf(r);
  const float cc = __fmul_rn(co, co), ss = __fmul_rn(si, si);
  Cov v;
  v.x = box[0];
  v.y = box[1];
  v.a = __fadd_rn(__fmul_rn(a, cc), __fmul_rn(b, ss));
  v.b = __fadd_rn(__fmul_rn(a, ss), __fmul_rn(b, cc));
  v.c = __fsub_rn(__fmul_rn(__fmul_rn(a, co), si), __fmul_rn(__fmul_rn(b, si), co));
  v.det = clip_lo(__fsub_rn(__fmul_rn(v.a, v.b), __fmul_rn(v.c, v.c)), 0.f);
  return v;
}

// ProbIoU(p, q) of ops/boxes.py:probiou, p the first box
__device__ __forceinline__ float probiou_of(const Cov& p, const Cov& q) {
  const float A = __fadd_rn(p.a, q.a), B = __fadd_rn(p.b, q.b), C = __fadd_rn(p.c, q.c);
  const float dx = __fsub_rn(p.x, q.x), dy = __fsub_rn(p.y, q.y);
  const float core = __fsub_rn(__fmul_rn(A, B), __fmul_rn(C, C));
  const float denom = __fadd_rn(core, PROBIOU_EPS);
  const float t1 = __fmul_rn(__fdiv_rn(__fadd_rn(__fmul_rn(A, __fmul_rn(dy, dy)), __fmul_rn(B, __fmul_rn(dx, dx))),
                                       denom), 0.25f);
  const float t2 = __fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(C, __fsub_rn(q.x, p.x)), dy), denom), 0.5f);
  const float root = __fmul_rn(4.f, __fsqrt_rn(__fmul_rn(p.det, q.det)));
  const float t3 = __fmul_rn(logf(__fadd_rn(__fdiv_rn(core, __fadd_rn(root, PROBIOU_EPS)), PROBIOU_EPS)), 0.5f);
  const float bd = clip_hi(clip_lo(__fadd_rn(__fadd_rn(t1, t2), t3), PROBIOU_EPS), 100.f);
  const float hd = __fsqrt_rn(__fadd_rn(__fsub_rn(1.f, expf(-bd)), PROBIOU_EPS));
  return __fsub_rn(1.f, hd);
}

// A block per (image, PAIR_ROWS rows, one 64-column word) of the upper
// triangle, as nms_suppress_kernel_pairs: the 64 column boxes' terms in
// shared memory, each row's terms once in registers.
__global__ void __launch_bounds__(PAIR_ROWS)
nms_rotated_kernel_pairs(const float* __restrict__ boxes, unsigned long long* __restrict__ mask, int K, int W,
                         float thr) {
  const int img = blockIdx.z, word = blockIdx.x, r0 = blockIdx.y * PAIR_ROWS;
  if (word < r0 / 64) return;
  __shared__ Cov col[64];
  const float* bx = boxes + static_cast<long long>(img) * K * 5;
  const int j0 = word * 64, cols = min(64, K - j0);
  if (threadIdx.x < cols) col[threadIdx.x] = cov_of(bx + (j0 + threadIdx.x) * 5);
  __syncthreads();
  const int i = r0 + threadIdx.x;
  if (i >= K || word < i / 64) return;
  const Cov row = cov_of(bx + i * 5);
  unsigned long long bits = 0;
  for (int t = max(0, i - j0 + 1); t < cols; ++t)  // j > i only
    if (probiou_of(row, col[t]) > thr) bits |= 1ull << t;
  mask[(static_cast<long long>(img) * K + i) * W + word] = bits;
}

static int chain_launch(const unsigned long long* mask, const unsigned char* valid, unsigned char* keep, int B, int K,
                        int W, cudaStream_t stream) {
  const int wpl = (W + 31) / 32;
  if (wpl == 1)
    nms_suppress_kernel_chain<1><<<B, 32, 0, stream>>>(mask, valid, keep, K, W);
  else if (wpl == 2)
    nms_suppress_kernel_chain<2><<<B, 32, 0, stream>>>(mask, valid, keep, K, W);
  else
    nms_suppress_kernel_chain<4><<<B, 32, 0, stream>>>(mask, valid, keep, K, W);
  return static_cast<int>(cudaGetLastError());
}

// boxes: (B, K, 4) f32 xyxy contiguous, 16-byte aligned; valid, keep: (B, K)
// bool (one byte each); mask: (B, K, ceil(K / 64)) 64-bit scratch, written
// and read here (no fill needed). K <= 8,192.
extern "C" int nms_suppress_launch(const float* boxes, const unsigned char* valid, unsigned char* keep,
                                   unsigned long long* mask, int B, int K, float thr, cudaStream_t stream) {
  if (B == 0 || K == 0) return static_cast<int>(cudaSuccess);
  const int W = (K + 63) / 64;
  if (W > 128 || B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 pairs(W, (K + PAIR_ROWS - 1) / PAIR_ROWS, B);
  nms_suppress_kernel_pairs<<<pairs, PAIR_ROWS, 0, stream>>>(boxes, mask, K, W, thr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return chain_launch(mask, valid, keep, B, K, W, stream);
}

// K7. boxes: (B, K, 5) f32 xywhr contiguous, the class offset on the centres;
// valid, keep, mask and K as for nms_suppress_launch.
extern "C" int nms_rotated_suppress_launch(const float* boxes, const unsigned char* valid, unsigned char* keep,
                                           unsigned long long* mask, int B, int K, float thr, cudaStream_t stream) {
  if (B == 0 || K == 0) return static_cast<int>(cudaSuccess);
  const int W = (K + 63) / 64;
  if (W > 128 || B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 pairs(W, (K + PAIR_ROWS - 1) / PAIR_ROWS, B);
  nms_rotated_kernel_pairs<<<pairs, PAIR_ROWS, 0, stream>>>(boxes, mask, K, W, thr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return chain_launch(mask, valid, keep, B, K, W, stream);
}
