// Gaussian soft-NMS: the kept score of each of K score-sorted, class-offset
// candidates, -1 where a candidate is not kept.
//
// Replaces experiment_yolo_tpu/ops/nms.py:_soft_nms_keep, a lax.fori_loop in
// JAX (not a Pallas kernel) and a Python loop of small torch ops in the port.
// Each step picks the best live score (ties to the lower index, as argmax
// breaks them), keeps it while it is above 0.25, decays by exp(-iou^2 / 0.5)
// every live score whose IoU with the pick is above the threshold, and
// removes the pick. In quirk mode the first pick is `first_idx`, and a step
// keeps while at least two live scores are above 0.25, step 0 taking
// `n_valid` as that count.
//
// What bounds it: a chain. Every step depends on the live scores the step
// before left, so an image costs its steps one after another; each step needs
// at least ceil(log2 K) dependent compares for the argmax. The bytes (20 per
// candidate) are small. One block per image also puts the decay of a whole
// pool on one SM (8 of 132 at a batch of 8): where every one of 4,096
// candidates stays above the floor (an untrained detector's val pool), that
// pass is half of a step's time and the chain of reductions, barrier and
// broadcast the other half.
//
// An image leaves its loop at the first step that does not keep, and the
// result is the plain loop's: a step that does not keep decays nothing, so
// afterwards live scores only lose the picks, set to -1. Without the quirk a
// step keeps while the best live score is above 0.25; once it is not, no live
// score is above 0.25 again. In quirk mode a later step keeps while at least
// two live scores are above 0.25; once fewer are, no step adds one. Step 0
// fails only with n_valid < 2: at most one candidate passed conf, and that one
// (when there is one) is the pick, forced into the pool, so step 1 counts no
// live score above 0.25 (an invalid candidate's live score is -1).
//
// For the same reason a candidate at or below 0.25 decides nothing after the
// quirk's step 0: a decay only lowers a score (a rounded product with a
// factor of at most 1), so it is never kept, never the pick of a step that
// keeps (such a step's best score is above 0.25), and never counted. So the
// kernel drops those candidates at load: a stable compaction keeps the n
// others in index order, and with them each one's original index for the
// output; a score that later decays to the floor or below is set to 0. The
// quirk's first pick is read from the full pool, whatever its score. A pool
// like a trained detector's at conf 0.001 keeps a few hundred of 4,096.
//
// Design: one block per image; thread tid holds the compacted positions
// c * nt + tid, C of them (a template parameter, at least MIN_PER_THREAD), in
// registers: box, area, live score. The position stands for the index, since
// the compaction keeps the order. The steps run on the nt = ceil(n / C)
// threads (rounded to warps) that hold the survivors: with one warp no barrier
// is left at all. The boxes also sit in shared memory, read-only, so that
// every thread reads the pick's box with one broadcast load. A step is:
// - the decay pass: each thread runs the exact pre-test (below) on all its
//   candidates, branch-free, and only the rare ones that fail it take the
//   division and expf;
// - each thread's best key by a tree over its candidates (on a tie the lower
//   position stays). The key is the live score's bits (0 at or below the
//   floor): positive floats order like their bits;
// - one warp-wide `redux` per quantity (sm_80+, one instruction each): the
//   largest key, the lowest position holding it, and (quirk) the sum of the
//   threads' counts of live scores, which each thread keeps up to date as its
//   scores drop instead of recounting;
// - lane 0 of each warp writes (key, position, count) into a slot, one
//   barrier, and every warp reads all the slots and reduces them itself, so
//   that no second barrier hands the pick round. The slots are
//   double-buffered by the parity of the step: a warp that has read step t's
//   slots and run ahead writes step t + 1's into the other buffer, while a
//   slower warp may still be reading step t's; it cannot reach step t + 2's
//   writes (into step t's buffer) before every warp has passed step t + 1's
//   barrier, that is, has finished reading;
// - the pick's owner zeroes its score; thread 0 writes the kept score.
//
// The IoU is the plain version's inter / (area1 + area2 - inter + 1e-7) and
// the decay its exp(-(iou * iou) / 0.5) times the live score, each operation
// rounded once with the explicit intrinsics, so that nvcc contracts no
// multiply-add, and expf at full precision (no fast math): the kept sets and
// the scores equal the plain version's on the card bit for bit, ties at the
// threshold and at the 0.25 floor included. Most candidates do not overlap the
// pick enough to decay, so the division waits behind an exact test: with the
// union u > 0 rounded as the plain version rounds it, fmaf(thr, u, -inter)
// rounds thr * u - inter once, so its sign is the sign of the exact value; if
// it is >= 0, then inter / u <= thr exactly, so the rounded quotient is <= thr
// as well (rounding is monotone and thr is a float) and the score stays as it
// is. Only the others take the division, the `iou > thr` test and expf.
#include <climits>
#include <cmath>

#include "common.cuh"

constexpr int THREADS = 512;  // threads per image at most (at most 1,024: a warp reads every warp's slot)
constexpr int MIN_PER_THREAD = 2;  // candidates per thread at least (C doubles while C * THREADS < K)
constexpr int MAX_K = 8192;
constexpr float KEEP_FLOOR = 0.25f;  // the fork's soft-NMS score threshold, whatever conf is
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// The intersection and the union of the pick p (area pa) and box b, rounded as the plain version rounds them.
__device__ __forceinline__ void overlap(float4 p, float pa, float4 b, float area, float& inter, float& u) {
  const float iw = fmaxf(__fsub_rn(fminf(p.z, b.z), fmaxf(p.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(p.w, b.w), fmaxf(p.y, b.y)), 0.f);
  inter = __fmul_rn(iw, ih);
  u = __fadd_rn(__fsub_rn(__fadd_rn(pa, area), inter), 1e-7f);
}

// C: candidates per thread, a power of two with C * blockDim.x >= K.
template <int C>
__global__ void __launch_bounds__(THREADS)
soft_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                const unsigned char* __restrict__ valid, const long long* __restrict__ first_idx,
                const long long* __restrict__ n_valid, float* __restrict__ out, int K, int steps, float thr) {
  extern __shared__ float4 smem[];
  float4* s_box = smem;                                     // compacted boxes
  float* s_live = reinterpret_cast<float*>(s_box + K);      // compacted scores, read once into registers
  int* s_orig = reinterpret_cast<int*>(s_live + K);         // compacted position -> index in the pool
  __shared__ int s_base[C * (THREADS / 32)];              // (c, warp) -> compacted position of its first
  __shared__ uint4 s_slot[2][32];                           // per warp: key, position, count
  __shared__ int s_n, s_first;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const long long img = blockIdx.x;
  const bool quirk = first_idx != nullptr;
  const float4* bx = boxes + img * K;
  const float* sc = scores + img * K;
  const unsigned char* ok = valid + img * K;
  float* o = out + img * K;

  // Stable compaction of the candidates above the floor: a ballot per (c, warp), a scan of the counts.
  for (int c = 0; c < C; ++c) {
    const int j = c * blockDim.x + tid;
    const unsigned alive = __ballot_sync(FULL, j < K && ok[j] && sc[j] > KEEP_FLOOR);
    if (lane == 0) s_base[c * nw + warp] = __popc(alive);
    if (j < K) o[j] = -1.f;
  }
  if (tid == 0) s_first = -1;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the C * nw counts, in (c, warp) order: index order
    const int m = C * nw, per = (m + 31) / 32, lo = min(m, lane * per), hi = min(m, lo + per);
    int sum = 0;
    for (int e = lo; e < hi; ++e) sum += s_base[e];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - sum;
    for (int e = lo; e < hi; ++e) {
      const int v = s_base[e];
      s_base[e] = run;
      run += v;
    }
    if (lane == 31) s_n = incl;
  }
  __syncthreads();
  const long long first = quirk ? first_idx[img] : -1;
  for (int c = 0; c < C; ++c) {
    const int j = c * blockDim.x + tid;
    const unsigned alive = __ballot_sync(FULL, j < K && ok[j] && sc[j] > KEEP_FLOOR);
    if (alive >> lane & 1u) {
      const int pos = s_base[c * nw + warp] + __popc(alive & ((1u << lane) - 1u));
      s_box[pos] = bx[j];
      s_live[pos] = sc[j];
      s_orig[pos] = j;
      if (j == first) s_first = pos;
    }
  }
  __syncthreads();
  // Thread tid holds the compacted positions c * nt + tid. The steps run on as few warps as hold the n
  // survivors at C a thread, and the others leave here.
  const int n = s_n;
  const int nt = max(32, min(static_cast<int>(blockDim.x), (n + 32 * C - 1) / (32 * C) * 32));
  if (tid >= nt) return;
  float4 b[C];
  float area[C], live[C];  // a live score is 0 or above the floor
  int cnt = 0;             // live scores above the floor, kept up to date as they drop
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int pos = c * nt + tid;
    b[c] = pos < n ? s_box[pos] : make_float4(0.f, 0.f, 0.f, 0.f);
    area[c] = area_of(b[c]);
    live[c] = pos < n && pos != s_first ? s_live[pos] : 0.f;  // the quirk's first pick is gone after step 0
    cnt += live[c] != 0.f;
  }

  float4 p = make_float4(0.f, 0.f, 0.f, 0.f);  // the last kept pick, whose decay the next pass applies
  int s = 0;                                     // steps taken
  if (quirk && steps > 0) {  // step 0 takes first_idx and n_valid, from the full pool
    if (first < 0 || first >= K || n_valid[img] < 2) return;  // a first_idx outside the pool keeps nothing
    if (tid == 0) o[first] = ok[first] ? sc[first] : -1.f;
    p = bx[first];
    s = 1;
  }
  bool decay = s == 1;
  for (int t = 0; s < steps; ++t) {
    if (decay) {  // decay by the last pick: every candidate's pre-test first, then the few that fail it
      const float pa = area_of(p);
      unsigned slow = 0u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float inter, u;
        overlap(p, pa, b[c], area[c], inter, u);
        if (live[c] != 0.f && !(fmaf(thr, u, -inter) >= 0.f)) slow |= 1u << c;  // inter / u may exceed thr
      }
      if (slow) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (slow >> c & 1u) {  // decide and decay as the plain version does
            float inter, u;
            overlap(p, pa, b[c], area[c], inter, u);
            const float iou = __fdiv_rn(inter, u);
            if (iou > thr) {  // / 0.5 is * 2, exact either way
              const float v = __fmul_rn(live[c], expf(__fmul_rn(-__fmul_rn(iou, iou), 2.f)));
              live[c] = v > KEEP_FLOOR ? v : 0.f;
              cnt -= v <= KEEP_FLOOR;
            }
          }
        }
      }
    }
    unsigned key[C], at[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      key[c] = __float_as_uint(live[c]);  // positive floats order like their bits
      at[c] = c;
    }
#pragma unroll
    for (int w = 1; w < C; w *= 2) {  // a tree over the thread's candidates; on a tie the lower c stays
#pragma unroll
      for (int c = 0; c + w < C; c += 2 * w) {
        if (key[c + w] > key[c]) {
          key[c] = key[c + w];
          at[c] = at[c + w];
        }
      }
    }
    const unsigned mine = at[0] * nt + tid;
    unsigned best = __reduce_max_sync(FULL, key[0]);
    unsigned pick = __reduce_min_sync(FULL, key[0] == best ? mine : UINT_MAX);
    unsigned count = quirk ? __reduce_add_sync(FULL, static_cast<unsigned>(cnt)) : 0u;
    if (nt > 32) {  // across warps: one barrier, and every warp reduces the slots itself
      if (lane == 0) s_slot[t & 1][warp] = make_uint4(best, pick, count, 0u);
      asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");  // the nt stepping threads only
      uint4 e = make_uint4(0u, UINT_MAX, 0u, 0u);
      if (lane < (nt >> 5)) e = s_slot[t & 1][lane];
      best = __reduce_max_sync(FULL, e.x);
      pick = __reduce_min_sync(FULL, e.x == best ? e.y : UINT_MAX);
      count = quirk ? __reduce_add_sync(FULL, e.z) : 0u;
    }
    if (!(quirk ? count >= 2u : best != 0u)) break;  // the same in every warp
    if (tid == 0) o[s_orig[pick]] = __uint_as_float(best);
    if (pick == mine) {  // the pick's owner drops it
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c == static_cast<int>(at[0])) live[c] = 0.f;
      --cnt;
    }
    p = s_box[pick];
    decay = true;
    ++s;
  }
}

template <int C>
cudaError_t launch_for(int c, const float4* boxes, const float* scores, const unsigned char* valid,
                       const long long* first_idx, const long long* n_valid, float* out, int B, int K, int steps,
                       float thr, cudaStream_t stream) {
  if constexpr (C * THREADS < MAX_K) {
    if (c > C) return launch_for<2 * C>(c, boxes, scores, valid, first_idx, n_valid, out, B, K, steps, thr, stream);
  }
  const size_t bytes = static_cast<size_t>(K) * (sizeof(float4) + sizeof(float) + sizeof(int));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(soft_nms_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const int threads = min(THREADS, (K + 32 * C - 1) / (32 * C) * 32);
  soft_nms_kernel<C><<<B, threads, bytes, stream>>>(boxes, scores, valid, first_idx, n_valid, out, K, steps, thr);
  return cudaGetLastError();
}

// boxes: (B, K, 4) f32 xyxy contiguous, 16-byte aligned; scores, out: (B, K)
// f32; valid: (B, K) bool (one byte each); first_idx, n_valid: (B,) int64,
// both null without the quirk. K <= 8,192; steps = min(max_det, K).
extern "C" int soft_nms_launch(const float* boxes, const float* scores, const unsigned char* valid,
                               const long long* first_idx, const long long* n_valid, float* out, int B, int K,
                               int steps, float thr, cudaStream_t stream) {
  if (B == 0 || K == 0) return static_cast<int>(cudaSuccess);
  if (K > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  int c = MIN_PER_THREAD;
  while (c * THREADS < K) c *= 2;
  return static_cast<int>(launch_for<MIN_PER_THREAD>(c, reinterpret_cast<const float4*>(boxes), scores, valid,
                                                     first_idx, n_valid, out, B, K, steps, thr, stream));
}
