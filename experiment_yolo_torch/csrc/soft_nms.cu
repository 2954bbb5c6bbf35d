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
// candidate) and the IoU arithmetic are small.
//
// Design, simple first: one block per image, up to 1,024 threads, the boxes
// and live scores in shared memory (20 bytes a candidate: 160 KB at the
// largest K, 8,192, so the launch opts in above 48 KB). A step is one block
// reduction of (score, index), which also counts the quirk's survivors, then
// one pass in which each thread decays its own candidates. Two barriers a step.
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
// Rounding: the IoU is the plain version's inter / (area1 + area2 - inter +
// 1e-7) and the decay its exp(-(iou * iou) / 0.5) times the live score, each
// operation rounded once with the explicit intrinsics, so that nvcc contracts
// no multiply-add, and expf at full precision (no fast math): the kept sets
// and the scores equal the plain version's on the card bit for bit, ties at
// the threshold and at the 0.25 floor included.
#include <climits>
#include <cmath>

#include "common.cuh"

constexpr int MAX_THREADS = 1024;
constexpr float KEEP_FLOOR = 0.25f;  // the fork's soft-NMS score threshold, whatever conf is

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// (v, i) becomes (ov, oi) when that is larger, or equal with a lower index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
soft_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                const unsigned char* __restrict__ valid, const long long* __restrict__ first_idx,
                const long long* __restrict__ n_valid, float* __restrict__ out, int K, int steps, float thr) {
  extern __shared__ float4 smem[];
  float4* box = smem;
  float* live = reinterpret_cast<float*>(box + K);
  __shared__ float red_v[32];
  __shared__ int red_i[32], red_c[32];
  __shared__ int s_pick, s_keep;
  __shared__ float s_score;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long img = blockIdx.x;
  const bool quirk = first_idx != nullptr;
  float* o = out + img * K;
  for (int j = tid; j < K; j += blockDim.x) {
    box[j] = boxes[img * K + j];
    live[j] = valid[img * K + j] ? scores[img * K + j] : -1.f;
    o[j] = -1.f;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const bool given = quirk && t == 0;  // step 0 of the quirk takes first_idx and n_valid
    if (!given) {
      float bv = -INFINITY;
      int bi = INT_MAX, cnt = 0;
      for (int j = tid; j < K; j += blockDim.x) {  // ascending j: a strict > keeps the lower index
        const float v = live[j];
        if (v > bv) {
          bv = v;
          bi = j;
        }
        cnt += v > KEEP_FLOOR;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        take_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off), __shfl_down_sync(0xffffffffu, bi, off));
        cnt += __shfl_down_sync(0xffffffffu, cnt, off);
      }
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
        red_c[warp] = cnt;
      }
    }
    __syncthreads();
    if (warp == 0) {
      long long pick, count;
      if (given) {
        pick = first_idx[img];
        count = n_valid[img];
      } else {
        float bv = lane < nwarps ? red_v[lane] : -INFINITY;
        int bi = lane < nwarps ? red_i[lane] : INT_MAX, cnt = lane < nwarps ? red_c[lane] : 0;
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          take_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off), __shfl_down_sync(0xffffffffu, bi, off));
          cnt += __shfl_down_sync(0xffffffffu, cnt, off);
        }
        pick = bi;
        count = cnt;
      }
      if (lane == 0) {
        const bool inside = pick >= 0 && pick < K;  // a first_idx outside the pool keeps nothing
        const float si = inside ? live[pick] : -1.f;
        s_keep = inside && (quirk ? count >= 2 : si > KEEP_FLOOR);
        s_pick = inside ? static_cast<int>(pick) : 0;
        s_score = si;
      }
    }
    __syncthreads();
    if (!s_keep) break;  // the same for every thread: read after the barrier
    const int pick = s_pick;
    if (tid == 0) o[pick] = s_score;
    const float4 p = box[pick];
    const float pa = area_of(p);
    for (int j = tid; j < K; j += blockDim.x) {  // each thread decays only its own candidates
      if (j == pick) {
        live[j] = -1.f;
        continue;
      }
      const float4 b = box[j];
      const float iw = fmaxf(__fsub_rn(fminf(p.z, b.z), fmaxf(p.x, b.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(p.w, b.w), fmaxf(p.y, b.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float iou = __fdiv_rn(inter, __fadd_rn(__fsub_rn(__fadd_rn(pa, area_of(b)), inter), 1e-7f));
      if (iou > thr) live[j] = __fmul_rn(live[j], expf(__fdiv_rn(-__fmul_rn(iou, iou), 0.5f)));
    }
  }
}

// boxes: (B, K, 4) f32 xyxy contiguous, 16-byte aligned; scores, out: (B, K)
// f32; valid: (B, K) bool (one byte each); first_idx, n_valid: (B,) int64,
// both null without the quirk. K <= 8,192; steps = min(max_det, K).
extern "C" int soft_nms_launch(const float* boxes, const float* scores, const unsigned char* valid,
                               const long long* first_idx, const long long* n_valid, float* out, int B, int K,
                               int steps, float thr, cudaStream_t stream) {
  if (B == 0 || K == 0) return static_cast<int>(cudaSuccess);
  if (K > 8192) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min(MAX_THREADS, max(32, (K + 31) / 32 * 32));
  const size_t bytes = static_cast<size_t>(K) * (sizeof(float4) + sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(soft_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  soft_nms_kernel<<<B, threads, bytes, stream>>>(reinterpret_cast<const float4*>(boxes), scores, valid, first_idx,
                                                 n_valid, out, K, steps, thr);
  return static_cast<int>(cudaGetLastError());
}
