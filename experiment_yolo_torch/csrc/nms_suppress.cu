// Greedy hard-NMS keep mask over K score-sorted, class-offset candidates.
//
// Replaces experiment_yolo_tpu/ops/pallas/nms_kernel.py:_nms_suppress_kernel
// (reached through nms_suppress). Box i suppresses every later j with
// IoU(i, j) > thr, provided i is itself still kept.
//
// Bound: latency, not bytes. The K steps over i are a chain: whether i may
// suppress depends on every step before it, so an image costs K dependent
// steps whatever the card's width; the bytes (24 B per candidate) are
// nothing. Design: one block per image, the images of a batch side by side
// on the SMs. The candidates' boxes, areas and keep flags sit in shared
// memory (K * 24 B); at step i every thread clears its own j > i whose IoU
// exceeds the threshold, then the block synchronises once. A step whose
// box i was already suppressed writes nothing and is skipped without a
// barrier; every thread reads the same keep[i], so the branch is uniform.
//
// The IoU is inter / (area_j + area_i - inter + 1e-7), computed with
// explicitly rounded operations so that no multiply-add is contracted: it
// matches the JAX package's and the plain PyTorch version's float32 IoU bit
// for bit, and ties at the threshold break the same way.
#include "common.cuh"

__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
}

__global__ void nms_suppress_kernel(const float* __restrict__ boxes, const unsigned char* __restrict__ valid,
                                    unsigned char* __restrict__ keep_out, int K, float thr) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* area = y2 + K;
  int* keep = reinterpret_cast<int*>(area + K);

  const long long img = blockIdx.x;
  const float* bx = boxes + img * K * 4;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const float4 b = reinterpret_cast<const float4*>(bx)[j];
    x1[j] = b.x; y1[j] = b.y; x2[j] = b.z; y2[j] = b.w;
    area[j] = area_of(b.x, b.y, b.z, b.w);
    keep[j] = valid[img * K + j] ? 1 : 0;
  }
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    if (!keep[i]) continue;  // uniform: keep[i] was last written before the previous barrier
    const float ix1 = x1[i], iy1 = y1[i], ix2 = x2[i], iy2 = y2[i], ia = area[i];
    for (int j = i + 1 + threadIdx.x; j < K; j += blockDim.x) {
      const float iw = fmaxf(__fsub_rn(fminf(x2[j], ix2), fmaxf(x1[j], ix1)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(y2[j], iy2), fmaxf(y1[j], iy1)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float iou = __fdiv_rn(inter, __fadd_rn(__fsub_rn(__fadd_rn(area[j], ia), inter), 1e-7f));
      if (iou > thr) keep[j] = 0;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) keep_out[img * K + j] = static_cast<unsigned char>(keep[j]);
}

// boxes: (B, K, 4) f32 xyxy contiguous; valid, keep: (B, K) bool (one byte each).
extern "C" int nms_suppress_launch(const float* boxes, const unsigned char* valid, unsigned char* keep,
                                   int B, int K, float thr, cudaStream_t stream) {
  const int threads = K < 1024 ? ((K + 31) / 32) * 32 : 1024;
  const size_t smem = static_cast<size_t>(K) * (5 * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_suppress_kernel<<<B, threads, smem, stream>>>(boxes, valid, keep, K, thr);
  return static_cast<int>(cudaGetLastError());
}
