// JPEG decode and encode on the card with nvJPEG: the port's JPEG route on
// the H100 (``data/codec.py``). The machine with the card has no libjpeg, and
// the CUDA toolkit that builds the kernels ships nvJPEG; the JAX package
// decoded with OpenCV on the host (``data/loaders.py:95``, ``serve.py:215``).
//
// It replaces no TPU kernel. A chunk of files is one call from Python, each
// file decoded in turn by nvJPEG's default backend (Huffman on the host, IDCT
// on the card). The card's hardware JPEG engines are only probed: on the H100
// machine tried, ``nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE)`` answers
// ARCH_MISMATCH. The output is BGR, interleaved, written to device memory that
// the caller allocated; a four-component file comes out as four planes of raw
// components, which ``codec.py`` converts as libjpeg and OpenCV do. nvJPEG's IDCT and chroma upsampling are not libjpeg's, so pixels differ
// from ``cv2.imdecode``: nvJPEG upsamples chroma by repeating samples where
// libjpeg interpolates (up to 68 levels at sharp colour edges), and its IDCT
// rounds otherwise (up to 3 levels) (``PERF.md``).
//
// Bound: the host's Huffman decode, not the card's memory.
//
// C ABI for ctypes. Every function returns 0, or 1 with a message in ``err``.
// Build: nvcc -O3 -shared -Xcompiler -fPIC nvjpeg_codec.cu -lnvjpeg.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstdio>

namespace {

// The default backend's handle, its decode state and the encoder; the caller
// uses one codec from one thread at a time (under a lock).
struct Codec {
  nvjpegHandle_t gpu = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int enc_quality = -1;
};

const char* status_name(nvjpegStatus_t s) {
  switch (s) {
    case NVJPEG_STATUS_SUCCESS: return "SUCCESS";
    case NVJPEG_STATUS_NOT_INITIALIZED: return "NOT_INITIALIZED";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "INVALID_PARAMETER";
    case NVJPEG_STATUS_BAD_JPEG: return "BAD_JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "JPEG_NOT_SUPPORTED";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "ALLOCATOR_FAILURE";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "EXECUTION_FAILED";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "ARCH_MISMATCH";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "INTERNAL_ERROR";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED: return "IMPLEMENTATION_NOT_SUPPORTED";
    default: return "UNKNOWN";
  }
}

}  // namespace

#define NVJ(call)                                                                                \
  do {                                                                                           \
    nvjpegStatus_t s_ = (call);                                                                  \
    if (s_ != NVJPEG_STATUS_SUCCESS) {                                                           \
      std::snprintf(err, errlen, "%s: nvJPEG status %d (%s)", #call, int(s_), status_name(s_)); \
      return 1;                                                                                  \
    }                                                                                            \
  } while (0)

#define CUDA(call)                                                                          \
  do {                                                                                      \
    cudaError_t e_ = (call);                                                                \
    if (e_ != cudaSuccess) {                                                                \
      std::snprintf(err, errlen, "%s: CUDA error %d (%s)", #call, int(e_), cudaGetErrorString(e_)); \
      return 1;                                                                             \
    }                                                                                       \
  } while (0)

extern "C" {

// A codec on the current device. ``engines`` comes back nvJPEG's status when
// asked for the hardware backend (the card's JPEG engines): a probe, 0 where
// they came up; the handle is let go at once and the engines decode nothing.
int nvj_create(void** out, int* engines, char* err, int errlen) {
  auto* c = new Codec();
  *out = c;
  nvjpegHandle_t hw = nullptr;
  *engines = int(nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr, 0, &hw));
  if (*engines == 0) nvjpegDestroy(hw);
  NVJ(nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, 0, &c->gpu));
  NVJ(nvjpegJpegStateCreate(c->gpu, &c->state));
  return 0;
}

void nvj_destroy(void* p) {
  auto* c = static_cast<Codec*>(p);
  if (!c) return;
  if (c->enc_params) nvjpegEncoderParamsDestroy(c->enc_params);
  if (c->enc_state) nvjpegEncoderStateDestroy(c->enc_state);
  if (c->state) nvjpegJpegStateDestroy(c->state);
  if (c->gpu) nvjpegDestroy(c->gpu);
  delete c;
}

// Decode ``n`` files on ``stream``. ``outs[i]``: device memory for file i,
// (h, w, 3) BGR when ``channels[i]`` is 3, four (h, w) planes when it is 4.
// The call returns once the launches are queued; the caller synchronises.
int nvj_decode(void* p, int n, const uint8_t* const* data, const size_t* lens, uint8_t* const* outs,
               const int* widths, const int* heights, const int* channels, void* stream_ptr, char* err,
               int errlen) {
  auto* c = static_cast<Codec*>(p);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (int i = 0; i < n; ++i) {
    nvjpegImage_t dst = {};
    nvjpegOutputFormat_t fmt = NVJPEG_OUTPUT_BGRI;
    if (channels[i] == 4) {
      fmt = NVJPEG_OUTPUT_UNCHANGED;
      const size_t plane = size_t(widths[i]) * heights[i];
      for (int k = 0; k < 4; ++k) {
        dst.channel[k] = outs[i] + k * plane;
        dst.pitch[k] = size_t(widths[i]);
      }
    } else {
      dst.channel[0] = outs[i];
      dst.pitch[0] = size_t(widths[i]) * 3;
    }
    NVJ(nvjpegDecode(c->gpu, c->state, data[i], lens[i], fmt, &dst, stream));
  }
  CUDA(cudaGetLastError());
  return 0;
}

// Encode an (h, w, 3) BGR image in device memory at ``quality``, 4:2:0,
// baseline, standard Huffman tables, into ``out`` (host, ``*len`` bytes of
// room); ``*len`` comes back as the file's length. Synchronises ``stream``.
int nvj_encode(void* p, const uint8_t* bgr, int h, int w, int quality, uint8_t* out, size_t* len,
               void* stream_ptr, char* err, int errlen) {
  auto* c = static_cast<Codec*>(p);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!c->enc_state) {
    NVJ(nvjpegEncoderStateCreate(c->gpu, &c->enc_state, stream));
    NVJ(nvjpegEncoderParamsCreate(c->gpu, &c->enc_params, stream));
    NVJ(nvjpegEncoderParamsSetSamplingFactors(c->enc_params, NVJPEG_CSS_420, stream));
    NVJ(nvjpegEncoderParamsSetOptimizedHuffman(c->enc_params, 0, stream));
  }
  if (c->enc_quality != quality) {
    NVJ(nvjpegEncoderParamsSetQuality(c->enc_params, quality, stream));
    c->enc_quality = quality;
  }
  nvjpegImage_t src = {};
  src.channel[0] = const_cast<uint8_t*>(bgr);
  src.pitch[0] = size_t(w) * 3;
  NVJ(nvjpegEncodeImage(c->gpu, c->enc_state, c->enc_params, &src, NVJPEG_INPUT_BGRI, w, h, stream));
  size_t need = 0;
  NVJ(nvjpegEncodeRetrieveBitstream(c->gpu, c->enc_state, nullptr, &need, stream));
  CUDA(cudaStreamSynchronize(stream));
  if (need > *len) {
    std::snprintf(err, errlen, "encoded file of %zu bytes exceeds the %zu bytes of room", need, *len);
    return 1;
  }
  NVJ(nvjpegEncodeRetrieveBitstream(c->gpu, c->enc_state, out, &need, stream));
  CUDA(cudaStreamSynchronize(stream));
  *len = need;
  return 0;
}

}  // extern "C"
