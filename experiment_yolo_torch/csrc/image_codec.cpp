// JPEG decode and encode with libjpeg on the host: the plain version of the
// port's JPEG route (``data/codec.py``), used for images that a caller reads
// on the CPU and by the tests. On the card, JPEG goes through nvJPEG
// (``nvjpeg_codec.cu``).
//
// The decoder is the in-memory decoder of the JAX package's native loader
// (``native/dataloader.cpp``: ``decode_jpeg_mem``, its longjmp error exit),
// copied and changed in what OpenCV does differently, so that the bytes equal
// ``cv2.imdecode(buf, IMREAD_COLOR)``:
//   - colour files decode straight to BGR (libjpeg-turbo's ``JCS_EXT_BGR``),
//     as OpenCV's ``JpegDecoder::readData`` asks, and grey files too;
//   - a four-component file (Adobe CMYK or YCCK) decodes to libjpeg's CMYK,
//     which ``codec.py`` turns into BGR with OpenCV's formula;
//   - a file that ends before its last scan raises (libjpeg only warns and
//     fills the rest with grey).
// EXIF orientation, the header read and the pixel cap are done in Python,
// once for both routes. The encoder takes ``cv2.imwrite``'s defaults:
// quality 95, 4:2:0, baseline, standard Huffman tables, a JFIF header.
//
// C ABI for ctypes. Every function returns 0 on success, or 1 with a message
// in ``err``. Build: g++ -O3 -fPIC -shared image_codec.cpp -ljpeg.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>
#include <jerror.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf env;
  char* err;
  int errlen;
};

void error_exit(j_common_ptr c) {
  auto* e = reinterpret_cast<ErrorMgr*>(c->err);
  char msg[JMSG_LENGTH_MAX];
  c->err->format_message(c, msg);
  std::snprintf(e->err, e->errlen, "%s", msg);
  longjmp(e->env, 1);
}

// A truncated stream is an error; libjpeg's other warnings (extraneous bytes
// before a marker, ...) pass, as they do in OpenCV.
void emit_message(j_common_ptr c, int level) {
  if (level == -1 && c->err->msg_code == JWRN_JPEG_EOF) error_exit(c);
}

void init_errors(ErrorMgr* e, char* err, int errlen) {
  jpeg_std_error(&e->pub);
  e->pub.error_exit = error_exit;
  e->pub.emit_message = emit_message;
  e->err = err;
  e->errlen = errlen;
}

}  // namespace

extern "C" {

// Decode ``len`` bytes into ``out``: (h, w, 3) BGR, or (h, w, 4) CMYK when
// ``channels`` is 4. ``h`` and ``w`` are the frame's, read by the caller from
// the header; a file whose decoder disagrees raises.
int jpeg_decode(const uint8_t* buf, size_t len, uint8_t* out, int h, int w, int channels, char* err, int errlen) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  init_errors(&jerr, err, errlen);
  cinfo.err = &jerr.pub;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  const int want = cinfo.num_components == 4 ? 4 : 3;
  if (want != channels || int(cinfo.image_width) != w || int(cinfo.image_height) != h) {
    std::snprintf(err, errlen, "header gives %dx%d with %d components, caller expected %dx%d with %d channels",
                  int(cinfo.image_width), int(cinfo.image_height), cinfo.num_components, w, h, channels);
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = want == 4 ? JCS_CMYK : JCS_EXT_BGR;
  jpeg_start_decompress(&cinfo);
  const size_t stride = size_t(w) * channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode an (h, w, 3) BGR image at ``quality`` (4:2:0). The bytes are
// malloc'ed: hand them back to ``codec_free``.
int jpeg_encode(const uint8_t* bgr, int h, int w, int quality, uint8_t** out, unsigned long* out_len, char* err,
                int errlen) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  init_errors(&jerr, err, errlen);
  cinfo.err = &jerr.pub;
  *out = nullptr;
  *out_len = 0;
  if (setjmp(jerr.env)) {
    jpeg_destroy_compress(&cinfo);
    std::free(*out);
    *out = nullptr;
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, out, out_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_EXT_BGR;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = size_t(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(bgr) + size_t(cinfo.next_scanline) * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

void codec_free(void* p) { std::free(p); }

}  // extern "C"
