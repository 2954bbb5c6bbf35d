// PNG scanline reconstruction on the host, for the port's own PNG decoder
// (``data/codec.py``): the card's machine has no libpng, so the chunks are
// read and the image data inflated in Python (``zlib``), and this file undoes
// the five filters (None, Sub, Up, Average, Paeth) row by row, walks the seven
// Adam7 passes of an interlaced file, and unpacks the samples. PNG is
// lossless, so the result is exact by construction; what libpng and OpenCV do
// to the samples afterwards (palette, grey expansion, dropping alpha, BGR)
// stays in Python.
//
// Average and Paeth need the pixel to the left within the row, so a row is a
// sequential walk: numpy cannot vectorise it, and a Python loop over the
// pixels of a 1280 x 720 image takes seconds.
//
// C ABI for ctypes; returns 0, or 1 with a message in ``err``.
// Build: g++ -O3 -fPIC -shared png_unfilter.cpp.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the filters of one (pass of an) image of ``ph`` rows of ``rowbytes``
// bytes into ``rows``; ``src`` holds each row's filter byte and its bytes.
bool unfilter(const uint8_t* src, int ph, size_t rowbytes, int bpp, uint8_t* rows, char* err, int errlen) {
  std::vector<uint8_t> zero(rowbytes, 0);
  for (int y = 0; y < ph; ++y) {
    const uint8_t* in = src + size_t(y) * (rowbytes + 1);
    uint8_t* cur = rows + size_t(y) * rowbytes;
    const uint8_t* up = y ? rows + size_t(y - 1) * rowbytes : zero.data();
    const int type = in[0];
    ++in;
    switch (type) {
      case 0:
        std::memcpy(cur, in, rowbytes);
        break;
      case 1:
        for (size_t i = 0; i < rowbytes; ++i) cur[i] = uint8_t(in[i] + (i >= size_t(bpp) ? cur[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) cur[i] = uint8_t(in[i] + up[i]);
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i) {
          const int left = i >= size_t(bpp) ? cur[i - bpp] : 0;
          cur[i] = uint8_t(in[i] + ((left + up[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i) {
          const int left = i >= size_t(bpp) ? cur[i - bpp] : 0;
          const int ul = i >= size_t(bpp) ? up[i - bpp] : 0;
          cur[i] = uint8_t(in[i] + paeth(left, up[i], ul));
        }
        break;
      default:
        std::snprintf(err, errlen, "bad filter type %d in row %d", type, y);
        return false;
    }
  }
  return true;
}

// Sample ``i`` of a reconstructed row: raw sub-byte values as they are, the
// high byte of a 16-bit sample (libpng's png_set_strip_16).
inline uint8_t sample(const uint8_t* row, size_t i, int depth) {
  if (depth == 8) return row[i];
  if (depth == 16) return row[2 * i];
  const size_t bit = i * depth;
  return uint8_t((row[bit >> 3] >> (8 - depth - int(bit & 7))) & ((1 << depth) - 1));
}

}  // namespace

extern "C" {

// ``data``: the inflated image data of an (h, w) image of ``channels``
// samples of ``depth`` bits; ``out``: (h, w, channels) uint8 samples.
int png_unfilter(const uint8_t* data, size_t len, int w, int h, int depth, int channels, int interlaced,
                 uint8_t* out, char* err, int errlen) {
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlaced ? kAdam7 : kWhole;
  const int npass = interlaced ? 7 : 1;
  const int bits = depth * channels;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  size_t pos = 0;
  std::vector<uint8_t> rows;
  for (int p = 0; p < npass; ++p) {
    const int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
    const int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass has no rows, not even filter bytes
    const size_t rowbytes = (size_t(pw) * bits + 7) / 8;
    const size_t need = size_t(ph) * (rowbytes + 1);
    if (pos + need > len) {
      std::snprintf(err, errlen, "image data too short: %zu bytes, pass %d needs %zu more", len, p, pos + need - len);
      return 1;
    }
    rows.resize(size_t(ph) * rowbytes);
    if (!unfilter(data + pos, ph, rowbytes, bpp, rows.data(), err, errlen)) return 1;
    pos += need;
    for (int y = 0; y < ph; ++y) {
      const uint8_t* row = rows.data() + size_t(y) * rowbytes;
      uint8_t* dst = out + (size_t(y0 + y * dy) * w) * channels;
      for (int x = 0; x < pw; ++x) {
        uint8_t* px = dst + size_t(x0 + x * dx) * channels;
        for (int c = 0; c < channels; ++c) px[c] = sample(row, size_t(x) * channels + c, depth);
      }
    }
  }
  return 0;
}

}  // extern "C"
