"""JPEG, PNG and BMP decoding and encoding without OpenCV or PIL.

The port's counterpart of ``cv2.imread`` / ``cv2.imdecode`` /
``cv2.imwrite`` for the formats the JAX package's users feed it. The machine
with the card has neither OpenCV nor PIL, nor libjpeg or libpng; it has the
CUDA toolkit's nvJPEG and zlib. So the route is fixed by the format and the
caller's device, with no decoder standing in for another:

- **JPEG on the card** (``device`` a CUDA device, the default): nvJPEG's
  default backend (``csrc/nvjpeg_codec.cu``, built with ``nvcc -lnvjpeg`` at
  first use). A chunk of files is one call; the BGR pixels come back to the
  host. They differ from ``cv2.imdecode``: nvJPEG repeats chroma samples
  where libjpeg interpolates (up to 68 levels at sharp colour edges) and
  rounds its IDCT otherwise (up to 3) (``PERF.md``).
- **JPEG on the CPU** (``device='cpu'``): libjpeg (``csrc/image_codec.cpp``,
  built with ``g++ -ljpeg``): the plain version, equal to ``cv2.imdecode``
  byte for byte. A machine without libjpeg raises naming it.
- **PNG, anywhere**: the chunks are parsed here, the image data inflated with
  ``zlib``, and the rows unfiltered by ``csrc/png_unfilter.cpp`` (no library);
  exact by construction.
- **24-bit uncompressed BMP, anywhere**: read and written in numpy.

Both JPEG routes share what is done here in Python, as OpenCV does it: the
header read (``image_shape`` without decoding), the 64-megapixel cap of the
JAX package's native loader (``native/dataloader.cpp:kMaxDecodePixels``),
EXIF orientations 1-8 (JPEG APP1, PNG ``eXIf``), CMYK and YCCK turned into
BGR with libjpeg's and OpenCV's integer formulas, and truncated files
refused. Every error is a ``ValueError`` naming the file.

Libraries are built by ``ops/kernels/_build.py`` into
``build/codec/lib<name>-<hash>.so`` at the root of the checkout, the hash
covering the source and the command, and loaded with ctypes. A call releases
the GIL: the loader's threads decode PNG and CPU JPEG in parallel, and take
turns at the card's one nvJPEG decode state.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from experiment_yolo_torch.ops.kernels import _build

BUILD_DIR = _build.BUILD_ROOT / "codec"
MAX_DECODE_PIXELS = 64 * 1024 * 1024  # native/dataloader.cpp:kMaxDecodePixels: refuse forged sizes before allocating
JPEG_QUALITY = 95  # cv2.imwrite's default
_HEADER_PREFIX = 1 << 16  # bytes read for a header before reading the whole file

_HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# name -> (how it is built, what the machine must have)
_LIBS = {
    "image_codec": (_build.Job(_build.CSRC / "image_codec.cpp", "g++", _HOST_FLAGS, ("-ljpeg",), build_dir=BUILD_DIR),
                    "libjpeg (jpeglib.h and libjpeg.so) for JPEG on the CPU"),
    "png_unfilter": (_build.Job(_build.CSRC / "png_unfilter.cpp", "g++", _HOST_FLAGS, build_dir=BUILD_DIR),
                     "a C++ compiler (g++)"),
    "nvjpeg_codec": (_build.Job(_build.CSRC / "nvjpeg_codec.cu", "nvcc",
                                ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                                 "-Xcompiler", "-fPIC"), ("-lnvjpeg",), build_dir=BUILD_DIR),
                     "the CUDA toolkit's nvcc and nvJPEG (nvjpeg.h, libnvjpeg.so) for JPEG on the card"),
}
_loaded: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
_ERRLEN = 512


def _library(name: str) -> ctypes.CDLL:
    """Library ``name``, built from ``csrc/`` on first use."""
    with _build_lock:
        if name in _loaded:
            return _loaded[name]
        job, needs = _LIBS[name]
        try:
            target = _build.build({name: job})[name]
            lib = ctypes.CDLL(str(target))
        except (RuntimeError, OSError) as e:
            raise RuntimeError(f"building and loading {job.source.name} needs {needs}; it failed on this "
                               f"machine:\n{e}") from None
        _declare(name, lib)
        _loaded[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, S, C = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_char_p
    sigs = {
        "image_codec": {"jpeg_decode": [P, S, P, I, I, I, C, I],
                        "jpeg_encode": [P, I, I, I, ctypes.POINTER(P), ctypes.POINTER(ctypes.c_ulong), C, I],
                        "codec_free": [P]},
        "png_unfilter": {"png_unfilter": [P, S, I, I, I, I, I, P, C, I]},
        "nvjpeg_codec": {"nvj_create": [ctypes.POINTER(P), ctypes.POINTER(I), C, I], "nvj_destroy": [P],
                         "nvj_decode": [P, I, P, P, P, P, P, P, P, C, I],
                         "nvj_encode": [P, P, I, I, I, P, ctypes.POINTER(S), P, C, I]},
    }[name]
    for fn, args in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = None if fn in ("codec_free", "nvj_destroy") else I


def _check(rc: int, err, what: str) -> None:
    if rc:
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")


# -- headers ----------------------------------------------------------------------------------------------------
@dataclass
class Header:
    """What a file's header says: ``h``, ``w`` as stored (before orientation)."""
    format: str  # "jpeg" or "png"
    h: int
    w: int
    components: int = 3  # JPEG: 1, 3 or 4 colour components
    orientation: int = 1  # EXIF orientation, 1 (as stored) to 8
    adobe_transform: Optional[int] = None  # JPEG APP14: 0 CMYK/RGB, 1 YCbCr, 2 YCCK
    subsampled: bool = False  # JPEG: some component has fewer samples than another (4:2:0, 4:2:2, ...)
    depth: int = 8  # PNG bit depth
    color_type: int = 2  # PNG colour type
    interlaced: bool = False
    palette: Optional[np.ndarray] = None  # PNG PLTE as (n, 3) RGB
    idat: bytes = b""

    @property
    def shape(self) -> Tuple[int, int]:
        """(h, w) as decoded: swapped where the orientation transposes."""
        return (self.w, self.h) if self.orientation >= 5 else (self.h, self.w)


def sniff(data: bytes) -> Optional[str]:
    """``"jpeg"``, ``"png"``, ``"bmp"`` or None from a file's first bytes."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    return None


def exif_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of IFD0 of a TIFF-structured EXIF block; 1 where it is
    absent, out of range or the block is malformed (OpenCV's ExifReader)."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack_from(e + "H", tiff, 2)[0] != 42:
        return 1
    off = struct.unpack_from(e + "I", tiff, 4)[0]
    if off + 2 > len(tiff):
        return 1
    for k in range(struct.unpack_from(e + "H", tiff, off)[0]):
        pos = off + 2 + 12 * k
        if pos + 12 > len(tiff):
            return 1
        tag, typ = struct.unpack_from(e + "HH", tiff, pos)
        if tag == 0x0112:
            value = struct.unpack_from(e + "H", tiff, pos + 8)[0] if typ == 3 else 1
            return value if 1 <= value <= 8 else 1
    return 1


_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def jpeg_header(data: bytes, name: str, whole: bool = True) -> Header:
    """The frame header, EXIF orientation and Adobe transform of a JPEG, read
    up to its first scan. ``whole``: ``data`` is the whole file, so a file that
    ends before its EOI marker (truncated) raises."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    pos, n = 2, len(data)
    hdr: Optional[Header] = None
    orientation, exif_seen, adobe = 1, False, None
    while True:
        while pos < n and data[pos] != 0xFF:  # OpenCV/libjpeg skip stray bytes before a marker
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos + 3 > n:
            raise ValueError(f"{name}: truncated JPEG header")
        marker = data[pos]
        pos += 1
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            continue
        length = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) < length - 2:
            raise ValueError(f"{name}: truncated JPEG header")
        if marker == 0xE1 and not exif_seen and seg[:6] == b"Exif\x00\x00":
            exif_seen = True
            orientation = exif_orientation(seg[6:])
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker in _SOF:
            if len(seg) < 6:
                raise ValueError(f"{name}: truncated JPEG frame header")
            _, h, w, comps = struct.unpack_from(">BHHB", seg)
            if h == 0 or w == 0 or comps not in (1, 3, 4) or len(seg) < 6 + 3 * comps:
                raise ValueError(f"{name}: JPEG frame of {w}x{h} with {comps} components is not decodable")
            hdr = Header("jpeg", h, w, comps, subsampled=len({seg[7 + 3 * c] for c in range(comps)}) > 1)
        elif marker == 0xDA:
            break
        elif marker == 0xD9:
            raise ValueError(f"{name}: JPEG ends before its first scan")
        pos += length
    if hdr is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    hdr.orientation, hdr.adobe_transform = orientation, adobe
    _cap(hdr, name)
    if whole and data.rfind(b"\xff\xd9") < pos:
        raise ValueError(f"{name}: truncated JPEG (no end-of-image marker after the scan data)")
    return hdr


def _cap(hdr: Header, name: str) -> None:
    if hdr.h * hdr.w > MAX_DECODE_PIXELS:
        raise ValueError(f"{name}: {hdr.w}x{hdr.h} exceeds the {MAX_DECODE_PIXELS:,}-pixel cap (forged size?)")


_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_header(data: bytes, name: str, whole: bool = True) -> Header:
    """IHDR, PLTE and the ``eXIf`` orientation of a PNG (chunks before the
    first IDAT); with ``whole``, also its image data, every critical chunk's
    CRC checked as libpng checks it."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{name}: not a PNG file")
    pos, n = 8, len(data)
    hdr: Optional[Header] = None
    idat: List[bytes] = []
    ended = False
    while pos + 8 <= n:
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            break
        critical = not ctype[0] & 0x20
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + body) & 0xFFFFFFFF:
            if critical:
                raise ValueError(f"{name}: CRC error in PNG {ctype.decode(errors='replace')} chunk")
            pos += 12 + length
            continue  # libpng drops an ancillary chunk with a bad CRC
        if ctype == b"IHDR":
            if length != 13:
                raise ValueError(f"{name}: bad PNG IHDR")
            w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB", body)
            if (w == 0 or h == 0 or color not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[color] or comp or filt
                    or inter > 1):
                raise ValueError(f"{name}: PNG of {w}x{h}, depth {depth}, colour type {color} is not decodable")
            hdr = Header("png", h, w, depth=depth, color_type=color, interlaced=bool(inter))
            _cap(hdr, name)
        elif hdr is None:
            raise ValueError(f"{name}: PNG without IHDR first")
        elif ctype == b"PLTE":
            if length % 3 or not length:
                raise ValueError(f"{name}: bad PNG palette")
            hdr.palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"eXIf" and not idat:
            hdr.orientation = exif_orientation(body)
        elif ctype == b"IDAT":
            if not whole:
                return hdr
            idat.append(body)
        elif ctype == b"IEND":
            ended = True
            break
        pos += 12 + length
    if hdr is None or not whole:  # without ``whole`` it returns at the first IDAT
        raise ValueError(f"{name}: truncated PNG header")
    if whole:
        if not ended or not idat:
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        if hdr.color_type == 3 and hdr.palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        hdr.idat = b"".join(idat)
    return hdr


def header(data: bytes, name: str, whole: bool = True) -> Header:
    kind = sniff(data)
    if kind == "jpeg":
        return jpeg_header(data, name, whole)
    if kind == "png":
        return png_header(data, name, whole)
    raise ValueError(f"{name}: not a BMP file, nor a JPEG or PNG")


def file_shape(path: str | Path, whole: bool = False) -> Tuple[int, int]:
    """(h, w) of a JPEG, PNG or BMP file as ``cv2.imread`` would give it, from
    its header alone (orientations 5-8 swap the two). ``whole`` reads a whole
    JPEG or PNG and also raises for a truncated one, as decoding it would."""
    with open(path, "rb") as f:
        data = f.read(_HEADER_PREFIX)
        if sniff(data) == "bmp":
            _, w, h, _ = bmp_header(data, str(path))
            return h, w
        if whole:
            return header(data + f.read(), str(path)).shape
        try:
            return header(data, str(path), whole=False).shape
        except ValueError:
            if len(data) < _HEADER_PREFIX:
                raise
            data += f.read()  # a header longer than the prefix (a large EXIF thumbnail)
    return header(data, str(path), whole=False).shape


# -- BMP: 24-bit uncompressed, rows bottom-up (or top-down) and padded to 4 bytes ---------------------------------
_BMP_FILE = struct.Struct("<2sIHHI")  # 'BM', file size, reserved x2, pixel-data offset
_BMP_INFO = struct.Struct("<IiiHHIIiiII")  # BITMAPINFOHEADER


def bmp_header(data: bytes, name: str) -> Tuple[int, int, int, bool]:
    """(offset, width, height, bottom_up) of a 24-bit uncompressed BMP."""
    if len(data) < _BMP_FILE.size + _BMP_INFO.size:
        raise ValueError(f"{name}: truncated BMP header")
    magic, _, _, _, offset = _BMP_FILE.unpack_from(data)
    size, w, h, planes, bpp, compression = _BMP_INFO.unpack_from(data, _BMP_FILE.size)[:6]
    if magic != b"BM" or size < _BMP_INFO.size:
        raise ValueError(f"{name}: not a BMP file")
    if bpp != 24 or compression != 0 or planes != 1:
        raise ValueError(f"{name}: only 24-bit uncompressed BMP is read (got {bpp} bits, compression {compression})")
    return offset, w, abs(h), h > 0


def bmp_decode(data: bytes, name: str = "image") -> np.ndarray:
    """An (H, W, 3) uint8 BGR image from a 24-bit BMP: ``cv2.imread``'s bytes."""
    offset, w, h, bottom_up = bmp_header(data, name)
    stride = (w * 3 + 3) & ~3
    px = data[offset:offset + stride * h]
    if len(px) < stride * h:
        raise ValueError(f"{name}: truncated BMP pixel data")
    img = np.frombuffer(px, np.uint8).reshape(h, stride)[:, :w * 3].reshape(h, w, 3)
    return np.ascontiguousarray(img[::-1] if bottom_up else img)


def bmp_encode(img: np.ndarray) -> bytes:
    """A 24-bit bottom-up BMP of an (H, W, 3) BGR image."""
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1].reshape(h, w * 3)
    offset = _BMP_FILE.size + _BMP_INFO.size
    return (_BMP_FILE.pack(b"BM", offset + rows.size, 0, 0, offset)
            + _BMP_INFO.pack(_BMP_INFO.size, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0) + rows.tobytes())


# -- pixels: what OpenCV does after the decoder ----------------------------------------------------------------
def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """Apply an EXIF orientation as OpenCV's ``ExifTransform`` does."""
    t = lambda a: a.transpose(1, 0, 2)  # noqa: E731
    out = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: t, 6: lambda a: t(a)[:, ::-1], 7: lambda a: t(a[::-1, ::-1]), 8: lambda a: t(a)[::-1]}[orientation](img)
    return np.ascontiguousarray(out)


def _ycc_tables():
    """libjpeg's integer YCbCr -> RGB tables (jdcolor.c:build_ycc_rgb_table)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    return ((fix(1.40200) * x + 32768) >> 16, (fix(1.77200) * x + 32768) >> 16, -fix(0.71414) * x,
            -fix(0.34414) * x + 32768)


def ycck_to_cmyk(ycck: np.ndarray) -> np.ndarray:
    """libjpeg's ``ycck_cmyk_convert``: YCC -> RGB -> inverted, K unchanged."""
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    y, cb, cr = (ycck[..., i].astype(np.int64) for i in range(3))
    out = np.empty_like(ycck)
    out[..., 0] = np.clip(255 - (y + cr_r[cr]), 0, 255)
    out[..., 1] = np.clip(255 - (y + ((cb_g[cb] + cr_g[cr]) >> 16)), 0, 255)
    out[..., 2] = np.clip(255 - (y + cb_b[cb]), 0, 255)
    out[..., 3] = ycck[..., 3]
    return out


def cmyk_to_bgr(cmyk: np.ndarray) -> np.ndarray:
    """OpenCV's ``icvCvt_CMYK2BGR_8u_C4C3R`` on libjpeg's CMYK output."""
    c, m, y, k = (cmyk[..., i].astype(np.int32) for i in range(4))
    conv = lambda v: k - (((255 - v) * k) >> 8)  # noqa: E731
    return np.stack([conv(y), conv(m), conv(c)], -1).astype(np.uint8)


def _finish_jpeg(raw: np.ndarray, hdr: Header) -> np.ndarray:
    if hdr.components == 4:
        raw = cmyk_to_bgr(raw)
    return orient(raw, hdr.orientation)


# -- JPEG: the plain version (libjpeg, CPU) and nvJPEG (card) ---------------------------------------------------
def jpeg_decode_plain(data: bytes, hdr: Header, name: str) -> np.ndarray:
    """libjpeg's BGR (or CMYK, converted) pixels, oriented: ``cv2.imdecode``'s bytes."""
    lib = _library("image_codec")
    ch = 4 if hdr.components == 4 else 3
    out = np.empty((hdr.h, hdr.w, ch), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(lib.jpeg_decode(data, len(data), out.ctypes.data, hdr.h, hdr.w, ch, err, _ERRLEN), err, name)
    return _finish_jpeg(out, hdr)


def jpeg_encode_plain(img: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    lib = _library("image_codec")
    img = np.ascontiguousarray(img)
    buf, n = ctypes.c_void_p(), ctypes.c_ulong()
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(lib.jpeg_encode(img.ctypes.data, img.shape[0], img.shape[1], quality, ctypes.byref(buf), ctypes.byref(n),
                           err, _ERRLEN), err, "JPEG encode")
    try:
        return ctypes.string_at(buf, n.value)
    finally:
        lib.codec_free(buf)


class NvJpeg:
    """nvJPEG's default backend on one card: the codec's handle, its one
    decode state and the encoder, used by one caller at a time under a lock,
    on a CUDA stream of their own. ``launches`` counts the decode calls and
    ``images`` the files they decoded. ``engine_status`` is nvJPEG's answer
    when asked for the card's hardware JPEG engines (0: they came up), a probe
    only: the engines decode nothing here."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self.lib = _library("nvjpeg_codec")
        self.ptr, engines = ctypes.c_void_p(), ctypes.c_int()
        err = ctypes.create_string_buffer(_ERRLEN)
        with torch.cuda.device(self.device):
            rc = self.lib.nvj_create(ctypes.byref(self.ptr), ctypes.byref(engines), err, _ERRLEN)
            if rc:
                self.lib.nvj_destroy(self.ptr)
            _check(rc, err, "nvJPEG")
            self.stream = torch.cuda.Stream(self.device)
        self.engine_status = engines.value
        self.lock = threading.Lock()
        self.launches = self.images = 0

    def decode_many(self, items: Sequence[Tuple[bytes, Header]], names: Sequence[str]) -> List[np.ndarray]:
        import torch

        n = len(items)
        chans = [4 if h.components == 4 else 3 for _, h in items]
        starts = np.concatenate([[0], np.cumsum([h.h * h.w * c for (_, h), c in zip(items, chans)])]).astype(np.int64)
        data = (ctypes.c_char_p * n)(*[d for d, _ in items])
        lens = (ctypes.c_size_t * n)(*[len(d) for d, _ in items])
        widths = (ctypes.c_int * n)(*[h.w for _, h in items])
        heights = (ctypes.c_int * n)(*[h.h for _, h in items])
        err = ctypes.create_string_buffer(_ERRLEN)
        with self.lock, torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = torch.empty(int(starts[-1]), dtype=torch.uint8, device=self.device)
            outs = (ctypes.c_void_p * n)(*[out.data_ptr() + int(s) for s in starts[:-1]])
            rc = self.lib.nvj_decode(self.ptr, n, data, lens, outs, widths, heights, (ctypes.c_int * n)(*chans),
                                     ctypes.c_void_p(self.stream.cuda_stream), err, _ERRLEN)
            _check(rc, err, ", ".join(names) if n <= 4 else f"{names[0]} and {n - 1} more")
            host = out.cpu().numpy()  # a copy on the codec's stream, after the decode
            self.launches += 1
            self.images += n
        imgs = []
        for (_, hdr), c, s in zip(items, chans, starts[:-1]):
            px = host[s:s + hdr.h * hdr.w * c]
            if c == 4:  # four planes of raw components
                px = px.reshape(4, hdr.h, hdr.w).transpose(1, 2, 0)
                px = ycck_to_cmyk(px) if hdr.adobe_transform == 2 else px
            imgs.append(_finish_jpeg(px.reshape(hdr.h, hdr.w, c), hdr))
        return imgs

    def encode(self, img: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
        import torch

        img = np.ascontiguousarray(img)
        h, w = img.shape[:2]
        room = 2 * img.size + 65536
        out = np.empty(room, np.uint8)
        n = ctypes.c_size_t(room)
        err = ctypes.create_string_buffer(_ERRLEN)
        with self.lock, torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            src = torch.from_numpy(img).to(self.device)
            rc = self.lib.nvj_encode(self.ptr, src.data_ptr(), h, w, quality, out.ctypes.data, ctypes.byref(n),
                                     ctypes.c_void_p(self.stream.cuda_stream), err, _ERRLEN)
        _check(rc, err, "nvJPEG encode")
        return out[:n.value].tobytes()


_nvjpeg: Dict[str, NvJpeg] = {}
_nvjpeg_lock = threading.Lock()


def nvjpeg(device) -> NvJpeg:
    """The process's nvJPEG codec for ``device`` (created on first use)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _nvjpeg_lock:
        if str(device) not in _nvjpeg:
            _nvjpeg[str(device)] = NvJpeg(device)
        return _nvjpeg[str(device)]


def _on_card(device) -> bool:
    return str(device).split(":")[0] == "cuda"


# -- PNG ----------------------------------------------------------------------------------------------------------
def png_decode(data: bytes, hdr: Header, name: str) -> np.ndarray:
    """The BGR pixels OpenCV's PNG reader gives: 16-bit samples cut to their
    high byte, sub-byte grey scaled to 8 bits, palettes expanded, alpha
    dropped, grey copied to three channels; then the ``eXIf`` orientation."""
    try:
        raw = zlib.decompress(hdr.idat)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    ch = _PNG_CHANNELS[hdr.color_type]
    out = np.empty((hdr.h, hdr.w, ch), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    lib = _library("png_unfilter")
    _check(lib.png_unfilter(raw, len(raw), hdr.w, hdr.h, hdr.depth, ch, int(hdr.interlaced), out.ctypes.data, err,
                            _ERRLEN), err, name)
    if hdr.color_type == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(hdr.palette)] = hdr.palette[:256]
        bgr = pal[out[..., 0]][..., ::-1]
    elif hdr.color_type in (0, 4):
        grey = out[..., 0]
        if hdr.depth < 8:
            grey = grey * np.uint8(255 // ((1 << hdr.depth) - 1))
        bgr = np.repeat(grey[..., None], 3, axis=2)
    else:
        bgr = out[..., 2::-1]
    return orient(bgr, hdr.orientation)


def png_encode(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of an (H, W, 3) BGR image: the Sub filter on every row,
    zlib at level 1 with run-length matching (``cv2.imwrite``'s zlib settings;
    libpng's filter choice differs, so the bytes do too, the pixels do not)."""
    h, w = img.shape[:2]
    rgb = np.ascontiguousarray(img[..., ::-1]).reshape(h, w * 3)
    rows = np.empty((h, w * 3 + 1), np.uint8)
    rows[:, 0] = 1
    rows[:, 1:4] = rgb[:, :3]
    rows[:, 4:] = rgb[:, 3:] - rgb[:, :-3]  # uint8 arithmetic wraps, as the filter does
    comp = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    idat = comp.compress(rows.tobytes()) + comp.flush()
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


# -- the two entry points ---------------------------------------------------------------------------------------
def decode_many(datas: Sequence[bytes], names: Sequence[str], device="cuda") -> List[np.ndarray]:
    """(H, W, 3) uint8 BGR images from the bytes of JPEG, PNG and BMP files,
    by what each file's first bytes say, as ``cv2.imdecode(buf, IMREAD_COLOR)``
    gives them; anything else raises ``ValueError``. The JPEGs go through
    nvJPEG together in one call when ``device`` is a CUDA device, through
    libjpeg one by one when it is the CPU."""
    hdrs = [None if sniff(d) == "bmp" else header(d, n) for d, n in zip(datas, names)]
    out: List[Optional[np.ndarray]] = [None] * len(datas)
    jpegs = [i for i, h in enumerate(hdrs) if h is not None and h.format == "jpeg"]
    if jpegs and _on_card(device):
        for i, img in zip(jpegs, nvjpeg(device).decode_many([(datas[i], hdrs[i]) for i in jpegs],
                                                            [names[i] for i in jpegs])):
            out[i] = img
    for i, (d, h, n) in enumerate(zip(datas, hdrs, names)):
        if out[i] is None:
            out[i] = (bmp_decode(d, n) if h is None else png_decode(d, h, n) if h.format == "png"
                      else jpeg_decode_plain(d, h, n))
    return out


def decode(data: bytes, name: str = "image", device="cuda") -> np.ndarray:
    """One image's bytes -> (H, W, 3) uint8 BGR (see :func:`decode_many`)."""
    return decode_many([data], [name], device)[0]


def encode(img: np.ndarray, fmt: str, device="cuda", quality: int = JPEG_QUALITY) -> bytes:
    """The bytes of a JPEG (``fmt`` ``"jpeg"``: nvJPEG on a CUDA device,
    libjpeg on the CPU, quality 95 and 4:2:0 as ``cv2.imwrite``), a PNG
    (``"png"``) or a BMP (``"bmp"``) of an (H, W, 3) uint8 BGR image."""
    if fmt in ("png", "bmp"):
        return png_encode(img) if fmt == "png" else bmp_encode(img)
    if fmt != "jpeg":
        raise ValueError(f"encode: unknown format {fmt!r}")
    return nvjpeg(device).encode(img, quality) if _on_card(device) else jpeg_encode_plain(img, quality)
