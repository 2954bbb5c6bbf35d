"""The port's image codec (``data/codec.py``, ``data/image_io.py``) against
OpenCV, on the CPU, where JPEG goes through libjpeg (the plain version of
the card's nvJPEG route) and PNG through the port's own decoder.

Every case of ``tests/image_cases.py`` (JPEG 4:2:0, 4:2:2, 4:4:4,
progressive, grey, restart markers, CMYK, EXIF orientations 1-8 in both byte
orders, an odd size; PNG RGB, RGBA, palette at 8 and 2 bits, grey at 8 and 1
bits, grey with alpha, 16 bits, all five filters, Adam7, an ``eXIf``
orientation) decodes to the bytes of ``cv2.imread`` from its file and of
``cv2.imdecode`` from its bytes, and its header gives the decoded shape. The
committed copies under ``tests/assets/images/`` are the same cases with their
``cv2.imread`` arrays, which the card is held to. Truncated and forged files
raise naming the file; JPEG written by the port equals ``cv2.imwrite``'s
bytes (libjpeg with OpenCV's settings), PNG reads back as OpenCV's does.
"""

import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from experiment_yolo_torch.data import codec, image_io
from image_cases import ASSETS, cases, scene

CASES = cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_is_opencvs_bytes(tmp_path, name):
    data = CASES[name]
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got = image_io.imread(path, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(codec.decode(data, name, device="cpu"),
                                  cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    assert image_io.image_shape(path) == want.shape[:2]


def test_committed_fixtures_are_the_cases_and_their_opencv_arrays():
    """The files the card is held to are this module's cases, and each
    ``<file>.npy`` is ``cv2.imread`` of its file."""
    files = sorted(f.name for f in ASSETS.iterdir() if f.suffix != ".npy")
    assert files == sorted(CASES)
    for name in files:
        assert (ASSETS / name).read_bytes() == CASES[name], name
        np.testing.assert_array_equal(np.load(ASSETS / f"{name}.npy"), cv2.imread(str(ASSETS / name)))


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (31, 17), (64, 64)])
def test_jpeg_written_is_opencvs_bytes_and_png_reads_back(tmp_path, shape):
    """libjpeg with ``cv2.imwrite``'s settings (quality 95, 4:2:0, a JFIF
    header) writes OpenCV's bytes; the port's PNG (its own filter and zlib
    choices, so other bytes) reads back to the array, in both packages."""
    img = scene(*shape, seed=sum(shape))
    image_io.imwrite(tmp_path / "a.jpg", img, device="cpu")
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    image_io.imwrite(tmp_path / "a.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), img)
    np.testing.assert_array_equal(image_io.imread(tmp_path / "a.png"), img)


@pytest.mark.parametrize("name", ["jpeg_420.jpg", "jpeg_progressive.jpg", "png_rgb.png", "png_adam7.png"])
def test_truncated_files_raise_naming_the_file(tmp_path, name):
    data = CASES[name]
    for cut in (len(data) // 3, len(data) - 40, len(data) - 2):
        path = tmp_path / f"cut{cut}_{name}"
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match=path.name):
            image_io.imread(path, device="cpu")


def test_forged_sizes_raise_before_decoding(tmp_path):
    """A header that claims more than 64 megapixels (the JAX native loader's
    cap) raises from the header alone, for the decode and the shape."""
    jpeg = bytearray(CASES["jpeg_420.jpg"])
    sof = jpeg.index(b"\xff\xc0")
    jpeg[sof + 5:sof + 9] = struct.pack(">HH", 60000, 60000)
    png = bytearray(CASES["png_rgb.png"])
    png[16:24] = struct.pack(">II", 9000, 9000)
    png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])) & 0xFFFFFFFF)
    for name, data in (("big.jpg", jpeg), ("big.png", png)):
        (tmp_path / name).write_bytes(bytes(data))
        for read in (lambda p: image_io.imread(p, device="cpu"), image_io.image_shape):
            with pytest.raises(ValueError, match=f"{name}.*pixel cap"):
                read(tmp_path / name)


def test_broken_png_chunks_raise(tmp_path):
    png = bytearray(CASES["png_rgb.png"])
    png[png.index(b"IDAT") + 8] ^= 0xFF  # a byte of the first IDAT's data: its CRC no longer holds
    with pytest.raises(ValueError, match="bad.png: CRC error in PNG IDAT"):
        codec.decode(bytes(png), "bad.png", device="cpu")
    with pytest.raises(ValueError, match="x.png: not a BMP file, nor a JPEG or PNG"):
        codec.decode_many([b"GIF89a" + bytes(64)], ["x.png"], device="cpu")


@pytest.mark.parametrize("suffix", [".webp", ".tif", ".tiff"])
def test_formats_still_to_port_raise_naming_the_item(tmp_path, suffix):
    path = tmp_path / f"a{suffix}"
    path.write_bytes(b"RIFF\x00\x00\x00\x00WEBP" if suffix == ".webp" else b"II*\x00")
    for call in (lambda: image_io.imread(path, device="cpu"), lambda: image_io.image_shape(path),
                 lambda: image_io.imwrite(path, np.zeros((2, 2, 3), np.uint8))):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 3.5"):
            call()
    np.save(image_io.sidecar(path), np.ones((3, 4, 3), np.uint8))  # a sidecar is read as it is
    assert image_io.imread(path, device="cpu").shape == (3, 4, 3) and image_io.image_shape(path) == (3, 4)


def test_the_route_is_fixed_by_the_device(monkeypatch):
    """A JPEG for a CUDA device goes to nvJPEG, a chunk in one call, and never
    to libjpeg, even when nvJPEG fails; PNG never goes to nvJPEG."""
    calls = []

    class Stub:
        def decode_many(self, items, names):
            calls.append(list(names))
            raise RuntimeError("nvJPEG failed")

    monkeypatch.setattr(codec, "nvjpeg", lambda device: Stub())
    monkeypatch.setattr(codec, "jpeg_decode_plain", lambda *a: pytest.fail("libjpeg used for the card"))
    jpegs = [CASES["jpeg_420.jpg"], CASES["jpeg_gray.jpg"]]
    with pytest.raises(RuntimeError, match="nvJPEG failed"):
        codec.decode_many([*jpegs, CASES["png_rgb.png"]], ["a.jpg", "b.jpg", "c.png"], device="cuda")
    assert calls == [["a.jpg", "b.jpg"]]
    np.testing.assert_array_equal(codec.decode(CASES["png_rgb.png"], device="cuda"),
                                  cv2.imdecode(np.frombuffer(CASES["png_rgb.png"], np.uint8), cv2.IMREAD_COLOR))


def test_cmyk_and_ycck_conversions_follow_libjpeg_and_opencv():
    """YCCK -> CMYK is libjpeg's integer ``ycck_cmyk_convert`` (held to its
    float form within rounding), CMYK -> BGR OpenCV's formula, on a grid of
    values of each channel. A real CMYK file is among the cases; no writer of
    YCCK files is at hand here."""
    v = np.arange(256, dtype=np.uint8)
    ycck = np.stack(np.meshgrid(v[::15], v[::15], v[::15], v[::51], indexing="ij"), -1).reshape(-1, 1, 4)
    y, cb, cr = (ycck[..., i].astype(float) for i in range(3))
    rgb = np.stack([y + 1.402 * (cr - 128), y - 0.344136 * (cb - 128) - 0.714136 * (cr - 128),
                    y + 1.772 * (cb - 128)], -1)
    cmyk = codec.ycck_to_cmyk(ycck)
    assert np.abs(cmyk[..., :3].astype(float) - np.clip(255 - rgb, 0, 255)).max() <= 1
    np.testing.assert_array_equal(cmyk[..., 3], ycck[..., 3])
    c, m, yy, k = (cmyk[..., i].astype(int) for i in range(4))
    want = np.stack([k - (255 - yy) * k // 256, k - (255 - m) * k // 256, k - (255 - c) * k // 256], -1)
    np.testing.assert_array_equal(codec.cmyk_to_bgr(cmyk), want)


def test_header_reads_only_what_it_needs(tmp_path):
    """``image_shape`` reads a prefix of the file; a header past the prefix
    (a large EXIF block) is read from the whole file."""
    jpeg = CASES["jpeg_exif6.jpg"]
    filler = b"\xff\xe2" + struct.pack(">H", 65000) + bytes(64998)  # an APP2 segment of 65,000 bytes
    path = tmp_path / "long.jpg"
    path.write_bytes(jpeg[:2] + filler + filler + jpeg[2:])
    assert image_io.image_shape(path) == cv2.imread(str(path)).shape[:2] == (64, 48)
    np.testing.assert_array_equal(image_io.imread(path, device="cpu"), cv2.imread(str(path)))
    assert Path(path).stat().st_size > 2 * codec._HEADER_PREFIX


def test_nvjpeg_callers_on_many_threads_take_turns(monkeypatch):
    """``NvJpeg``'s Python around a stand-in for the nvJPEG library (libjpeg
    writing into the pointers it is given, four-component files as planes):
    16 threads decoding at once get the cv2 arrays, no two calls into the
    library overlap (the codec has one decode state), and the counters lose
    nothing."""
    import contextlib
    import ctypes
    import sys
    import threading

    import torch

    busy, overlaps = [], []

    class Library:
        def nvj_decode(self, codec_ptr, n, data, lens, outs, widths, heights, chans, stream, err, errlen):
            if busy:
                overlaps.append(n)
            busy.append(n)
            for i in range(n):
                raw = ctypes.string_at(ctypes.cast(data, ctypes.POINTER(ctypes.c_void_p))[i], lens[i])
                hdr = codec.jpeg_header(raw, "x")
                c = chans[i]
                out = np.empty((hdr.h, hdr.w, c), np.uint8)
                e = ctypes.create_string_buffer(64)
                assert codec._library("image_codec").jpeg_decode(raw, len(raw), out.ctypes.data, hdr.h, hdr.w, c, e,
                                                                 64) == 0
                out = np.ascontiguousarray(out.transpose(2, 0, 1) if c == 4 else out)
                ctypes.memmove(outs[i], out.ctypes.data, out.nbytes)
            busy.pop()
            return 0

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    nv = codec.NvJpeg.__new__(codec.NvJpeg)
    nv.device, nv.lib, nv.ptr, nv.lock = torch.device("cpu"), Library(), None, threading.Lock()
    nv.stream = type("Stream", (), {"cuda_stream": 0})()
    nv.launches = nv.images = 0
    names = ["jpeg_420.jpg", "jpeg_cmyk.jpg", "jpeg_exif7.jpg", "jpeg_gray.jpg"]
    items = [(CASES[k], codec.jpeg_header(CASES[k], k)) for k in names]
    want = [cv2.imdecode(np.frombuffer(CASES[k], np.uint8), cv2.IMREAD_COLOR) for k in names]
    failures = []

    def caller():
        try:
            for _ in range(5):
                for got, w in zip(nv.decode_many(items, names), want):
                    np.testing.assert_array_equal(got, w)
        except Exception as e:  # reported below, with the thread's traceback
            failures.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not failures and not any(t.is_alive() for t in threads), failures
    assert not overlaps
    assert nv.launches == 80 and nv.images == 320
