"""Seeded JPEG and PNG files that cover what the port's codec must decode.

Each case is the bytes of one file, written by OpenCV or PIL (or, for the
PNG filter and interlace cases and the EXIF blocks, by the small writers
below) from a numpy seed. ``tests/test_torch_port_codec.py`` decodes every
case with the port and with ``cv2.imdecode``. Run as a script, it writes the
cases and their ``cv2.imread`` arrays (``<file>.npy``) into ``tests/assets/images/``,
which ``chip_smoke.py`` holds the card's decoder to:

    python tests/image_cases.py

It needs OpenCV and PIL, so it runs beside the JAX package, never on the card.
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path
from typing import Dict

import numpy as np

ASSETS = Path(__file__).resolve().parent / "assets" / "images"


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """An (h, w, 3) uint8 BGR picture with edges, gradients and noise."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([(x * 3 + y) % 256, (y * 2 + 40) % 256, (x * y // 7) % 256], -1).astype(np.int64)
    img[h // 4:h // 2, w // 3:2 * w // 3] = rs.randint(0, 256, 3)  # a flat block with sharp edges
    return np.clip(img + rs.randint(-24, 25, img.shape), 0, 255).astype(np.uint8)


def exif_block(orientation: int, order: str = "II") -> bytes:
    """A TIFF-structured EXIF block whose IFD0 holds one tag, 0x0112."""
    e = "<" if order == "II" else ">"
    return (order.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))


def with_exif(jpeg: bytes, orientation: int, order: str = "II") -> bytes:
    """``jpeg`` with an APP1 Exif segment right after SOI."""
    seg = b"Exif\x00\x00" + exif_block(orientation, order)
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + jpeg[2:]


def png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Filter row ``y`` with type ``y % 5`` (None, Sub, Up, Average, Paeth)."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        t = y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if t == 0:
            pred = np.zeros_like(row)
        elif t == 1:
            pred = left
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(t)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def png_all_filters(img: np.ndarray, interlaced: bool) -> bytes:
    """An 8-bit RGB PNG of BGR ``img`` whose rows take all five filters, Adam7-interlaced or not."""
    rgb = np.ascontiguousarray(img[..., ::-1])
    h, w = rgb.shape[:2]
    passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
    data = b""
    for x0, y0, dx, dy in (passes if interlaced else [(0, 0, 1, 1)]):
        sub = rgb[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(sub.reshape(sub.shape[0], -1), 3)
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, int(interlaced)))
            + png_chunk(b"IDAT", zlib.compress(data, 9)) + png_chunk(b"IEND", b""))


def with_png_exif(png: bytes, orientation: int) -> bytes:
    """``png`` with an ``eXIf`` chunk before its first IDAT."""
    i = png.index(b"IDAT") - 4
    return png[:i] + png_chunk(b"eXIf", exif_block(orientation)) + png[i:]


def cases(h: int = 48, w: int = 64, seed: int = 0) -> Dict[str, bytes]:
    """name (with its extension) -> file bytes: every case the codec is held to."""
    import cv2
    from PIL import Image

    img = scene(h, w, seed)
    pil = Image.fromarray(img[..., ::-1].copy())

    def pil_bytes(im, fmt, **kw) -> bytes:
        b = io.BytesIO()
        im.save(b, fmt, **kw)
        return b.getvalue()

    cv_jpeg = bytes(cv2.imencode(".jpg", img)[1])  # 4:2:0 at quality 95, cv2.imwrite's defaults
    out = {
        "jpeg_420.jpg": cv_jpeg,
        "jpeg_422.jpg": pil_bytes(pil, "JPEG", quality=90, subsampling=1),
        "jpeg_444.jpg": pil_bytes(pil, "JPEG", quality=90, subsampling=0),
        "jpeg_progressive.jpg": pil_bytes(pil, "JPEG", quality=90, progressive=True),
        "jpeg_gray.jpg": pil_bytes(pil.convert("L"), "JPEG", quality=90),
        "jpeg_restart.jpg": bytes(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1]),
        "jpeg_cmyk.jpg": pil_bytes(Image.fromarray(np.random.RandomState(seed + 1).randint(0, 256, (h, w, 4), np.uint8),
                                                   "CMYK"), "JPEG", quality=90),
        "jpeg_odd.jpg": bytes(cv2.imencode(".jpg", scene(19, 29, seed + 2))[1]),
        "png_rgb.png": bytes(cv2.imencode(".png", img)[1]),
        "png_rgba.png": bytes(cv2.imencode(".png", np.concatenate([img, img[..., :1] ^ 0x5A], -1))[1]),
        "png_palette.png": pil_bytes(pil.convert("P", palette=Image.ADAPTIVE, colors=13), "PNG"),
        "png_palette_2bit.png": pil_bytes(pil.convert("P", palette=Image.ADAPTIVE, colors=4), "PNG", bits=2),
        "png_gray.png": pil_bytes(pil.convert("L"), "PNG"),
        "png_gray_1bit.png": pil_bytes(pil.convert("L").point(lambda v: 255 * (v > 128)).convert("1"), "PNG"),
        "png_gray_alpha.png": pil_bytes(pil.convert("LA"), "PNG"),
        "png_16bit.png": bytes(cv2.imencode(".png", img.astype(np.uint16) * 257 + 123)[1]),
        "png_filters.png": png_all_filters(img, interlaced=False),
        "png_adam7.png": png_all_filters(scene(23, 21, seed + 3), interlaced=True),
        "png_exif6.png": with_png_exif(bytes(cv2.imencode(".png", img)[1]), 6),
    }
    for o in range(1, 9):
        out[f"jpeg_exif{o}.jpg"] = with_exif(cv_jpeg, o, "MM" if o % 2 else "II")
    return out


def main() -> None:
    import cv2

    ASSETS.mkdir(parents=True, exist_ok=True)
    total = 0
    for name, data in sorted(cases().items()):
        (ASSETS / name).write_bytes(data)
        arr = cv2.imread(str(ASSETS / name), cv2.IMREAD_COLOR)
        np.save(ASSETS / f"{name}.npy", arr)  # the array of jpeg_420.jpg is jpeg_420.jpg.npy
        total += len(data) + arr.nbytes + 128
    print(f"{len(cases())} files and their cv2.imread arrays in {ASSETS}, {total:,} bytes")


if __name__ == "__main__":
    main()
