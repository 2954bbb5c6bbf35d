"""Image files without OpenCV or PIL: 24-bit BMP and ``.npy`` sidecars.

The port's counterpart of ``cv2.imread`` / ``cv2.imwrite`` and of the header
read that the JAX package's ``data/dataset.py`` does with PIL. The card's
machine has neither library, so images are:

- 24-bit uncompressed BMP (BGR, rows bottom-up and padded to 4 bytes), read
  and written in numpy: ``cv2.imread`` reads such a file to the same bytes,
  so both packages see identical pixels;
- ``.npy`` sidecars of decoded BGR images, as the JAX package's
  ``cache='disk'`` writes them next to each image, read as they are.

A JPEG or PNG (any other format of ``IMG_FORMATS``) without a sidecar raises:
decoding it waits for the libjpeg route (ROADMAP.md queue 1).
"""

from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import Tuple

import numpy as np

_FILE_HEADER = struct.Struct("<2sIHHI")  # 'BM', file size, reserved x2, pixel-data offset
_INFO_HEADER = struct.Struct("<IiiHHIIiiII")  # BITMAPINFOHEADER


def sidecar(path: str | Path) -> Path:
    """The ``.npy`` sidecar of an image file (the JAX package's ``cache='disk'`` name)."""
    return Path(path).with_suffix(".npy")


def _undecodable(path: Path) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: decoding {path.suffix or 'this format'} needs a decoder library, which the port does not have; "
        "give it a .npy sidecar of the decoded BGR image, or convert it to a 24-bit BMP (JPEG/PNG decoding waits "
        "for the libjpeg route, ROADMAP.md queue 1)")


def _bmp_header(f, path) -> Tuple[int, int, int, bool]:
    """(offset, width, height, bottom_up) of a 24-bit uncompressed BMP."""
    head = f.read(_FILE_HEADER.size + _INFO_HEADER.size)
    if len(head) < _FILE_HEADER.size + _INFO_HEADER.size:
        raise ValueError(f"{path}: truncated BMP header")
    magic, _, _, _, offset = _FILE_HEADER.unpack_from(head)
    size, w, h, planes, bpp, compression = _INFO_HEADER.unpack_from(head, _FILE_HEADER.size)[:6]
    if magic != b"BM" or size < _INFO_HEADER.size:
        raise ValueError(f"{path}: not a BMP file")
    if bpp != 24 or compression != 0 or planes != 1:
        raise ValueError(f"{path}: only 24-bit uncompressed BMP is read (got {bpp} bits, compression {compression})")
    return offset, w, abs(h), h > 0


def imread(path: str | Path) -> np.ndarray:
    """An (H, W, 3) uint8 BGR image: a 24-bit BMP decoded, or any image read
    from its ``.npy`` sidecar. Raises for a file it cannot decode."""
    path = Path(path)
    if path.suffix.lower() == ".npy":
        return np.load(path)
    if path.suffix.lower() != ".bmp":
        if sidecar(path).exists():
            return np.load(sidecar(path))
        raise _undecodable(path)
    with open(path, "rb") as f:
        return _bmp_read(f, path)


def bmp_decode(data: bytes, name: str = "image") -> np.ndarray:
    """An (H, W, 3) uint8 BGR image from the bytes of a 24-bit BMP file."""
    return _bmp_read(io.BytesIO(data), name)


def _bmp_read(f, path) -> np.ndarray:
    offset, w, h, bottom_up = _bmp_header(f, path)
    f.seek(offset)
    stride = (w * 3 + 3) & ~3
    data = f.read(stride * h)
    if len(data) < stride * h:
        raise ValueError(f"{path}: truncated BMP pixel data")
    img = np.frombuffer(data, np.uint8).reshape(h, stride)[:, :w * 3].reshape(h, w, 3)
    return np.ascontiguousarray(img[::-1] if bottom_up else img)


def imwrite(path: str | Path, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 BGR image as a 24-bit bottom-up BMP."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"imwrite: expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    if Path(path).suffix.lower() != ".bmp":
        raise _undecodable(Path(path))
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1].reshape(h, w * 3)
    offset = _FILE_HEADER.size + _INFO_HEADER.size
    with open(path, "wb") as f:
        f.write(_FILE_HEADER.pack(b"BM", offset + rows.size, 0, 0, offset))
        f.write(_INFO_HEADER.pack(_INFO_HEADER.size, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0))
        f.write(rows.tobytes())


def image_shape(path: str | Path) -> Tuple[int, int]:
    """An image's (h, w) from its BMP or ``.npy`` header, without decoding."""
    path = Path(path)
    if path.suffix.lower() == ".bmp":
        with open(path, "rb") as f:
            _, w, h, _ = _bmp_header(f, path)
        return h, w
    npy = path if path.suffix.lower() == ".npy" else sidecar(path)
    if not npy.exists():
        raise _undecodable(path)
    with open(npy, "rb") as f:
        fmt = np.lib.format
        read_header = fmt.read_array_header_1_0 if fmt.read_magic(f) == (1, 0) else fmt.read_array_header_2_0
        shape = read_header(f)[0]
    return int(shape[0]), int(shape[1])
