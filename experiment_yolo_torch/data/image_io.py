"""Image files without OpenCV or PIL: JPEG, PNG, 24-bit BMP and ``.npy`` sidecars.

The port's counterpart of ``cv2.imread`` / ``cv2.imdecode`` / ``cv2.imwrite``
and of the header read that the JAX package's ``data/dataset.py`` does with
PIL. The card's machine has neither library, so images are:

- JPEG, PNG and 24-bit uncompressed BMP, decoded and encoded by
  ``data/codec.py`` (nvJPEG for a JPEG read for the card, libjpeg for one
  read on the CPU, the port's own PNG and BMP code), with EXIF orientation as
  OpenCV applies it;
- ``.npy`` sidecars of decoded BGR images, as the JAX package's
  ``cache='disk'`` writes them next to each image, read as they are.

A file is decoded by what its first bytes say, as OpenCV does, whatever its
extension. ``webp``, ``tif`` and ``tiff`` (the rest of ``IMG_FORMATS``) raise
without a sidecar: they wait for ROADMAP.md queue 1 item 3.5.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from experiment_yolo_torch.data import codec

FORMATS = {".jpg": "jpeg", ".jpeg": "jpeg", ".png": "png", ".bmp": "bmp"}  # the rest of IMG_FORMATS needs a sidecar


def sidecar(path: str | Path) -> Path:
    """The ``.npy`` sidecar of an image file (the JAX package's ``cache='disk'`` name)."""
    return Path(path).with_suffix(".npy")


def _undecodable(path: Path) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: decoding {path.suffix or 'this format'} is not ported to experiment_yolo_torch yet (webp and tiff "
        "wait for ROADMAP.md queue 1 item 3.5); give it a .npy sidecar of the decoded BGR image, or convert it to "
        "JPEG, PNG or BMP")


def imread(path: str | Path, device="cuda") -> np.ndarray:
    """An (H, W, 3) uint8 BGR image, as ``cv2.imread`` gives it: a JPEG, PNG or
    24-bit BMP decoded (a JPEG with nvJPEG for a CUDA ``device``, with libjpeg
    for the CPU), or any other image read from its ``.npy`` sidecar. Raises
    ``ValueError`` naming the file for one it cannot decode."""
    return imread_many([path], device)[0]


def imread_many(paths, device="cuda") -> List[np.ndarray]:
    """:func:`imread` of several files: the ``.npy`` files and sidecars are
    loaded, the rest read and handed to :func:`codec.decode_many` in one call
    (their JPEGs are one nvJPEG call on the card)."""
    paths = [Path(p) for p in paths]
    out: List[Optional[np.ndarray]] = [None] * len(paths)
    for i, p in enumerate(paths):
        npy = p if p.suffix.lower() == ".npy" else None if p.suffix.lower() in FORMATS else sidecar(p)
        if npy is not None:
            if npy != p and not npy.exists():
                raise _undecodable(p)
            out[i] = np.load(npy)
    coded = [i for i, img in enumerate(out) if img is None]
    decoded = codec.decode_many([paths[i].read_bytes() for i in coded], [str(paths[i]) for i in coded], device)
    for i, img in zip(coded, decoded):
        out[i] = img
    return out


def imwrite(path: str | Path, img: np.ndarray, device="cuda") -> None:
    """Write an (H, W, 3) uint8 BGR image by the path's extension: a JPEG at
    ``cv2.imwrite``'s quality 95 (nvJPEG for a CUDA ``device``, libjpeg for the
    CPU), a PNG, or a 24-bit bottom-up BMP."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"imwrite: expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    fmt = FORMATS.get(Path(path).suffix.lower())
    if fmt is None:
        raise _undecodable(Path(path))
    Path(path).write_bytes(codec.encode(img, fmt, device))


def image_shape(path: str | Path, whole: bool = False) -> Tuple[int, int]:
    """An image's (h, w) as :func:`imread` would give it, from its JPEG, PNG,
    BMP or ``.npy`` header, without decoding. ``whole``: a JPEG or PNG is read
    whole, and a truncated one raises as :func:`imread` would."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in FORMATS:
        return codec.file_shape(path, whole)
    npy = path if suffix == ".npy" else sidecar(path)
    if not npy.exists():
        raise _undecodable(path)
    with open(npy, "rb") as f:
        fmt = np.lib.format
        read_header = fmt.read_array_header_1_0 if fmt.read_magic(f) == (1, 0) else fmt.read_array_header_2_0
        shape = read_header(f)[0]
    return int(shape[0]), int(shape[1])
