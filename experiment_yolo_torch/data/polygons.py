"""Polygon rasterising for the segment task and the rotated boxes of the obb
task, without OpenCV.

The JAX package draws instance masks with ``cv2.fillPoly`` and orders them by
``cv2.contourArea`` (``data/augment.py:polygons2mask_overlap``), and pastes
CopyPaste's instances through ``cv2.drawContours(..., FILLED)``. Here:

- :func:`fill_polys` is ``cv2.fillPoly`` with integer vertices, bit for bit:
  ``csrc/polygon_fill.cpp``, OpenCV's outline (8-connected, clipped) and
  edge-list scanline fill in 16.16 fixed point, built with g++ at first use
  into ``build/host/`` (``ops/kernels/_build.py:build``);
- :func:`contour_area` is ``cv2.contourArea`` of float32 points: the shoelace
  terms in float64 (exact products of float32 values, one rounding each),
  summed in order, halved, absolute;
- :func:`polygons2mask_overlap` is the JAX function: one overlap-index image
  at 1/``downsample`` resolution, instances drawn largest first with value
  i+1, and the order (``np.argsort(-areas)``, so ties fall the same way);
- :func:`min_area_rect` is ``cv2.minAreaRect`` of float32 points, bit for bit
  (the convex hull, the rotating calipers, the angle in [-90, 0) degrees), in
  the same C++ library; the obb task's ``xyxyxyxy2xywhr`` takes its boxes
  from it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from experiment_yolo_torch.ops.kernels import _build

BUILD_DIR = _build.BUILD_ROOT / "host"
_JOB = _build.Job(_build.CSRC / "polygon_fill.cpp", "g++", ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"),
                  build_dir=BUILD_DIR)
_lib: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    with _lock:
        if "lib" not in _lib:
            try:
                lib = ctypes.CDLL(str(_build.build({"polygon_fill": _JOB})["polygon_fill"]))
            except (RuntimeError, OSError) as e:
                raise RuntimeError(f"building and loading polygon_fill.cpp needs a C++ compiler (g++); it failed "
                                   f"on this machine:\n{e}") from None
            P = ctypes.c_void_p
            lib.fill_polys.argtypes = [P, ctypes.c_int, ctypes.c_int, P, P, ctypes.c_int, P]
            lib.fill_polys.restype = ctypes.c_int
            lib.min_area_rects.argtypes = [P, ctypes.c_int, ctypes.c_int, P]
            lib.min_area_rects.restype = None
            _lib["lib"] = lib
        return _lib["lib"]


def fill_polys(img: np.ndarray, polys: Sequence[np.ndarray], colors: Sequence[int]) -> np.ndarray:
    """Fill each (n, 2) integer polygon of ``polys`` (x, y vertices, n >= 1)
    into the (H, W) int32 image ``img`` in place with its colour, in order:
    ``cv2.fillPoly(img, [p], c)`` for each (p, c)."""
    if img.dtype != np.int32 or img.ndim != 2 or not img.flags.c_contiguous:
        raise ValueError(f"fill_polys: expected a C-contiguous (H, W) int32 image, got {img.dtype} {img.shape}")
    if not len(polys):
        return img
    pts = [np.asarray(p, np.int32).reshape(-1, 2) for p in polys]
    if min(len(p) for p in pts) < 1:
        raise ValueError("fill_polys: every polygon needs a vertex")
    flat = np.ascontiguousarray(np.concatenate(pts))
    npts = np.asarray([len(p) for p in pts], np.int32)
    col = np.asarray(colors, np.int32)
    if _library().fill_polys(img.ctypes.data, img.shape[0], img.shape[1], flat.ctypes.data, npts.ctypes.data,
                             len(pts), col.ctypes.data):
        raise ValueError("fill_polys: a polygon without vertices")
    return img


def min_area_rect(points: np.ndarray) -> np.ndarray:
    """``cv2.minAreaRect`` of point sets: (..., n, 2) float32 points, n >= 1
    -> (..., 5) float32 (cx, cy, w, h, angle in degrees in [-90, 0)), one box
    per set of n points."""
    p = np.ascontiguousarray(np.asarray(points, np.float32))
    if p.ndim < 2 or p.shape[-1] != 2 or p.shape[-2] < 1:
        raise ValueError(f"min_area_rect: expected (..., n >= 1, 2) points, got shape {p.shape}")
    lead = p.shape[:-2]
    count = int(np.prod(lead, dtype=np.int64))
    out = np.zeros((*lead, 5), np.float32)
    if count:
        _library().min_area_rects(p.ctypes.data, count, p.shape[-2], out.ctypes.data)
    return out


def contour_area(points: np.ndarray) -> float:
    """``cv2.contourArea(points)`` of (n, 2) float32 points."""
    p = np.asarray(points, np.float32).reshape(-1, 2).astype(np.float64)
    if not len(p):
        return 0.0
    prev = np.roll(p, 1, 0)
    terms = prev[:, 0] * p[:, 1] - prev[:, 1] * p[:, 0]
    return abs(float(np.cumsum(terms)[-1]) * 0.5)


def polygons2mask_overlap(segments: Sequence[np.ndarray], shape: Tuple[int, int], downsample: int = 4
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Polygons in pixels -> (overlap-index image (H/d, W/d) int32, order):
    instance ``order[i]`` is drawn with value i+1, largest area first, so a
    later (smaller) instance covers an earlier one."""
    h, w = shape[0] // downsample, shape[1] // downsample
    mask = np.zeros((h, w), np.int32)
    polys: List[np.ndarray] = []
    areas = []
    for seg in segments:
        p = np.asarray(seg, np.float64) / downsample
        polys.append(p.astype(np.int32))
        areas.append(contour_area(p.astype(np.float32)) if len(p) >= 3 else 0.0)
    order = np.argsort(-np.asarray(areas)) if areas else np.zeros(0, np.int64)
    fill_polys(mask, [polys[i] for i in order], np.arange(1, len(order) + 1))
    return mask, order
