"""Host-side image augmentations in numpy, without OpenCV.

Port of ``experiment_yolo_tpu/data/augment.py`` for the detect, segment and
pose tasks: the v8
pipeline Mosaic (4 or 9) -> CopyPaste -> RandomPerspective -> MixUp ->
RandomHSV -> RandomFlip x2 -> format (padded to a static label count), and
the letterbox of validation and serving. Labels are dicts: {'img': HWC uint8
BGR, 'bboxes': (N, 4) xyxy pixels, 'cls': (N,)}, and for the segment task
'segments', a list of (Si, 2) float pixel polygons, one per instance, carried
through every transform as in the JAX module (boxes rebuilt from the warped
polygons, CopyPaste's flipped instances, the overlap-index mask of
:func:`format_sample`); for the pose task 'keypoints', (N, nk, 3) float pixel
(x, y, visibility), made invisible where a mosaic or the warp puts them off
the canvas and swapped by ``flip_idx`` on a horizontal flip.

The card's machine has no OpenCV, so each ``cv2`` call of the JAX module has
a counterpart here that does the arithmetic of the OpenCV the JAX package runs
with (5.0) in vectorised numpy (or torch) CPU ops, whose loops release the
GIL, so that the loader's threads run them side by side. Each is bit-equal to it on uint8
images (``tests/test_torch_port_data.py``):

- :func:`resize_linear` is ``cv2.resize(..., INTER_LINEAR)``: 11-bit fixed
  -point weights, the horizontal pass in integers, the vertical pass as
  OpenCV's ``VResizeLinear`` specialisation rounds it, and INTER_AREA for an
  exact halving, as OpenCV switches to it (in torch's integer CPU ops);
- :func:`warp_affine` and :func:`warp_perspective` are ``cv2.warpAffine`` and
  ``cv2.warpPerspective`` with INTER_LINEAR and a constant border: the matrix
  inverted in double as OpenCV inverts it, then the source coordinates and
  the bilinear blends in float32 with OpenCV 5's fused multiply-adds (OpenCV
  4 rounded coordinates to 1/32 px and weights to 15 bits instead);
- :func:`rotation_matrix_2d` is ``cv2.getRotationMatrix2D`` as OpenCV writes
  it, so that the warp matrix, and with it every warped box, is bit-equal;
- :func:`bgr2hsv` and :func:`hsv2bgr` are ``cv2.cvtColor`` BGR<->HSV (hue in
  [0, 180)): the forward through OpenCV's integer division tables
  (``hsv_shift`` 12), the inverse in float32, truncated;
- the polygon fills (``cv2.fillPoly``, ``cv2.drawContours(..., FILLED)``)
  and ``cv2.contourArea`` are ``data/polygons.py``'s.

:func:`resize_linear_f32` is ``cv2.resize(..., INTER_LINEAR)`` of float32
maps in torch ops on any device (the predictor's mask upsampling), within a
float32 rounding of OpenCV's.

Every random draw is the JAX module's, call for call and size for size, so the
labels of a sample are identical to the JAX package's for the same generator.
The obb task carries 'obb', (N, 4, 2) float pixel corners, through every
step beside the boxes, and :func:`format_sample` turns them into xywhr with
:func:`xyxyxyxy2xywhr`, OpenCV 5.0's ``minAreaRect`` bit for bit
(``data/polygons.py``). The optional Albumentations hook stays out, as the
JAX package skips it without the package.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from experiment_yolo_torch.data.polygons import fill_polys, min_area_rect, polygons2mask_overlap

PAD_VALUE = 114
RESIZE_BITS = 11  # fixed-point bits of INTER_LINEAR resize weights
HSV_SHIFT = 12


# ---------------------------------------------------------------------------
# OpenCV counterparts
# ---------------------------------------------------------------------------

def _resize_taps(src: int, dst: int, clamp_low: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Source index and the two 11-bit weights of each output coordinate of
    OpenCV's INTER_LINEAR resize (``resize.cpp``): the scale as 1 / (dst /
    src) in double, the fraction in float32, rounded to nearest even."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_low:  # columns only: OpenCV pins the first and last source column
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s = np.where(low, 0, np.where(high, src - 1, s))
    one = np.float32(1 << RESIZE_BITS)
    w = np.stack([np.rint((np.float32(1.0) - f) * one), np.rint(f * one)], 1).astype(np.int32)
    return s, w


def resize_linear(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)`` of an (H, W,
    C) uint8 image; ``dsize`` is (width, height). The integer arithmetic runs
    in torch CPU ops (a quarter of numpy's time on 8 threads, two thirds on
    one), the serving path's letterbox included."""
    h, w = img.shape[:2]
    dw, dh = int(dsize[0]), int(dsize[1])
    if (dw, dh) == (w, h):
        return img.copy()
    src = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    if w == 2 * dw and h == 2 * dh:  # OpenCV takes INTER_AREA for an exact halving
        q = src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2]
        return ((q + 2) >> 2).to(torch.uint8).numpy()
    sx, ax = (torch.from_numpy(a) for a in _resize_taps(w, dw, True))
    sy, by = (torch.from_numpy(a) for a in _resize_taps(h, dh, False))
    hor = src.index_select(1, sx) * ax[:, 0, None] + src.index_select(1, (sx + 1).clamp_(max=w - 1)) * ax[:, 1, None]
    hor >>= 4  # OpenCV's VResizeLinear: each term (b * (S >> 4)) >> 16, then (sum + 2) >> 2
    out = (by[:, 0, None, None] * hor.index_select(0, sy.clamp(0, h - 1))) >> 16
    out += (by[:, 1, None, None] * hor.index_select(0, (sy + 1).clamp_(0, h - 1))) >> 16
    return ((out + 2) >> 2).to(torch.uint8).numpy()


def resize_linear_f32(x: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(m, dsize, interpolation=cv2.INTER_LINEAR)`` of each float32
    map of ``x`` (..., H, W), on ``x``'s device; ``dsize`` is (width, height).
    OpenCV's float path: each output's source position in double, its
    fraction f in double and the weights 1 - f and f rounded to float32,
    columns pinned at both ends, rows clamped to the image with their weights
    as computed; the horizontal pass, then the vertical one; an exact halving
    averages each 2x2 block (INTER_AREA), as OpenCV switches to it."""
    h, w = x.shape[-2:]
    dw, dh = int(dsize[0]), int(dsize[1])
    if (dw, dh) == (w, h):
        return x.clone()
    if w == 2 * dw and h == 2 * dh:
        q = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + (x[..., 1::2, 0::2] + x[..., 1::2, 1::2])
        return q * 0.25
    dev = x.device

    def taps(src, dst, pin):
        f = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5
        s = np.floor(f).astype(np.int64)
        f -= s
        if pin:
            low, high = s < 0, s >= src - 1
            f[low | high] = 0.0
            s = np.where(low, 0, np.where(high, src - 1, s))
        i0 = torch.from_numpy(np.clip(s, 0, src - 1)).to(dev)
        i1 = torch.from_numpy(np.clip(s + 1, 0, src - 1)).to(dev)
        return i0, i1, torch.from_numpy((1.0 - f).astype(np.float32)).to(dev), torch.from_numpy(f.astype(np.float32)).to(dev)

    c0, c1, a0, a1 = taps(w, dw, True)
    r0, r1, b0, b1 = taps(h, dh, False)
    hor = x.index_select(-1, c0) * a0 + x.index_select(-1, c1) * a1
    return hor.index_select(-2, r0) * b0[:, None] + hor.index_select(-2, r1) * b1[:, None]


def rotation_matrix_2d(angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D((0, 0), angle, scale)``, term for term."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx = cy = 0.0
    return np.asarray([[alpha, beta, (1 - alpha) * cx - beta * cy],
                       [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


BLEND_ROWS = 32  # output rows per pass of the bilinear blends


def _bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: int) -> np.ndarray:
    """OpenCV's float32 bilinear sampling of an (H, W, C) uint8 image at
    float32 source coordinates (H', W'), with a constant border: each tap
    outside the image reads ``border``; the two horizontal blends and the
    vertical one are fused multiply-adds (exact products in float64, one
    rounding to float32); the result is rounded to nearest even. Works
    through ``BLEND_ROWS`` output rows at a time, so that its temporaries stay
    in cache (half the time of one pass over a 640 x 640 output, one thread)."""
    h, w, c = img.shape
    f32, f64 = np.float32, np.float64
    pad = np.full((h + 2, w + 2, c), border, np.uint8)
    pad[1:-1, 1:-1] = img
    flat = pad.reshape(-1, c)
    out = np.empty((*sx.shape, c), np.uint8)
    for r0 in range(0, sx.shape[0], BLEND_ROWS):
        x, y = sx[r0:r0 + BLEND_ROWS], sy[r0:r0 + BLEND_ROWS]
        ok = np.isfinite(x) & np.isfinite(y)
        if not ok.all():  # a perspective row through the horizon: treat as outside
            x, y = np.where(ok, x, f32(-4)), np.where(ok, y, f32(-4))
        fx, fy = np.floor(x), np.floor(y)
        a, b = (x - fx).astype(f64).reshape(-1, 1), (y - fy).astype(f64).reshape(-1, 1)
        ix = np.clip(fx, -4, w + 4).astype(np.int32).ravel()
        iy = np.clip(fy, -4, h + 4).astype(np.int32).ravel()
        outside = (ix < -1) | (ix >= w) | (iy < -1) | (iy >= h)
        i00 = (iy + 1) * (w + 2) + ix + 1
        i00[outside] = 0
        p00, p01 = flat[i00].astype(f64), flat[i00 + 1].astype(f64)
        p10, p11 = flat[i00 + (w + 2)].astype(f64), flat[i00 + (w + 3)].astype(f64)
        p01 -= p00
        p01 *= a
        p01 += p00
        f0 = p01.astype(f32)  # fma(a, p01 - p00, p00)
        p11 -= p10
        p11 *= a
        p11 += p10
        f1 = p11.astype(f32)  # fma(a, p11 - p10, p10)
        v = (f1 - f0).astype(f64)
        v *= b
        v += f0
        v = np.rint(v.astype(f32))  # fma(b, f1 - f0, f0), rounded
        v[outside] = border
        out[r0:r0 + BLEND_ROWS] = v.astype(np.uint8).reshape(*x.shape, c)
    return out


def _invert_affine(m: np.ndarray) -> List[float]:
    """OpenCV's in-place inverse of a forward 2x3 matrix, in its order."""
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _invert3(m: np.ndarray) -> List[float]:
    """``cv::invert`` of a 3x3 double matrix (its closed form for n == 3)."""
    s = [[float(v) for v in row] for row in m]
    det = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1]) - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
           + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    if det == 0:
        return [0.0] * 9
    d = 1.0 / det
    return [(s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d, (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
            (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d, (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
            (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d, (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
            (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d, (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
            (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d]


def _grid(m: List[float], dsize: Tuple[int, int]) -> Tuple[List[np.float32], np.ndarray, np.ndarray]:
    """The matrix in float32, and the output's columns (1, W) and rows (H, 1)."""
    return ([np.float32(v) for v in m], np.arange(int(dsize[0]), dtype=np.float32)[None],
            np.arange(int(dsize[1]), dtype=np.float32)[:, None])


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int], border: int = PAD_VALUE) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, borderValue=(border,) * 3)`` (INTER_LINEAR,
    BORDER_CONSTANT) of an (H, W, C) uint8 image with a forward 2x3 matrix:
    the inverse in double, then each source coordinate in float32 as
    ``fma(m0, x, m1*y + m2)``."""
    mf, xs, ys = _grid(_invert_affine(m), dsize)
    sx = _fma(mf[0], xs, mf[1] * ys + mf[2])
    sy = _fma(mf[3], xs, mf[4] * ys + mf[5])
    return _bilinear(img, sx, sy, border)


def warp_perspective(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int], border: int = PAD_VALUE) -> np.ndarray:
    """``cv2.warpPerspective(img, m, dsize, borderValue=(border,) * 3)``
    (INTER_LINEAR, BORDER_CONSTANT) with a forward 3x3 matrix: the inverse by
    ``cv::invert``'s closed form, then X, Y and W each as in
    :func:`warp_affine` and the source coordinate X / W in float32."""
    mf, xs, ys = _grid(_invert3(m), dsize)
    X = _fma(mf[0], xs, mf[1] * ys + mf[2])
    Y = _fma(mf[3], xs, mf[4] * ys + mf[5])
    W = _fma(mf[6], xs, mf[7] * ys + mf[8])
    with np.errstate(divide="ignore", invalid="ignore"):
        return _bilinear(img, X / W, Y / W, border)


def _hsv_tables() -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << HSV_SHIFT) / i)]).astype(np.int32)
    hdiv = np.concatenate([[0], np.rint((180 << HSV_SHIFT) / (6.0 * i))]).astype(np.int32)
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` of uint8 BGR (``RGB2HSV_b``)."""
    b, g, r = (img[..., k].astype(np.int32) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    hh = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    hh = (hh * _HDIV[diff] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    hh += np.where(hh < 0, 180, 0)
    return np.stack([np.clip(hh, 0, 255), s, v], -1).astype(np.uint8)


# per hue sector, the entry of (v, v(1-s), v(1-sf), v(1-s(1-f))) that b, g and r take
_SECTORS = np.asarray([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _hsv2bgr_formula(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` of uint8 HSV (hue in [0, 180)):
    float32 throughout, ``1 - s*f`` and ``1 - s*(1-f)`` as fused
    multiply-adds, truncated to uint8."""
    f32, one = np.float32, np.float32(1.0)
    h = img[..., 0].astype(f32) * (f32(6.0) / f32(180.0))
    s = img[..., 1].astype(f32) * (one / f32(255.0))
    v = img[..., 2].astype(f32) * (one / f32(255.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one), v * _fma(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector % 6], -1) * f32(255.0)
    return np.clip(np.floor(bgr), 0, 255).astype(np.uint8)


_HSV2BGR_TABLE: List[np.ndarray] = []
_HSV2BGR_LOCK = threading.Lock()


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """:func:`_hsv2bgr_formula` through a table of all 180 * 256 * 256 inputs
    (35 MB, built on the first call in about a second): a gather costs a
    fifth of the formula on a 640 x 640 image."""
    with _HSV2BGR_LOCK:
        if not _HSV2BGR_TABLE:
            grid = np.empty((180, 256, 256, 3), np.uint8)
            grid[..., 0] = np.arange(180)[:, None, None]
            grid[..., 1] = np.arange(256)[:, None]
            grid[..., 2] = np.arange(256)
            _HSV2BGR_TABLE.append(np.concatenate([_hsv2bgr_formula(g) for g in grid]).reshape(-1, 3))
    i = (img[..., 0].astype(np.int32) * 256 + img[..., 1]) * 256 + img[..., 2]
    return np.take(_HSV2BGR_TABLE[0], i.ravel(), 0).reshape(img.shape)


# ---------------------------------------------------------------------------
# Label helpers (boxes, classes, the segment task's polygons, the pose task's keypoints, the obb task's corners)
# ---------------------------------------------------------------------------

def _scale_shift_points(labels: Dict, r: float, padw: float, padh: float) -> Dict:
    """The labels with every polygon point, keypoint and corner mapped to x * r + pad."""
    out = dict(labels)
    if labels.get("segments") is not None:
        out["segments"] = [s * r + np.asarray([padw, padh], np.float32) for s in labels["segments"]]
    if labels.get("keypoints") is not None:
        kp = labels["keypoints"].copy()
        kp[..., 0] = kp[..., 0] * r + padw
        kp[..., 1] = kp[..., 1] * r + padh
        out["keypoints"] = kp
    if labels.get("obb") is not None:
        out["obb"] = labels["obb"] * r + np.asarray([padw, padh], np.float32)
    return out


def _take_instances(labels: Dict, keep) -> Dict:
    """Index every per-instance field by a boolean or integer index array."""
    out = {**labels, "bboxes": labels["bboxes"][keep], "cls": labels["cls"][keep]}
    if labels.get("segments") is not None:
        idx = np.flatnonzero(keep) if np.asarray(keep).dtype == bool else np.asarray(keep)
        out["segments"] = [labels["segments"][i] for i in idx]
    if labels.get("keypoints") is not None:
        out["keypoints"] = labels["keypoints"][keep]
    if labels.get("obb") is not None:
        out["obb"] = labels["obb"][keep]
    return out


def _cat_instances(l1: Dict, l2: Dict) -> Dict:
    out = {"bboxes": np.concatenate([l1["bboxes"], l2["bboxes"]]).astype(np.float32),
           "cls": np.concatenate([l1["cls"], l2["cls"]])}
    if l1.get("segments") is not None or l2.get("segments") is not None:
        out["segments"] = list(l1.get("segments") or []) + list(l2.get("segments") or [])
    if l1.get("keypoints") is not None:
        out["keypoints"] = np.concatenate([l1["keypoints"], l2["keypoints"]])
    if l1.get("obb") is not None:
        out["obb"] = np.concatenate([l1["obb"], l2["obb"]])
    return out


def _invisible_off(kp: np.ndarray, width: float, height: float) -> np.ndarray:
    """Keypoints (N, nk, 3) with the visibility of those outside [0, width) x [0, height) set to 0."""
    oob = (kp[..., 0] < 0) | (kp[..., 0] >= width) | (kp[..., 1] < 0) | (kp[..., 1] >= height)
    kp[..., 2] = np.where(oob, 0.0, kp[..., 2])
    return kp


# ---------------------------------------------------------------------------
# LetterBox
# ---------------------------------------------------------------------------

def letterbox(img: np.ndarray, new_shape: Union[int, Tuple[int, int]] = (640, 640), scaleup: bool = True
              ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Ratio-preserving resize + centred pad of 114 of an (H, W, 3) uint8
    image (no upscaling when ``scaleup`` is off). Returns (image, gain,
    (padw, padh)), with the JAX package's rounding: the pad split as
    ``round(d - 0.1)`` before and ``round(d + 0.1)`` after."""
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw, dh = (new_shape[1] - new_w) / 2, (new_shape[0] - new_h) / 2
    if (shape[1], shape[0]) != (new_w, new_h):
        img = resize_linear(img, (new_w, new_h))
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full((new_h + top + bottom, new_w + left + right, img.shape[2]), PAD_VALUE, dtype=np.uint8)
    out[top:top + new_h, left:left + new_w] = img
    return out, r, (left, top)


def letterbox_labels(labels: Dict, imgsz, scaleup: bool = True) -> Dict:
    """``imgsz``: an int (square) or an (h, w) tuple (rect batches)."""
    shape = (imgsz, imgsz) if isinstance(imgsz, int) else tuple(imgsz)
    img, r, (padw, padh) = letterbox(labels["img"], shape, scaleup=scaleup)
    bboxes = labels["bboxes"].copy()
    if len(bboxes):
        bboxes = bboxes * r
        bboxes[:, [0, 2]] += padw
        bboxes[:, [1, 3]] += padh
    labels = _scale_shift_points(labels, r, padw, padh)
    return {**labels, "img": img, "bboxes": bboxes, "ratio_pad": (r, (padw, padh))}


# ---------------------------------------------------------------------------
# Mosaic
# ---------------------------------------------------------------------------

def _tile(it: Dict, s: int) -> Tuple[np.ndarray, float]:
    """An item's image with its longest side resized to ``s``, and the gain."""
    img = it["img"]
    h, w = img.shape[:2]
    r = s / max(h, w)
    if r != 1:
        img = resize_linear(img, (int(w * r), int(h * r)))
    return img, r


def _merge(shifted: List[Dict], s: int, first: Dict) -> Dict:
    """The tiles' labels on the (2s, 2s) canvas, clipped to it (the obb
    corners too), keypoints off it made invisible; the geometry fields are
    ``first``'s (the first item's), empty when no tile has a label."""
    if shifted:
        merged = shifted[0]
        for nxt in shifted[1:]:
            merged = _cat_instances(merged, nxt)
    else:
        merged = {"bboxes": np.zeros((0, 4), np.float32), "cls": np.zeros((0,), np.float32)}
        if first.get("segments") is not None:
            merged["segments"] = []
        for k in ("keypoints", "obb"):
            if first.get(k) is not None:
                merged[k] = np.zeros((0,) + first[k].shape[1:], np.float32)
    merged["bboxes"] = np.clip(merged["bboxes"], 0, 2 * s).astype(np.float32)
    if merged.get("segments") is not None:
        merged["segments"] = [np.clip(p, 0, 2 * s) for p in merged["segments"]]
    if merged.get("obb") is not None:
        merged["obb"] = np.clip(merged["obb"], 0, 2 * s)
    if merged.get("keypoints") is not None:
        merged["keypoints"] = _invisible_off(merged["keypoints"], 2 * s, 2 * s)
    return merged


def mosaic4(items: List[Dict], imgsz: int, rng: np.random.Generator) -> Dict:
    """Four images on a (2s, 2s) canvas around a random centre; the following
    :func:`random_perspective` crops back to s x s (border -s/2)."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((2 * s, 2 * s, 3), PAD_VALUE, dtype=np.uint8)
    shifted = []
    for i, it in enumerate(items):
        img, r = _tile(it, s)
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(it["bboxes"]):
            b = it["bboxes"] * r
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            shifted.append({**_scale_shift_points(it, r, padw, padh), "bboxes": b})
    merged = _merge(shifted, s, items[0])
    return {"img": canvas, **merged, "mosaic_border": (-s // 2, -s // 2)}


def mosaic9(items: List[Dict], imgsz: int, rng: np.random.Generator) -> Dict:
    """Nine images in a 3x3 grid, cropped to the (2s, 2s) canvas: the same
    output as :func:`mosaic4`. Draws nothing from ``rng``, as in JAX."""
    s = imgsz
    canvas = np.full((3 * s, 3 * s, 3), PAD_VALUE, dtype=np.uint8)
    hp = wp = -1  # the previous tile's h, w
    h0 = w0 = 0
    shifted = []
    for i, it in enumerate(items):
        img, r = _tile(it, s)
        h, w = img.shape[:2]
        if i == 0:  # centre
            h0, w0 = h, w
            c = s, s, s + w, s + h
        elif i == 1:  # top
            c = s, s - h, s + w, s
        elif i == 2:  # top right
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:  # right
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:  # bottom right
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:  # bottom
            c = s + w0 - w, s + h0, s + w0, s + h0 + h
        elif i == 6:  # bottom left
            c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
        elif i == 7:  # left
            c = s - w, s + h0 - h, s, s + h0
        else:  # top left
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padw, padh = c[:2]
        x1, y1, x2, y2 = (max(x, 0) for x in c)
        canvas[y1:y2, x1:x2] = img[y1 - padh:, x1 - padw:]
        hp, wp = h, w
        if len(it["bboxes"]):
            off_x, off_y = padw - s // 2, padh - s // 2  # canvas coordinates, then the (2s, 2s) crop's
            b = it["bboxes"] * r
            b[:, [0, 2]] += off_x
            b[:, [1, 3]] += off_y
            shifted.append({**_scale_shift_points(it, r, off_x, off_y), "bboxes": b})
    crop = canvas[s // 2:s // 2 + 2 * s, s // 2:s // 2 + 2 * s]
    merged = _merge(shifted, s, items[0])
    return {"img": np.ascontiguousarray(crop), **merged, "mosaic_border": (-s // 2, -s // 2)}


def _bbox_ioa(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    """Intersection over box2's area (the reference's ``bbox_ioa``)."""
    ix = (np.minimum(box1[:, None, 2], box2[None, :, 2]) - np.maximum(box1[:, None, 0], box2[None, :, 0])).clip(0)
    iy = (np.minimum(box1[:, None, 3], box2[None, :, 3]) - np.maximum(box1[:, None, 1], box2[None, :, 1])).clip(0)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1]) + 1e-7
    return ix * iy / area2[None]


def copy_paste(labels: Dict, p: float, rng: np.random.Generator) -> Dict:
    """CopyPaste (the reference's, arXiv:2012.07177): segment instances whose
    horizontally flipped box overlaps every box by IoA < 0.3 are pasted back
    flipped, ``round(p * candidates)`` of them drawn by ``rng.choice``. The
    image is changed in place, as in the JAX module. Without segments (the
    detect task) the labels pass through and nothing is drawn."""
    segments = labels.get("segments")
    if not p or not segments or len(segments) == 0:
        return labels
    im = labels["img"]
    h, w = im.shape[:2]
    boxes = labels["bboxes"]  # pixel xyxy
    flip_boxes = boxes.copy()
    flip_boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    candidates = np.nonzero((_bbox_ioa(flip_boxes, boxes) < 0.30).all(1))[0]
    k = round(p * len(candidates))
    if k == 0:
        return labels
    chosen = rng.choice(candidates, size=k, replace=False)
    pasted = np.zeros((h, w), np.int32)
    new_cls, new_boxes, new_segs = [], [], []
    for j in chosen:
        seg = segments[j].copy()
        seg[:, 0] = w - seg[:, 0]
        new_cls.append(labels["cls"][j])
        new_boxes.append(flip_boxes[j])
        new_segs.append(seg)
        fill_polys(pasted, [seg.astype(np.int32)], [1])
    keep = pasted[:, ::-1].astype(bool)
    im[keep] = im[:, ::-1][keep]
    out = dict(labels)
    out["img"] = im
    out["cls"] = np.concatenate([labels["cls"], np.asarray(new_cls, np.float32)])
    out["bboxes"] = np.concatenate([boxes, np.stack(new_boxes)]).astype(np.float32)
    out["segments"] = list(segments) + new_segs
    return out


# ---------------------------------------------------------------------------
# RandomPerspective
# ---------------------------------------------------------------------------

def random_perspective(labels: Dict, degrees: float = 0.0, translate: float = 0.1, scale: float = 0.5,
                       shear: float = 0.0, perspective: float = 0.0, border: Tuple[int, int] = (0, 0),
                       rng: Optional[np.random.Generator] = None) -> Dict:
    """Affine or perspective warp with the box transform and the degenerate-box
    filter. Draws P, P, angle, scale, shear, shear, T, T, as in JAX."""
    rng = rng or np.random.default_rng()
    img = labels["img"]
    border = labels.get("mosaic_border", border)
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    # centre -> perspective -> rotation and scale -> shear -> translation
    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix_2d(a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ P @ C

    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = warp_perspective(img, M, (width, height))
        else:
            img = warp_affine(img, M[:2], (width, height))

    def warp_pts(pts):  # (..., 2) -> transformed (..., 2) float32
        shape = pts.shape
        xy = np.ones((int(np.prod(shape[:-1])), 3))
        xy[:, :2] = pts.reshape(-1, 2)
        xy = xy @ M.T
        return (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(shape).astype(np.float32)

    labels = dict(labels)
    bboxes, cls = labels["bboxes"], labels["cls"]
    if len(bboxes):
        n = len(bboxes)
        if labels.get("segments"):  # boxes rebuilt from the warped polygons, as the reference does
            segs = [np.clip(warp_pts(p), [0, 0], [width, height]) for p in labels["segments"]]
            new = np.stack([np.concatenate([p.min(0), p.max(0)]) for p in segs], 0).astype(np.float32)
            labels["segments"] = segs
        elif labels.get("obb") is not None:  # the corners warped, not clipped; the boxes from their extremes, clipped
            corners = warp_pts(labels["obb"])
            labels["obb"] = corners
            new = np.concatenate([corners.min(1), corners.max(1)], -1).astype(np.float32)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        else:
            xy = warp_pts(bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n, 4, 2)).reshape(n, 8)
            x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
            new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        if labels.get("keypoints") is not None:  # warped; those off the output made invisible
            kp = labels["keypoints"].copy()
            kp[..., :2] = warp_pts(kp[..., :2])
            labels["keypoints"] = _invisible_off(kp, width, height)
        keep = _box_candidates(bboxes.T * s, new.T)
        labels["bboxes"] = new
        labels = _take_instances(labels, keep)
        bboxes, cls = labels["bboxes"].astype(np.float32), labels["cls"]
    return {**labels, "img": img, "bboxes": bboxes, "cls": cls}


def _box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Drop degenerate boxes after the warp (the reference's box_candidates)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


# ---------------------------------------------------------------------------
# HSV, flips, MixUp
# ---------------------------------------------------------------------------

def random_hsv(img: np.ndarray, hgain=0.015, sgain=0.7, vgain=0.4, rng=None) -> np.ndarray:
    """Random gains of hue, saturation and value through 256-entry tables."""
    rng = rng or np.random.default_rng()
    if hgain or sgain or vgain:
        r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
        hsv = bgr2hsv(img)
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(img.dtype)
        lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
        lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
        hsv = np.stack([lut_hue[hsv[..., 0]], lut_sat[hsv[..., 1]], lut_val[hsv[..., 2]]], -1)
        img = hsv2bgr(hsv)
    return img


def random_flip(labels: Dict, direction: str, p: float, rng=None, flip_idx=None) -> Dict:
    """Image, box, polygon, corner and keypoint flip with probability ``p`` (one
    draw); ``flip_idx`` reorders the keypoints on a horizontal flip (left and
    right swapped; None keeps their order)."""
    rng = rng or np.random.default_rng()
    if rng.random() >= p:
        return labels
    img, bboxes = labels["img"], labels["bboxes"].copy()
    h, w = img.shape[:2]
    if direction == "horizontal":
        img = np.fliplr(img)
        if len(bboxes):
            bboxes[:, [0, 2]] = w - bboxes[:, [2, 0]]
    else:
        img = np.flipud(img)
        if len(bboxes):
            bboxes[:, [1, 3]] = h - bboxes[:, [3, 1]]
    if labels.get("segments"):
        axis, extent = (0, w) if direction == "horizontal" else (1, h)
        flipped = []
        for p in labels["segments"]:
            p = p.copy()
            p[..., axis] = extent - p[..., axis]
            flipped.append(p)
        labels = {**labels, "segments": flipped}
    if labels.get("obb") is not None:
        axis, extent = (0, w) if direction == "horizontal" else (1, h)
        corners = labels["obb"].copy()
        corners[..., axis] = extent - corners[..., axis]
        labels = {**labels, "obb": corners}
    if labels.get("keypoints") is not None:
        axis, extent = (0, w) if direction == "horizontal" else (1, h)
        kp = labels["keypoints"].copy()
        kp[..., axis] = extent - kp[..., axis]
        if direction == "horizontal" and flip_idx is not None:
            kp = kp[:, np.asarray(flip_idx, np.int64)]
        labels = {**labels, "keypoints": kp}
    return {**labels, "img": np.ascontiguousarray(img), "bboxes": bboxes}


def mixup(l1: Dict, l2: Dict, rng=None) -> Dict:
    """Beta(32, 32) blend of two images with the union of their labels."""
    rng = rng or np.random.default_rng()
    r = rng.beta(32.0, 32.0)
    img = (l1["img"].astype(np.float32) * r + l2["img"].astype(np.float32) * (1 - r)).astype(np.uint8)
    return {**l1, "img": img, **_cat_instances(l1, l2)}


def xyxyxyxy2xywhr(corners: np.ndarray) -> np.ndarray:
    """(N, 4, 2) corner points -> (N, 5) float32 xywhr: ``cv2.minAreaRect`` of
    each, its angle in degrees in [-90, 0) taken to radians in float64 (JAX
    ``data/augment.py:512``)."""
    rects = min_area_rect(np.asarray(corners, np.float32).reshape(-1, 4, 2))
    out = rects.copy()
    out[:, 4] = rects[:, 4].astype(np.float64) / 180 * np.pi
    return out


# ---------------------------------------------------------------------------
# Format: pad to a static label count
# ---------------------------------------------------------------------------

def format_sample(labels: Dict, imgsz: int, max_labels: int, task: str = "detect", kpt_shape=(17, 3),
                  mask_ratio: int = 4) -> Dict[str, np.ndarray]:
    """One sample in the device batch's form: ``img`` RGB HWC uint8,
    ``bboxes`` (max_labels, 4) normalised xywh, ``cls`` (max_labels,) int32
    and ``mask`` (max_labels,) bool; for ``task='segment'`` also ``masks``
    (H / mask_ratio, W / mask_ratio) int32, the overlap-index image, with the
    instances reordered by area, largest first, to match its values; for
    ``task='pose'`` also ``keypoints`` (max_labels, nk, nd), xy normalised
    and the visibility; for ``task='obb'`` ``bboxes`` are (max_labels, 5),
    each instance's corners as :func:`xyxyxyxy2xywhr` gives them, xywh
    normalised and the angle in radians. ``classify`` raises naming ROADMAP.md
    catalogue item 13."""
    if task not in ("detect", "segment", "pose", "obb"):
        raise NotImplementedError(f"task={task!r} is not ported to experiment_yolo_torch yet "
                                  "(ROADMAP.md catalogue item 13)")
    img = labels["img"]
    h, w = img.shape[:2]
    bboxes, cls = labels["bboxes"], labels["cls"]
    out: Dict[str, np.ndarray] = {}
    if task == "segment":
        masks, order = polygons2mask_overlap(labels.get("segments") or [], (h, w), mask_ratio)
        out["masks"] = masks
        if len(order):
            bboxes, cls = bboxes[order], cls[order]
    if task == "obb" and labels.get("obb") is not None and len(labels["obb"]):
        bboxes = xyxyxyxy2xywhr(labels["obb"])
    n = min(len(bboxes), max_labels)
    out_boxes = np.zeros((max_labels, 5 if task == "obb" else 4), np.float32)
    out_cls = np.zeros((max_labels,), np.int32)
    mask = np.zeros((max_labels,), bool)
    if n and task == "obb":
        out_boxes[:n] = bboxes[:n] / np.asarray([w, h, w, h, 1.0], np.float32)
        out_cls[:n] = cls[:n].astype(np.int32)
        mask[:n] = True
    elif n:
        b = bboxes[:n]
        out_boxes[:n] = np.stack([(b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
                                  (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h], axis=1)
        out_cls[:n] = cls[:n].astype(np.int32)
        mask[:n] = True
    if task == "pose":
        nk, ndim = kpt_shape
        kp_out = np.zeros((max_labels, nk, ndim), np.float32)
        kp = labels.get("keypoints")
        if kp is not None and n:
            kp = kp[:n].astype(np.float32).copy()
            kp[..., 0] /= w
            kp[..., 1] /= h
            kp_out[:n] = kp[..., :ndim]
        out["keypoints"] = kp_out
    out.update({"img": np.ascontiguousarray(img[..., ::-1]), "bboxes": out_boxes, "cls": out_cls, "mask": mask})
    return out
