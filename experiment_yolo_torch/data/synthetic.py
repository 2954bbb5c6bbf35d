"""Synthetic YOLO-format detection dataset.

Port of ``experiment_yolo_tpu/data/synthetic.py:make_synthetic_dataset``: the
no-network stand-in for COCO128/WAID, coloured ellipses, rectangles and
triangles (one class each) on blurred noise, written as a standard YOLO
dataset (``images/``, ``labels/``, ``data.yaml``). It makes the same numpy
draws in the same order, so for the same seed the label files and
``data.yaml`` are identical to the JAX generator's.

One deviation: the images are 24-bit ``.bmp`` files, not ``.jpg``: a
lossless file keeps the pixels drawn here on every machine, where a JPEG's
would depend on the encoder (nvJPEG on the card, libjpeg on the CPU;
``data/codec.py``). The pixels come from this module's own rasteriser
(a 7x7 Gaussian blur with OpenCV's sigma for that size, 1.4, and a
saturating offset; filled shapes by pixel-centre tests) and are not held to
OpenCV's drawing. ``make_synthetic_task_dataset`` (segment, pose, obb) waits
for the task families (ROADMAP.md catalogue item 13).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from experiment_yolo_torch.data.image_io import imwrite
from experiment_yolo_torch.utils import yaml_save

SHAPE_NAMES = ["circle", "square", "triangle"]
BLUR_SIGMA = 0.3 * ((7 - 1) * 0.5 - 1) + 0.8  # OpenCV's sigma for a 7x7 kernel given sigma 0


def _blur7(img: np.ndarray) -> np.ndarray:
    """Separable 7x7 Gaussian blur of a uint8 image, reflect-101 border, rounded."""
    k = np.exp(-(np.arange(-3, 4) ** 2) / (2 * BLUR_SIGMA ** 2))
    k /= k.sum()
    x = img.astype(np.float64)
    for axis in (0, 1):
        pad = [(3, 3) if a == axis else (0, 0) for a in range(3)]
        xp = np.pad(x, pad, mode="reflect")
        n = x.shape[axis]
        x = sum(k[i] * np.take(xp, np.arange(i, i + n), axis) for i in range(7))
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _draw_shape(img: np.ndarray, cls: int, cx: int, cy: int, rx: int, ry: int, color) -> None:
    """Fill one shape with independent x/y half-extents, by pixel-centre tests
    inside its box (every shape lies within cx +- rx, cy +- ry)."""
    y0, x0 = max(cy - ry, 0), max(cx - rx, 0)
    ys, xs = np.mgrid[y0:min(cy + ry, img.shape[0] - 1) + 1, x0:min(cx + rx, img.shape[1] - 1) + 1]
    if cls == 0:  # ellipse
        inside = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1.0
    elif cls == 1:  # rectangle, both corners included
        inside = np.ones(xs.shape, bool)
    else:  # triangle (cx, cy - ry), (cx - rx, cy + ry), (cx + rx, cy + ry)
        inside = (2 * ry * (xs - cx) <= rx * (ys - cy + ry)) & (2 * ry * (cx - xs) <= rx * (ys - cy + ry))
    img[ys[inside], xs[inside]] = color


def make_synthetic_dataset(root: str | Path, n_train: int = 64, n_val: int = 16, imgsz: int = 320,
                           max_objects: int = 6, seed: int = 0) -> Path:
    """Write a synthetic dataset; returns the path of its data.yaml."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = root / "images" / split
        lab_dir = root / "labels" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        lab_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = rng.integers(0, 60, (imgsz, imgsz, 3), np.uint8)
            img = np.clip(_blur7(img).astype(np.int32) + int(rng.integers(40, 90)), 0, 255).astype(np.uint8)
            lines = []
            for _ in range(int(rng.integers(1, max_objects + 1))):
                cls = int(rng.integers(0, len(SHAPE_NAMES)))
                # log-uniform scale (small objects dominate) and aspect ratios 1:2 .. 2:1
                r = int(round(np.exp(rng.uniform(np.log(max(imgsz // 28, 3)), np.log(imgsz // 5)))))
                a = float(np.exp(rng.uniform(np.log(0.5), np.log(2.0))))
                rx = int(np.clip(round(r * a), 2, imgsz // 3))
                ry = int(np.clip(round(r / a), 2, imgsz // 3))
                cx = int(rng.integers(rx, imgsz - rx))
                cy = int(rng.integers(ry, imgsz - ry))
                color = tuple(int(c) for c in rng.integers(120, 255, 3))
                _draw_shape(img, cls, cx, cy, rx, ry, color)
                lines.append(f"{cls} {cx/imgsz:.6f} {cy/imgsz:.6f} {2*rx/imgsz:.6f} {2*ry/imgsz:.6f}")
            imwrite(img_dir / f"{i:05d}.bmp", img)
            (lab_dir / f"{i:05d}.txt").write_text("\n".join(lines) + "\n")
    yaml_path = root / "data.yaml"
    yaml_save(yaml_path, {"path": str(root), "train": "images/train", "val": "images/val",
                          "nc": len(SHAPE_NAMES), "names": SHAPE_NAMES})
    return yaml_path
