"""Synthetic YOLO-format detection dataset.

Port of ``experiment_yolo_tpu/data/synthetic.py`` (``make_synthetic_dataset``
and ``make_synthetic_task_dataset`` for the segment, pose and obb tasks): the
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
OpenCV's drawing, except the segment task's polygons and the obb task's
rotated rectangles, which ``data/polygons.py:fill_polys`` draws as
``cv2.fillPoly`` does; the pose task's rings and dots are pixel-centre tests
too.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from experiment_yolo_torch.data.image_io import imwrite
from experiment_yolo_torch.data.polygons import fill_polys
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


def _draw_ring_and_dots(img: np.ndarray, cx: int, cy: int, r: int, color, kps) -> None:
    """A pose object: a ring of radius ``r``, 2 px wide, in ``color``, then a
    white dot of radius 3 at each keypoint (truncated to whole pixels), by
    pixel-centre tests."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    dist = np.hypot(xs - cx, ys - cy)
    img[np.abs(dist - r) <= 1.0] = color
    for x, y in kps:
        img[(xs - int(x)) ** 2 + (ys - int(y)) ** 2 <= 9] = (255, 255, 255)


def make_synthetic_task_dataset(root: str | Path, task: str, n_train: int = 32, n_val: int = 8, imgsz: int = 256,
                                max_objects: int = 4, seed: int = 0, nk: int = 5) -> Path:
    """Write a synthetic dataset of the segment task (filled triangles and
    pentagons, class ``poly3`` and ``poly5``, labelled by their normalised
    vertices) or of the pose task (rings of class ``blob`` with ``nk``
    keypoints, the centre and ``nk - 1`` on the ring, each marked by a dot,
    labelled by a box of 2.2 radii and the keypoints at visibility 2;
    ``kpt_shape: [nk, 3]`` in data.yaml) or of the obb task (filled
    rectangles of class ``blob``, 2r by 2 max(r // 2, 4), turned by an angle
    in [0, pi/2), labelled by their four normalised corners); returns the
    path of its data.yaml.
    The draws are the JAX generator's, in its order, so the label files and
    data.yaml are identical to its; the images are then blurred, drawn and
    written on a thread pool."""
    if task not in ("segment", "pose", "obb"):
        raise NotImplementedError(f"task={task!r}: the port writes segment, pose and obb datasets; classify waits "
                                  "for ROADMAP.md catalogue item 13")
    root = Path(root)
    rng = np.random.default_rng(seed)
    names = ["poly3", "poly5"] if task == "segment" else ["blob"]
    jobs = []  # (image path, noise, offset, [(what, geometry, colour)])
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = root / "images" / split
        lab_dir = root / "labels" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        lab_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            noise = rng.integers(0, 60, (imgsz, imgsz, 3), np.uint8)
            offset = int(rng.integers(40, 90))
            lines, shapes = [], []
            for _ in range(int(rng.integers(1, max_objects + 1))):
                r = int(rng.integers(imgsz // 12, imgsz // 6))
                cx = int(rng.integers(r + 2, imgsz - r - 2))
                cy = int(rng.integers(r + 2, imgsz - r - 2))
                color = tuple(int(c) for c in rng.integers(120, 255, 3))
                if task == "segment":
                    cls = int(rng.integers(0, 2))
                    k = 3 if cls == 0 else 5
                    ang = rng.uniform(0, 2 * np.pi)
                    pts = np.stack([cx + r * np.cos(ang + 2 * np.pi * np.arange(k) / k),
                                    cy + r * np.sin(ang + 2 * np.pi * np.arange(k) / k)], -1)
                    shapes.append(("polygon", pts.astype(np.int32), color))
                    lines.append(f"{cls} " + " ".join(f"{v:.6f}" for v in (pts / imgsz).reshape(-1)))
                elif task == "obb":
                    w2, h2 = r, max(r // 2, 4)
                    ang = rng.uniform(0, np.pi / 2)
                    c, s = np.cos(ang), np.sin(ang)
                    box = np.asarray([[-w2, -h2], [w2, -h2], [w2, h2], [-w2, h2]], np.float32)
                    pts = box @ np.asarray([[c, s], [-s, c]], np.float32) + [cx, cy]
                    shapes.append(("polygon", pts.astype(np.int32), color))
                    lines.append("0 " + " ".join(f"{v:.6f}" for v in (pts / imgsz).reshape(-1)))
                else:  # the centre, then nk - 1 keypoints around the ring
                    kps = [(cx, cy)] + [(cx + r * np.cos(2 * np.pi * j / (nk - 1)),
                                         cy + r * np.sin(2 * np.pi * j / (nk - 1))) for j in range(nk - 1)]
                    shapes.append(("ring", (cx, cy, r, kps), color))
                    box = f"{cx/imgsz:.6f} {cy/imgsz:.6f} {2.2*r/imgsz:.6f} {2.2*r/imgsz:.6f}"
                    lines.append(f"0 {box} " + " ".join(f"{x/imgsz:.6f} {y/imgsz:.6f} 2" for x, y in kps))
            (lab_dir / f"{i:05d}.txt").write_text("\n".join(lines) + "\n")
            jobs.append((img_dir / f"{i:05d}.bmp", noise, offset, shapes))

    def render(job):
        path, noise, offset, shapes = job
        img = np.clip(_blur7(noise).astype(np.int32) + offset, 0, 255).astype(np.uint8)
        for what, geom, color in shapes:
            if what == "polygon":
                img[fill_polys(np.zeros((imgsz, imgsz), np.int32), [geom], [1]).astype(bool)] = color
            else:
                _draw_ring_and_dots(img, *geom[:3], color, geom[3])
        imwrite(path, img)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(render, jobs))
    yaml_path = root / "data.yaml"
    meta = {"path": str(root), "train": "images/train", "val": "images/val", "nc": len(names), "names": names}
    if task == "pose":
        meta["kpt_shape"] = [nk, 3]
    yaml_save(yaml_path, meta)
    return yaml_path
