"""DOTA image and label window splitter.

Port of ``experiment_yolo_tpu/data/split_dota.py`` (the reference's
``ultralytics/data/split_dota.py``): large aerial images are cut into
overlapping crop windows, and each window keeps the 8-point OBB labels whose
intersection over the object's own area (IoF) with it reaches a threshold,
renormalised to the crop. The polygon-window intersection is the JAX
module's Sutherland-Hodgman clip of the quad against the window (no
shapely). Images are read and written through ``data/image_io.py`` (JPEGs
with nvJPEG for the card, libjpeg for the CPU), not OpenCV; the crops are
the same arrays as the JAX module's.
"""

from __future__ import annotations

import itertools
from math import ceil
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from experiment_yolo_torch.data import image_io
from experiment_yolo_torch.data.converter import image_size

__all__ = ["split_trainval", "split_test", "split_images_and_labels", "get_windows", "bbox_iof"]

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def _poly_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def _poly_rect_inter_area(poly: np.ndarray, rect: Sequence[float]) -> float:
    """Area of the polygon (n, 2) clipped to the window (x1, y1, x2, y2), one
    window side after the other, in float64."""
    x1, y1, x2, y2 = rect

    def clip(points: List[np.ndarray], inside, intersect) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        for i in range(len(points)):
            cur, nxt = points[i], points[(i + 1) % len(points)]
            cin, nin = inside(cur), inside(nxt)
            if cin:
                out.append(cur)
                if not nin:
                    out.append(intersect(cur, nxt))
            elif nin:
                out.append(intersect(cur, nxt))
        return out

    def x_cut(a, b, x):
        t = (x - a[0]) / (b[0] - a[0] + 1e-12)
        return np.array([x, a[1] + t * (b[1] - a[1])])

    def y_cut(a, b, y):
        t = (y - a[1]) / (b[1] - a[1] + 1e-12)
        return np.array([a[0] + t * (b[0] - a[0]), y])

    pts = [p.astype(np.float64) for p in poly]
    for inside, cut in ((lambda p: p[0] >= x1, lambda a, b: x_cut(a, b, x1)),
                        (lambda p: p[0] <= x2, lambda a, b: x_cut(a, b, x2)),
                        (lambda p: p[1] >= y1, lambda a, b: y_cut(a, b, y1)),
                        (lambda p: p[1] <= y2, lambda a, b: y_cut(a, b, y2))):
        if not pts:
            break
        pts = clip(pts, inside, cut)
    return _poly_area(np.stack(pts)) if len(pts) >= 3 else 0.0


def bbox_iof(polygon1: np.ndarray, bbox2: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """IoF of label quads (n, 8) against xyxy windows (m, 4) -> (n, m): the
    clipped area over the quad's own (at least ``eps``); pairs whose extents
    do not meet are 0 without a clip."""
    polys = polygon1.reshape(-1, 4, 2)
    out = np.zeros((polys.shape[0], bbox2.shape[0]), np.float64)
    lt, rb = polys.min(-2), polys.max(-2)
    for i in range(len(polys)):
        area = max(_poly_area(polys[i]), eps)
        for j in range(len(bbox2)):
            if rb[i, 0] <= bbox2[j, 0] or rb[i, 1] <= bbox2[j, 1] or lt[i, 0] >= bbox2[j, 2] or lt[i, 1] >= bbox2[j, 3]:
                continue
            out[i, j] = _poly_rect_inter_area(polys[i], bbox2[j]) / area
    return out


def _images(folder: Path) -> List[Path]:
    return [f for f in sorted(folder.iterdir()) if f.suffix.lower() in IMAGE_SUFFIXES]


def load_yolo_dota(data_root: str, split: str = "train") -> List[dict]:
    """The annotations of ``images/<split>`` and ``labels/<split>``: each
    image's ``filepath``, its ``label`` rows (n, 9) float32 (cls and the
    normalised corners) and its ``ori_size`` (h, w)."""
    root = Path(data_root)
    im_dir, lb_dir = root / "images" / split, root / "labels" / split
    assert im_dir.exists(), f"missing {im_dir}"
    annos = []
    for im_file in _images(im_dir):
        h, w = image_size(im_file)
        lb_file = lb_dir / f"{im_file.stem}.txt"
        rows = [x.split() for x in lb_file.read_text().splitlines() if x.strip()] if lb_file.exists() else []
        label = np.array(rows, dtype=np.float32) if rows else np.zeros((0, 9), np.float32)
        annos.append({"filepath": str(im_file), "label": label, "ori_size": (h, w)})
    return annos


def get_windows(im_size: Tuple[int, int], crop_sizes: Sequence[int] = (1024,), gaps: Sequence[int] = (200,),
                im_rate_thr: float = 0.6, eps: float = 0.01) -> np.ndarray:
    """Sliding crop windows (x1, y1, x2, y2) over an (h, w) image, one grid
    per (crop size, gap), the last row and column moved back inside the
    image; windows whose share inside the image is at most ``im_rate_thr``
    are dropped, unless none passes, when those within ``eps`` of the best
    are kept."""
    h, w = im_size
    windows = []
    for crop_size, gap in zip(crop_sizes, gaps):
        assert crop_size > gap, f"invalid crop_size/gap pair [{crop_size} {gap}]"
        step = crop_size - gap
        xn = 1 if w <= crop_size else ceil((w - crop_size) / step + 1)
        xs = [step * i for i in range(xn)]
        if len(xs) > 1 and xs[-1] + crop_size > w:
            xs[-1] = w - crop_size
        yn = 1 if h <= crop_size else ceil((h - crop_size) / step + 1)
        ys = [step * i for i in range(yn)]
        if len(ys) > 1 and ys[-1] + crop_size > h:
            ys[-1] = h - crop_size
        start = np.array(list(itertools.product(xs, ys)), dtype=np.int64)
        windows.append(np.concatenate([start, start + crop_size], axis=1))
    windows = np.concatenate(windows, axis=0)

    clipped = windows.copy()
    clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, w)
    clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, h)
    im_areas = (clipped[:, 2] - clipped[:, 0]) * (clipped[:, 3] - clipped[:, 1])
    win_areas = (windows[:, 2] - windows[:, 0]) * (windows[:, 3] - windows[:, 1])
    im_rates = im_areas / win_areas
    if not (im_rates > im_rate_thr).any():
        im_rates[np.abs(im_rates - im_rates.max()) < eps] = 1
    return windows[im_rates > im_rate_thr]


def get_window_obj(anno: dict, windows: np.ndarray, iof_thr: float = 0.7) -> List[np.ndarray]:
    """Each window's label rows, corners in pixels, whose IoF with it reaches ``iof_thr``."""
    h, w = anno["ori_size"]
    label = anno["label"].copy()
    if len(label) == 0:
        return [np.zeros((0, 9), np.float32) for _ in range(len(windows))]
    label[:, 1::2] *= w
    label[:, 2::2] *= h
    iofs = bbox_iof(label[:, 1:], windows)
    return [label[iofs[:, i] >= iof_thr] for i in range(len(windows))]


def _window_name(stem: str, window) -> str:
    x_start, y_start, x_stop, _ = window
    return f"{stem}__{x_stop - x_start}__{x_start}___{y_start}"


def crop_and_save(anno: dict, windows: np.ndarray, window_objs: List[np.ndarray], im_dir: str, lb_dir: str,
                  device="cuda") -> None:
    """Write each window's crop as ``{stem}__{crop}__{x}___{y}.jpg`` and its
    labels renormalised to the crop (``{c:.6g}``), as the reference names and
    writes them; a window without labels gets no label file."""
    im = image_io.imread(anno["filepath"], device)
    name = Path(anno["filepath"]).stem
    for window, label in zip(windows.tolist(), window_objs):
        x_start, y_start, x_stop, y_stop = window
        new_name = _window_name(name, window)
        patch = np.ascontiguousarray(im[y_start:y_stop, x_start:x_stop])
        ph, pw = patch.shape[:2]
        image_io.imwrite(Path(im_dir) / f"{new_name}.jpg", patch, device)
        if len(label) == 0:
            continue
        label = label.copy()
        label[:, 1::2] -= x_start
        label[:, 2::2] -= y_start
        label[:, 1::2] /= pw
        label[:, 2::2] /= ph
        with open(Path(lb_dir) / f"{new_name}.txt", "w") as f:
            for lb in label:
                f.write(f"{int(lb[0])} " + " ".join(f"{c:.6g}" for c in lb[1:]) + "\n")


def split_images_and_labels(data_root: str, save_dir: str, split: str = "train", crop_sizes: Sequence[int] = (1024,),
                            gaps: Sequence[int] = (200,), device="cuda") -> None:
    """Every image of ``split`` cut into its windows, with their labels, under ``save_dir``."""
    save = Path(save_dir)
    im_dir, lb_dir = save / "images" / split, save / "labels" / split
    im_dir.mkdir(parents=True, exist_ok=True)
    lb_dir.mkdir(parents=True, exist_ok=True)
    for anno in load_yolo_dota(data_root, split):
        windows = get_windows(anno["ori_size"], crop_sizes, gaps)
        crop_and_save(anno, windows, get_window_obj(anno, windows), str(im_dir), str(lb_dir), device)


def split_trainval(data_root: str, save_dir: str, crop_size: int = 1024, gap: int = 200,
                   rates: Sequence[float] = (1.0,), device="cuda") -> None:
    """Split DOTA's train and val at each scale rate (crop and gap over the rate)."""
    crop_sizes = [int(crop_size / r) for r in rates]
    gaps = [int(gap / r) for r in rates]
    for split in ("train", "val"):
        split_images_and_labels(data_root, save_dir, split, crop_sizes, gaps, device)


def split_test(data_root: str, save_dir: str, crop_size: int = 1024, gap: int = 200,
               rates: Sequence[float] = (1.0,), device="cuda") -> None:
    """Split DOTA's unlabelled test images into ``save_dir/images/test``."""
    crop_sizes = [int(crop_size / r) for r in rates]
    gaps = [int(gap / r) for r in rates]
    out = Path(save_dir) / "images" / "test"
    out.mkdir(parents=True, exist_ok=True)
    im_dir = Path(data_root) / "images" / "test"
    assert im_dir.exists(), f"missing {im_dir}"
    for im_file in _images(im_dir):
        im = image_io.imread(im_file, device)
        for window in get_windows(im.shape[:2], crop_sizes, gaps).tolist():
            x_start, y_start, x_stop, y_stop = window
            image_io.imwrite(out / f"{_window_name(im_file.stem, window)}.jpg",
                             np.ascontiguousarray(im[y_start:y_stop, x_start:x_stop]), device)
