"""YOLO-format detection dataset with the v8 augmentation pipeline.

Port of ``experiment_yolo_tpu/data/dataset.py`` (``IMG_FORMATS``,
``check_det_dataset``, ``img2label_path`` and ``YOLODataset``) for the detect,
segment, pose and obb tasks: the image scan, ``fraction``, ``single_cls``, the
YOLO txt labels (detect: cls cx cy w h; segment: cls x1 y1 x2 y2 ..., a
polygon whose extent is the box; pose: cls cx cy w h then (kx ky [kv]) for
each of ``kpt_shape``'s keypoints, visibility 1 where the dims are 2; obb:
cls x1 y1 ... x4 y4, four corners whose extent is the box; normalised), the ``.cache.npy`` label cache with the JAX package's
hash key and format (so either package reads the other's), the image caches
(``cache='ram'`` and ``'disk'``, whose ``.npy`` sidecars the JAX package
writes too), and the samples: augmented for training (:meth:`get_sample`,
whose draws from the generator are the JAX method's, call for call) and
letterboxed for validation (:meth:`get_val_sample`).

Images are read by ``data/image_io.py`` (JPEG, PNG, 24-bit BMP, or a ``.npy``
sidecar), JPEGs with nvJPEG when the dataset's ``device`` is the card and with
libjpeg when it is the CPU; unreadable images and images under 10 px are
dropped with the JAX package's messages.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from experiment_yolo_torch.cfg import yaml_load
from experiment_yolo_torch.data import augment as A
from experiment_yolo_torch.data import image_io
from experiment_yolo_torch.utils import LOGGER

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}
CACHE_VERSION = 1


def check_det_dataset(data) -> dict:
    """Resolve a dataset yaml (or dict) into {path, train, val, test, names,
    nc}, and a pose dataset's ``kpt_shape`` and ``flip_idx`` where given."""
    d = dict(data) if isinstance(data, dict) else {**yaml_load(data), "yaml_file": str(data)}
    root = Path(d.get("path") or Path(str(d.get("yaml_file", "."))).parent)
    out = {"path": root}
    for split in ("train", "val", "test"):
        v = d.get(split)
        if v:
            p = Path(v)
            out[split] = p if p.is_absolute() else root / p
    names = d.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    out["names"] = names or {}
    out["nc"] = d.get("nc", len(out["names"]))
    for k in ("kpt_shape", "flip_idx"):
        if k in d:
            out[k] = d[k]
    return out


def img2label_path(img_path: str) -> str:
    """images/xxx.bmp -> labels/xxx.txt."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(str(img_path).rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


def _verify(f: str) -> Optional[str]:
    """What is wrong with an image file, from its header and, for JPEG and
    PNG, its end; None if nothing (the JAX package's messages). A truncated
    JPEG, which the JAX package keeps and OpenCV fills with grey, is dropped:
    the port's decoders refuse it. A format the port cannot decode yet (webp,
    tiff without a sidecar) raises instead of being dropped."""
    try:
        h, w = image_io.image_shape(f, whole=True)
    except (OSError, ValueError) as e:
        return f"corrupt image: {e}"
    return f"image too small {w}x{h}" if w < 10 or h < 10 else None


class YOLODataset:
    """Detection dataset: file scan + label parse + v8 transforms. A pose
    dataset's keypoints are (nk, 3) an instance (``kpt_shape``); ``flip_idx``
    swaps them on a horizontal flip (none: no swap)."""

    def __init__(self, img_path: str | Path, imgsz: int = 640, augment: bool = True, hyp=None, max_labels: int = 128,
                 fraction: float = 1.0, single_cls: bool = False, task: str = "detect", cache: str | bool = False,
                 device="cuda", kpt_shape=(17, 3), flip_idx=None):
        if task not in ("detect", "segment", "pose", "obb"):
            raise NotImplementedError(f"task={task!r} datasets are not ported to experiment_yolo_torch yet "
                                      "(ROADMAP.md catalogue item 13)")
        self.img_path = Path(img_path)
        self.imgsz = imgsz
        self.augment = augment
        self.hyp = hyp
        self.max_labels = max_labels
        self.single_cls = single_cls
        self.task = task
        self.kpt_shape = tuple(kpt_shape)  # part of the cache key for every task, as in JAX
        self.flip_idx = flip_idx
        self.device = device  # where JPEGs are decoded: nvJPEG on the card, libjpeg on the CPU
        self.im_files = self._scan_images(fraction)
        self.labels = self._load_labels_cached()
        self.mosaic_enabled = bool(augment and hyp is not None and getattr(hyp, "mosaic", 0) > 0)
        self.cache = {True: "ram", "True": "ram"}.get(cache, cache) or ""
        self._ims: List[Optional[np.ndarray]] = [None] * len(self.im_files)

    # -- label cache ---------------------------------------------------------
    def _cache_key(self) -> str:
        """Fingerprint of the dataset: file list, label sizes and mtimes, the
        JAX package's key exactly."""
        h = hashlib.sha1()
        for f in self.im_files:
            h.update(f.encode())
            try:
                st = os.stat(img2label_path(f))
                h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
            except OSError:
                h.update(b"-")
        h.update(f"{self.task}:{self.kpt_shape}:{self.single_cls}".encode())
        return h.hexdigest()

    def _load_labels_cached(self) -> List[Dict]:
        """Parse the labels once, check the images' headers in a thread pool
        (dropping corrupt and tiny ones), and keep both in a
        ``labels/<split>.cache.npy`` beside the label folder."""
        lbl_dir = Path(img2label_path(self.im_files[0])).parent
        cache_file = lbl_dir.parent / f"{lbl_dir.name}.cache.npy"
        key = self._cache_key()
        try:
            blob = np.load(cache_file, allow_pickle=True).item()
            if blob.get("hash") == key and blob.get("version") == CACHE_VERSION:
                self.im_files = list(blob["im_files"])
                return list(blob["labels"])
        except (OSError, ValueError, EOFError, KeyError, AttributeError):
            pass
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            problems = list(ex.map(_verify, self.im_files))
        bad = [(f, msg) for f, msg in zip(self.im_files, problems) if msg]
        for f, msg in bad[:5]:
            LOGGER.warning(f"ignoring {f}: {msg}")
        if bad:
            LOGGER.warning(f"{len(bad)} corrupt image(s) dropped")
            self.im_files = [f for f, msg in zip(self.im_files, problems) if not msg]
            if not self.im_files:
                raise FileNotFoundError(f"all images in {self.img_path} are corrupt")
            key = self._cache_key()
        labels = [self._load_label(f) for f in self.im_files]
        try:
            np.save(cache_file, {"hash": key, "version": CACHE_VERSION, "im_files": self.im_files, "labels": labels})
        except OSError as e:
            LOGGER.warning(f"label cache not writable ({e}); continuing uncached")
        return labels

    def _scan_images(self, fraction: float) -> List[str]:
        p = self.img_path
        if p.is_dir():
            files = sorted(str(f) for f in p.rglob("*") if f.suffix.lstrip(".").lower() in IMG_FORMATS)
        elif p.is_file():  # a txt file listing image paths
            files = [ln.strip() for ln in p.read_text().splitlines() if ln.strip()]
        else:
            raise FileNotFoundError(f"image path {p} does not exist")
        if not files:
            raise FileNotFoundError(f"no images found in {p}")
        if fraction < 1.0:
            files = files[: max(1, int(len(files) * fraction))]
        return files

    def _load_label(self, img_file: str) -> Dict:
        """Parse one YOLO txt label file, normalised: ``cls cx cy w h`` per
        line, for the segment task ``cls x1 y1 x2 y2 ...``, whose box is the
        polygon's extent, for the pose task ``cls cx cy w h`` and the
        keypoints, for the obb task ``cls x1 y1 ... x4 y4``, whose box is the
        corners' extent (a line of another length gives a box of its first
        four numbers and no corners, as in JAX)."""
        lp = img2label_path(img_file)
        cls, boxes, segments, keypoints, corners = [], [], [], [], []
        nk, ndim = self.kpt_shape
        if os.path.isfile(lp):
            for ln in Path(lp).read_text().splitlines():
                parts = ln.split()
                if len(parts) < 5:
                    continue
                vals = np.asarray([float(x) for x in parts[1:]], np.float32)
                if self.task == "segment":
                    pts = vals.reshape(-1, 2)
                    segments.append(pts)
                    lo, hi = pts.min(0), pts.max(0)
                    boxes.append([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[0] - lo[0], hi[1] - lo[1]])
                elif self.task == "obb" and len(vals) == 8:
                    pts = vals.reshape(4, 2)
                    corners.append(pts)
                    lo, hi = pts.min(0), pts.max(0)
                    boxes.append([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[0] - lo[0], hi[1] - lo[1]])
                elif self.task == "pose":
                    boxes.append(vals[:4].tolist())
                    kp = vals[4:4 + nk * ndim].reshape(nk, ndim)
                    if ndim == 2:  # full visibility
                        kp = np.concatenate([kp, np.ones((nk, 1), np.float32)], -1)
                    keypoints.append(kp)
                else:
                    boxes.append(vals[:4].tolist())
                cls.append(0.0 if self.single_cls else float(parts[0]))
        out = {"cls": np.asarray(cls, np.float32), "bboxes_n": np.asarray(boxes, np.float32).reshape(-1, 4)}
        if self.task == "segment":
            out["segments_n"] = segments
        elif self.task == "pose":
            out["keypoints_n"] = np.stack(keypoints) if keypoints else np.zeros((0, nk, 3), np.float32)
        elif self.task == "obb":
            out["obb_n"] = np.stack(corners) if corners else np.zeros((0, 4, 2), np.float32)
        return out

    def __len__(self) -> int:
        return len(self.im_files)

    def _load_item(self, i: int) -> Dict:
        """Image and labels in pixel xyxy. With ``cache='ram'`` decoded images
        stay in memory; with ``'disk'`` they are kept as ``.npy`` sidecars."""
        img = None
        cached = False
        if self.cache == "ram" and self._ims[i] is not None:
            img, cached = self._ims[i], True
        elif self.cache == "disk":
            npy = image_io.sidecar(self.im_files[i])
            if npy.exists():
                try:
                    img, cached = np.load(npy), True
                except (OSError, ValueError):
                    img = None
        if img is None:
            img = image_io.imread(self.im_files[i], self.device)
        if not cached:
            if self.cache == "ram":
                self._ims[i] = img
            elif self.cache == "disk":
                try:
                    np.save(image_io.sidecar(self.im_files[i]), np.ascontiguousarray(img))
                except OSError:
                    pass
        h, w = img.shape[:2]
        lab = self.labels[i]
        if len(lab["cls"]):
            b = lab["bboxes_n"]
            xyxy = np.stack([(b[:, 0] - b[:, 2] / 2) * w, (b[:, 1] - b[:, 3] / 2) * h,
                             (b[:, 0] + b[:, 2] / 2) * w, (b[:, 1] + b[:, 3] / 2) * h], axis=1).astype(np.float32)
        else:
            xyxy = np.zeros((0, 4), np.float32)
        out = {"img": img, "bboxes": xyxy, "cls": lab["cls"].copy(), "im_file": self.im_files[i], "ori_shape": (h, w)}
        if self.task == "segment":
            out["segments"] = [p * np.asarray([w, h], np.float32) for p in lab["segments_n"]]
        elif self.task == "pose":
            kp = lab["keypoints_n"].copy()
            kp[..., :2] *= np.asarray([w, h], np.float32)
            out["keypoints"] = kp
        elif self.task == "obb":
            out["obb"] = lab["obb_n"] * np.asarray([w, h], np.float32)
        return out

    def _perspective(self, lab: Dict, rng: np.random.Generator) -> Dict:
        hyp = self.hyp
        return A.random_perspective(lab, degrees=getattr(hyp, "degrees", 0.0), translate=getattr(hyp, "translate", 0.1),
                                    scale=getattr(hyp, "scale", 0.5), shear=getattr(hyp, "shear", 0.0),
                                    perspective=getattr(hyp, "perspective", 0.0), rng=rng)

    def get_sample(self, i: int, rng: np.random.Generator, mosaic: Optional[bool] = None) -> Dict[str, np.ndarray]:
        """One augmented, formatted sample (static shapes). The draws from
        ``rng`` are the JAX method's: the mosaic probability, mosaic9's, the
        tile indices, the mosaic centre, the warp's eight, mixup's (its own
        mosaic and warp, then the blend), HSV's three and the two flips'."""
        hyp = self.hyp
        use_mosaic = self.mosaic_enabled if mosaic is None else mosaic
        if use_mosaic and rng.random() < getattr(hyp, "mosaic", 1.0):
            if rng.random() < getattr(hyp, "mosaic9", 0.0):  # the 3x3 grid with probability mosaic9
                idxs = [i] + list(rng.integers(0, len(self), 8))
                lab = A.mosaic9([self._load_item(j) for j in idxs], self.imgsz, rng)
            else:
                idxs = [i] + list(rng.integers(0, len(self), 3))
                lab = A.mosaic4([self._load_item(j) for j in idxs], self.imgsz, rng)
            lab = A.copy_paste(lab, getattr(hyp, "copy_paste", 0.0), rng)
            lab = self._perspective(lab, rng)
            if getattr(hyp, "mixup", 0.0) > 0 and rng.random() < hyp.mixup:
                j = int(rng.integers(0, len(self)))
                lab2 = A.mosaic4([self._load_item(j)] + [self._load_item(int(k)) for k in rng.integers(0, len(self), 3)],
                                 self.imgsz, rng)
                lab2 = A.random_perspective(lab2, translate=getattr(hyp, "translate", 0.1),
                                            scale=getattr(hyp, "scale", 0.5), rng=rng)
                lab = A.mixup(lab, lab2, rng)
        else:
            lab = A.letterbox_labels(self._load_item(i), self.imgsz, scaleup=self.augment)
            if self.augment:
                lab = self._perspective(lab, rng)
        if self.augment:
            lab["img"] = A.random_hsv(lab["img"], getattr(hyp, "hsv_h", 0.015), getattr(hyp, "hsv_s", 0.7),
                                      getattr(hyp, "hsv_v", 0.4), rng)
            lab = A.random_flip(lab, "vertical", getattr(hyp, "flipud", 0.0), rng)
            lab = A.random_flip(lab, "horizontal", getattr(hyp, "fliplr", 0.5), rng, flip_idx=self.flip_idx)
        return A.format_sample(lab, self.imgsz, self.max_labels, task=self.task, kpt_shape=self.kpt_shape)

    def get_val_sample(self, i: int, shape=None) -> Dict[str, np.ndarray]:
        """Letterboxed sample with ``ori_shape`` (h, w) and ``ratio_pad``
        (gain, padw, padh); ``shape`` (h, w) overrides the square imgsz (rect
        batches)."""
        item = self._load_item(i)
        lab = A.letterbox_labels(item, shape or self.imgsz, scaleup=True)
        out = A.format_sample(lab, self.imgsz, self.max_labels, task=self.task, kpt_shape=self.kpt_shape)
        out["ori_shape"] = np.asarray(item["ori_shape"], np.int32)
        out["ratio_pad"] = np.asarray([lab["ratio_pad"][0], *lab["ratio_pad"][1]], np.float32)
        return out

    def image_shapes(self) -> np.ndarray:
        """(N, 2) original (h, w) per image, from the headers."""
        if not hasattr(self, "_shapes"):
            self._shapes = np.asarray([image_io.image_shape(f) for f in self.im_files], np.int32)
        return self._shapes
