"""Detection, segmentation, pose and oriented-box results in original-image
space (port of the detect, segment, pose and obb fields of
``experiment_yolo_tpu/engine/results.py``: ``Boxes``, ``Masks``,
``Keypoints``, ``OBB`` and ``Results`` with ``save_txt``, ``to_dict``,
``tojson``, ``verbose`` and ``save_crop``; as in JAX, ``to_dict`` and
``tojson`` give the boxes alone, and the server adds the keypoints). An OBB
result has no ``boxes``: as in JAX its ``verbose`` reads "(no detections)",
and ``save_txt``, ``to_dict``, ``tojson`` and ``save_crop`` raise as JAX's
do. ``plot`` and ``save`` draw with OpenCV in the JAX package and wait for
ROADMAP.md catalogue item 15; the probability holder waits for catalogue
item 13."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class Boxes:
    """Boxes of one image. data: (N, 6) [x1, y1, x2, y2, conf, cls]."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, np.float32).reshape(-1, 6)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xyxy(self) -> np.ndarray:
        return self.data[:, :4]

    @property
    def conf(self) -> np.ndarray:
        return self.data[:, 4]

    @property
    def cls(self) -> np.ndarray:
        return self.data[:, 5]

    @property
    def xywh(self) -> np.ndarray:
        b = self.data[:, :4]
        return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2, b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)

    @property
    def xyxyn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.xyxy / np.asarray([w, h, w, h])

    @property
    def xywhn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.xywh / np.asarray([w, h, w, h])


class Masks:
    """Instance masks of one image, in original-image space. data: (N, H, W) bool."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, bool)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)


class Keypoints:
    """Keypoints of one image, in original-image space. data: (N, nk, 2|3) [x, y(, conf)]."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, np.float32)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xy(self) -> np.ndarray:
        return self.data[..., :2]

    @property
    def conf(self) -> Optional[np.ndarray]:
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


class OBB:
    """Oriented boxes in original-image space. data: (N, 7) [cx, cy, w, h, rad, conf, cls]."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = np.asarray(data, np.float32).reshape(-1, 7)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xywhr(self) -> np.ndarray:
        return self.data[:, :5]

    @property
    def conf(self) -> np.ndarray:
        return self.data[:, 5]

    @property
    def cls(self) -> np.ndarray:
        return self.data[:, 6]

    @property
    def xyxyxyxy(self) -> np.ndarray:
        """(N, 4, 2) corners, in the JAX holder's numpy order of operations."""
        cx, cy, w, h, r = (self.data[:, i] for i in range(5))
        cos, sin = np.cos(r), np.sin(r)
        dx1, dy1 = w / 2 * cos, w / 2 * sin
        dx2, dy2 = -h / 2 * sin, h / 2 * cos
        c = np.stack([cx, cy], -1)
        return np.stack([c + np.stack([dx1 + dx2, dy1 + dy2], -1), c + np.stack([dx1 - dx2, dy1 - dy2], -1),
                         c - np.stack([dx1 + dx2, dy1 + dy2], -1), c - np.stack([dx1 - dx2, dy1 - dy2], -1)], 1)


class Results:
    """One image's detections (and, from a segmentation model, their
    ``masks``, from a pose model their ``keypoints``; an OBB model's ``obb``
    in place of ``boxes``) and metadata. ``device`` is where its crops are
    encoded as JPEG (nvJPEG on the card, libjpeg on the CPU)."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str], boxes: Optional[np.ndarray],
                 speed: Optional[dict] = None, device="cuda", masks: Optional[np.ndarray] = None,
                 keypoints: Optional[np.ndarray] = None, obb: Optional[np.ndarray] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.obb = OBB(obb, self.orig_shape) if obb is not None else None
        self.speed = speed or {}
        self.device = device

    def __len__(self):
        if self.boxes is not None:
            return len(self.boxes)
        return len(self.obb) if self.obb is not None else 0

    def plot(self, *args, **kwargs):
        raise NotImplementedError("Results.plot draws with OpenCV in the JAX package and is not ported to "
                                  "experiment_yolo_torch yet (ROADMAP.md catalogue item 15)")

    def save(self, *args, **kwargs):
        raise NotImplementedError("Results.save writes plot()'s drawing and is not ported to experiment_yolo_torch "
                                  "yet (ROADMAP.md catalogue item 15)")

    def save_txt(self, txt_file: str | Path, save_conf: bool = False) -> None:
        """YOLO-format txt: one ``cls cx cy w h [conf]`` line (normalised) a box."""
        lines = []
        for i in range(len(self.boxes)):
            xywhn = self.boxes.xywhn[i]
            c = int(self.boxes.cls[i])
            line = (c, *xywhn) + ((float(self.boxes.conf[i]),) if save_conf else ())
            lines.append(("%g " * len(line)).rstrip() % line)
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + "\n")

    def to_dict(self) -> list:
        """One ``{name, class, confidence, box: {x1, y1, x2, y2}}`` a detection."""
        return [{"name": self.names.get(int(cls), str(int(cls))), "class": int(cls), "confidence": float(conf),
                 "box": {"x1": float(x1), "y1": float(y1), "x2": float(x2), "y2": float(y2)}}
                for x1, y1, x2, y2, conf, cls in self.boxes.data]

    def tojson(self, normalize: bool = False) -> str:
        """:meth:`to_dict` as indented JSON; ``normalize`` divides the boxes by the image's size."""
        recs = self.to_dict()
        if normalize:
            h, w = self.orig_shape
            for r in recs:
                b = r["box"]
                b["x1"], b["x2"] = b["x1"] / w, b["x2"] / w
                b["y1"], b["y2"] = b["y1"] / h, b["y2"] / h
        return json.dumps(recs, indent=2)

    def verbose(self) -> str:
        """The per-class counts, as ``"2 cars, 1 person, "``."""
        if self.boxes is None or not len(self.boxes):
            return "(no detections), "
        cls = self.boxes.cls.astype(int)
        return "".join(f"{(cls == c).sum()} {self.names.get(int(c), int(c))}{'s' if (cls == c).sum() > 1 else ''}, "
                       for c in sorted(set(cls.tolist())))

    def save_crop(self, save_dir: str | Path, file_name: str | Path = "im.jpg") -> None:
        """One crop a detection into ``save_dir/<class name>/`` (the box times
        1.02 plus 10 px a side, as the reference's ``save_one_box``), written
        by :func:`~experiment_yolo_torch.data.image_io.imwrite`."""
        from experiment_yolo_torch.data.image_io import imwrite

        h, w = self.orig_shape
        stem, suffix = Path(file_name).stem, Path(file_name).suffix or ".jpg"
        for i in range(len(self.boxes)):
            x1, y1, x2, y2 = self.boxes.xyxy[i]
            px, py = (x2 - x1) * 0.01 + 10, (y2 - y1) * 0.01 + 10
            xa, ya = max(int(x1 - px), 0), max(int(y1 - py), 0)
            xb, yb = min(int(x2 + px), w), min(int(y2 + py), h)
            cname = str(self.names.get(int(self.boxes.cls[i]), int(self.boxes.cls[i])))
            d = Path(save_dir) / cname
            d.mkdir(parents=True, exist_ok=True)
            imwrite(d / f"{stem}{i if i else ''}{suffix}", np.ascontiguousarray(self.orig_img[ya:yb, xa:xb]),
                    self.device)
