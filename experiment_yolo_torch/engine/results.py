"""Detection results in original-image space (port of the detect fields of
``experiment_yolo_tpu/engine/results.py``: ``Boxes`` and ``Results``)."""

from __future__ import annotations

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


class Results:
    """One image's detections and metadata."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str], boxes: np.ndarray,
                 speed: Optional[dict] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape)
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes)
