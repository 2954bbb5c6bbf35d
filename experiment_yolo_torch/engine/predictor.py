"""Detection predictor: uint8 BGR images -> letterbox -> model -> NMS -> Results.

Port of ``experiment_yolo_tpu/engine/predictor.py:DetectionPredictor`` for
in-memory images. Letterbox runs on the host; the batch goes to the device as
uint8 and is normalised there; forward, decode and NMS run on the device;
boxes are mapped back to each original image with its (gain, pad). The batch
shape is fixed: a short last batch is padded with black images.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from experiment_yolo_torch.cfg import check_imgsz, get_cfg
from experiment_yolo_torch.data.augment import letterbox
from experiment_yolo_torch.engine.results import Results
from experiment_yolo_torch.ops.nms import non_max_suppression


class DetectionPredictor:
    """``DetectionPredictor(model, overrides)(images)`` -> list of :class:`Results`.

    It runs where ``model`` lives (the card unless the model was built with
    ``device='cpu'``) and never moves the model.
    """

    def __init__(self, model, overrides: Optional[Dict] = None):
        self.args = get_cfg(overrides)
        if self.args.conf is None:
            self.args.conf = 0.25
        self.device = model.device
        self.model = model
        self.imgsz = check_imgsz(int(self.args.imgsz), max(model.stride))
        self.batch = max(int(self.args.batch), 1)

    def _nms(self, boxes: torch.Tensor, scores: torch.Tensor):
        return non_max_suppression(
            boxes, scores,
            conf_thres=float(self.args.conf),
            iou_thres=float(self.args.iou),
            max_det=int(self.args.max_det),
            agnostic=bool(self.args.agnostic_nms),
            nms_type=str(self.args.nms_type or "soft"),
            soft_first_quirk=bool(self.args.soft_nms_quirk),
        )

    @torch.no_grad()
    def infer(self, imgs: torch.Tensor):
        """(B, H, W, 3) uint8 RGB on the device -> (detections (B, max_det, 6), counts (B,))."""
        x = (imgs.permute(0, 3, 1, 2).float() / 255.0).contiguous()
        return self._nms(*self.model.predict(x))

    def __call__(self, source: Union[np.ndarray, Sequence[np.ndarray]]) -> List[Results]:
        images = [source] if isinstance(source, np.ndarray) else list(source)
        results: List[Results] = []
        for start in range(0, len(images), self.batch):
            chunk = images[start:start + self.batch]
            t0 = time.perf_counter()
            pre = [letterbox(img, (self.imgsz, self.imgsz)) for img in chunk]
            batch = np.zeros((self.batch, self.imgsz, self.imgsz, 3), np.uint8)
            for i, (img, _, _) in enumerate(pre):
                batch[i] = img[..., ::-1]  # BGR -> RGB
            t1 = time.perf_counter()
            det, counts = self.infer(torch.from_numpy(batch).to(self.device))
            det, counts = det.cpu().numpy(), counts.cpu().numpy()
            t2 = time.perf_counter()
            speed = {"preprocess": (t1 - t0) * 1000 / len(chunk), "inference": (t2 - t1) * 1000 / len(chunk)}
            for i, (orig, (_, gain, (padw, padh))) in enumerate(zip(chunk, pre)):
                d = det[i, :int(counts[i])].copy()
                oh, ow = orig.shape[:2]
                d[:, [0, 2]] = ((d[:, [0, 2]] - padw) / gain).clip(0, ow)
                d[:, [1, 3]] = ((d[:, [1, 3]] - padh) / gain).clip(0, oh)
                if self.args.classes is not None:
                    d = d[np.isin(d[:, 5].astype(int), np.atleast_1d(self.args.classes))]
                results.append(Results(orig, f"image{start + i}", self.model.names, d, speed=speed))
        return results
