"""Two-stage "double inference": a crop-and-refine second pass.

Port of ``experiment_yolo_tpu/engine/double_inference.py``: the first pass's
detections above a confidence gate are inferred again on padded crops, the
refined boxes are mapped back and accepted only where they beat the original
under a combined score, then a per-class NMS cleans up.

All crops of an image are letterboxed on the host and go to the device as
one fixed batch of ``max_crops`` (zero-padded) through
``DetectionPredictor.infer`` (the model's own device and dtype) with hard
NMS (kernel K2 on the card); the accept gate and the final NMS are small
numpy work on the host over at most 32 boxes a crop.

The constants are the reference's: conf gate 0.25, 20% crop padding with a
32 px minimum, letterbox to 640, accept a refined box of the same class with
IoU >= 0.25 and a higher conf, the best by 0.6 * conf + 0.4 * IoU, then a
per-class NMS at IoU 0.45.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from experiment_yolo_torch.data.augment import letterbox
from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.engine.results import Results
from experiment_yolo_torch.utils.metrics import box_iou_np


@dataclass
class DoubleInferenceConfig:
    conf_threshold: float = 0.25  # first-pass gate
    pad_ratio: float = 0.2  # crop padding fraction
    min_pad: int = 32  # minimum padding in px
    crop_size: int = 640  # second-pass input size
    accept_iou: float = 0.25  # a refined box must overlap the original
    score_w_conf: float = 0.6  # combined score weights
    score_w_iou: float = 0.4
    final_nms_iou: float = 0.45
    max_crops: int = 16  # the second pass's fixed batch per image


def calculate_optimal_crop(box: np.ndarray, img_shape: Tuple[int, int], pad_ratio: float = 0.2,
                           min_pad: int = 32) -> Tuple[int, int, int, int]:
    """The padded crop region (x1, y1, x2, y2) of one xyxy box, clipped to the image."""
    h, w = img_shape
    x1, y1, x2, y2 = box
    bw, bh = x2 - x1, y2 - y1
    pad_x = max(bw * pad_ratio, min_pad)
    pad_y = max(bh * pad_ratio, min_pad)
    cx1 = int(max(0, np.floor(x1 - pad_x)))
    cy1 = int(max(0, np.floor(y1 - pad_y)))
    cx2 = int(min(w, np.ceil(x2 + pad_x)))
    cy2 = int(min(h, np.ceil(y2 + pad_y)))
    return cx1, cy1, cx2, cy2


def per_class_nms(boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray, iou_thres: float = 0.45) -> np.ndarray:
    """Greedy NMS within each class on the host: the kept indices, sorted."""
    keep_all = []
    for c in np.unique(classes):
        idx = np.nonzero(classes == c)[0]
        b, s = boxes[idx], scores[idx]
        order = s.argsort()[::-1]
        while order.size:
            i = order[0]
            keep_all.append(idx[i])
            if order.size == 1:
                break
            ious = box_iou_np(b[i:i + 1], b[order[1:]])[0]
            order = order[1:][ious <= iou_thres]
    return np.asarray(sorted(keep_all), int)


class DoubleInference:
    """``DoubleInference(model, cfg)(results)``: the refine pass over a list of
    first-pass :class:`Results`, on the device where ``model`` lives."""

    def __init__(self, model, cfg: Optional[DoubleInferenceConfig] = None):
        self.model = model
        self.cfg = cfg or DoubleInferenceConfig()
        # the second pass: hard NMS at conf 0.05, IoU 0.7, 32 boxes a crop
        self.second = DetectionPredictor(model, {"conf": 0.05, "iou": 0.7, "max_det": 32, "nms_type": "hard",
                                                 "imgsz": self.cfg.crop_size})

    def refine(self, result: Results) -> Results:
        """The second pass for one image's :class:`Results`."""
        cfg = self.cfg
        img = result.orig_img
        h, w = img.shape[:2]
        data = result.boxes.data.copy()
        if len(data) == 0:
            return result
        idxs = np.nonzero(data[:, 4] >= cfg.conf_threshold)[0][:cfg.max_crops]
        if idxs.size == 0:
            return result

        crops, metas = [], []
        for i in idxs:
            cx1, cy1, cx2, cy2 = calculate_optimal_crop(data[i, :4], (h, w), cfg.pad_ratio, cfg.min_pad)
            lb, gain, (padw, padh) = letterbox(img[cy1:cy2, cx1:cx2], (cfg.crop_size, cfg.crop_size))
            crops.append(lb[..., ::-1])  # BGR -> RGB
            metas.append((cx1, cy1, gain, padw, padh))
        batch = np.zeros((cfg.max_crops, cfg.crop_size, cfg.crop_size, 3), np.uint8)
        batch[:len(crops)] = np.stack(crops)
        det, counts = self.second.infer(torch.from_numpy(batch).to(self.model.device))
        det, counts = det.cpu().numpy(), counts.cpu().numpy()

        refined = data.copy()
        for k, i in enumerate(idxs):
            n = int(counts[k])
            if n == 0:
                continue
            cx1, cy1, gain, padw, padh = metas[k]
            cand = det[k, :n].copy()
            cand[:, [0, 2]] = (cand[:, [0, 2]] - padw) / gain + cx1  # crop letterbox -> original pixels
            cand[:, [1, 3]] = (cand[:, [1, 3]] - padh) / gain + cy1
            ious = box_iou_np(cand[:, :4], data[i, :4][None])[:, 0]
            ok = (cand[:, 5] == data[i, 5]) & (ious >= cfg.accept_iou) & (cand[:, 4] > data[i, 4])
            if not ok.any():
                continue
            combined = np.where(ok, cfg.score_w_conf * cand[:, 4] + cfg.score_w_iou * ious, -1.0)
            refined[i, :5] = cand[int(combined.argmax()), :5]

        refined = refined[per_class_nms(refined[:, :4], refined[:, 4], refined[:, 5], cfg.final_nms_iou)]
        refined[:, [0, 2]] = refined[:, [0, 2]].clip(0, w)
        refined[:, [1, 3]] = refined[:, [1, 3]].clip(0, h)
        return Results(result.orig_img, result.path, result.names, refined, speed=result.speed, device=result.device)

    def __call__(self, results: List[Results]) -> List[Results]:
        return [self.refine(r) for r in results]
