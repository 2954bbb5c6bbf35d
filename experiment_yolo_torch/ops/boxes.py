"""Box geometry on tensors (port of ``experiment_yolo_tpu/ops/boxes.py``)."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], -1)


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M).

    Same expression as the JAX package, ``inter / (area1 + area2 - inter + eps)``,
    so that equal inputs give bitwise-equal IoUs (NMS ties break alike).
    """
    a1, a2 = box1[..., :, None, :2], box1[..., :, None, 2:4]
    b1, b2 = box2[..., None, :, :2], box2[..., None, :, 2:4]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (a2 - a1).clamp(min=0).prod(-1)
    area2 = (b2 - b1).clamp(min=0).prod(-1)
    return inter / (area1 + area2 - inter + eps)
