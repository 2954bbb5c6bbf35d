"""Box geometry on tensors (port of ``experiment_yolo_tpu/ops/boxes.py``)."""

from __future__ import annotations

import math

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


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7, **variants) -> torch.Tensor:
    """Elementwise Complete-IoU of broadcastable (..., 4) xyxy boxes ->
    (..., 1), in the JAX package's float order (``ops/boxes.py:100`` with
    ``xywh=False, CIoU=True``, as TAL and the box loss call it).

    CIoU = IoU - (rho^2 / c^2 + v * alpha), with ``alpha`` out of the
    gradient, as the JAX package's ``stop_gradient`` and the reference's
    ``torch.no_grad`` keep it. Any other variant of the JAX IoU zoo raises.
    """
    if any(variants.values()):
        raise NotImplementedError(f"bbox_iou variants {sorted(k for k, v in variants.items() if v)} are not ported "
                                  "to experiment_yolo_torch (ROADMAP.md queue 1 item 2); only CIoU is")
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.chunk(4, -1)
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.chunk(4, -1)
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    # maximum(., 0), not clamp: on a tie (boxes that touch) it passes half the
    # gradient, as JAX's clip does, where clamp passes all of it
    zero = box1.new_zeros(())
    inter = torch.maximum(torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1), zero) * \
        torch.maximum(torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1), zero)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)  # convex width
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)  # convex height
    c2 = cw ** 2 + ch ** 2 + eps  # convex diagonal squared
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)
