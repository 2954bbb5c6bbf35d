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


def wasserstein_similarity(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7,
                           constant: float = 12.8) -> torch.Tensor:
    """Normalized Wasserstein Distance similarity exp(-W2 / C) of xyxy boxes
    (..., 4) -> (..., 1), the NWD term of the DEAL-YOLO box loss (JAX
    ``ops/boxes.py:228``, in its float order)."""
    b1_x1, b1_y1, b1_x2, b1_y2 = pred.chunk(4, -1)
    b2_x1, b2_y1, b2_x2, b2_y2 = target.chunk(4, -1)
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    cx1, cy1 = b1_x1 + w1 / 2, b1_y1 + h1 / 2
    cx2, cy2 = b2_x1 + w2 / 2, b2_y1 + h2 / 2
    center_d2 = (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2 + eps
    wh_d2 = ((w1 - w2) ** 2 + (h1 - h2) ** 2) / 4
    return torch.exp(-torch.sqrt(center_d2 + wh_d2) / constant)


WIOU_ALPHA = 1.7
WIOU_DELTA = 2.7
WIOU_MOMENTUM = 1e-2


def wise_iou_loss(pred: torch.Tensor, target: torch.Tensor, iou_mean: torch.Tensor, ltype: str = "WIoU",
                  monotonous: bool | None = False, inner: bool = False, focaler: bool = False,
                  eps: float = 1e-7) -> tuple[torch.Tensor, torch.Tensor]:
    """Wise-IoU v3 of xyxy boxes (..., 4) with non-monotonic focusing
    (arXiv:2301.10051; JAX ``ops/boxes.py:255`` with ``ltype='WIoU'``,
    ``monotonous=False``, in its float order) -> (loss (...,), the new
    running mean of 1 - IoU).

    The loss is ``exp(l2_center / l2_box) * (1 - IoU)`` times ``beta /
    (delta * alpha^(beta - delta))`` with ``beta = (1 - IoU) / iou_mean``;
    ``l2_box`` and ``beta`` are out of the gradient, as the JAX package's
    ``stop_gradient`` keeps them. The other ltypes, v1 and v2 focusing and
    Inner- and Focaler-IoU raise.
    """
    if ltype != "WIoU" or monotonous is not False or inner or focaler:
        raise NotImplementedError(
            f"wise_iou_loss(ltype={ltype!r}, monotonous={monotonous!r}, inner={inner}, focaler={focaler}) is not "
            "ported to experiment_yolo_torch; the port has WIoU v3 only (ROADMAP.md queue 1 item 2)")
    zero = pred.new_zeros(())
    pred_xy = (pred[..., :2] + pred[..., 2:4]) / 2
    target_xy = (target[..., :2] + target[..., 2:4]) / 2
    pred_wh = pred[..., 2:4] - pred[..., :2]
    target_wh = target[..., 2:4] - target[..., :2]
    min_coord = torch.minimum(pred, target)
    max_coord = torch.maximum(pred, target)
    # maximum(., 0), not clamp: on a tie it passes half the gradient, as JAX's clip does
    wh_inter = torch.maximum(min_coord[..., 2:4] - max_coord[..., :2], zero)
    s_inter = wh_inter[..., 0] * wh_inter[..., 1]
    s_union = pred_wh[..., 0] * pred_wh[..., 1] + target_wh[..., 0] * target_wh[..., 1] - s_inter
    wh_box = max_coord[..., 2:4] - min_coord[..., :2]
    l2_box = (wh_box ** 2).sum(-1)
    l2_center = ((pred_xy - target_xy) ** 2).sum(-1)
    iou_loss = 1.0 - s_inter / (s_union + eps)
    loss = torch.exp(l2_center / (l2_box + eps).detach()) * iou_loss
    new_mean = iou_mean * (1 - WIOU_MOMENTUM) + WIOU_MOMENTUM * iou_loss.detach().mean()
    beta = iou_loss.detach() / iou_mean
    divisor = WIOU_DELTA * torch.pow(WIOU_ALPHA, beta - WIOU_DELTA)
    return loss * beta / divisor, new_mean
