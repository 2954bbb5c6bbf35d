"""Box geometry on tensors (port of ``experiment_yolo_tpu/ops/boxes.py``)."""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], -1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    p1, p2 = x[..., :2], x[..., 2:4]
    return torch.cat([(p1 + p2) * 0.5, p2 - p1], -1)


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


def _clip(x: torch.Tensor, lo: float | None = None, hi: float | None = None) -> torch.Tensor:
    """``jnp.clip``: ``maximum``/``minimum`` against 0-d tensors, which on a tie
    pass half the gradient, as JAX's clip does, where ``clamp`` passes all of it."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def abs_select(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` as ``jnp.abs`` differentiates it: the gradient at 0 is +1 (JAX
    selects on ``x >= 0``), where ``Tensor.abs`` passes 0."""
    return torch.where(x >= 0, x, -x)


def get_inner_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, ratio: float = 0.7,
                  eps: float = 1e-7) -> torch.Tensor:
    """Inner-IoU: the IoU of boxes shrunk about their centres by ``ratio``
    (arXiv:2311.02877; JAX ``ops/boxes.py:84``). Returns (..., 1)."""
    if not xywh:
        box1, box2 = xyxy2xywh(box1), xyxy2xywh(box2)
    x1, y1, w1, h1 = box1.chunk(4, -1)
    x2, y2, w2, h2 = box2.chunk(4, -1)
    b1_x1, b1_x2, b1_y1, b1_y2 = x1 - w1 * ratio / 2, x1 + w1 * ratio / 2, y1 - h1 * ratio / 2, y1 + h1 * ratio / 2
    b2_x1, b2_x2, b2_y1, b2_y2 = x2 - w2 * ratio / 2, x2 + w2 * ratio / 2, y2 - h2 * ratio / 2, y2 + h2 * ratio / 2
    inter = _clip(torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1), 0) * \
        _clip(torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1), 0)
    union = w1 * h1 * ratio * ratio + w2 * h2 * ratio * ratio - inter + eps
    return inter / union


IOU_TYPES = ("IoU", "GIoU", "DIoU", "CIoU", "EIoU", "SIoU", "ShapeIoU", "PIoU", "PIoU2", "MPDIoU")


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False, DIoU: bool = False,
             CIoU: bool = False, EIoU: bool = False, SIoU: bool = False, ShapeIoU: bool = False, PIoU: bool = False,
             PIoU2: bool = False, MPDIoU: bool = False, inner: bool = False, focaler: bool = False,
             ratio: float = 0.7, d: float = 0.0, u: float = 0.95, scale: float = 0.0, Lambda: float = 1.3,
             mpdiou_hw=None, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of broadcastable (..., 4) boxes with the reference's
    variant zoo -> (..., 1), in the JAX package's float order
    (``ops/boxes.py:100``): G/D/C/E/S/Shape/P/P2/MPD IoU, each composable with
    Inner-IoU (``inner``: the base term from boxes shrunk by ``ratio``) and
    Focaler-IoU (``focaler``: the base term remapped from [d, u] to [0, 1]).

    As in JAX: ``inner`` replaces the base IoU while CIoU's ``alpha`` still
    sees the plain one; ``focaler`` remaps before the penalties, so ``alpha``
    sees the remapped one; ``alpha`` is out of the gradient; the xyxy path
    adds ``eps`` to the heights only; MPDIoU divides the corner distances by
    ``mpdiou_hw`` (the image diagonal squared, 1 when None).
    """
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, -1)
        x2, y2, w2, h2 = box2.chunk(4, -1)
        b1_x1, b1_x2, b1_y1, b1_y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2, b2_y1, b2_y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.chunk(4, -1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.chunk(4, -1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = _clip(torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1), 0) * \
        _clip(torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1), 0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    iou_for_alpha = iou  # Inner-IoU's CIoU alpha keeps the plain IoU
    if inner:
        iou = get_inner_iou(box1, box2, xywh=xywh, ratio=ratio, eps=eps)
    elif focaler:  # the remap comes before the penalties, so alpha sees it too
        iou = _clip((iou - d) / (u - d), 0.0, 1.0)
        iou_for_alpha = iou

    if MPDIoU:
        hw = mpdiou_hw if mpdiou_hw is not None else 1.0
        d1 = (b2_x1 - b1_x1) ** 2 + (b2_y1 - b1_y1) ** 2
        d2 = (b2_x2 - b1_x2) ** 2 + (b2_y2 - b1_y2) ** 2
        return iou - d1 / hw - d2 / hw
    if not (GIoU or DIoU or CIoU or EIoU or SIoU or ShapeIoU or PIoU or PIoU2):
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)  # convex width
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)  # convex height
    if GIoU:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + eps  # convex diagonal squared
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    if DIoU:
        return iou - rho2 / c2
    if CIoU:
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou_for_alpha + (1 + eps))
        return iou - (rho2 / c2 + v * alpha)
    if EIoU:
        rho_w2 = (w2 - w1) ** 2
        rho_h2 = (h2 - h1) ** 2
        return iou - (rho2 / c2 + rho_w2 / (cw ** 2 + eps) + rho_h2 / (ch ** 2 + eps))
    if SIoU:  # SCYLLA-IoU (arXiv:2205.12740)
        s_cw = (b2_x1 + b2_x2 - b1_x1 - b1_x2) * 0.5 + eps
        s_ch = (b2_y1 + b2_y2 - b1_y1 - b1_y2) * 0.5 + eps
        sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2) + eps
        sin_a, sin_b = abs_select(s_cw) / sigma, abs_select(s_ch) / sigma
        sin_best = torch.where(sin_a > math.sqrt(2) / 2, sin_b, sin_a)
        angle_cost = torch.cos(torch.asin(_clip(sin_best, -1 + eps, 1 - eps)) * 2 - math.pi / 2)
        rho_x = (s_cw / (cw + eps)) ** 2
        rho_y = (s_ch / (ch + eps)) ** 2
        gamma = angle_cost - 2
        distance_cost = 2 - torch.exp(gamma * rho_x) - torch.exp(gamma * rho_y)
        omiga_w = abs_select(w1 - w2) / torch.maximum(w1, w2)
        omiga_h = abs_select(h1 - h2) / torch.maximum(h1, h2)
        shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
        return iou - 0.5 * (distance_cost + shape_cost)
    if ShapeIoU:  # Shape-IoU (arXiv:2312.17663)
        ww = 2 * w2 ** scale / (w2 ** scale + h2 ** scale)
        hh = 2 * h2 ** scale / (w2 ** scale + h2 ** scale)
        cdx = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2) / 4
        cdy = ((b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
        distance = (hh * cdx + ww * cdy) / c2
        omiga_w = hh * abs_select(w1 - w2) / torch.maximum(w1, w2)
        omiga_h = ww * abs_select(h1 - h2) / torch.maximum(h1, h2)
        shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
        return iou - distance - 0.5 * shape_cost
    # PIoU / PIoU2 (arXiv:2311.07716): a corner-distance penalty P relative to the target's size
    dw1 = abs_select(torch.minimum(b1_x2, b1_x1) - torch.minimum(b2_x2, b2_x1))
    dw2 = abs_select(torch.maximum(b1_x2, b1_x1) - torch.maximum(b2_x2, b2_x1))
    dh1 = abs_select(torch.minimum(b1_y2, b1_y1) - torch.minimum(b2_y2, b2_y1))
    dh2 = abs_select(torch.maximum(b1_y2, b1_y1) - torch.maximum(b2_y2, b2_y1))
    P = ((dw1 + dw2) / abs_select(w2) + (dh1 + dh2) / abs_select(h2)) / 4
    piou_v1 = 1 - iou - torch.exp(-(P ** 2)) + 1
    if PIoU:
        return 1 - piou_v1
    x = torch.exp(-P) * Lambda
    return 1 - 3 * x * torch.exp(-(x ** 2)) * piou_v1


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


WIOU_LTYPES = ("WIoU", "IoU", "GIoU", "DIoU", "CIoU", "EIoU", "SIoU", "MPDIoU", "ShapeIoU", "PIoU", "PIoU2")


def wise_iou_loss(pred: torch.Tensor, target: torch.Tensor, iou_mean: torch.Tensor, ltype: str = "WIoU",
                  monotonous: bool | None = False, inner: bool = False, focaler: bool = False, ratio: float = 1.0,
                  d: float = 0.0, u: float = 0.95, mpdiou_hw=1.0, scale: float = 0.0, Lambda: float = 1.3,
                  eps: float = 1e-7) -> tuple[torch.Tensor, torch.Tensor]:
    """Wise-IoU of xyxy boxes (..., 4) (arXiv:2301.10051; JAX
    ``ops/boxes.py:255``, the reference's 11 ltypes, in its float order) ->
    (loss (...,), the new running mean of the base term 1 - IoU).

    ``ltype`` picks the penalty added to the base term (``WIoU``: the base
    term times ``exp(l2_center / l2_box)``); ``inner`` / ``focaler`` change
    the base term as in :func:`bbox_iou`; ``monotonous`` picks the focusing:
    None none, True ``sqrt(beta)`` (v2), False ``beta / (delta *
    alpha^(beta - delta))`` (v3), with ``beta = (1 - IoU) / iou_mean``.
    ``l2_box`` in WIoU, CIoU's ``alpha`` and ``beta`` are out of the gradient,
    as the JAX package's ``stop_gradient`` keeps them.
    """
    pred_xy = (pred[..., :2] + pred[..., 2:4]) / 2
    target_xy = (target[..., :2] + target[..., 2:4]) / 2
    pred_wh = pred[..., 2:4] - pred[..., :2]
    target_wh = target[..., 2:4] - target[..., :2]
    min_coord = torch.minimum(pred, target)
    max_coord = torch.maximum(pred, target)
    wh_inter = _clip(min_coord[..., 2:4] - max_coord[..., :2], 0)
    s_inter = wh_inter[..., 0] * wh_inter[..., 1]
    s_union = pred_wh[..., 0] * pred_wh[..., 1] + target_wh[..., 0] * target_wh[..., 1] - s_inter
    wh_box = max_coord[..., 2:4] - min_coord[..., :2]
    l2_box = (wh_box ** 2).sum(-1)
    d_center = pred_xy - target_xy
    l2_center = (d_center ** 2).sum(-1)
    if inner:
        iou_loss = 1.0 - get_inner_iou(pred, target, xywh=False, ratio=ratio, eps=eps)[..., 0]
    elif focaler:
        iou_loss = 1.0 - _clip((s_inter / (s_union + eps) - d) / (u - d), 0.0, 1.0)
    else:
        iou_loss = 1.0 - s_inter / (s_union + eps)

    if ltype == "WIoU":
        loss = torch.exp(l2_center / (l2_box + eps).detach()) * iou_loss
    elif ltype == "IoU":
        loss = iou_loss
    elif ltype == "GIoU":
        s_box = wh_box[..., 0] * wh_box[..., 1]
        loss = iou_loss + (s_box - s_union) / (s_box + eps)
    elif ltype == "DIoU":
        loss = iou_loss + l2_center / (l2_box + eps)
    elif ltype == "CIoU":
        v = 4 / math.pi ** 2 * (torch.atan(pred_wh[..., 0] / (pred_wh[..., 1] + 1e-4))
                                - torch.atan(target_wh[..., 0] / (target_wh[..., 1] + 1e-4))) ** 2
        alpha = v / (iou_loss + v + eps)
        loss = iou_loss + l2_center / (l2_box + eps) + alpha.detach() * v
    elif ltype == "EIoU":
        loss = iou_loss + (l2_center / (l2_box + eps) + ((d_center / (wh_box + eps)) ** 2).sum(-1))
    elif ltype == "SIoU":  # the reference's _SIoU (theta = 4)
        angle = torch.asin(_clip(abs_select(d_center).amin(-1) / (torch.sqrt(l2_center) + 1e-4), -1 + eps, 1 - eps))
        angle = torch.sin(2 * angle) - 2
        dist = angle[..., None] * (d_center / (wh_box + eps)) ** 2
        dist = 2 - torch.exp(dist[..., 0]) - torch.exp(dist[..., 1])
        d_shape = abs_select(pred_wh - target_wh)
        big_shape = torch.maximum(pred_wh, target_wh)
        w_shape = 1 - torch.exp(-d_shape[..., 0] / (big_shape[..., 0] + eps))
        h_shape = 1 - torch.exp(-d_shape[..., 1] / (big_shape[..., 1] + eps))
        loss = iou_loss + (dist + w_shape ** 4 + h_shape ** 4) / 2
    elif ltype == "MPDIoU":
        d1 = ((target[..., :2] - pred[..., :2]) ** 2).sum(-1)
        d2 = ((target[..., 2:4] - pred[..., 2:4]) ** 2).sum(-1)
        loss = iou_loss + d1 / mpdiou_hw + d2 / mpdiou_hw
    elif ltype == "ShapeIoU":
        w1, h1 = pred_wh[..., 0], pred_wh[..., 1] + eps
        w2, h2 = target_wh[..., 0], target_wh[..., 1] + eps
        ww = 2 * w2 ** scale / (w2 ** scale + h2 ** scale)
        hh = 2 * h2 ** scale / (w2 ** scale + h2 ** scale)
        distance = (hh * d_center[..., 0] ** 2 + ww * d_center[..., 1] ** 2) / (l2_box + eps)
        omiga_w = hh * abs_select(w1 - w2) / torch.maximum(w1, w2)
        omiga_h = ww * abs_select(h1 - h2) / torch.maximum(h1, h2)
        shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
        loss = iou_loss + distance + 0.5 * shape_cost
    elif ltype in ("PIoU", "PIoU2"):
        w2 = target_wh[..., 0] + eps
        h2 = target_wh[..., 1] + eps
        dw1 = abs_select(torch.minimum(pred[..., 2], pred[..., 0]) - torch.minimum(target[..., 2], target[..., 0]))
        dw2 = abs_select(torch.maximum(pred[..., 2], pred[..., 0]) - torch.maximum(target[..., 2], target[..., 0]))
        dh1 = abs_select(torch.minimum(pred[..., 3], pred[..., 1]) - torch.minimum(target[..., 3], target[..., 1]))
        dh2 = abs_select(torch.maximum(pred[..., 3], pred[..., 1]) - torch.maximum(target[..., 3], target[..., 1]))
        P = ((dw1 + dw2) / abs_select(w2) + (dh1 + dh2) / abs_select(h2)) / 4
        piou_v1 = iou_loss - torch.exp(-(P ** 2)) + 1
        if ltype == "PIoU":
            loss = piou_v1
        else:
            x = torch.exp(-P) * Lambda
            loss = 3 * x * torch.exp(-(x ** 2)) * piou_v1
    else:
        raise ValueError(f"unsupported Wise-IoU ltype {ltype!r}: one of {', '.join(WIOU_LTYPES)}")

    new_mean = iou_mean * (1 - WIOU_MOMENTUM) + WIOU_MOMENTUM * iou_loss.detach().mean()
    if monotonous is not None:
        beta = iou_loss.detach() / iou_mean
        if monotonous:
            loss = loss * torch.sqrt(beta)
        else:
            loss = loss * beta / (WIOU_DELTA * torch.pow(WIOU_ALPHA, beta - WIOU_DELTA))
    return loss, new_mean


def _rbox_covariance(boxes: torch.Tensor):
    """The Gaussian covariance terms (a, b, c) of xywhr boxes (..., 5), each
    (..., 1), in the JAX package's order of operations (``ops/boxes.py:386``)."""
    a = boxes[..., 2:3] ** 2 / 12.0
    b = boxes[..., 3:4] ** 2 / 12.0
    r = boxes[..., 4:5]
    cos, sin = torch.cos(r), torch.sin(r)
    return a * cos ** 2 + b * sin ** 2, a * sin ** 2 + b * cos ** 2, a * cos * sin - b * sin * cos


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Probabilistic IoU of rotated xywhr boxes (arXiv:2106.06072; JAX
    ``ops/boxes.py:401``), broadcast over the leading dims -> (...,). The JAX
    package's order of operations and ``eps`` placements, and both clips:
    each determinant at 0 and the Bhattacharyya distance to [eps, 100], so
    that boxes far apart (two classes' centres ``max_wh`` apart) give
    ``1 - sqrt(1 - exp(-100) + eps)``, not 0. Kernel K7
    (``ops/kernels/nms_rotated.py``) computes the same float32 operations."""
    x1, y1 = obb1[..., 0:1], obb1[..., 1:2]
    x2, y2 = obb2[..., 0:1], obb2[..., 1:2]
    a1, b1, c1 = _rbox_covariance(obb1)
    a2, b2, c2 = _rbox_covariance(obb2)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    det1 = _clip(a1 * b1 - c1 ** 2, 0.0)
    det2 = _clip(a2 * b2 - c2 ** 2, 0.0)
    t3 = torch.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2) / (4 * torch.sqrt(det1 * det2) + eps) + eps) * 0.5
    bd = _clip(t1 + t2 + t3, eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return (1.0 - hd)[..., 0]


def xywhr2xyxyxyxy(rboxes: torch.Tensor) -> torch.Tensor:
    """xywhr (..., 5) -> the four corners (..., 4, 2) (JAX ``ops/boxes.py:418``)."""
    c, s = torch.cos(rboxes[..., 4]), torch.sin(rboxes[..., 4])
    ctr = rboxes[..., :2]
    w2, h2 = rboxes[..., 2] / 2.0, rboxes[..., 3] / 2.0
    v1 = torch.stack([w2 * c, w2 * s], -1)
    v2 = torch.stack([-h2 * s, h2 * c], -1)
    return torch.stack([ctr + v1 + v2, ctr + v1 - v2, ctr - v1 - v2, ctr - v1 + v2], -2)
