"""The segmentation, pose and oriented-box losses: the detection loss plus a
per-instance mask BCE, or plus the keypoint terms; and the rotated-box loss.

Port of ``experiment_yolo_tpu/utils/task_losses.py`` (``OKS_SIGMA:36``,
``crop_mask:42``, ``segmentation_loss:54``, ``pose_loss:109``,
``obb_loss:173``), the reference's ``v8SegmentationLoss``, ``v8PoseLoss``
and ``v8OBBLoss`` in fixed shapes. For
segmentation: the detection part is :func:`~experiment_yolo_torch.utils.loss.detection_loss`
with its assignment returned, and the mask term takes the ``max_fg`` (64)
foreground anchors of largest target score per image, as ``jax.lax.top_k``
picks them (ties to the lower index, here by a stable descending sort, which
holds on the card too). Ground truth arrives as one overlap-index image per
sample (B, Hm, Wm): value i+1 is instance i.

Dtypes follow the JAX trainer's segment branch (``engine/trainer.py:457-465``):
the detect maps come in f32, the coefficients and protos in the compute
dtype, so under bf16 the mask logits, the targets and the BCE are bf16, each
crop's mean is summed in f32 and rounded to bf16, and the division by the box
area and the sums run in f32.

The pose loss (JAX's form, ``(2 * p + anchor - 0.5)`` on the raw regression)
adds an OKS-style location term over the visible keypoints of each
foreground anchor's ground truth and a visibility BCE, both over
``n_fg * nk``. Its dtypes follow the JAX trainer's pose branch
(``engine/trainer.py:466-475``): the detect maps in f32, the keypoint maps in
the compute dtype. Under bf16 the targets are rounded to bf16 (as JAX casts
them to the maps' dtype), the location term runs in f32 (the anchors and
strides are f32) with the sigmas' ``(2 * sigma)^2`` in bf16, and the
visibility BCE and its sum in bf16.

The OBB loss is JAX's: the rotated assigner (``utils/tal.py``, ProbIoU
overlaps) on the decoded xywhr boxes, the class BCE, a ``1 - probiou`` box
term and the DFL on the unrotated box of each target (its ``xywh2xyxy``, the
angle left out, as upstream), each weighted by target score; targets under
2 px on a side are masked out. Off the foreground the box term meets a unit
box in place of a padded target, so that its gradient is 0 where JAX's is NaN
(see :func:`obb_loss`). It keeps no Wise-IoU mean and ignores
``iou_type``, NWD and the class-loss zoo, as JAX does. Its dtypes follow the
JAX trainer's obb branch (``engine/trainer.py:476-482``): the detect maps in
f32, the angle maps in the compute dtype, so under bf16 the angle's sigmoid,
cosine and sine run in bf16 before they meet the f32 distances.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from experiment_yolo_torch.nn.heads_extra import decode_obb_angle, flat_kpts
from experiment_yolo_torch.ops.anchors import bbox2dist, dist2rbox, make_anchors
from experiment_yolo_torch.ops.boxes import probiou, xywh2xyxy
from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_levels
from experiment_yolo_torch.utils import tal
from experiment_yolo_torch.utils.loss import LossConfig, _sigmoid_bce, detection_loss, df_loss_levels

MAX_FG = 64  # foreground anchors a image that the mask term takes
# the COCO 17-keypoint OKS sigmas (the reference's metrics.py:14)
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89,
                      0.89]) / 10.0


def kpt_sigmas(kpt_shape: Sequence[int]) -> np.ndarray:
    """The OKS sigmas of a keypoint shape: COCO's for (17, 3), else 1 / nk each."""
    nk = kpt_shape[0]
    return OKS_SIGMA if tuple(kpt_shape) == (17, 3) else np.ones(nk) / nk


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask values outside each box: masks (..., H, W), boxes (..., 4)
    xyxy in mask pixels; a pixel (r, c) stays when x1 <= c < x2 and y1 <= r < y2."""
    h, w = masks.shape[-2:]
    cols = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, :]
    rows = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[:, None]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    keep = (cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)
    return masks * keep


def resize_nearest_index(src: int, dst: int, device=None) -> torch.Tensor:
    """Source index of each of ``dst`` outputs of ``jax.image.resize``'s
    nearest method: floor((i + 0.5) * src / dst) in float32 (half-pixel centres)."""
    pos = (torch.arange(dst, dtype=torch.float32, device=device) + 0.5) * src / dst
    return pos.floor().long().clamp_(max=src - 1)


def top_foreground(fg_mask: torch.Tensor, weight: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) anchor indices of the ``k`` largest weights among foreground
    anchors (others count -1), ties to the lower index, as ``jax.lax.top_k``."""
    w = torch.where(fg_mask, weight, -1.0)
    return torch.sort(w, dim=1, descending=True, stable=True)[1][:, :k]


def segmentation_loss(feats: Sequence[torch.Tensor], coeffs: Sequence[torch.Tensor], protos: torch.Tensor,
                      batch: Dict[str, torch.Tensor], strides: Sequence[int], cfg: LossConfig,
                      iou_mean: Optional[torch.Tensor] = None, max_fg: int = MAX_FG,
                      picks: Optional[torch.Tensor] = None) -> Tuple:
    """(total, {box, cls, dfl, seg}, assignment, new iou_mean, picked anchors)
    of the detect maps ``feats`` [(B, 4*reg_max + nc, H, W)], the coefficient
    maps ``coeffs`` [(B, nm, H, W)] and ``protos`` (B, nm, Hp, Wp); ``batch``
    adds ``masks`` (B, Hm, Wm) int to the detection targets. The seg term is
    scaled by the box gain and the total adds it times the batch size, as the
    reference does. ``picks`` (B, K) replaces the top-``max_fg`` selection
    (a comparison hands one side's picks to the other)."""
    b = feats[0].shape[0]
    nm, hp, wp = protos.shape[1:]
    total_det, comps, res, new_iou, aux = detection_loss(feats, batch, strides, cfg, iou_mean, return_aux=True)
    flat_coeffs = torch.cat([c.flatten(2) for c in coeffs], 2).transpose(1, 2)  # (B, A, nm)
    fg_mask = aux["fg_mask"]
    top_idx = top_foreground(fg_mask, aux["weight"], min(max_fg, fg_mask.shape[1])) if picks is None else picks
    valid = torch.gather(fg_mask, 1, top_idx)  # (B, K)
    sel_coeffs = torch.gather(flat_coeffs, 1, top_idx[..., None].expand(-1, -1, nm))  # (B, K, nm)
    sel_gt_idx = torch.gather(aux["target_gt_idx"], 1, top_idx).long()  # (B, K)
    # target boxes: grid units -> pixels -> normalised -> mask pixels
    tb_px = aux["target_bboxes"] * aux["stride_tensor"][None]
    sel_boxes = torch.gather(tb_px, 1, top_idx[..., None].expand(-1, -1, 4))  # (B, K, 4)
    imgsz_h, imgsz_w = aux["imgsz"]
    boxes_n = sel_boxes / sel_boxes.new_tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h])
    marea = ((boxes_n[..., 2] - boxes_n[..., 0]) * (boxes_n[..., 3] - boxes_n[..., 1])).clamp(min=1e-7)
    mxyxy = boxes_n * boxes_n.new_tensor([wp, hp, wp, hp])

    masks = batch["masks"]
    if tuple(masks.shape[1:3]) != (hp, wp):  # nearest resize with half-pixel centres (jax.image.resize)
        hm, wm = masks.shape[1:3]
        masks = masks[:, resize_nearest_index(hm, hp, masks.device)][:, :, resize_nearest_index(wm, wp, masks.device)]
    gt_masks = (masks[:, None].long() == (sel_gt_idx + 1)[:, :, None, None]).to(protos.dtype)  # (B, K, Hp, Wp)
    pred_masks = torch.einsum("bkn,bnhw->bkhw", sel_coeffs, protos.to(sel_coeffs.dtype))
    bce = _sigmoid_bce(pred_masks, gt_masks)
    cropped = crop_mask(bce, mxyxy)
    per_anchor = cropped.mean((-2, -1), dtype=torch.float32).to(cropped.dtype) / marea  # (B, K)
    n_sel = valid.sum().clamp(min=1)
    loss_seg = torch.where(valid, per_anchor, 0.0).sum() / n_sel

    comps = {**comps, "seg": loss_seg * cfg.box}
    return total_det + comps["seg"] * b, comps, res, new_iou, top_idx


def pose_loss(feats: Sequence[torch.Tensor], kpt_maps: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor],
              strides: Sequence[int], cfg: LossConfig, iou_mean: Optional[torch.Tensor] = None,
              kpt_shape: Sequence[int] = (17, 3), pose_gain: float = 12.0, kobj_gain: float = 1.0) -> Tuple:
    """(total, {box, cls, dfl, pose, kobj}, assignment, new iou_mean) of the
    detect maps ``feats`` [(B, 4*reg_max + nc, H, W)] and the keypoint maps
    [(B, nk*nd, H, W)]; ``batch`` adds ``keypoints`` (B, M, nk, nd),
    normalised xy and the visibility, to the detection targets. The pose
    and kobj terms carry their gains and the total adds them times the
    batch size, as the reference does."""
    b = feats[0].shape[0]
    nk, nd = kpt_shape
    total_det, comps, res, new_iou, aux = detection_loss(feats, batch, strides, cfg, iou_mean, return_aux=True)
    anchor_points, stride_t = aux["anchor_points"], aux["stride_tensor"]
    imgsz_h, imgsz_w = aux["imgsz"]

    flat = flat_kpts(kpt_maps, kpt_shape)  # (B, A, nk, nd), the compute dtype
    pred_xy = flat[..., :2] * 2.0 + (anchor_points[None, :, None] - 0.5)  # grid units, f32
    # each anchor's ground-truth keypoints: normalised -> pixels -> that anchor's grid units
    kpts = batch["keypoints"].to(flat.dtype)
    kpts = torch.cat([kpts[..., :2] * torch.tensor([imgsz_w, imgsz_h], dtype=flat.dtype, device=flat.device),
                      kpts[..., 2:]], -1)
    idx = aux["target_gt_idx"].long()[..., None, None].expand(-1, -1, nk, kpts.shape[-1])
    sel = torch.gather(kpts, 1, idx)  # (B, A, nk, nd)
    sel_xy = sel[..., :2] / stride_t[None, :, None]
    kpt_mask = sel[..., 2] != 0 if nd == 3 else torch.ones(sel.shape[:-1], dtype=torch.bool, device=sel.device)

    fg = aux["fg_mask"]
    tb = aux["target_bboxes"]
    area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])).clamp(min=1e-9)  # grid units
    sigmas = torch.tensor(kpt_sigmas(kpt_shape), dtype=flat.dtype, device=flat.device)
    d = ((pred_xy - sel_xy) ** 2).sum(-1)  # (B, A, nk)
    e = d / (2 * sigmas[None, None]) ** 2 / (area[..., None] + 1e-9) / 2.0
    kpt_loss_factor = nk / (kpt_mask.sum(-1, keepdim=True) + 1e-9)
    per_el = kpt_loss_factor * (1.0 - torch.exp(-e)) * kpt_mask
    n_fg_el = (fg.sum() * nk).clamp(min=1)
    loss_pose = torch.where(fg[..., None], per_el, 0.0).sum() / n_fg_el
    if nd == 3:
        kobj = _sigmoid_bce(flat[..., 2], kpt_mask.to(flat.dtype))
        loss_kobj = torch.where(fg[..., None], kobj, 0.0).sum() / n_fg_el
    else:
        loss_kobj = torch.zeros((), dtype=flat.dtype, device=flat.device)

    comps = {**comps, "pose": loss_pose * pose_gain, "kobj": loss_kobj * kobj_gain}
    return total_det + (comps["pose"] + comps["kobj"]) * b, comps, res, new_iou


def obb_loss(feats: Sequence[torch.Tensor], angle_maps: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor],
             strides: Sequence[int], cfg: LossConfig) -> Tuple:
    """(total, {box, cls, dfl}, assignment) of the detect maps ``feats`` [(B,
    4*reg_max + nc, H, W)] and the angle maps [(B, ne, H, W)]; ``batch`` holds
    ``bboxes`` (B, M, 5) normalised xywh and the angle in radians, ``cls``
    (B, M) and ``mask`` (B, M). The total is the components' sum times the
    batch size, as the reference's."""
    nc, reg_max = cfg.nc, cfg.reg_max
    b = feats[0].shape[0]
    pred_scores = torch.cat([f[:, 4 * reg_max:].reshape(b, nc, -1) for f in feats], 2).transpose(1, 2)  # (B, A, nc)
    dtype = pred_scores.dtype
    feat_shapes = [tuple(f.shape[2:4]) for f in feats]
    anchor_points, stride_tensor = make_anchors(feat_shapes, strides, 0.5, device=feats[0].device)
    imgsz_h, imgsz_w = feats[0].shape[2] * strides[0], feats[0].shape[3] * strides[0]
    angle = decode_obb_angle(angle_maps)  # (B, A, ne), the angle maps' dtype

    # targets: normalised xywh + angle -> pixel xywhr, boxes under 2 px masked
    gt = batch["bboxes"].to(dtype)
    gt_xywh = gt[..., :4] * torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=dtype, device=gt.device)
    mask_gt = batch["mask"].bool() & (gt_xywh[..., 2] >= 2) & (gt_xywh[..., 3] >= 2)
    gt_rboxes = torch.where(mask_gt[..., None], torch.cat([gt_xywh, gt[..., 4:5]], -1), 0.0)

    dist = dfl_decode_levels(feats, reg_max)  # (B, A, 4) grid units, K1 and its backward on the card
    xywh = dist2rbox(dist, angle[..., :1], anchor_points[None])
    pred_rboxes = torch.cat([xywh, angle[..., :1].to(xywh.dtype)], -1)  # (B, A, 5) grid units
    assigner_boxes = torch.cat([pred_rboxes[..., :4] * stride_tensor[None], pred_rboxes[..., 4:5]], -1).detach()
    res = tal.assign(torch.sigmoid(pred_scores.detach()), assigner_boxes, anchor_points * stride_tensor,
                     batch["cls"], gt_rboxes, mask_gt, topk=cfg.tal_topk, num_classes=nc, alpha=cfg.tal_alpha,
                     beta=cfg.tal_beta, rotated=True)
    target_scores, fg_mask = res.target_scores, res.fg_mask
    target_scores_sum = target_scores.sum().clamp(min=1.0)
    target_rboxes = torch.cat([res.target_bboxes[..., :4] / stride_tensor[None], res.target_bboxes[..., 4:5]], -1)

    loss_cls = _sigmoid_bce(pred_scores, target_scores).sum() / target_scores_sum
    weight = torch.where(fg_mask, target_scores.sum(-1), 0.0)
    # JAX takes every anchor's ProbIoU and masks it after; an anchor off the foreground whose target is a padded
    # zero box (gt row 0 of an image without labels, or one under 2 px) then gets 0 * inf = NaN in its gradient,
    # from the square root of a zero determinant. Here such anchors meet a unit box: the values and the foreground's
    # gradients are JAX's, and the rest of the gradient is 0 where JAX's is NaN.
    iou = probiou(pred_rboxes, torch.where(fg_mask[..., None], target_rboxes,
                                           target_rboxes.new_tensor([0.0, 0.0, 1.0, 1.0, 0.0])))
    loss_iou = (torch.where(fg_mask, 1.0 - iou, 0.0) * weight).sum() / target_scores_sum
    target_ltrb = bbox2dist(anchor_points[None], xywh2xyxy(target_rboxes[..., :4]), reg_max)
    dfl = df_loss_levels(feats, target_ltrb, reg_max)
    loss_dfl = (torch.where(fg_mask, dfl, 0.0) * weight).sum() / target_scores_sum

    comps = {"box": loss_iou * cfg.box, "cls": loss_cls * cfg.cls, "dfl": loss_dfl * cfg.dfl}
    return (comps["box"] + comps["cls"] + comps["dfl"]) * b, comps, res
