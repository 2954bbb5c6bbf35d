"""Task-aligned assigner (TAL) on padded ground truth.

Port of ``experiment_yolo_tpu/utils/tal.py`` (``select_candidates_in_gts``,
``_select_topk_mask`` with ``exact=True``, ``assign``) for axis-aligned boxes:
ground truth arrives padded to M boxes per image with a validity mask, and
every step is a fixed-shape masked computation. The whole assigner runs
without gradients, as in the JAX package (callers pass detached predictions).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from experiment_yolo_torch.ops.boxes import bbox_iou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int32
    target_bboxes: torch.Tensor  # (B, A, 4)
    target_scores: torch.Tensor  # (B, A, nc)
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int32


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Anchor centres strictly inside gt boxes: (A, 2) x (B, M, 4) -> (B, M, A) bool."""
    x, y = xy_centers[None, None, :, 0], xy_centers[None, None, :, 1]
    x1, y1 = gt_bboxes[..., None, 0], gt_bboxes[..., None, 1]
    x2, y2 = gt_bboxes[..., None, 2], gt_bboxes[..., None, 3]
    return (x - x1 > eps) & (y - y1 > eps) & (x2 - x > eps) & (y2 - y > eps)


def select_topk_mask(metrics: torch.Tensor, topk: int, valid_gt: torch.Tensor) -> torch.Tensor:
    """The exact top-k anchors of each gt as a (B, M, A) 0/1 mask, zero on
    invalid gt rows.

    ``jax.lax.top_k`` breaks ties by the lowest index, and many anchors tie
    at metric 0; a stable descending sort keeps equal values in index order,
    so it picks the same k anchors (``torch.topk`` promises no tie order, and
    its order differs between the CPU and the card).
    """
    idx = torch.sort(metrics, dim=-1, descending=True, stable=True).indices[..., :topk]
    mask = torch.zeros_like(metrics).scatter_(-1, idx, 1.0)
    return mask * valid_gt[..., None].to(metrics.dtype)


@torch.no_grad()
def assign(pd_scores: torch.Tensor, pd_bboxes: torch.Tensor, anc_points: torch.Tensor, gt_labels: torch.Tensor,
           gt_bboxes: torch.Tensor, mask_gt: torch.Tensor, topk: int = 10, num_classes: int = 80,
           alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9) -> AssignResult:
    """Task-aligned assignment (s^alpha * u^beta), fixed shapes throughout.

    pd_scores (B, A, nc) sigmoided; pd_bboxes (B, A, 4) xyxy px; anc_points
    (A, 2) px; gt_labels (B, M); gt_bboxes (B, M, 4) xyxy px, zero rows as
    padding; mask_gt (B, M) bool.
    """
    b, a, nc = pd_scores.shape
    m = gt_bboxes.shape[1]
    gt_labels = gt_labels.to(torch.int32)
    mask_gt = mask_gt.bool()

    pre_mask = select_candidates_in_gts(anc_points, gt_bboxes) & mask_gt[..., None]  # (B, M, A)
    # each anchor's score for each gt's class: one nonzero per row, so exact
    label_idx = gt_labels.clamp(0, nc - 1).long()[..., None].expand(b, m, a)
    cls_scores = pd_scores.transpose(1, 2).gather(1, label_idx)  # (B, M, A)
    overlaps = bbox_iou(gt_bboxes[:, :, None], pd_bboxes[:, None], xywh=False, CIoU=True)[..., 0]
    overlaps = torch.where(pre_mask, overlaps, 0.0).clamp(min=0.0)
    cls_scores = torch.where(pre_mask, cls_scores, 0.0)
    # s^alpha in f32: XLA fuses JAX's bf16 power into the f32 product without rounding it to bf16
    align_metric = cls_scores.float() ** alpha * overlaps ** beta

    mask_pos = select_topk_mask(align_metric, topk, mask_gt) * pre_mask.to(align_metric.dtype)  # (B, M, A)

    # anchors claimed by several gts go to the gt of highest CIoU
    mask_multi = mask_pos.sum(-2)[:, None, :] > 1
    mi = torch.arange(m, device=gt_bboxes.device)[None, :, None]
    is_max = (mi == overlaps.argmax(1)[:, None, :]).to(mask_pos.dtype)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2) > 0  # (B, A)
    target_gt_idx = mask_pos.argmax(-2).to(torch.int32)  # (B, A), the first gt on ties as in JAX

    oh_gt = mi == target_gt_idx[:, None, :]  # (B, M, A), one hit per anchor
    target_labels = torch.where(oh_gt, gt_labels[:, :, None], 0).sum(1, dtype=torch.int32).clamp(min=0)
    target_bboxes = torch.where(oh_gt[..., None], gt_bboxes[:, :, None, :], 0.0).sum(1)  # (B, A, 4)
    onehot = F.one_hot(target_labels.long(), num_classes).to(pd_scores.dtype)
    target_scores = torch.where(fg_mask[..., None], onehot, 0.0)

    # normalise by each gt's best metric
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)  # (B, M, 1)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_metric * pos_overlap / (pos_align + eps)).amax(-2)[..., None]  # (B, A, 1)
    # the targets stay in the score dtype (bf16 scores under amp), as in the JAX package
    return AssignResult(target_labels, target_bboxes, target_scores * norm.to(target_scores.dtype), fg_mask,
                        target_gt_idx)
