"""The ATSS assigner on padded ground truth.

Port of ``experiment_yolo_tpu/utils/atss.py`` (``anchor_boxes_from_points``,
``assign``): the top-k anchors nearest each gt centre on every level, an IoU
threshold of mean plus standard deviation over the candidates, the in-gt
test, anchors claimed by several gts resolved by the largest IoU, and one-hot
targets scaled by the best predicted IoU of each gt. Every step is a
fixed-shape masked computation without gradients, and it returns the TAL
assigner's ``AssignResult``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from experiment_yolo_torch.ops.boxes import box_iou
from experiment_yolo_torch.utils.tal import AssignResult, select_candidates_in_gts

GRID_CELL_SIZE = 5.0  # an anchor box is 5 strides a side around its cell centre


def anchor_boxes_from_points(anc_points: torch.Tensor, stride_tensor: torch.Tensor) -> torch.Tensor:
    """(A, 2) centres and (A, 1) strides -> (A, 4) xyxy anchor boxes."""
    half = stride_tensor * GRID_CELL_SIZE * 0.5
    return torch.cat([anc_points - half, anc_points + half], -1)


@torch.no_grad()
def assign(pd_bboxes: torch.Tensor, anc_points: torch.Tensor, stride_tensor: torch.Tensor,
           feat_shapes: Sequence[Tuple[int, int]], gt_labels: torch.Tensor, gt_bboxes: torch.Tensor,
           mask_gt: torch.Tensor, topk: int = 9, num_classes: int = 80) -> AssignResult:
    """ATSS assignment. pd_bboxes (B, A, 4) xyxy px (decoded predictions);
    anc_points (A, 2) px; stride_tensor (A, 1); feat_shapes the (H, W) of
    each level; gt_labels (B, M); gt_bboxes (B, M, 4) xyxy px, zero rows as
    padding; mask_gt (B, M) bool. The targets come back in f32.

    ``jax.lax.top_k`` keeps equal distances in index order, and a gt centre
    equidistant from two anchors is common; a stable ascending sort picks the
    same anchors (``torch.topk`` promises no order for ties).
    """
    b, m = gt_labels.shape
    a = anc_points.shape[0]
    mask_gt = mask_gt.bool()
    gt_labels = gt_labels.to(torch.int32)

    anc_bboxes = anchor_boxes_from_points(anc_points, stride_tensor)  # (A, 4)
    overlaps = box_iou(gt_bboxes.reshape(-1, 4), anc_bboxes).reshape(b, m, a)
    gt_centers = (gt_bboxes[..., :2] + gt_bboxes[..., 2:4]) / 2  # (B, M, 2)
    dist = ((gt_centers[:, :, None] - anc_points[None, None]) ** 2).sum(-1).sqrt()  # (B, M, A), jnp.linalg.norm's

    # the top-k nearest anchors of every level, an anchor picked twice dropped
    cand_masks, start = [], 0
    for h, w in feat_shapes:
        n = h * w
        k = min(topk, n)
        idx = torch.sort(dist[..., start:start + n], dim=-1, stable=True).indices[..., :k]
        idx = torch.where(mask_gt[..., None], idx, 0)
        count = torch.zeros((b, m, n), dtype=torch.int32, device=dist.device).scatter_add_(
            -1, idx, torch.ones_like(idx, dtype=torch.int32))
        cand_masks.append(torch.where(count > 1, 0, count))
        start += n
    is_in_candidate = torch.cat(cand_masks, -1).to(overlaps.dtype)  # (B, M, A)

    # threshold: mean + std of the candidate IoUs over exactly k * levels slots
    cand_overlaps = torch.where(is_in_candidate > 0, overlaps, 0.0)
    n_cand = sum(min(topk, h * w) for h, w in feat_shapes)
    mean = cand_overlaps.sum(-1, keepdim=True) / n_cand
    var = torch.where(is_in_candidate > 0, (overlaps - mean) ** 2, 0.0).sum(-1, keepdim=True) / max(n_cand - 1, 1)
    thr = mean + var.sqrt()

    is_pos = torch.where(cand_overlaps > thr, is_in_candidate, 0.0)
    is_in_gts = select_candidates_in_gts(anc_points, gt_bboxes)
    mask_pos = is_pos * is_in_gts.to(is_pos.dtype) * mask_gt[..., None].to(is_pos.dtype)

    # anchors claimed by several gts go to the gt of largest IoU
    mask_multi = mask_pos.sum(-2)[:, None, :] > 1
    mi = torch.arange(m, device=gt_bboxes.device)[None, :, None]
    is_max = (mi == overlaps.argmax(1)[:, None, :]).to(mask_pos.dtype)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2) > 0
    target_gt_idx = mask_pos.argmax(-2).to(torch.int32)  # the first gt on ties, as in JAX

    oh_gt = mi == target_gt_idx[:, None, :]  # (B, M, A)
    target_labels = torch.where(oh_gt, gt_labels[:, :, None], 0).sum(1, dtype=torch.int32)
    target_bboxes = torch.where(oh_gt[..., None], gt_bboxes[:, :, None, :], 0.0).sum(1)
    onehot = F.one_hot(target_labels.clamp(min=0).long(), num_classes).to(pd_bboxes.dtype)
    target_scores = torch.where(fg_mask[..., None], onehot, 0.0)

    # soft labels: each gt's best IoU with the predictions of its anchors
    pred_ious = box_iou(gt_bboxes, pd_bboxes)  # (B, M, A)
    ious = (pred_ious * mask_pos).amax(-2)[..., None]
    return AssignResult(target_labels, target_bboxes, target_scores * ious, fg_mask, target_gt_idx)
