"""Detection loss: the anchor-free v8 loss with the default switches.

Port of ``experiment_yolo_tpu/utils/loss.py`` (``LossConfig``, ``_df_loss``,
``_bce_sum``, ``_cls_loss``, ``_box_dfl_losses``, ``_per_level_decode``,
``detection_loss``) for its default configuration: TAL assignment, BCE class
loss, CIoU box loss and the distribution focal loss, with the box half of
each head map decoded per level by kernel K1 straight from the NCHW map.

    per-level DFL decode (K1) -> TAL assign (no gradient) -> BCE cls + CIoU box + DFL

The other switches of the JAX ``LossConfig`` (Wise-IoU, NWD, the IoU and
class-loss zoos, ATSS) raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from experiment_yolo_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from experiment_yolo_torch.ops.boxes import bbox_iou, xywh2xyxy
from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode
from experiment_yolo_torch.utils import tal


@dataclass(frozen=True)
class LossConfig:
    """Loss hyperparameters (gains as in ``cfg/default.yaml``: box/cls/dfl).

    The JAX package's other switches are accepted at their defaults only.
    """

    nc: int = 80
    reg_max: int = 16
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    use_wiseiou: bool = False
    nwd: bool = False
    iou_type: str = "CIoU"
    cls_loss: str = "bce"
    assigner: str = "tal"

    def __post_init__(self):
        unported = {"use_wiseiou": self.use_wiseiou, "nwd": self.nwd, "iou_type": self.iou_type != "CIoU",
                    "cls_loss": self.cls_loss != "bce", "assigner": self.assigner != "tal"}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"LossConfig {', '.join(f'{k}={getattr(self, k)!r}' for k in bad)} is not ported to "
                "experiment_yolo_torch; the port has the default loss (TAL, BCE, CIoU, DFL): see ROADMAP.md "
                "queue 1 item 8")


def df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss in the hat form (the JAX package's ``_df_loss``).

    pred_dist (B, 4, reg_max, A) logits of one level's box channels; target
    (B, 4, A) in [0, reg_max - 1). Returns (B, A), the mean over the 4 sides of
    ``logsumexp(d) - sum_r d_r * hat_r`` with ``hat_r = max(0, 1 - |r - t|)``,
    which is the two-bin cross-entropy (both bins collapse on ``reg_max - 1``
    when the target is clipped there).
    """
    reg_max = pred_dist.shape[2]
    t = target.clamp(max=reg_max - 1)[:, :, None]  # (B, 4, 1, A)
    bins = torch.arange(reg_max, dtype=t.dtype, device=t.device)[:, None]
    hat = (1.0 - (bins - t).abs()).clamp(min=0.0)
    m = pred_dist.detach().amax(2, keepdim=True)
    lse = m[:, :, 0] + torch.log(torch.exp(pred_dist - m).sum(2))
    proj = (pred_dist * hat).sum(2)
    return (lse - proj).mean(1)


def per_level_decode(feats: Sequence[torch.Tensor], anchor_points: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Each level's (B, no, H, W) map -> xyxy boxes in grid units, through
    the differentiable DFL decode (kernel K1 on the card), concatenated to (B, A, 4)."""
    parts, start = [], 0
    for f in feats:
        a = f.shape[2] * f.shape[3]
        parts.append(dist2bbox(dfl_decode(f, reg_max), anchor_points[None, start:start + a], xywh=False))
        start += a
    return torch.cat(parts, 1)


def _box_dfl_losses(pred_maps: List[torch.Tensor], pred_bboxes: torch.Tensor, anchor_points: torch.Tensor,
                    target_bboxes: torch.Tensor, fg_mask: torch.Tensor, weight: torch.Tensor,
                    target_scores_sum: torch.Tensor, reg_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """CIoU box loss and DFL loss, weighted by target score."""
    iou = bbox_iou(pred_bboxes, target_bboxes)[..., 0]
    loss_iou = (torch.where(fg_mask, 1.0 - iou, 0.0) * weight).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchor_points[None], target_bboxes, reg_max)  # (B, A, 4)
    parts, start = [], 0
    for f in pred_maps:
        b, _, h, w = f.shape
        d = f[:, : 4 * reg_max].reshape(b, 4, reg_max, h * w)
        parts.append(df_loss(d, target_ltrb[:, start:start + h * w].transpose(1, 2)))
        start += h * w
    dfl = torch.cat(parts, 1)  # (B, A)
    loss_dfl = (torch.where(fg_mask, dfl, 0.0) * weight).sum() / target_scores_sum
    return loss_iou, loss_dfl


def detection_loss(feats: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor], strides: Sequence[int],
                   cfg: LossConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], tal.AssignResult]:
    """(total, components, assignment) of raw Detect maps [(B, 4*reg_max + nc, H, W)].

    ``batch`` holds ``bboxes`` (B, M, 4) normalised xywh, ``cls`` (B, M) and
    ``mask`` (B, M). Components are ``box``, ``cls`` and ``dfl``, each times
    its gain; the total is their sum times the batch size, the scale of the
    reference's ``loss.sum() * batch_size``.
    """
    nc, reg_max = cfg.nc, cfg.reg_max
    b = feats[0].shape[0]
    pred_scores = torch.cat([f[:, 4 * reg_max:].reshape(b, nc, -1) for f in feats], 2).transpose(1, 2)  # (B, A, nc)
    anchor_points, stride_tensor = make_anchors([f.shape[2:4] for f in feats], strides, 0.5, device=feats[0].device)
    imgsz_h, imgsz_w = feats[0].shape[2] * strides[0], feats[0].shape[3] * strides[0]

    # targets: normalised xywh -> pixel xyxy, padded rows masked
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32, device=anchor_points.device)
    gt_bboxes = xywh2xyxy(batch["bboxes"].float() * scale)
    mask_gt = batch["mask"].bool() & (gt_bboxes.sum(-1) > 0)
    gt_bboxes = torch.where(mask_gt[..., None], gt_bboxes, 0.0)

    pred_bboxes = per_level_decode(feats, anchor_points, reg_max)  # (B, A, 4) grid units
    res = tal.assign(torch.sigmoid(pred_scores.detach()), pred_bboxes.detach() * stride_tensor[None],
                     anchor_points * stride_tensor, batch["cls"], gt_bboxes, mask_gt, topk=cfg.tal_topk,
                     num_classes=nc, alpha=cfg.tal_alpha, beta=cfg.tal_beta)
    target_scores, fg_mask = res.target_scores, res.fg_mask
    target_bboxes = res.target_bboxes / stride_tensor[None]  # grid units
    target_scores_sum = target_scores.sum().clamp(min=1.0)

    # BCE with logits: the analytic backward sigmoid(x) - t of the JAX _bce_sum
    loss_cls = F.binary_cross_entropy_with_logits(pred_scores, target_scores, reduction="sum") / target_scores_sum
    weight = torch.where(fg_mask, target_scores.sum(-1), 0.0)  # (B, A)
    loss_iou, loss_dfl = _box_dfl_losses(list(feats), pred_bboxes, anchor_points, target_bboxes, fg_mask, weight,
                                         target_scores_sum, reg_max)
    comps = {"box": loss_iou * cfg.box, "cls": loss_cls * cfg.cls, "dfl": loss_dfl * cfg.dfl}
    total = (comps["box"] + comps["cls"] + comps["dfl"]) * b
    return total, comps, res
