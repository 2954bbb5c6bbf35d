"""Detection loss: the anchor-free v8 loss and the paper's box-loss recipe.

Port of ``experiment_yolo_tpu/utils/loss.py`` (``LossConfig``, ``_df_loss``,
``_bce_sum``, ``_cls_loss``, ``_box_dfl_losses``, ``_masked_wise_iou``,
``_plain_iou_loss``, ``_per_level_decode``, ``detection_loss``): TAL
assignment, BCE class loss, CIoU or Wise-IoU v3 box loss (with the NWD blend
on request) and the distribution focal loss, with the box half of each head
map decoded per level by kernel K1 straight from the NCHW map.

    per-level DFL decode (K1) -> TAL assign (no gradient) -> BCE cls + (W/C)IoU [+ NWD] box + DFL

Wise-IoU keeps a running mean of 1 - IoU over foreground anchors, which the
caller threads from step to step.

Maps of a bf16 model are lost in mixed precision, as in the JAX package:
geometry, the assigner and every reduction run in f32, the targets stay in
the score dtype, and the big elementwise parts of BCE and DFL run in bf16 with
f32 sums (``utils/loss.py:112-156``, ``:399-416``, ``:515-544``). For f32
maps every cast is a no-op. The JAX ``LossConfig``'s other switches
(the rest of the IoU zoo, Inner- and Focaler-IoU, the class-loss zoo, ATSS)
raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from experiment_yolo_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from experiment_yolo_torch.ops.boxes import WIOU_MOMENTUM, bbox_iou, wasserstein_similarity, wise_iou_loss, xywh2xyxy
from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode
from experiment_yolo_torch.utils import tal


@dataclass(frozen=True)
class LossConfig:
    """Loss hyperparameters (gains as in ``cfg/default.yaml``: box/cls/dfl).

    ``use_wiseiou`` takes Wise-IoU v3 (``wiou_ltype='WIoU'``) for the box
    loss in place of CIoU; ``nwd`` blends in the NWD loss as ``iou_ratio *
    iou + (1 - iou_ratio) * nwd``. The JAX package's other switches are
    accepted at their defaults only.
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
    wiou_ltype: str = "WIoU"
    nwd: bool = False
    iou_ratio: float = 0.5
    iou_type: str = "CIoU"
    inner_iou: bool = False
    focaler_iou: bool = False
    cls_loss: str = "bce"
    assigner: str = "tal"

    def __post_init__(self):
        unported = {"wiou_ltype": self.wiou_ltype != "WIoU", "iou_type": self.iou_type != "CIoU",
                    "inner_iou": self.inner_iou, "focaler_iou": self.focaler_iou,
                    "cls_loss": self.cls_loss != "bce", "assigner": self.assigner != "tal"}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"LossConfig {', '.join(f'{k}={getattr(self, k)!r}' for k in bad)} is not ported to "
                "experiment_yolo_torch; the port has TAL, BCE, CIoU or WIoU v3 with the NWD blend, and DFL: see "
                "ROADMAP.md queue 1 item 2 for the rest of the IoU zoo")


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
    hat = (1.0 - (bins - t).abs()).clamp(min=0.0).to(pred_dist.dtype)
    m = pred_dist.detach().amax(2, keepdim=True)
    lse = m[:, :, 0] + torch.log(torch.exp((pred_dist - m).float()).sum(2))
    proj = (pred_dist * hat).sum(2, dtype=torch.float32)
    return (lse - proj).mean(1)


class _BCESum(torch.autograd.Function):
    """``sum(max(x, 0) - x * t + log1p(exp(-|x|)))`` over every element, in
    the logits' dtype with an f32 sum, and the analytic backward
    ``sigmoid(x) - t`` in f32, rounded once to the logits' dtype (the JAX
    package's ``_bce_sum``). The targets take no gradient."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(logits, targets)
        return (logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))).sum(
            dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, targets = ctx.saved_tensors
        return ((torch.sigmoid(logits.float()) - targets.float()) * g).to(logits.dtype), None


def per_level_decode(feats: Sequence[torch.Tensor], anchor_points: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Each level's (B, no, H, W) map -> xyxy boxes in grid units, through
    the differentiable DFL decode (kernel K1 on the card), concatenated to (B, A, 4)."""
    parts, start = [], 0
    for f in feats:
        a = f.shape[2] * f.shape[3]
        parts.append(dist2bbox(dfl_decode(f, reg_max), anchor_points[None, start:start + a], xywh=False))
        start += a
    return torch.cat(parts, 1)


def _plain_iou_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """1 - IoU of xyxy boxes (..., 4) -> (...,), the JAX package's float order."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:4], target[..., 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    wp = (pred[..., 2:4] - pred[..., :2]).clamp(min=0)
    wt = (target[..., 2:4] - target[..., :2]).clamp(min=0)
    return 1.0 - inter / (wp[..., 0] * wp[..., 1] + wt[..., 0] * wt[..., 1] - inter + eps)


def _masked_wise_iou(pred: torch.Tensor, target: torch.Tensor, fg_mask: torch.Tensor,
                     iou_mean: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wise-IoU v3 of every anchor, focused by the running ``iou_mean``, zero
    off the foreground, and the new running mean, taken over the foreground
    anchors only (the reference's subset; ``max(fg, 1)`` guards an empty one)."""
    loss, _ = wise_iou_loss(pred, target, iou_mean)
    with torch.no_grad():
        fg_mean = torch.where(fg_mask, _plain_iou_loss(pred, target), 0.0).sum() / fg_mask.sum().clamp(min=1)
        new_mean = iou_mean * (1 - WIOU_MOMENTUM) + WIOU_MOMENTUM * fg_mean
    return torch.where(fg_mask, loss, 0.0), new_mean


def _box_dfl_losses(pred_maps: List[torch.Tensor], pred_bboxes: torch.Tensor, anchor_points: torch.Tensor,
                    target_bboxes: torch.Tensor, fg_mask: torch.Tensor, weight: torch.Tensor,
                    target_scores_sum: torch.Tensor, iou_mean: torch.Tensor,
                    cfg: LossConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(W/C)IoU box loss (with the NWD blend) and DFL loss, weighted by target
    score, and the new Wise-IoU running mean (``iou_mean`` itself without
    Wise-IoU)."""
    reg_max = cfg.reg_max
    if cfg.use_wiseiou:
        wiou, new_iou_mean = _masked_wise_iou(pred_bboxes, target_bboxes, fg_mask, iou_mean)
        loss_iou = (wiou * weight).sum() / target_scores_sum
    else:
        iou = bbox_iou(pred_bboxes, target_bboxes)[..., 0]
        loss_iou = (torch.where(fg_mask, 1.0 - iou, 0.0) * weight).sum() / target_scores_sum
        new_iou_mean = iou_mean
    if cfg.nwd:
        nwd = wasserstein_similarity(pred_bboxes, target_bboxes)[..., 0]
        nwd_loss = (torch.where(fg_mask, 1.0 - nwd, 0.0) * weight).sum() / target_scores_sum
        loss_iou = cfg.iou_ratio * loss_iou + (1.0 - cfg.iou_ratio) * nwd_loss

    target_ltrb = bbox2dist(anchor_points[None], target_bboxes, reg_max)  # (B, A, 4)
    parts, start = [], 0
    for f in pred_maps:
        b, _, h, w = f.shape
        d = f[:, : 4 * reg_max].reshape(b, 4, reg_max, h * w)
        parts.append(df_loss(d, target_ltrb[:, start:start + h * w].transpose(1, 2)))
        start += h * w
    dfl = torch.cat(parts, 1)  # (B, A)
    loss_dfl = (torch.where(fg_mask, dfl, 0.0) * weight).sum() / target_scores_sum
    return loss_iou, loss_dfl, new_iou_mean


def detection_loss(feats: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor], strides: Sequence[int],
                   cfg: LossConfig, iou_mean: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], tal.AssignResult, torch.Tensor]:
    """(total, components, assignment, new iou_mean) of raw Detect maps
    [(B, 4*reg_max + nc, H, W)].

    ``batch`` holds ``bboxes`` (B, M, 4) normalised xywh, ``cls`` (B, M) and
    ``mask`` (B, M). Components are ``box``, ``cls`` and ``dfl``, each times
    its gain; the total is their sum times the batch size, the scale of the
    reference's ``loss.sum() * batch_size``. ``iou_mean`` is Wise-IoU's
    running mean (0-d f32, 1.0 when None), returned as it came without
    Wise-IoU.
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
    target_scores, fg_mask = res.target_scores, res.fg_mask  # targets in the score dtype
    target_bboxes = res.target_bboxes / stride_tensor[None]  # grid units
    target_scores_sum = target_scores.sum(dtype=torch.float32).clamp(min=1.0)

    loss_cls = _BCESum.apply(pred_scores, target_scores) / target_scores_sum
    # one nonzero per anchor, so the sum is exact in bf16 too
    weight = torch.where(fg_mask, target_scores.sum(-1), 0.0).float()  # (B, A)
    if iou_mean is None:
        iou_mean = torch.ones((), dtype=torch.float32, device=feats[0].device)
    loss_iou, loss_dfl, new_iou_mean = _box_dfl_losses(list(feats), pred_bboxes, anchor_points, target_bboxes,
                                                       fg_mask, weight, target_scores_sum, iou_mean, cfg)
    comps = {"box": loss_iou * cfg.box, "cls": loss_cls * cfg.cls, "dfl": loss_dfl * cfg.dfl}
    total = (comps["box"] + comps["cls"] + comps["dfl"]) * b
    return total, comps, res, new_iou_mean
