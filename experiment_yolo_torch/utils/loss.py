"""Detection loss: the anchor-free v8 loss with the reference's switches.

Port of ``experiment_yolo_tpu/utils/loss.py`` (``LossConfig``, ``_df_loss``,
``_bce_sum``, ``_cls_loss``, ``_box_dfl_losses``, ``_masked_wise_iou``,
``_plain_iou_loss``, ``_per_level_decode``, ``detection_loss``): TAL or ATSS
assignment, the class-loss zoo (BCE by default), the IoU zoo or Wise-IoU for
the box loss (CIoU by default, the NWD blend on request) and the distribution
focal loss, with the box half of the head maps decoded by kernel K1, every
level in one launch, straight from the NCHW maps.

    DFL decode of every level (K1) -> TAL|ATSS assign (no gradient) -> cls zoo + IoU zoo|Wise-IoU [+ NWD] box + DFL

Wise-IoU keeps a running mean of 1 - IoU over foreground anchors, and
EMASlide a running IoU, which the caller threads from step to step.

Maps of a bf16 model are lost in mixed precision, as in the JAX package:
geometry, the assigners and every reduction run in f32, the targets stay in
the score dtype, and the big elementwise parts of the class loss and DFL run
in bf16 with f32 sums where JAX's type promotion keeps them in bf16
(``utils/loss.py:112-156``, ``:397-416``, ``:538-592``). For f32 maps every
cast is a no-op.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from experiment_yolo_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from experiment_yolo_torch.ops.boxes import (IOU_TYPES, WIOU_LTYPES, WIOU_MOMENTUM, abs_select, bbox_iou,
                                             wasserstein_similarity, wise_iou_loss, xywh2xyxy)
from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_levels
from experiment_yolo_torch.utils import atss, tal


CLS_LOSSES = ("bce", "focal", "varifocal", "qualityfocal", "slide", "emaslide")
ASSIGNERS = ("tal", "atss")


@dataclass(frozen=True)
class LossConfig:
    """Loss hyperparameters (gains as in ``cfg/default.yaml``: box/cls/dfl),
    every field of the JAX ``LossConfig`` that changes the math.

    The box loss is ``bbox_iou``'s ``iou_type`` (CIoU by default), or with
    ``use_wiseiou`` the Wise-IoU v3 of ``wiou_ltype``; ``inner_iou`` /
    ``focaler_iou`` change their base term (``inner_ratio``, ``focaler_d``,
    ``focaler_u``); ``nwd`` blends in the NWD loss as ``iou_ratio * iou +
    (1 - iou_ratio) * nwd``. ``cls_loss`` picks the class loss and
    ``assigner`` TAL or ATSS. The JAX package's TPU layout switches
    (``checkpoint_loss``, ``packed_decode``, ``fused_dfl``, ``exact_topk``)
    change no value and are not here: the port's TAL takes the exact top-k.
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
    inner_ratio: float = 0.7
    focaler_d: float = 0.0
    focaler_u: float = 0.95
    cls_loss: str = "bce"
    focal_gamma: float = 1.5
    focal_alpha: float = 0.25
    vfl_gamma: float = 2.0
    vfl_alpha: float = 0.75
    qfl_beta: float = 2.0
    assigner: str = "tal"

    def __post_init__(self):
        for key, known in (("wiou_ltype", WIOU_LTYPES), ("iou_type", IOU_TYPES), ("cls_loss", CLS_LOSSES),
                           ("assigner", ASSIGNERS)):
            if getattr(self, key) not in known:
                raise ValueError(f"unknown {key} {getattr(self, key)!r}: one of {', '.join(known)}")


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
    """The levels' (B, no, H, W) maps -> xyxy boxes in grid units, (B, A, 4),
    through the differentiable DFL decode of every level at once (one launch
    of kernel K1 on the card); the box arithmetic is elementwise, so each
    level's boxes are those of a decode per level."""
    return dist2bbox(dfl_decode_levels(feats, reg_max), anchor_points[None], xywh=False)


def _plain_iou_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """1 - IoU of xyxy boxes (..., 4) -> (...,), the JAX package's float order."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:4], target[..., 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    wp = (pred[..., 2:4] - pred[..., :2]).clamp(min=0)
    wt = (target[..., 2:4] - target[..., :2]).clamp(min=0)
    return 1.0 - inter / (wp[..., 0] * wp[..., 1] + wt[..., 0] * wt[..., 1] - inter + eps)


def _sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, differentiated as the JAX package's
    ``_sigmoid_bce`` is (half the gradient at a logit of 0 through the clip,
    ``jnp.abs``'s +1 at 0); the dtype follows the inputs' promotion."""
    return torch.maximum(logits, logits.new_zeros(())) - logits * targets + \
        torch.log1p(torch.exp(-abs_select(logits)))


def _cls_loss(cfg: LossConfig, pred_scores: torch.Tensor, target_scores: torch.Tensor, target_labels: torch.Tensor,
              pred_bboxes: torch.Tensor, target_bboxes: torch.Tensor, fg_mask: torch.Tensor,
              target_scores_sum: torch.Tensor, slide_mean: Optional[torch.Tensor],
              step) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The class-loss zoo (JAX ``utils/loss.py:538``) -> (loss, new slide
    mean). The elementwise parts run in the score dtype (bf16 under AMP)
    where JAX's promotion keeps them there, and every sum in f32."""
    new_slide_mean = slide_mean
    fg_count = fg_mask.sum().clamp(min=1)
    if cfg.cls_loss == "bce":
        return _BCESum.apply(pred_scores, target_scores) / target_scores_sum, new_slide_mean
    if cfg.cls_loss == "focal":  # the reference's FocalLoss_YOLO
        t = target_scores
        p = torch.sigmoid(pred_scores)
        p_t = t * p + (1 - t) * (1 - p)
        alpha_f = t * cfg.focal_alpha + (1 - t) * (1 - cfg.focal_alpha)
        elem = _sigmoid_bce(pred_scores, t) * (1.0 - p_t) ** cfg.focal_gamma * alpha_f
        return elem.sum(dtype=torch.float32) / target_scores_sum, new_slide_mean
    if cfg.cls_loss == "varifocal":  # VarifocalLoss_YOLO, over the foreground count
        q = target_scores
        with torch.no_grad():
            weight = cfg.vfl_alpha * abs_select(torch.sigmoid(pred_scores) - q) ** cfg.vfl_gamma * (q <= 0) + \
                q * (q > 0)
        return (_sigmoid_bce(pred_scores, q) * weight).sum(dtype=torch.float32) / fg_count, new_slide_mean
    if cfg.cls_loss == "qualityfocal":  # QualityfocalLoss_YOLO: the IoU as the soft target on the foreground
        with torch.no_grad():
            iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False)[..., 0].clamp(min=1e-6)
        # jax.nn.one_hot's: a label outside [0, nc) gives a row of zeros
        onehot = (target_labels[..., None] == torch.arange(cfg.nc, device=target_labels.device)).to(pred_scores.dtype)
        pos = fg_mask[..., None] * onehot
        q = torch.where(pos > 0, iou[..., None] * onehot, 0.0)  # f32, as JAX promotes it
        p = torch.sigmoid(pred_scores)
        scale = torch.where(pos > 0, abs_select(q - p), p) ** cfg.qfl_beta
        return (_sigmoid_bce(pred_scores, q) * scale).sum(dtype=torch.float32) / fg_count, new_slide_mean
    # slide / emaslide: BCE weighted by where the target sits against auto_iou, the foreground's mean CIoU
    with torch.no_grad():
        iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True)[..., 0]
        auto_iou = torch.where(fg_mask, iou, 0.0).sum() / fg_count
        if cfg.cls_loss == "emaslide":
            upd = torch.as_tensor(1 if step is None else step, device=iou.device).float() + 1.0
            d = 0.999 * (1.0 - torch.exp(-upd / 2000.0))
            sm = slide_mean if slide_mean is not None else torch.ones((), device=iou.device)
            new_slide_mean = auto_iou = d * sm + (1 - d) * auto_iou
        auto_iou = auto_iou.clamp(min=0.2)
        t = target_scores
        tf = t.float()  # JAX compares in f32: torch would round auto_iou to a bf16 t's dtype
        w = (tf <= auto_iou - 0.1).float() + torch.exp(1.0 - auto_iou) * ((tf > auto_iou - 0.1) & (tf < auto_iou)) + \
            torch.exp(-(t - 1.0)) * (tf >= auto_iou)
    return (_sigmoid_bce(pred_scores, t) * w).sum(dtype=torch.float32) / target_scores_sum, new_slide_mean


def _masked_wise_iou(pred: torch.Tensor, target: torch.Tensor, fg_mask: torch.Tensor, iou_mean: torch.Tensor,
                     cfg: LossConfig, mpdiou_hw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wise-IoU v3 of ``cfg.wiou_ltype`` for every anchor, focused by the
    running ``iou_mean``, zero off the foreground, and the new running mean of
    the plain 1 - IoU, taken over the foreground anchors only (the reference's
    subset; ``max(fg, 1)`` guards an empty one)."""
    loss, _ = wise_iou_loss(pred, target, iou_mean, ltype=cfg.wiou_ltype, inner=cfg.inner_iou,
                            focaler=cfg.focaler_iou, ratio=cfg.inner_ratio, d=cfg.focaler_d, u=cfg.focaler_u,
                            mpdiou_hw=mpdiou_hw)
    with torch.no_grad():
        fg_mean = torch.where(fg_mask, _plain_iou_loss(pred, target), 0.0).sum() / fg_mask.sum().clamp(min=1)
        new_mean = iou_mean * (1 - WIOU_MOMENTUM) + WIOU_MOMENTUM * fg_mean
    return torch.where(fg_mask, loss, 0.0), new_mean


def _box_dfl_losses(pred_maps: List[torch.Tensor], pred_bboxes: torch.Tensor, anchor_points: torch.Tensor,
                    target_bboxes: torch.Tensor, fg_mask: torch.Tensor, weight: torch.Tensor,
                    target_scores_sum: torch.Tensor, iou_mean: torch.Tensor, mpdiou_hw: torch.Tensor,
                    cfg: LossConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The box loss (``iou_type``, or Wise-IoU, with the NWD blend) and DFL
    loss, weighted by target score, and the new Wise-IoU running mean
    (``iou_mean`` itself without Wise-IoU). ``mpdiou_hw`` (A,) is each
    anchor's image diagonal squared in grid units, MPDIoU's normaliser."""
    reg_max = cfg.reg_max
    if cfg.use_wiseiou:
        wiou, new_iou_mean = _masked_wise_iou(pred_bboxes, target_bboxes, fg_mask, iou_mean, cfg, mpdiou_hw[None])
        loss_iou = (wiou * weight).sum() / target_scores_sum
    else:
        variant = {} if cfg.iou_type == "IoU" else {cfg.iou_type: True}
        if cfg.iou_type == "MPDIoU":
            variant["mpdiou_hw"] = mpdiou_hw[None, :, None]
        iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, inner=cfg.inner_iou, focaler=cfg.focaler_iou,
                       ratio=cfg.inner_ratio, d=cfg.focaler_d, u=cfg.focaler_u, **variant)[..., 0]
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
                   cfg: LossConfig, iou_mean: Optional[torch.Tensor] = None,
                   slide_mean: Optional[torch.Tensor] = None, step=None) -> tuple:
    """(total, components, assignment, new iou_mean[, new slide_mean]) of raw
    Detect maps [(B, 4*reg_max + nc, H, W)].

    ``batch`` holds ``bboxes`` (B, M, 4) normalised xywh, ``cls`` (B, M) and
    ``mask`` (B, M). Components are ``box``, ``cls`` and ``dfl``, each times
    its gain; the total is their sum times the batch size, the scale of the
    reference's ``loss.sum() * batch_size``. ``iou_mean`` is Wise-IoU's
    running mean (0-d f32, 1.0 when None), returned as it came without
    Wise-IoU. ``slide_mean`` and ``step`` (the optimizer step) drive
    EMASlide's running IoU; the new slide mean is returned only when
    ``slide_mean`` is given, as in the JAX package.
    """
    nc, reg_max = cfg.nc, cfg.reg_max
    b = feats[0].shape[0]
    pred_scores = torch.cat([f[:, 4 * reg_max:].reshape(b, nc, -1) for f in feats], 2).transpose(1, 2)  # (B, A, nc)
    feat_shapes = [tuple(f.shape[2:4]) for f in feats]
    anchor_points, stride_tensor = make_anchors(feat_shapes, strides, 0.5, device=feats[0].device)
    imgsz_h, imgsz_w = feats[0].shape[2] * strides[0], feats[0].shape[3] * strides[0]

    # targets: normalised xywh -> pixel xyxy, padded rows masked
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32, device=anchor_points.device)
    gt_bboxes = xywh2xyxy(batch["bboxes"].float() * scale)
    mask_gt = batch["mask"].bool() & (gt_bboxes.sum(-1) > 0)
    gt_bboxes = torch.where(mask_gt[..., None], gt_bboxes, 0.0)

    pred_bboxes = per_level_decode(feats, anchor_points, reg_max)  # (B, A, 4) grid units
    if cfg.assigner == "atss":
        res = atss.assign(pred_bboxes.detach() * stride_tensor[None], anchor_points * stride_tensor, stride_tensor,
                          feat_shapes, batch["cls"], gt_bboxes, mask_gt, num_classes=nc)
    else:
        res = tal.assign(torch.sigmoid(pred_scores.detach()), pred_bboxes.detach() * stride_tensor[None],
                         anchor_points * stride_tensor, batch["cls"], gt_bboxes, mask_gt, topk=cfg.tal_topk,
                         num_classes=nc, alpha=cfg.tal_alpha, beta=cfg.tal_beta)
    # the targets in the score dtype (ATSS's come in f32), as in the JAX package
    target_scores, fg_mask = res.target_scores.to(pred_scores.dtype), res.fg_mask
    target_bboxes = res.target_bboxes / stride_tensor[None]  # grid units
    target_scores_sum = target_scores.sum(dtype=torch.float32).clamp(min=1.0)

    loss_cls, new_slide_mean = _cls_loss(cfg, pred_scores, target_scores, res.target_labels, pred_bboxes,
                                         target_bboxes, fg_mask, target_scores_sum, slide_mean, step)
    # one nonzero per anchor, so the sum is exact in bf16 too
    weight = torch.where(fg_mask, target_scores.sum(-1), 0.0).float()  # (B, A)
    if iou_mean is None:
        iou_mean = torch.ones((), dtype=torch.float32, device=feats[0].device)
    mpdiou_hw = (imgsz_h ** 2 + imgsz_w ** 2) / stride_tensor[:, 0] ** 2  # (A,) the image diagonal^2, grid units
    loss_iou, loss_dfl, new_iou_mean = _box_dfl_losses(list(feats), pred_bboxes, anchor_points, target_bboxes,
                                                       fg_mask, weight, target_scores_sum, iou_mean, mpdiou_hw, cfg)
    comps = {"box": loss_iou * cfg.box, "cls": loss_cls * cfg.cls, "dfl": loss_dfl * cfg.dfl}
    total = (comps["box"] + comps["cls"] + comps["dfl"]) * b
    out = (total, comps, res, new_iou_mean)
    return out + (new_slide_mean,) if slide_mean is not None else out
