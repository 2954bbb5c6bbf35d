"""The segmentation loss: the detection loss plus a per-instance mask BCE.

Port of ``experiment_yolo_tpu/utils/task_losses.py`` (``crop_mask:42``,
``segmentation_loss:54``), the reference's ``v8SegmentationLoss`` in fixed
shapes: the detection part is :func:`~experiment_yolo_torch.utils.loss.detection_loss`
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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from experiment_yolo_torch.utils.loss import LossConfig, _sigmoid_bce, detection_loss

MAX_FG = 64  # foreground anchors a image that the mask term takes


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
