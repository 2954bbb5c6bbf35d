"""Batched fixed-shape non-maximum suppression.

Port of ``experiment_yolo_tpu/ops/nms.py:non_max_suppression`` on its
predict-path settings (one label per anchor): a top-k pre-filter over each
anchor's best class, the class-offset trick, then greedy hard NMS (kernel K2
on the card) or the reference fork's Gaussian soft-NMS, packed into a fixed
(B, max_det, 6) [x1, y1, x2, y2, conf, cls] plus per-image counts.

Ties in every top-k break toward the lower index, as ``jax.lax.top_k`` does,
so the port keeps the JAX package's candidate order exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from experiment_yolo_torch.ops.boxes import box_iou, xywh2xyxy
from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress

_PRE_NMS_TOPK = 1024  # candidates kept per image before NMS
_MAX_WH = 7680.0  # class offset of the boxes, so classes never overlap
_SIGMA = 0.5  # soft-NMS Gaussian decay exp(-iou^2 / sigma)
_SOFT_SCORE_THRESHOLD = 0.25  # soft-NMS keeps while the best live score exceeds this, whatever conf is
_EARLY_EXIT_EVERY = 16  # soft-NMS steps between checks that any image still keeps boxes


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last dim, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _soft_nms_keep(shifted: torch.Tensor, cand_scores: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                   max_det: int, first_idx: Optional[torch.Tensor] = None, n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian soft-NMS over (B, K) score-sorted candidates -> per-candidate
    output scores (decayed; -1 where not kept).

    Each step takes the best live box, decays by exp(-iou^2 / sigma) every live
    score whose IoU with it exceeds ``iou_thres``, and stops keeping once the
    best live score falls to 0.25 (the fork's threshold, whatever ``conf``
    is). With ``first_idx``/``n_valid`` set it reproduces the fork's
    quirks: the first box kept is the first in anchor order, and a step keeps
    only while at least two boxes survive, so the last lone survivor is dropped.
    Once no image keeps a box, no later step can: the loop then ends early.
    """
    b, k = cand_scores.shape
    rows = torch.arange(b, device=cand_scores.device)
    live = torch.where(valid, cand_scores, torch.full_like(cand_scores, -1.0))
    out = torch.full_like(cand_scores, -1.0)
    for t in range(min(max_det, k)):
        if first_idx is not None:
            i = first_idx if t == 0 else live.argmax(-1)
            m = n_valid if t == 0 else (live > _SOFT_SCORE_THRESHOLD).sum(-1)
            cond = m >= 2
        else:
            i = live.argmax(-1)
            cond = live[rows, i] > _SOFT_SCORE_THRESHOLD
        si = live[rows, i]
        iou = box_iou(shifted[rows, i][:, None], shifted)[:, 0]  # (B, K)
        decay = torch.where(iou > iou_thres, torch.exp(-(iou ** 2) / _SIGMA), torch.ones_like(iou))
        live = torch.where(cond[:, None], live * decay, live)
        live[rows, i] = -1.0
        out[rows, i] = torch.where(cond, si, out[rows, i])
        if t % _EARLY_EXIT_EVERY == _EARLY_EXIT_EVERY - 1 and not bool(cond.any()):
            break
    return out


def _pack(cand_boxes, cand_cls, keep_scores, conf_thres: float, max_det: int):
    """Top ``max_det`` kept candidates -> ((B, max_det, 6), counts (B,))."""
    b, k = keep_scores.shape
    out_scores, out_idx = _top_k(keep_scores, min(max_det, k))
    if k < max_det:
        out_scores = torch.cat([out_scores, out_scores.new_full((b, max_det - k), -1.0)], 1)
        out_idx = torch.cat([out_idx, out_idx.new_zeros((b, max_det - k))], 1)
    det_valid = out_scores > conf_thres
    boxes = torch.gather(cand_boxes, 1, out_idx[..., None].expand(b, max_det, 4))
    cls = torch.gather(cand_cls, 1, out_idx)
    out = torch.cat([boxes, out_scores[..., None], cls[..., None]], -1)
    return torch.where(det_valid[..., None], out, torch.zeros_like(out)), det_valid.sum(-1, dtype=torch.int32)


class Candidates(NamedTuple):
    """The top-k pool of each image, score-sorted: xyxy boxes (B, K, 4),
    classes (B, K) f32, scores (B, K), class-offset boxes (B, K, 4), the
    conf gate (B, K), and the soft-NMS quirk's first index and count (or None)."""

    boxes: torch.Tensor
    cls: torch.Tensor
    scores: torch.Tensor
    shifted: torch.Tensor
    valid: torch.Tensor
    first_idx: Optional[torch.Tensor]
    n_valid: Optional[torch.Tensor]


def nms_candidates(boxes: torch.Tensor, scores: torch.Tensor, conf_thres: float = 0.25, agnostic: bool = False,
                   first_box: bool = False) -> Candidates:
    """The top-k pre-filter over each anchor's best class and the class-offset
    trick on xywh boxes; ``first_box`` adds the soft-NMS quirk's first box in
    anchor order."""
    boxes, scores = xywh2xyxy(boxes.float()), scores.float()
    b, a, _ = boxes.shape
    k = min(_PRE_NMS_TOPK, a)
    best_scores, best_cls = scores.max(-1)
    best_cls = best_cls.float()
    cand_scores, cand_anchor = _top_k(best_scores, k)
    first_idx = n_valid = None
    if first_box:
        # the fork keeps its first box in anchor order, the lowest conf-passing
        # anchor; if the top-k pool misses it, it takes the last slot
        vfirst = best_scores > conf_thres
        n_valid = vfirst.sum(-1)
        first_anchor = vfirst.int().argmax(-1)
        present = (cand_anchor == first_anchor[:, None]).any(-1)
        cand_anchor[:, -1] = torch.where(present, cand_anchor[:, -1], first_anchor)
        cand_scores[:, -1] = torch.where(present, cand_scores[:, -1],
                                         best_scores.gather(1, first_anchor[:, None])[:, 0])
        first_idx = (cand_anchor == first_anchor[:, None]).int().argmax(-1)
    cand_boxes = torch.gather(boxes, 1, cand_anchor[..., None].expand(b, k, 4))
    cand_cls = torch.gather(best_cls, 1, cand_anchor)
    shifted = cand_boxes if agnostic else cand_boxes + (cand_cls * _MAX_WH)[..., None]
    return Candidates(cand_boxes, cand_cls, cand_scores, shifted, cand_scores > conf_thres, first_idx, n_valid)


def non_max_suppression(boxes: torch.Tensor, scores: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.7, max_det: int = 300, agnostic: bool = False,
                        nms_type: str = "hard", soft_first_quirk: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched NMS: xywh boxes (B, A, 4) in input pixels and sigmoid scores
    (B, A, nc) -> detections (B, max_det, 6) [x1, y1, x2, y2, conf, cls],
    zero-padded, and counts (B,) int32. Each image keeps its 1024 best
    anchors before NMS.

    ``nms_type='hard'`` is greedy suppression (kernel K2 on the card);
    ``'soft'`` is the fork's Gaussian soft-NMS, and ``soft_first_quirk`` its
    exact protocol (see :func:`_soft_nms_keep`).
    """
    if nms_type not in ("hard", "soft"):
        raise ValueError(f"nms_type={nms_type!r}: expected 'hard' or 'soft'")
    c = nms_candidates(boxes, scores, conf_thres, agnostic, first_box=nms_type == "soft" and soft_first_quirk)
    if nms_type == "soft":
        keep_scores = _soft_nms_keep(c.shifted, c.scores, c.valid, iou_thres, max_det,
                                     first_idx=c.first_idx, n_valid=c.n_valid)
    else:
        keep = nms_suppress(c.shifted.contiguous(), c.valid, iou_thres)
        keep_scores = torch.where(keep, c.scores, torch.full_like(c.scores, -1.0))
    return _pack(c.boxes, c.cls, keep_scores, conf_thres, max_det)
