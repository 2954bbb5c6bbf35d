"""Batched fixed-shape non-maximum suppression.

Port of ``experiment_yolo_tpu/ops/nms.py:non_max_suppression`` for xywh
boxes: a top-k pre-filter, over each anchor's best class (one label per
anchor, the predictor's setting) or over every (anchor, class) score
(``multi_label``, the validator's), the class-offset trick, then greedy hard
NMS (kernel K2 on the card) or the reference fork's Gaussian soft-NMS (kernel
K5), packed into a fixed (B, max_det, 6) [x1, y1, x2, y2, conf, cls] plus
per-image counts.

Ties in every top-k break toward the lower index, as ``jax.lax.top_k`` does,
so the port keeps the JAX package's candidate order exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from experiment_yolo_torch.ops.boxes import xywh2xyxy
from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress
from experiment_yolo_torch.ops.kernels.soft_nms import soft_nms

_MAX_WH = 7680.0  # class offset of the boxes, so classes never overlap


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last dim, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
                   first_box: bool = False, multi_label: bool = False, pre_nms_topk: int = 1024) -> Candidates:
    """The top-k pre-filter and the class-offset trick on xywh boxes (B, A, 4)
    and scores (B, A, nc). The pool is the ``pre_nms_topk`` best of each
    anchor's best class, or with ``multi_label`` of every (anchor, class)
    score (flat index ``anchor * nc + class``). ``first_box`` adds the
    soft-NMS quirk's first box: the lowest conf-passing index of that array."""
    boxes, scores = xywh2xyxy(boxes.float()), scores.float()
    b, a, nc = scores.shape
    if multi_label:
        pool = scores.reshape(b, a * nc)
    else:
        pool, best_cls = scores.max(-1)
    k = min(pre_nms_topk, pool.shape[1])
    cand_scores, cand_idx = _top_k(pool, k)
    first_idx = n_valid = None
    if first_box:
        # the fork keeps its first box in array order, the lowest conf-passing
        # index; if the top-k pool misses it, it takes the last slot
        vfirst = pool > conf_thres
        n_valid = vfirst.sum(-1)
        first = vfirst.int().argmax(-1)
        present = (cand_idx == first[:, None]).any(-1)
        cand_idx[:, -1] = torch.where(present, cand_idx[:, -1], first)
        cand_scores[:, -1] = torch.where(present, cand_scores[:, -1], pool.gather(1, first[:, None])[:, 0])
        first_idx = (cand_idx == first[:, None]).int().argmax(-1)
    if multi_label:
        cand_anchor, cand_cls = cand_idx // nc, (cand_idx % nc).float()
    else:
        cand_anchor, cand_cls = cand_idx, torch.gather(best_cls.float(), 1, cand_idx)
    cand_boxes = torch.gather(boxes, 1, cand_anchor[..., None].expand(b, k, 4))
    shifted = cand_boxes if agnostic else cand_boxes + (cand_cls * _MAX_WH)[..., None]
    return Candidates(cand_boxes, cand_cls, cand_scores, shifted, cand_scores > conf_thres, first_idx, n_valid)


def non_max_suppression(boxes: torch.Tensor, scores: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.7, max_det: int = 300, agnostic: bool = False,
                        nms_type: str = "hard", soft_first_quirk: bool = False, multi_label: bool = False,
                        pre_nms_topk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched NMS: xywh boxes (B, A, 4) in input pixels and sigmoid scores
    (B, A, nc) -> detections (B, max_det, 6) [x1, y1, x2, y2, conf, cls],
    zero-padded, and counts (B,) int32. Each image keeps its
    ``pre_nms_topk`` best anchors (or, with ``multi_label``, (anchor, class)
    pairs) before NMS.

    ``nms_type='hard'`` is greedy suppression (kernel K2 on the card);
    ``'soft'`` is the fork's Gaussian soft-NMS (kernel K5 on the card), and
    ``soft_first_quirk`` its exact protocol (see
    :func:`~experiment_yolo_torch.ops.kernels.soft_nms.soft_nms_plain`).
    """
    if nms_type not in ("hard", "soft"):
        raise ValueError(f"nms_type={nms_type!r}: expected 'hard' or 'soft'")
    c = nms_candidates(boxes, scores, conf_thres, agnostic, first_box=nms_type == "soft" and soft_first_quirk,
                       multi_label=multi_label, pre_nms_topk=pre_nms_topk)
    shifted = c.shifted.contiguous()
    if nms_type == "soft":
        keep_scores = soft_nms(shifted, c.scores.contiguous(), c.valid.contiguous(), iou_thres, max_det,
                               first_idx=c.first_idx, n_valid=c.n_valid)
    else:
        keep = nms_suppress(shifted, c.valid, iou_thres)
        keep_scores = torch.where(keep, c.scores, torch.full_like(c.scores, -1.0))
    return _pack(c.boxes, c.cls, keep_scores, conf_thres, max_det)
