"""The segmentation, pose and oriented-box validators: box mAP with mask or
pose mAP, and rotated-box mAP.

Port of ``experiment_yolo_tpu/engine/validators_extra.py`` (``mask_iou_np:28``,
``kpt_oks_np:36``, ``_TaskValidator:46``, ``SegmentationValidator:98-172``,
``PoseValidator:173-234``, ``OBBValidator:236-296``, ``TASK_VALIDATORS:298``)
for the segment, pose and obb tasks. The card part (:meth:`SegmentationValidator.infer`):
normalise, forward, decode (kernel K1), NMS as the JAX validator calls it
(multi-label, hard, its default pool of 1,024: kernel K2) with the kept
anchors' indices, and the masks of the kept detections at proto resolution.
The host part (:meth:`SegmentationValidator.score_batch`) is numpy: boxes as
``DetectionValidator`` scores them, and each mask cut to its box at proto
resolution and held to the ground-truth instances rebuilt from the batch's
overlap-index image (resized as OpenCV's ``INTER_NEAREST`` does when its size
differs).

:class:`PoseValidator` keeps the same NMS and gathers the kept anchors'
keypoints on the card; on the host each image's keypoints are taken back
through its (gain, pad) and held to the ground truth's by OKS, whose area is
the original-image ground-truth box's times 0.53 (the reference's).

:class:`OBBValidator` runs rotated NMS (hard, each anchor's best class, a
pool of 1,024: kernel K7) at the validator's ``conf``, ``iou`` and
``max_det``; on the host the predicted and ground-truth xywhr boxes go back
through each image's (gain, pad), centres unpadded and extents divided by the
gain, the angles unchanged and nothing clipped, and are matched by ProbIoU.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch

from experiment_yolo_torch.engine.validator import DetectionValidator
from experiment_yolo_torch.ops.boxes import probiou
from experiment_yolo_torch.ops.nms import nms_rotated, non_max_suppression
from experiment_yolo_torch.utils import LOGGER
from experiment_yolo_torch.utils.metrics import IOUV, DetMetrics, box_iou_np, match_predictions
from experiment_yolo_torch.utils.task_losses import kpt_sigmas


def mask_iou_np(pred: np.ndarray, gt: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N, HW) x (M, HW) binary masks -> (N, M) IoU (the reference's ``mask_iou``)."""
    inter = pred.astype(np.float32) @ gt.astype(np.float32).T
    union = pred.sum(-1)[:, None] + gt.sum(-1)[None] - inter
    return inter / (union + eps)


def kpt_oks_np(pred_kpts: np.ndarray, gt_kpts: np.ndarray, gt_area: np.ndarray, sigmas: np.ndarray,
               eps: float = 1e-7) -> np.ndarray:
    """(N, nk, 2|3) predicted and (M, nk, 3) ground-truth keypoints -> (N, M)
    OKS over the ground truth's visible keypoints (the reference's ``kpt_iou``)."""
    d = ((pred_kpts[:, None, :, 0] - gt_kpts[None, :, :, 0]) ** 2
         + (pred_kpts[:, None, :, 1] - gt_kpts[None, :, :, 1]) ** 2)  # (N, M, nk)
    vis = gt_kpts[..., 2] != 0  # (M, nk)
    e = d / (2 * sigmas[None, None]) ** 2 / (gt_area[None, :, None] + eps) / 2
    return (np.exp(-e) * vis[None]).sum(-1) / (vis.sum(-1)[None] + eps)


def _gt_boxes(batch: Mapping, i: int, ih: int, iw: int):
    """Image ``i``'s ground truth: (xyxy on the letterboxed image, classes, the label mask)."""
    m = np.asarray(batch["mask"][i]).astype(bool)
    gx = np.asarray(batch["bboxes"][i])[m][:, :4] * np.asarray([iw, ih, iw, ih])
    gt = np.stack([gx[:, 0] - gx[:, 2] / 2, gx[:, 1] - gx[:, 3] / 2, gx[:, 0] + gx[:, 2] / 2,
                   gx[:, 1] + gx[:, 3] / 2], 1)
    return gt, np.asarray(batch["cls"][i])[m].astype(np.float32), m


def _to_ori(b: np.ndarray, gain, padw, padh, oh, ow, clip: bool = True) -> np.ndarray:
    """Letterbox xyxy -> original-image xyxy, clipped to the image unless ``clip`` is off."""
    b = b.copy()
    b[:, [0, 2]] = (b[:, [0, 2]] - padw) / gain
    b[:, [1, 3]] = (b[:, [1, 3]] - padh) / gain
    if clip:
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, ow)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, oh)
    return b


def resize_nearest_cv(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`` of a 2-D
    array: source index floor(i * (1 / (dst / src))), capped at the last."""
    w, h = size
    sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / img.shape[0]))).astype(np.int64), img.shape[0] - 1)
    sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / img.shape[1]))).astype(np.int64), img.shape[1] - 1)
    return img[sy][:, sx]


class SegmentationValidator(DetectionValidator):
    """``SegmentationValidator(overrides)(model)`` on ``overrides['data']``
    (a segment dataset), or ``(model, batches, names, n_images=None)`` on
    batches in memory that also hold ``masks`` (B, Hm, Wm) -> the stats:
    ``box_*`` and ``mask_*`` (precision, recall, mAP50, mAP50-95, fitness),
    the box family's under their plain names, and ``fitness``, the mean of the
    two fitnesses. :class:`PoseValidator` shares all but the task's scoring."""

    task, family = "segment", "mask"

    def __init__(self, overrides: Optional[Dict] = None):
        super().__init__(overrides)
        self.args.task = self.task

    def nms(self, boxes: torch.Tensor, scores: torch.Tensor):
        """The JAX validator's NMS: multi-label, ``nms_type`` at the function's
        default (hard), the default pool, with the kept anchors."""
        a = self.args
        return non_max_suppression(boxes, scores, conf_thres=float(a.conf), iou_thres=float(a.iou),
                                   max_det=int(a.max_det), multi_label=True, return_idx=True)

    @torch.no_grad()
    def infer(self, model, imgs: torch.Tensor):
        """The card part: (B, H, W, 3) uint8 -> (detections (B, max_det, 6) in
        letterbox pixels, counts (B,), the kept rows' task outputs: mask
        probabilities (B, max_det, Hp, Wp), or keypoints (B, max_det, nk, nd)
        in letterbox pixels). The model runs in eval mode, on images
        normalised in f32 and cast to its compute dtype."""
        x = (imgs.permute(0, 3, 1, 2).float() / 255.0).to(model.dtype).contiguous()
        training = model.training
        model.eval()
        try:
            boxes, scores, *rest = model.predict(x)
            det, counts, idx = self.nms(boxes, scores)
            return det, counts, model.kept_outputs(*rest, idx)
        finally:
            model.train(training)

    def score_batch(self, box_m: DetMetrics, mask_m: DetMetrics, det: np.ndarray, counts: np.ndarray,
                    pmasks: np.ndarray, batch: Mapping, n: Optional[int] = None) -> None:
        """The host part for the first ``n`` images of one batch: box and mask
        matching, ``box_m.update`` and ``mask_m.update``."""
        ih, iw = np.asarray(batch["img"]).shape[1:3]
        hp, wp = pmasks.shape[-2:]
        for i in range(len(det) if n is None else n):
            k = int(counts[i])
            d = det[i, :k]
            gain, padw, padh = np.asarray(batch["ratio_pad"][i])
            oh, ow = np.asarray(batch["ori_shape"][i])
            pb = _to_ori(d[:, :4], gain, padw, padh, oh, ow)
            gt, cls, m = _gt_boxes(batch, i, ih, iw)
            gt = _to_ori(gt, gain, padw, padh, oh, ow, clip=False)
            iou = box_iou_np(pb, gt) if k else np.zeros((0, len(gt)))
            tp_b = match_predictions(d[:, 5], cls, iou) if k else np.zeros((0, IOUV.size), bool)
            box_m.update(tp_b, d[:, 4], d[:, 5], cls)

            # masks at proto resolution, each cut to its box
            pm = pmasks[i, :k] > 0.5
            sx, sy = wp / iw, hp / ih
            for j in range(k):
                x1, y1, x2, y2 = d[j, :4]
                keep = np.zeros((hp, wp), bool)
                xa, xb = int(max(x1 * sx, 0)), int(min(np.ceil(x2 * sx), wp))
                ya, yb = int(max(y1 * sy, 0)), int(min(np.ceil(y2 * sy), hp))
                keep[ya:yb, xa:xb] = True
                pm[j] &= keep
            gidx = np.flatnonzero(m)
            gimg = np.asarray(batch["masks"][i])
            if gimg.shape != (hp, wp):
                gimg = resize_nearest_cv(gimg.astype(np.int32), (wp, hp))
            gm = np.stack([gimg == j + 1 for j in gidx]) if len(gidx) else np.zeros((0, hp, wp), bool)
            iou_m = (mask_iou_np(pm.reshape(k, -1), gm.reshape(len(gm), -1)) if k and len(gm)
                     else np.zeros((k, len(gm))))
            tp_m = match_predictions(d[:, 5], cls, iou_m) if k else np.zeros((0, IOUV.size), bool)
            mask_m.update(tp_m, d[:, 4], d[:, 5], cls)

    def __call__(self, model, batches: Optional[Iterable[Mapping]] = None, names: Optional[Dict[int, str]] = None,
                 n_images: Optional[int] = None) -> Dict[str, float]:
        if batches is None:
            data, dataset, batches = self._setup(model)
            names, n_images = data["names"], len(dataset)
        box_m, task_m = DetMetrics(names), DetMetrics(names)
        seen, t0 = 0, time.time()
        for batch in batches:
            imgs = torch.as_tensor(np.asarray(batch["img"])).to(model.device)
            det, counts, extra = (t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
                                  for t in self.infer(model, imgs))
            n = len(det) if n_images is None else min(len(det), n_images - seen)
            if n <= 0:
                break
            self.score_batch(box_m, task_m, det, counts, extra, batch, n)
            seen += n
        bs, ts = box_m.result(), task_m.result()
        if self.args.verbose:
            dt = time.time() - t0
            LOGGER.info(f"val[{self.task}]: {seen} images  box mAP50 {bs['mAP50']:.3f} mAP50-95 {bs['mAP50-95']:.3f} | "
                        f"{self.family} mAP50 {ts['mAP50']:.3f} mAP50-95 {ts['mAP50-95']:.3f} "
                        f"({seen / max(dt, 1e-9):.1f} img/s)")
        out = {f"box_{k}": v for k, v in bs.items() if isinstance(v, float)}
        out.update({f"{self.family}_{k}": v for k, v in ts.items() if isinstance(v, float)})
        out["fitness"] = (bs["fitness"] + ts["fitness"]) / 2
        out.update({k: v for k, v in bs.items() if k in ("mAP50", "mAP50-95", "precision", "recall")})
        return out


class PoseValidator(SegmentationValidator):
    """``PoseValidator(overrides)(model)`` on ``overrides['data']`` (a pose
    dataset), or ``(model, batches, names, n_images=None)`` on batches in
    memory that also hold ``keypoints`` (B, M, nk, 3) normalised -> the
    stats: ``box_*`` and ``pose_*`` (precision, recall, mAP50, mAP50-95,
    fitness), the box family's under their plain names, and ``fitness``,
    the mean of the two fitnesses."""

    task, family = "pose", "pose"

    def score_batch(self, box_m: DetMetrics, pose_m: DetMetrics, det: np.ndarray, counts: np.ndarray,
                    pkpts: np.ndarray, batch: Mapping, n: Optional[int] = None) -> None:
        """The host part for the first ``n`` images of one batch: box and OKS
        matching (the sigmas of the keypoints' shape), ``box_m.update`` and
        ``pose_m.update``."""
        ih, iw = np.asarray(batch["img"]).shape[1:3]
        sigmas = kpt_sigmas(pkpts.shape[2:])
        for i in range(len(det) if n is None else n):
            k = int(counts[i])
            d = det[i, :k]
            gain, padw, padh = np.asarray(batch["ratio_pad"][i])
            oh, ow = np.asarray(batch["ori_shape"][i])
            pb = _to_ori(d[:, :4], gain, padw, padh, oh, ow)
            gt, cls, m = _gt_boxes(batch, i, ih, iw)
            gt = _to_ori(gt, gain, padw, padh, oh, ow, clip=False)
            iou = box_iou_np(pb, gt) if k else np.zeros((0, len(gt)))
            tp_b = match_predictions(d[:, 5], cls, iou) if k else np.zeros((0, IOUV.size), bool)
            box_m.update(tp_b, d[:, 4], d[:, 5], cls)

            pk = pkpts[i, :k].copy()  # (k, nk, nd) letterbox pixels
            pk[..., 0] = (pk[..., 0] - padw) / gain
            pk[..., 1] = (pk[..., 1] - padh) / gain
            gk = np.asarray(batch["keypoints"][i])[m].copy()  # normalised
            gk[..., 0] = (gk[..., 0] * iw - padw) / gain
            gk[..., 1] = (gk[..., 1] * ih - padh) / gain
            area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) * 0.53
            oks = kpt_oks_np(pk, gk, area, sigmas) if k and len(gk) else np.zeros((k, len(gk)))
            tp_p = match_predictions(d[:, 5], cls, oks) if k else np.zeros((0, IOUV.size), bool)
            pose_m.update(tp_p, d[:, 4], d[:, 5], cls)


class OBBValidator(DetectionValidator):
    """``OBBValidator(overrides)(model)`` on ``overrides['data']`` (an obb
    dataset), or ``(model, batches, names, n_images=None)`` on batches in
    memory whose ``bboxes`` are (B, M, 5) normalised xywh and the angle in
    radians -> the stats (precision, recall, mAP50, mAP50-95, fitness) of
    ProbIoU matching. No COCO records are kept."""

    task = "obb"

    def __init__(self, overrides: Optional[Dict] = None):
        super().__init__(overrides)
        self.args.task = self.task

    def nms(self, rboxes: torch.Tensor, scores: torch.Tensor):
        """Rotated NMS on decoded (B, A, 5) xywhr boxes and (B, A, nc) scores ->
        (detections (B, max_det, 7), counts (B,))."""
        a = self.args
        return nms_rotated(rboxes, scores, conf_thres=float(a.conf), iou_thres=float(a.iou), max_det=int(a.max_det))

    @torch.no_grad()
    def infer(self, model, imgs: torch.Tensor):
        """The card part: (B, H, W, 3) uint8 -> (detections (B, max_det, 7)
        [xywhr, conf, cls] in letterbox pixels, counts (B,)), the images
        normalised in f32 and cast to the model's compute dtype, the model in
        eval mode."""
        x = (imgs.permute(0, 3, 1, 2).float() / 255.0).to(model.dtype).contiguous()
        training = model.training
        model.eval()
        try:
            return self.nms(*model.predict(x))
        finally:
            model.train(training)

    def score_batch(self, metrics: DetMetrics, det: np.ndarray, counts: np.ndarray, batch: Mapping,
                    n: Optional[int] = None, first_id: int = 0) -> List[dict]:
        """The host part for the first ``n`` images of one batch: the xywhr
        boxes to original-image space, ProbIoU matching, ``metrics.update``."""
        ih, iw = np.asarray(batch["img"]).shape[1:3]
        for i in range(len(det) if n is None else n):
            k = int(counts[i])
            d = det[i, :k]  # (k, 7) letterbox space
            gain, padw, padh = np.asarray(batch["ratio_pad"][i])
            pr = d[:, :5].copy()
            pr[:, 0] = (pr[:, 0] - padw) / gain
            pr[:, 1] = (pr[:, 1] - padh) / gain
            pr[:, 2:4] /= gain
            m = np.asarray(batch["mask"][i]).astype(bool)
            cls = np.asarray(batch["cls"][i])[m].astype(np.float32)
            gr = np.asarray(batch["bboxes"][i])[m].copy()  # (M, 5) normalised xywhr
            gr[:, 0] = (gr[:, 0] * iw - padw) / gain
            gr[:, 1] = (gr[:, 1] * ih - padh) / gain
            gr[:, 2] = gr[:, 2] * iw / gain
            gr[:, 3] = gr[:, 3] * ih / gain
            if k and len(gr):
                iou = probiou(torch.from_numpy(pr)[:, None], torch.from_numpy(gr.astype(np.float32))[None]).numpy()
            else:
                iou = np.zeros((k, len(gr)))
            tp = match_predictions(d[:, 6], cls, iou) if k else np.zeros((0, IOUV.size), bool)
            metrics.update(tp, d[:, 5], d[:, 6], cls)
        return []


TASK_VALIDATORS = {"segment": SegmentationValidator, "pose": PoseValidator, "obb": OBBValidator}
