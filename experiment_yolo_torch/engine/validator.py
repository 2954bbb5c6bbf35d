"""Detection validator: forward -> decode -> multi-label NMS -> matching -> mAP.

Port of ``experiment_yolo_tpu/engine/validator.py:DetectionValidator``. The
card part (:meth:`DetectionValidator.infer`:
normalise, forward, decode with kernel K1, NMS with ``multi_label`` over a
pool of 4,096 (kernel K5 for soft, K2 for hard)) runs where the model lives;
the host part (:meth:`DetectionValidator.score_batch`: boxes and ground truth
back to original-image space, matching, ``DetMetrics``) is numpy, as in the
JAX package, so that mAP numbers are comparable.

Called with a model alone it reads ``args.data``'s ``split`` through the
port's val ``DataLoader`` (letterboxed, ``rect`` batches if asked, the last
batch padded and cut back to the dataset's length); the dataset and the loader
are built once per (model, data, imgsz, batch), so the trainer's per-epoch
validation of its EMA model scans the split once. Batches in memory, as the
JAX val ``DataLoader`` yields them, are taken too.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch

from experiment_yolo_torch.cfg import check_imgsz, get_cfg
from experiment_yolo_torch.data.build import DataLoader, build_yolo_dataset
from experiment_yolo_torch.data.dataset import check_det_dataset
from experiment_yolo_torch.ops.nms import non_max_suppression
from experiment_yolo_torch.utils import LOGGER
from experiment_yolo_torch.utils.metrics import IOUV, DetMetrics, box_iou_np, match_predictions

VAL_PRE_NMS_TOPK = 4096  # the JAX validator's pool at conf 0.001 (the reference's max_nms is 30,000)


class DetectionValidator:
    """``DetectionValidator(overrides)(model)`` on ``overrides['data']``, or
    ``DetectionValidator(overrides)(model, batches, names, n_images=None)`` on
    batches in memory -> the stats dict (precision, recall, mAP50, mAP50-95,
    fitness).

    ``overrides`` are ``default.yaml`` keys; ``conf`` defaults to 0.001, and
    ``nms_type`` and ``soft_nms_quirk`` choose the NMS. ``plots=True`` raises:
    the figures are not ported (ROADMAP.md catalogue item 15).
    """

    def __init__(self, overrides: Optional[Dict] = None):
        self.args = get_cfg(overrides)
        if self.args.conf is None:
            self.args.conf = 0.001
        if self.args.plots:
            raise NotImplementedError("plots=True draws figures, which are not ported to experiment_yolo_torch yet "
                                      "(utils/plotting.py, ROADMAP.md catalogue item 15)")
        self._cache_key = self._data = self._dataset = self._loader = None

    def _setup(self, model):
        """The split's dataset and val loader, built once per (model, data,
        imgsz, batch)."""
        args = self.args
        args.imgsz = check_imgsz(int(args.imgsz), max(model.stride))
        key = (id(model), str(args.data), int(args.imgsz), int(args.batch))
        if self._cache_key != key:
            data = check_det_dataset(args.data)
            split = data.get(args.split or "val") or data["val"]
            dataset = build_yolo_dataset(args, split, mode="val", device=model.device, data=data)
            loader = DataLoader(dataset, args.batch, shuffle=False, workers=args.workers, drop_last=False,
                                rect=bool(args.rect), stride=max(model.stride))
            self._cache_key, self._data, self._dataset, self._loader = key, data, dataset, loader
        return self._data, self._dataset, self._loader

    def nms(self, boxes: torch.Tensor, scores: torch.Tensor):
        """The validator's NMS on decoded (B, A, 4) xywh boxes and (B, A, nc)
        scores -> (detections (B, max_det, 6), counts (B,))."""
        a = self.args
        return non_max_suppression(boxes, scores, conf_thres=float(a.conf), iou_thres=float(a.iou),
                                   max_det=int(a.max_det), nms_type=str(a.nms_type or "soft"),
                                   soft_first_quirk=bool(a.soft_nms_quirk), multi_label=True,
                                   pre_nms_topk=VAL_PRE_NMS_TOPK)

    @torch.no_grad()
    def infer(self, model, imgs: torch.Tensor):
        """The card part: (B, H, W, 3) uint8 on the model's device ->
        (detections (B, max_det, 6) in letterbox pixels, counts (B,)). The
        model runs in eval mode, as the JAX package's ``predict`` does (a
        model in training mode is put back in it afterwards). The images are
        normalised in the model's compute dtype."""
        x = (imgs.permute(0, 3, 1, 2).to(model.dtype) / 255.0).contiguous()
        training = model.training
        model.eval()
        try:
            return self.nms(*model.predict(x))
        finally:
            model.train(training)

    def score_batch(self, metrics: DetMetrics, det: np.ndarray, counts: np.ndarray, batch: Mapping,
                    n: Optional[int] = None, first_id: int = 0) -> List[dict]:
        """The host part for the first ``n`` images of one batch (all by
        default): detections and ground truth to original-image space,
        matching, ``metrics.update``. Returns COCO-style records (``image_id``
        counts images from ``first_id``) of the detections."""
        imgsz_h, imgsz_w = np.asarray(batch["img"]).shape[1:3]
        records = []
        for i in range(len(det) if n is None else n):
            k = int(counts[i])
            d = det[i, :k]  # (k, 6) letterbox space
            gain, padw, padh = np.asarray(batch["ratio_pad"][i])
            oh, ow = np.asarray(batch["ori_shape"][i])
            pb = d[:, :4].copy()
            pb[:, [0, 2]] = (pb[:, [0, 2]] - padw) / gain
            pb[:, [1, 3]] = (pb[:, [1, 3]] - padh) / gain
            pb[:, [0, 2]] = pb[:, [0, 2]].clip(0, ow)
            pb[:, [1, 3]] = pb[:, [1, 3]].clip(0, oh)
            # ground truth: normalised xywh on the letterboxed image -> original xyxy
            m = np.asarray(batch["mask"][i]).astype(bool)
            gx = np.asarray(batch["bboxes"][i])[m] * np.asarray([imgsz_w, imgsz_h, imgsz_w, imgsz_h])
            cls = np.asarray(batch["cls"][i])[m].astype(np.float32)
            gt = np.stack([gx[:, 0] - gx[:, 2] / 2, gx[:, 1] - gx[:, 3] / 2,
                           gx[:, 0] + gx[:, 2] / 2, gx[:, 1] + gx[:, 3] / 2], 1)
            gt[:, [0, 2]] = (gt[:, [0, 2]] - padw) / gain
            gt[:, [1, 3]] = (gt[:, [1, 3]] - padh) / gain
            tp = np.zeros((0, IOUV.size), bool) if k == 0 else match_predictions(d[:, 5], cls, box_iou_np(pb, gt))
            metrics.update(tp, d[:, 4], d[:, 5], cls)
            records += [{"image_id": first_id + i, "category_id": int(d[j, 5]),
                         "bbox": [float(pb[j, 0]), float(pb[j, 1]), float(pb[j, 2] - pb[j, 0]),
                                  float(pb[j, 3] - pb[j, 1])], "score": float(d[j, 4])} for j in range(k)]
        return records

    def __call__(self, model, batches: Optional[Iterable[Mapping]] = None, names: Optional[Dict[int, str]] = None,
                 n_images: Optional[int] = None) -> Dict[str, float]:
        """Validate ``model`` where it lives: on ``args.data``'s split when no
        ``batches`` are given, else on ``batches``: dicts of ``img`` (B, H, W,
        3) uint8 RGB letterboxed, ``bboxes`` (B, M, 4) normalised xywh on the
        letterboxed image, ``cls`` and ``mask`` (B, M), ``ori_shape`` (B, 2)
        and ``ratio_pad`` (B, 3) = (gain, padw, padh), with ``names``;
        ``n_images`` cuts the padded tail of the last batch. COCO-style
        ``image_id`` is the image file's stem on a dataset, the image's index
        in ``batches``."""
        args = self.args
        stems = None
        if batches is None:
            data, dataset, batches = self._setup(model)
            names, n_images = data["names"], len(dataset)
            stems = [Path(dataset.im_files[i]).stem for i in batches.image_order()]
        metrics = DetMetrics(names)
        seen, records = 0, []
        t0 = time.time()
        for batch in batches:
            imgs = torch.as_tensor(np.asarray(batch["img"])).to(model.device)
            det, counts = (t.cpu().numpy() for t in self.infer(model, imgs))
            n = len(det) if n_images is None else min(len(det), n_images - seen)
            if n <= 0:
                break
            records += self.score_batch(metrics, det, counts, batch, n, first_id=seen)
            seen += n
        if stems:
            for r in records:
                r["image_id"] = stems[r["image_id"]]
        if args.save_json:
            out = Path(args.project or "runs/detect") / "predictions.json"
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(records))
            LOGGER.info(f"val: saved {len(records)} detections to {out}")
        stats = metrics.result()
        dt = time.time() - t0
        if args.verbose:
            LOGGER.info(f"val: {seen} images  P {stats['precision']:.3f}  R {stats['recall']:.3f}  "
                        f"mAP50 {stats['mAP50']:.3f}  mAP50-95 {stats['mAP50-95']:.3f}  "
                        f"({seen / max(dt, 1e-9):.1f} img/s)")
        return stats
