"""Bootstrap comparison of two models' mAP50: the fork's ``testandcox.py``.

Port of ``scripts/compare_models.py``: each model's per-image matches are
computed once through ``YOLO.predict`` (conf 0.001, the predictor's default
NMS: soft), then each of the bootstrap subsamples' mAP50 is scored from them
and the paired score vectors go to ``utils/stats.py:compare_scores``. The
predictor's soft NMS is not the validator's multi-label pool, so a full set's
mAP50 here is not the validator's.

Usage (the card by default; ``device=cpu`` for the CPU)::

    python -m experiment_yolo_torch.compare_models model_a=<a.pt> model_b=<b.pt> data=<data.yaml> \
        [split=val n_bootstrap=30 fraction=0.5 imgsz=640 device=cuda]
"""

from __future__ import annotations

import sys
from typing import List, Sequence, Tuple

import numpy as np

from experiment_yolo_torch.cfg.cli import parse_key_value
from experiment_yolo_torch.data.dataset import YOLODataset, check_det_dataset
from experiment_yolo_torch.engine.model import YOLO
from experiment_yolo_torch.utils import LOGGER
from experiment_yolo_torch.utils.metrics import IOUV, DetMetrics, box_iou_np, match_predictions
from experiment_yolo_torch.utils.stats import bootstrap_indices, compare_scores

ImageStats = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]  # (tp, conf, pred_cls, target_cls)


def per_image_stats(model: YOLO, ds: YOLODataset, imgsz: int, conf: float = 0.001) -> List[ImageStats]:
    """Each image's (tp (n, 10), conf, pred_cls, target_cls), computed once,
    so that every bootstrap subsample reuses them (the reference validates
    each subsample again; the statistics are the same)."""
    stats = []
    for i in range(len(ds)):
        item = ds._load_item(i)
        d = model.predict(item["img"], conf=conf, imgsz=imgsz)[0].boxes.data
        gt_cls = item["cls"]
        if len(d) == 0:
            tp = np.zeros((0, IOUV.size), bool)
        else:
            iou = box_iou_np(d[:, :4], item["bboxes"]) if len(gt_cls) else np.zeros((len(d), 0))
            tp = match_predictions(d[:, 5], gt_cls, iou)
        stats.append((tp, d[:, 4], d[:, 5], gt_cls))
    return stats


def map50_of_subset(stats: Sequence[ImageStats], idx) -> float:
    """mAP50 of the images ``idx`` (repeats count again) from their per-image stats."""
    m = DetMetrics()
    for i in idx:
        m.update(*stats[i])
    return m.result()["mAP50"]


def main(argv: List[str]) -> None:
    kv = parse_key_value(argv)
    imgsz = int(kv.get("imgsz", 640))
    device = str(kv.get("device", "cuda"))
    data = check_det_dataset(kv["data"])
    ds = YOLODataset(data[kv.get("split", "val")], imgsz=imgsz, augment=False, device=device)
    model_a, model_b = YOLO(kv["model_a"], device=device), YOLO(kv["model_b"], device=device)
    LOGGER.info("precomputing per-image stats (model A)...")
    stats_a = per_image_stats(model_a, ds, imgsz)
    LOGGER.info("precomputing per-image stats (model B)...")
    stats_b = per_image_stats(model_b, ds, imgsz)
    idxs = bootstrap_indices(len(ds), int(kv.get("n_bootstrap", 30)), float(kv.get("fraction", 0.5)))
    a = np.asarray([map50_of_subset(stats_a, i) for i in idxs])
    b = np.asarray([map50_of_subset(stats_b, i) for i in idxs])
    r = compare_scores(a, b)
    LOGGER.info(f"model A mAP50: {a.mean():.4f} +/- {a.std():.4f}")
    LOGGER.info(f"model B mAP50: {b.mean():.4f} +/- {b.std():.4f}")
    LOGGER.info(r.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
