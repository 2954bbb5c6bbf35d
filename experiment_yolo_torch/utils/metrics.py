"""Detection metrics: IoU matching, per-class AP, DetMetrics, ConfusionMatrix.

Port of ``experiment_yolo_tpu/utils/metrics.py`` (itself the reference's
``utils/metrics.py:903-1405`` and the validator's ``match_predictions``):
101-point interpolated AP, precision and recall at the max-F1 confidence,
fitness = 0.1 * mAP50 + 0.9 * mAP50-95. Host-side numpy, as in the JAX
package. The figures (``plot``) wait for ``utils/plotting.py``, ROADMAP.md
catalogue item 15.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz
_NO_PLOTS = "figures are not ported to experiment_yolo_torch yet (utils/plotting.py, ROADMAP.md catalogue item 15)"


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU (N,4) x (M,4) xyxy -> (N,M), numpy."""
    a1 = box1[:, None, :2]
    a2 = box1[:, None, 2:4]
    b1 = box2[None, :, :2]
    b2 = box2[None, :, 2:4]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(-1)
    area1 = np.clip(box1[:, 2:4] - box1[:, :2], 0, None).prod(-1)
    area2 = np.clip(box2[:, 2:4] - box2[:, :2], 0, None).prod(-1)
    return inter / (area1[:, None] + area2[None] - inter + eps)


IOUV = np.linspace(0.5, 0.95, 10)  # mAP@0.5:0.95 thresholds


def match_predictions(pred_classes: np.ndarray, true_classes: np.ndarray, iou: np.ndarray) -> np.ndarray:
    """TP matrix (N, 10) of predictions (N,) against ground truth (M,) with
    their IoU (N, M): for each threshold, (gt, pred) pairs above it with
    matching class, sorted by IoU descending, each side used once."""
    correct = np.zeros((pred_classes.shape[0], IOUV.size), dtype=bool)
    correct_class = true_classes[None, :] == pred_classes[:, None]  # (N, M)
    iou = np.where(correct_class, iou, 0.0)
    for i, thr in enumerate(IOUV):
        pred_i, gt_i = np.nonzero(iou >= thr)
        if pred_i.size:
            ious = iou[pred_i, gt_i]
            order = ious.argsort()[::-1]
            pred_i, gt_i = pred_i[order], gt_i[order]
            _, keep_p = np.unique(pred_i, return_index=True)
            # unique gt first on the already-pred-unique set (reference order)
            pred_i, gt_i = pred_i[np.sort(keep_p)], gt_i[np.sort(keep_p)]
            _, keep_g = np.unique(gt_i, return_index=True)
            pred_i = pred_i[np.sort(keep_g)]
            correct[pred_i, i] = True
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP (reference metrics.py:1109)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray,
                 eps: float = 1e-16) -> Dict[str, np.ndarray]:
    """Per-class precision, recall and AP of predictions ``tp`` (N, 10) bool,
    ``conf`` (N,), ``pred_cls`` (N,) against ``target_cls`` (Ngt,): a dict
    with p, r, f1 (at the max-F1 confidence, as the reference reports them),
    ap (nc_present, 10), unique_classes and nt."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    x = np.linspace(0, 1, 1000)
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = nt[ci]
        n_p = i.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-x, -conf[i], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-x, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j] = compute_ap(recall[:, j], precision[:, j])[0]
    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = int(smooth(f1_curve.mean(0), 0.1).argmax())
    return {"p": p_curve[:, i], "r": r_curve[:, i], "f1": f1_curve[:, i], "ap": ap,
            "unique_classes": unique_classes.astype(int), "nt": nt}


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing (reference metrics.py:smooth)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]))
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


class ConfusionMatrix:
    """Detection confusion matrix (reference metrics.py:903).

    (nc+1) x (nc+1): last row/col is background (FP row, FN col). Matching
    at IoU >= iou_thres, predictions gated at conf >= conf_thres.
    """

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), dtype=np.int64)

    def process_batch(self, detections: np.ndarray, gt_bboxes: np.ndarray, gt_cls: np.ndarray) -> None:
        """detections (N, 6) [xyxy, conf, cls]; gt_bboxes (M, 4); gt_cls (M,)."""
        gt_cls = np.asarray(gt_cls, int)
        if detections is None or len(detections) == 0:
            for c in gt_cls:
                self.matrix[self.nc, c] += 1  # background FN
            return
        detections = detections[detections[:, 4] >= self.conf]
        det_cls = detections[:, 5].astype(int)
        if len(gt_cls) == 0:
            for c in det_cls:
                self.matrix[c, self.nc] += 1  # background FP
            return
        iou = box_iou_np(gt_bboxes, detections[:, :4])
        x = np.argwhere(iou >= self.iou_thres)
        if x.shape[0]:
            ious = iou[x[:, 0], x[:, 1]]
            order = ious.argsort()[::-1]
            x = x[order]
            # unique gt then unique det (reference's match dedup)
            _, keep_g = np.unique(x[:, 0], return_index=True)
            x = x[np.sort(keep_g)]
            _, keep_d = np.unique(x[:, 1], return_index=True)
            x = x[np.sort(keep_d)]
        matched_gt = set(x[:, 0].tolist()) if x.shape[0] else set()
        matched_det = set(x[:, 1].tolist()) if x.shape[0] else set()
        for gi, di in x:
            self.matrix[det_cls[di], gt_cls[gi]] += 1
        for gi, c in enumerate(gt_cls):
            if gi not in matched_gt:
                self.matrix[self.nc, c] += 1  # FN
        for di, c in enumerate(det_cls):
            if di not in matched_det:
                self.matrix[c, self.nc] += 1  # FP

    def tp_fp(self) -> Tuple[np.ndarray, np.ndarray]:
        tp = self.matrix.diagonal()[: self.nc]
        fp = self.matrix[: self.nc].sum(1) - tp
        return tp, fp

    def plot(self, *args, **kwargs):
        raise NotImplementedError(f"ConfusionMatrix.plot: {_NO_PLOTS}")


class DetMetrics:
    """Accumulates (tp, conf, pred_cls, target_cls) and computes the summary.

    fitness = 0.1 * mAP50 + 0.9 * mAP50-95 (reference metrics.py:1355).
    """

    def __init__(self, names: Dict[int, str] | None = None):
        self.names = names or {}
        self._tp: List[np.ndarray] = []
        self._conf: List[np.ndarray] = []
        self._pred_cls: List[np.ndarray] = []
        self._target_cls: List[np.ndarray] = []

    def update(self, tp, conf, pred_cls, target_cls):
        self._tp.append(tp)
        self._conf.append(conf)
        self._pred_cls.append(pred_cls)
        self._target_cls.append(target_cls)

    def result(self) -> Dict[str, float]:
        zero = {"precision": 0.0, "recall": 0.0, "mAP50": 0.0, "mAP50-95": 0.0, "fitness": 0.0}
        if not self._tp or sum(len(t) for t in self._target_cls) == 0:
            return zero
        tp = np.concatenate(self._tp)
        if tp.shape[0] == 0:
            return zero
        r = ap_per_class(tp, np.concatenate(self._conf), np.concatenate(self._pred_cls),
                         np.concatenate(self._target_cls))
        ap50 = r["ap"][:, 0].mean() if len(r["ap"]) else 0.0
        ap = r["ap"].mean() if len(r["ap"]) else 0.0
        self.per_class = r
        return {"precision": float(r["p"].mean()), "recall": float(r["r"].mean()), "mAP50": float(ap50),
                "mAP50-95": float(ap), "fitness": float(0.1 * ap50 + 0.9 * ap)}

    def plot(self, *args, **kwargs):
        raise NotImplementedError(f"DetMetrics.plot: {_NO_PLOTS}")
