"""The validation slice against the JAX package: the metrics, multi-label NMS
over the validator's pool of 4,096, the validator's host part on the same raw
``(boxes, scores)``, and the whole ``DetectionValidator`` on the same weights
and synthetic split, with soft-NMS in quirk mode (``PARITY.md``'s protocol)
and with hard NMS.

Inputs are made from numpy seeds; the split is the JAX package's
``make_synthetic_dataset``, read by its val ``DataLoader``, whose batches go to
both validators as they are.

The JAX LD-P2 takes its LDConv layers on the gather path (``sampling='gather'``,
what K3 computes), as ``tests/test_torch_port_amp.py``'s: the default ``auto``
compiles a dense hat window as well, a TPU workaround the port does not carry
(ROADMAP catalogue item 5), for a minute of compile a train step.
"""

import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiment_yolo_tpu.engine.validator as jvalidator
from experiment_yolo_torch import DetectionModel as TorchModel
from experiment_yolo_torch import DetectionValidator as TorchValidator
from experiment_yolo_torch.nn.tasks import yaml_model_load
from experiment_yolo_torch.ops.nms import non_max_suppression as t_nms
from experiment_yolo_torch.utils import metrics as tmetrics
from experiment_yolo_torch.utils.seeded import he_normal_
from experiment_yolo_tpu.data import make_synthetic_dataset
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.ops.nms import non_max_suppression as j_nms
from experiment_yolo_tpu.utils import metrics as jmetrics
from experiment_yolo_tpu.utils.torch_convert import convert_state_dict
from test_torch_port_amp import _gather_ldconv

NC, IMGSZ, BATCH, N_VAL = 3, 128, 2, 6
PROTOCOLS = {"soft-quirk": {"nms_type": "soft", "soft_nms_quirk": True},
             "hard": {"nms_type": "hard", "soft_nms_quirk": False}}


def _made_up_predictions(rng, gt, gt_cls, n_noise=40):
    """xyxy predictions (N, 6) [box, conf, cls] near the ground truth (three
    jittered copies of each box, one of them of the wrong class, mostly
    scoring higher) plus random ones: a mix of true and false positives at
    every IoU threshold."""
    near = np.repeat(gt, 3, 0) + rng.normal(0, 3, (3 * len(gt), 4))
    cls = np.repeat(gt_cls, 3)
    cls[2::3] = (cls[2::3] + 1) % NC
    xy = rng.uniform(0, 200, (n_noise, 2))
    noise = np.concatenate([xy, xy + rng.uniform(5, 60, (n_noise, 2))], 1)
    boxes = np.concatenate([near, noise]).astype(np.float32)
    conf = np.concatenate([rng.uniform(0.3, 1.0, len(near)), rng.uniform(0.01, 0.6, n_noise)]).astype(np.float32)
    return np.concatenate([boxes, conf[:, None], np.concatenate([cls, rng.integers(0, NC, n_noise)])[:, None]], 1)


def _made_up_ground_truth(rng, m):
    xy = rng.uniform(0, 150, (m, 2))
    return np.concatenate([xy, xy + rng.uniform(8, 60, (m, 2))], 1).astype(np.float32), rng.integers(0, NC, m)


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    """``match_predictions``, ``ap_per_class``, ``DetMetrics.result`` and
    ``ConfusionMatrix.process_batch`` equal the JAX package's on made-up
    images (one with no ground truth, one with no prediction), with nonzero mAP."""
    rng = np.random.default_rng(seed)
    t_det, j_det = tmetrics.DetMetrics(), jmetrics.DetMetrics()
    t_cm, j_cm = tmetrics.ConfusionMatrix(NC), jmetrics.ConfusionMatrix(NC)
    for i in range(6):
        gt, gt_cls = _made_up_ground_truth(rng, 0 if i == 4 else int(rng.integers(1, 8)))
        pred = _made_up_predictions(rng, gt, gt_cls)[: 0 if i == 5 else None]
        iou = tmetrics.box_iou_np(pred[:, :4], gt)
        np.testing.assert_array_equal(iou, jmetrics.box_iou_np(pred[:, :4], gt))
        tp = tmetrics.match_predictions(pred[:, 5], gt_cls.astype(np.float32), iou)
        np.testing.assert_array_equal(tp, jmetrics.match_predictions(pred[:, 5], gt_cls.astype(np.float32), iou))
        t_det.update(tp, pred[:, 4], pred[:, 5], gt_cls)
        j_det.update(tp, pred[:, 4], pred[:, 5], gt_cls)
        t_cm.process_batch(pred if len(pred) else None, gt, gt_cls)
        j_cm.process_batch(pred if len(pred) else None, gt, gt_cls)
    stats = t_det.result()
    assert stats == j_det.result() and stats["mAP50"] > 0.1 and stats["mAP50-95"] > 0.02
    r, jr = t_det.per_class, j_det.per_class
    for k in ("p", "r", "f1", "ap", "unique_classes", "nt"):
        np.testing.assert_array_equal(r[k], jr[k], err_msg=k)
    np.testing.assert_array_equal(t_cm.matrix, j_cm.matrix)
    for a, b in zip(t_cm.tp_fp(), j_cm.tp_fp()):
        np.testing.assert_array_equal(a, b)
    assert t_cm.matrix.trace() > 0


def _pool_inputs(seed, b=2, a=2400):
    """Clustered xywh boxes (B, A, 4) and (B, A, NC) scores: at conf 0.001
    nearly every one of the A * NC = 14,400 (anchor, class) pairs passes, so
    the pool of 4,096 drops most; the first anchor scores just above conf, so
    the quirk's first box (flat index 0) lies outside the pool."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 300, (b, a // 6, 2)).repeat(6, 1) + rng.normal(0, 4, (b, a, 2))
    boxes = np.concatenate([centres, rng.uniform(8, 50, (b, a, 2))], -1).astype(np.float32)
    scores = rng.beta(0.6, 2.0, (b, a, NC)).astype(np.float32)
    scores[:, 0] = 0.0015
    return boxes, scores


@pytest.mark.parametrize("protocol", [*PROTOCOLS, "soft"])
def test_multi_label_nms_matches_jax(protocol):
    """The validator's NMS (``multi_label``, ``pre_nms_topk=4096``, conf
    0.001): identical counts, detections within 1e-5."""
    boxes, scores = _pool_inputs(3)
    flat = scores.reshape(len(scores), -1)
    assert ((flat > 0.001).sum(-1) > 4096).all()
    assert ((flat > flat[:, :1]).sum(-1) >= 4096).all(), "the first flat index should fall outside the pool"
    p = PROTOCOLS.get(protocol, {"nms_type": "soft", "soft_nms_quirk": False})
    kw = dict(conf_thres=0.001, iou_thres=0.7, max_det=300, multi_label=True, pre_nms_topk=4096,
              nms_type=p["nms_type"], soft_first_quirk=p["soft_nms_quirk"])
    td, tn = t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    jd, jn = j_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.min() > 50
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
    # the pool holds classes of one anchor side by side: some detections share a box
    assert len(np.unique(td[0, : int(tn[0]), :4].numpy(), axis=0)) < int(tn[0])


@pytest.fixture(scope="module")
def split():
    """The synthetic val split (``make_synthetic_dataset``, 6 images at 128
    px, 3 classes) and the batches of 2 the JAX val ``DataLoader`` yields
    from it (the last one padded)."""
    root = Path(tempfile.mkdtemp())
    data = make_synthetic_dataset(root / "ds", n_train=1, n_val=N_VAL, imgsz=IMGSZ, max_objects=8)
    jv = jvalidator.DetectionValidator(args={"data": str(data), "imgsz": IMGSZ, "batch": BATCH})
    _, dataset, loader, _ = jv._setup(SimpleNamespace(strides=(4, 8, 16)))
    batches = list(loader)
    assert len(dataset) == N_VAL and len(batches) == 3
    return SimpleNamespace(data=str(data), batches=batches, names={i: str(i) for i in range(NC)})


class _Recording(jmetrics.DetMetrics):
    """The JAX ``DetMetrics`` that keeps the last instance, so that a test can
    read the TP matrices the JAX validator matched."""

    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _Recording.last = self


def _raw_outputs(batch, seed):
    """Made-up raw model outputs for one batch, as a detector's decode gives
    them: xywh boxes (B, 400, 4) in letterbox pixels and scores (B, 400, NC),
    with three jittered copies of each ground-truth box scoring high in its
    class and the rest random."""
    rng = np.random.default_rng(seed)
    b = len(batch["img"])
    boxes = np.concatenate([rng.uniform(0, IMGSZ, (b, 400, 2)), rng.uniform(4, 40, (b, 400, 2))], -1)
    scores = rng.uniform(0, 0.3, (b, 400, NC))
    for i in range(b):
        m = batch["mask"][i]
        gt = batch["bboxes"][i][m] * IMGSZ
        for j, (box, c) in enumerate(zip(gt, batch["cls"][i][m].astype(int))):
            boxes[i, 3 * j: 3 * j + 3] = box + rng.normal(0, 1.5, (3, 4))
            scores[i, 3 * j: 3 * j + 3, c] = rng.uniform(0.4, 0.99, 3)
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_host_part_matches_jax_on_the_same_outputs(split, protocol, monkeypatch):
    """The same raw ``(boxes, scores)`` through each validator's NMS and host
    part (the JAX one through a stand-in model's ``forward_host``, the path
    of an exported model): identical TP matrices, image by image, and
    identical stats, with nonzero mAP."""
    raw = {batch["img"].tobytes(): _raw_outputs(batch, k) for k, batch in enumerate(split.batches)}
    model = SimpleNamespace(strides=(4, 8, 16), forward_host=lambda imgs: raw[np.asarray(imgs).tobytes()])
    monkeypatch.setattr(jvalidator, "DetMetrics", _Recording)
    args = {"data": split.data, "imgsz": IMGSZ, "batch": BATCH, "verbose": False, **PROTOCOLS[protocol]}
    jstats = jvalidator.DetectionValidator(args=args)(model, None)
    tv = TorchValidator({"verbose": False, **PROTOCOLS[protocol]})
    metrics, seen = tmetrics.DetMetrics(split.names), 0
    for batch in split.batches:
        det, counts = (t.numpy() for t in tv.nms(*(torch.from_numpy(a) for a in raw[batch["img"].tobytes()])))
        n = min(len(det), N_VAL - seen)
        tv.score_batch(metrics, det, counts, batch, n, first_id=seen)
        seen += n
    assert len(metrics._tp) == len(_Recording.last._tp) == N_VAL
    for a, b in zip(metrics._tp, _Recording.last._tp):
        np.testing.assert_array_equal(a, b)
    stats = metrics.result()
    assert stats == jstats and stats["mAP50"] > 0.3


@pytest.fixture(scope="module")
def weights():
    """LD-P2 n with 3 classes, the port's seeded init with He-normal convs,
    moved into JAX with the JAX package's ``convert_state_dict``. The last
    box conv is shrunk (weights times 0.05, bins peaked at 2) so that boxes
    are two strides to a side, the size of the split's objects: with random
    weights no box would match a ground truth, and mAP would be 0 on both
    sides."""
    cfg = yaml_model_load("yolov8-LD-P2.yaml")
    cfg["nc"] = NC
    tm = TorchModel(cfg, device="cpu")
    he_normal_(tm, 3)
    with torch.no_grad():
        bins = torch.arange(16, dtype=torch.float32)
        for box in tm.detect.cv2:
            box[-1].weight.mul_(0.05)
            box[-1].bias.copy_((-(bins - 2.0) ** 2 / 2).repeat(4))
    with _gather_ldconv():
        jm = JaxModel("yolov8-LD-P2.yaml", nc=NC)
    variables = convert_state_dict({k: v.numpy() for k, v in tm.state_dict().items()
                                    if not k.endswith("num_batches_tracked")}, jm)
    return tm, jm, variables


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_validator_matches_jax_end_to_end(split, weights, protocol):
    """The port's ``DetectionValidator`` and the JAX one on the same weights
    and batches: mAP50 and mAP50-95 within 1e-4, and within 1e-3 of each
    other relative (an untrained detector's mAP is small, so the absolute
    bound alone would hold for anything); precision and recall alike."""
    tm, jm, variables = weights
    args = {"verbose": False, **PROTOCOLS[protocol]}
    jstats = jvalidator.DetectionValidator(args={"data": split.data, "imgsz": IMGSZ, "batch": BATCH, **args})(
        jm, variables)
    stats = TorchValidator(args)(tm, split.batches, split.names, n_images=N_VAL)
    assert stats["mAP50"] > 0
    for k in ("precision", "recall", "mAP50", "mAP50-95"):
        assert abs(stats[k] - jstats[k]) <= 1e-4, (k, stats[k], jstats[k])
        assert abs(stats[k] - jstats[k]) <= 1e-3 * abs(jstats[k]), (k, stats[k], jstats[k])


def test_validator_refuses_plots_and_metrics_refuse_figures():
    with pytest.raises(NotImplementedError, match="catalogue item 15"):
        TorchValidator({"plots": True})
    with pytest.raises(NotImplementedError, match="catalogue item 15"):
        tmetrics.DetMetrics().plot("out")
    with pytest.raises(NotImplementedError, match="catalogue item 15"):
        tmetrics.ConfusionMatrix(NC).plot("out.png")
    assert TorchValidator().args.conf == 0.001 and TorchValidator({"conf": 0.1}).args.conf == 0.1


def test_validator_saves_coco_records_and_keeps_the_model_mode(tmp_path):
    """``save_json`` writes one COCO-style record per detection (image ids
    counted across batches, the padded tail cut by ``n_images``); the model
    runs in eval mode and comes back in the mode it came in."""
    import json

    from experiment_yolo_torch.utils.seeded import seeded_batch

    model = TorchModel("yolov8-LD-P2.yaml", device="cpu")
    he_normal_(model, 1)  # class-bias priors at 0: scores above conf
    model.train()
    batch = {**seeded_batch(2, 64, 0), "ori_shape": np.full((2, 2), 64),
             "ratio_pad": np.tile(np.float32([1, 0, 0]), (2, 1))}
    running = [m.running_mean.clone() for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    TorchValidator({"save_json": True, "project": str(tmp_path), "verbose": False})(model, [batch, batch], model.names,
                                                                                     n_images=3)
    records = json.loads((tmp_path / "predictions.json").read_text())
    assert model.training and {r["image_id"] for r in records} == {0, 1, 2}
    assert all(set(r) == {"image_id", "category_id", "bbox", "score"} and r["score"] > 0.001 for r in records)
    after = [m.running_mean for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert all(torch.equal(a, b) for a, b in zip(running, after))
