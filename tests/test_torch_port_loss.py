"""The port's TAL assigner and detection loss against the JAX package.

Inputs come from a numpy seed and go through both packages: the assigner on
predictions built with ties on purpose, the loss on random raw head maps of a
three-level pyramid at 64 px, value and gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.ops.anchors import make_anchors as t_make_anchors
from experiment_yolo_torch.utils import tal as ttal
from experiment_yolo_torch.utils.loss import LossConfig as TLossConfig
from experiment_yolo_torch.utils.loss import detection_loss as t_loss
from experiment_yolo_tpu.utils import tal as jtal
from experiment_yolo_tpu.utils.loss import LossConfig as JLossConfig
from experiment_yolo_tpu.utils.loss import detection_loss as j_loss

NC, REG_MAX = 6, 16
SHAPES, STRIDES = [(16, 16), (8, 8), (4, 4)], (4, 8, 16)  # a 64 px input


def _labels(seed, b=2, m=6, imgsz=64):
    """Padded normalised xywh labels: 2..m boxes of 6..28 px per image."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(6, 28, (b, m, 2))
    xy = rng.uniform(wh / 2, imgsz - wh / 2)
    bboxes = (np.concatenate([xy, wh], -1) / imgsz).astype(np.float32)
    mask = np.arange(m)[None] < rng.integers(2, m + 1, (b, 1))
    return {"bboxes": bboxes * mask[..., None], "cls": rng.integers(0, NC, (b, m)).astype(np.int32), "mask": mask}


def _tied_predictions(seed, anchors_px, gt_xyxy, b=2):
    """Scores and xyxy boxes where many anchors tie: a third of them copy a
    neighbour's box and scores exactly, and a fifth score 0 (metric 0 inside
    their gt, as every anchor outside any gt has)."""
    rng = np.random.default_rng(seed)
    a = len(anchors_px)
    scores = rng.uniform(0.01, 0.99, (b, a, NC)).astype(np.float32)
    gi = rng.integers(0, gt_xyxy.shape[1], (b, a))
    target = np.take_along_axis(gt_xyxy, gi[..., None], 1)  # a gt box near each anchor, jittered
    boxes = (target + rng.normal(0, 3, (b, a, 4))).astype(np.float32)
    src = rng.integers(0, a, (b, a))
    dup = rng.random((b, a)) < 0.33
    boxes = np.where(dup[..., None], np.take_along_axis(boxes, src[..., None], 1), boxes)
    scores = np.where(dup[..., None], np.take_along_axis(scores, src[..., None], 1), scores)
    scores[rng.random((b, a)) < 0.2] = 0.0
    return scores, boxes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tal_assign_matches_jax_exact_topk(seed):
    """Every field of ``AssignResult`` equal to the JAX assigner's with
    ``exact_topk=True``: the stable sort picks the same anchors among ties
    as ``lax.top_k`` (lowest index first). Labels, masks, indices and boxes
    exactly; target scores within 1e-6 abs (a CIoU through arctan and a
    division, rounded in each framework)."""
    lab = _labels(seed)
    anchors, strides = t_make_anchors(SHAPES, STRIDES)
    anchors_px = (anchors * strides).numpy()
    gt = lab["bboxes"] * 64
    gt_xyxy = np.concatenate([gt[..., :2] - gt[..., 2:] / 2, gt[..., :2] + gt[..., 2:] / 2], -1) * lab["mask"][..., None]
    scores, boxes = _tied_predictions(seed + 10, anchors_px, gt_xyxy)
    kw = dict(topk=10, num_classes=NC, alpha=0.5, beta=6.0)
    want = jtal.assign(jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(anchors_px), jnp.asarray(lab["cls"]),
                       jnp.asarray(gt_xyxy.astype(np.float32)), jnp.asarray(lab["mask"]), exact_topk=True, **kw)
    got = ttal.assign(torch.from_numpy(scores), torch.from_numpy(boxes), torch.from_numpy(anchors_px),
                      torch.from_numpy(lab["cls"]), torch.from_numpy(gt_xyxy.astype(np.float32)),
                      torch.from_numpy(lab["mask"]), **kw)
    assert got.fg_mask.sum() >= 8, "the case should assign foreground"
    for field in ("target_labels", "fg_mask", "target_gt_idx", "target_bboxes"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores), atol=1e-6, rtol=0)


def test_topk_mask_breaks_ties_by_lowest_index():
    """A row of equal metrics selects its first k anchors, as ``lax.top_k``."""
    metrics = torch.zeros(1, 2, 30)
    metrics[0, 0, 5:12] = 0.5  # 7 tied non-zero, then 3 picked from the zero ties
    mask = ttal.select_topk_mask(metrics, 10, torch.tensor([[True, True]]))
    np.testing.assert_array_equal(np.flatnonzero(mask[0, 0].numpy()), [0, 1, 2, 5, 6, 7, 8, 9, 10, 11])
    np.testing.assert_array_equal(np.flatnonzero(mask[0, 1].numpy()), np.arange(10))


def _head_maps(seed, b=2):
    rng = np.random.default_rng(seed)
    return [(2 * rng.standard_normal((b, 4 * REG_MAX + NC, h, w))).astype(np.float32) for h, w in SHAPES]


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_value_and_gradient_match_jax(seed):
    """Loss components within 1e-5 relative and the gradient with respect to
    each of the three head maps within 1e-5 abs + 1e-4 rel: the per-level DFL
    decode (K1's plain version and its backward), TAL, BCE, CIoU and the DFL
    loss, against ``jax.value_and_grad`` of the JAX ``detection_loss`` with
    its default switches and the exact top-k."""
    maps, lab = _head_maps(seed), _labels(seed + 5)
    jcfg = JLossConfig(nc=NC, exact_topk=True)

    def jfn(feats):
        total, comps, _ = j_loss(feats, {k: jnp.asarray(v) for k, v in lab.items()}, STRIDES, jcfg)
        return total, comps

    (jtotal, jcomps), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        [jnp.asarray(np.transpose(m, (0, 2, 3, 1))) for m in maps])
    feats = [torch.from_numpy(m).requires_grad_() for m in maps]
    total, comps, res, _ = t_loss(feats, {k: torch.from_numpy(v) for k, v in lab.items()}, STRIDES, TLossConfig(nc=NC))
    total.backward()
    assert int(res.fg_mask.sum()) > 10
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(comps[k].item(), float(jcomps[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for f, jg in zip(feats, jgrads):
        np.testing.assert_allclose(f.grad.numpy(), np.transpose(np.asarray(jg), (0, 3, 1, 2)), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("switch", [{"use_wiseiou": True, "wiou_ltype": "SIoU"}, {"inner_iou": True},
                                    {"iou_type": "GIoU"}, {"cls_loss": "focal"}, {"assigner": "atss"}])
def test_unported_loss_switches_raise(switch):
    """Each switch of the JAX ``LossConfig`` is taken now (its values are held
    to JAX in ``tests/test_torch_port_loss_zoo.py`` and ``_iou_zoo.py``); a
    name that neither package knows raises ``ValueError``."""
    cfg = TLossConfig(nc=NC, **switch)
    assert all(getattr(cfg, k) == v for k, v in switch.items())
    key = next((k for k, v in switch.items() if isinstance(v, str)), "iou_type")
    with pytest.raises(ValueError, match=f"unknown {key} 'nope'"):
        TLossConfig(nc=NC, **{**switch, key: "nope"})
