"""The training recipe's class-loss zoo and the ATSS assigner in the port
against the JAX package: ``atss.assign`` field by field, ``detection_loss``
for every ``cls_loss`` under both assigners (and with MPDIoU, whose
normaliser is each anchor's image diagonal in grid units), EMASlide's running
IoU over two calls, and every class loss in bf16.

Inputs come from a numpy seed and go through both packages: random raw head
maps of a three-level pyramid at 64 px, padded labels, and for the assigner a
gt whose centre lies on a grid line, equidistant from two anchors of every
level (``jax.lax.top_k`` keeps such ties in index order, and so must the
port). The JAX TAL takes the exact top-k, as the port's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.ops.anchors import make_anchors as t_make_anchors
from experiment_yolo_torch.utils import atss as tatss
from experiment_yolo_torch.utils.loss import CLS_LOSSES
from experiment_yolo_torch.utils.loss import LossConfig as TLossConfig
from experiment_yolo_torch.utils.loss import detection_loss as t_loss
from experiment_yolo_tpu.utils import atss as jatss
from experiment_yolo_tpu.utils.loss import LossConfig as JLossConfig
from experiment_yolo_tpu.utils.loss import detection_loss as j_loss

NC, REG_MAX, IMGSZ = 6, 16, 64
SHAPES, STRIDES = [(16, 16), (8, 8), (4, 4)], (4, 8, 16)
RATIO = 1.5  # bf16: the port's distance from JAX's f32 over JAX's own bf16 distance, at most (the _amp criterion)


def _labels(seed, b=2, m=6):
    """Padded normalised xywh labels: 2..m boxes of 6..28 px per image; the
    first box of the first image is centred at (24, 40) px, on a grid line of
    every level, so that two or more anchors of each level are equally near
    its centre."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(6, 28, (b, m, 2))
    xy = rng.uniform(wh / 2, IMGSZ - wh / 2)
    xy[0, 0] = (24.0, 40.0)
    bboxes = (np.concatenate([xy, wh], -1) / IMGSZ).astype(np.float32)
    mask = np.arange(m)[None] < rng.integers(2, m + 1, (b, 1))
    return {"bboxes": bboxes * mask[..., None], "cls": rng.integers(0, NC, (b, m)).astype(np.int32), "mask": mask}


def _head_maps(seed, b=2):
    rng = np.random.default_rng(seed)
    return [(2 * rng.standard_normal((b, 4 * REG_MAX + NC, h, w))).astype(np.float32) for h, w in SHAPES]


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_atss_assign_matches_jax(seed):
    """Labels, foreground mask and gt index equal to JAX ``atss.assign``'s,
    target boxes and scores within 1e-6, on predictions jittered around the
    gts; the tied gt takes the same candidates (by index) on every level."""
    lab = _labels(seed)
    anchors, strides = t_make_anchors(SHAPES, STRIDES)
    anchors_px = (anchors * strides).numpy()
    gt = lab["bboxes"] * IMGSZ
    gt_xyxy = (np.concatenate([gt[..., :2] - gt[..., 2:] / 2, gt[..., :2] + gt[..., 2:] / 2], -1)
               * lab["mask"][..., None]).astype(np.float32)
    rng = np.random.default_rng(seed + 20)
    near = np.take_along_axis(gt_xyxy, rng.integers(0, int(lab["mask"].sum(1).min()), (2, len(anchors_px), 1)), 1)
    boxes = (near + rng.normal(0, 3, near.shape)).astype(np.float32)
    centre = gt_xyxy[0, 0, :2] / 2 + gt_xyxy[0, 0, 2:] / 2
    dist = np.linalg.norm(anchors_px[:256] - centre, axis=-1)
    assert np.sum(dist == dist.min()) >= 2, "the case needs a gt centre equidistant from two anchors"

    want = jatss.assign(jnp.asarray(boxes), jnp.asarray(anchors_px), jnp.asarray(strides.numpy()), tuple(SHAPES),
                        STRIDES, jnp.asarray(lab["cls"]), jnp.asarray(gt_xyxy), jnp.asarray(lab["mask"]),
                        num_classes=NC)
    got = tatss.assign(torch.from_numpy(boxes), torch.from_numpy(anchors_px), strides, SHAPES,
                       torch.from_numpy(lab["cls"]), torch.from_numpy(gt_xyxy), torch.from_numpy(lab["mask"]),
                       num_classes=NC)
    assert int(got.fg_mask.sum()) >= 8, "the case should assign foreground"
    for field in ("target_labels", "fg_mask", "target_gt_idx"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.target_bboxes.numpy(), np.asarray(want.target_bboxes), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores), atol=1e-6, rtol=0)


def _jax_loss(maps, lab, jcfg, dtype=jnp.float32, slide_mean=None, step=None):
    """(total, comps[, new slide mean]) and the gradient with respect to the
    NCHW maps of the JAX ``detection_loss``, jitted: one compile a config
    costs less than the eager dispatch of its few hundred operations."""
    def fn(feats, tb, slide_mean, step):
        out = j_loss(feats, tb, STRIDES, jcfg, slide_mean=slide_mean, step=step)
        return out[0], out[1:]

    (total, aux), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        [jnp.asarray(np.transpose(m, (0, 2, 3, 1))).astype(dtype) for m in maps],
        {k: jnp.asarray(v) for k, v in lab.items()}, slide_mean, step)
    comps = aux[0]
    return (float(total), {k: float(v) for k, v in comps.items()},
            [np.transpose(np.asarray(g, np.float32), (0, 3, 1, 2)) for g in grads], aux[2:])


def _port_loss(maps, lab, tcfg, dtype=torch.float32, **kw):
    feats = [torch.from_numpy(m).to(dtype).requires_grad_() for m in maps]
    out = t_loss(feats, {k: torch.from_numpy(v) for k, v in lab.items()}, STRIDES, tcfg, **kw)
    out[0].backward()
    return (out[0].item(), {k: v.item() for k, v in out[1].items()}, [f.grad.float().numpy() for f in feats],
            out[2], out[4:])


CASES = [dict(cls_loss=c, assigner=a) for a in ("tal", "atss") for c in CLS_LOSSES] + \
    [dict(iou_type="MPDIoU"), dict(use_wiseiou=True, wiou_ltype="MPDIoU", assigner="atss")]


@pytest.mark.parametrize("switches", CASES, ids=lambda s: "-".join(str(v) for v in s.values()))
def test_detection_loss_zoo_matches_jax(switches):
    """Each component within 1e-5 relative of JAX's and the gradient with
    respect to each head map within 1e-4 of its largest value, against
    ``jax.value_and_grad`` of the JAX ``detection_loss`` with the same
    switches."""
    maps, lab = _head_maps(3), _labels(4)
    total, comps, grads, res, _ = _port_loss(maps, lab, TLossConfig(nc=NC, **switches))
    jtotal, jcomps, jgrads, _ = _jax_loss(maps, lab, JLossConfig(nc=NC, exact_topk=True, **switches))
    assert int(res.fg_mask.sum()) > 10
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(comps[k], jcomps[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=1e-4 * np.abs(jg).max(), rtol=0)


def test_emaslide_threads_its_running_iou_like_jax():
    """EMASlide over two calls: the slide mean each call returns within 1e-6
    of JAX's, the second call starting from the first's, at optimizer steps 0
    and 1; the loss follows it (components within 1e-5 relative). Without
    ``slide_mean`` none comes back, as in JAX."""
    lab = _labels(5)
    tcfg, jcfg = TLossConfig(nc=NC, cls_loss="emaslide"), JLossConfig(nc=NC, exact_topk=True, cls_loss="emaslide")
    sm, jsm = torch.tensor(1.0), jnp.float32(1.0)
    for step, seed in enumerate((6, 7)):
        maps = _head_maps(seed)
        _, comps, _, _, (sm,) = _port_loss(maps, lab, tcfg, slide_mean=sm, step=step)
        _, jcomps, _, (jsm,) = _jax_loss(maps, lab, jcfg, slide_mean=jsm, step=jnp.int32(step))
        np.testing.assert_allclose(sm.item(), float(jsm), rtol=1e-6)
        np.testing.assert_allclose(comps["cls"], jcomps["cls"], rtol=1e-5)
    assert 0.0 < sm.item() < 1.0 and sm.item() != 1.0
    assert _port_loss(_head_maps(6), lab, tcfg)[4] == ()


def _cls_case(seed, b=2, a=336):
    """Inputs of a class loss as ``detection_loss`` hands them over: logits
    (B, A, nc), one-hot target scores in (0, 1) on 15% foreground anchors,
    their labels, and xyxy predicted and target boxes in grid units."""
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((b, a, NC))).astype(np.float32)
    fg = rng.random((b, a)) < 0.15
    labels = rng.integers(0, NC, (b, a)).astype(np.int32)
    xy = rng.uniform(0, 12, (b, a, 2))
    target = np.concatenate([xy, xy + rng.uniform(1, 6, (b, a, 2))], -1).astype(np.float32)
    pred = (target + rng.normal(0, 0.7, target.shape)).astype(np.float32)
    scores = (np.eye(NC, dtype=np.float32)[labels] * (rng.uniform(0.05, 0.95, (b, a)) * fg)[..., None])
    return logits, scores.astype(np.float32), labels, pred, target, fg


@pytest.mark.parametrize("cls_loss", CLS_LOSSES)
def test_cls_loss_bf16_within_jax_bf16_error(cls_loss):
    """Each class loss on bf16 logits and targets, as ``detection_loss``
    calls it under AMP, over four seeded cases: the port's values and its
    gradients with respect to the logits are no further from JAX's f32
    results than 1.5 times JAX's own bf16 results are, in relative L2 over
    the cases (the criterion of ``tests/test_torch_port_amp.py``). Both
    packages' ``_cls_loss`` take the same inputs, so the assignment does not
    enter: through ``detection_loss`` the bf16 DFL decode moves the boxes TAL
    normalises its targets by, which is the decode's error, not the class
    loss's."""
    from experiment_yolo_torch.utils.loss import _cls_loss as t_cls
    from experiment_yolo_tpu.utils.loss import _cls_loss as j_cls

    tcfg, jcfg = TLossConfig(nc=NC, cls_loss=cls_loss), JLossConfig(nc=NC, cls_loss=cls_loss)
    vals, grads = {"j32": [], "j16": [], "t16": []}, {"j32": [], "j16": [], "t16": []}
    for seed in range(4):
        logits, scores, labels, pred, target, fg = _cls_case(seed)
        boxes = [jnp.asarray(a) for a in (labels, pred, target, fg)]
        for name, dtype in (("j32", jnp.float32), ("j16", jnp.bfloat16)):
            ts = jnp.asarray(scores).astype(dtype)
            tss = jnp.maximum(ts.sum(dtype=jnp.float32), 1.0)
            v, g = jax.value_and_grad(lambda x: j_cls(jcfg, x, ts, *boxes[:3], boxes[3], tss, None, None)[0])(
                jnp.asarray(logits).astype(dtype))
            vals[name].append(float(v))
            grads[name].append(np.asarray(g, np.float32))
        x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
        ts = torch.from_numpy(scores).to(torch.bfloat16)
        v, _ = t_cls(tcfg, x, ts, *(torch.from_numpy(a) for a in (labels, pred, target, fg)),
                     ts.sum(dtype=torch.float32).clamp(min=1.0), None, None)
        v.backward()
        vals["t16"].append(v.item())
        grads["t16"].append(x.grad.float().numpy())
    for what in (vals, grads):
        want = np.concatenate([np.ravel(a) for a in what["j32"]])
        own = _rel(np.concatenate([np.ravel(a) for a in what["j16"]]), want)
        got = _rel(np.concatenate([np.ravel(a) for a in what["t16"]]), want)
        assert 0 < own and got <= RATIO * own, (got, own)
