"""The port's tensor ops against the JAX package: DFL decode and its
gradient, anchors and decode, boxes and the CIoU, hard-NMS suppression, full
NMS, letterbox and the config.

Inputs come from a numpy seed and go through the JAX function and its port.
Where the JAX function has a Pallas kernel, it also runs in interpret mode,
as the JAX package's own tests run it on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch import cfg as tcfg
from experiment_yolo_torch.data.augment import letterbox as t_letterbox
from experiment_yolo_torch.ops import anchors as tanchors
from experiment_yolo_torch.ops.boxes import box_iou as t_box_iou
from experiment_yolo_torch.ops.boxes import xywh2xyxy as t_xywh2xyxy
from experiment_yolo_torch.ops.boxes import bbox_iou as t_bbox_iou
from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode as t_dfl, dfl_decode_bwd, dfl_decode_bwd_plain
from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode_plain
from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress as t_suppress, nms_suppress_plain
from experiment_yolo_torch.ops.nms import non_max_suppression as t_nms
from experiment_yolo_tpu import cfg as jcfg
from experiment_yolo_tpu.data.augment import letterbox as j_letterbox
from experiment_yolo_tpu.ops import anchors as janchors
from experiment_yolo_tpu.ops.boxes import bbox_iou as j_bbox_iou
from experiment_yolo_tpu.ops.boxes import box_iou as j_box_iou
from experiment_yolo_tpu.ops.boxes import xywh2xyxy as j_xywh2xyxy
from experiment_yolo_tpu.ops.nms import non_max_suppression as j_nms
from experiment_yolo_tpu.ops.pallas.dfl_decode import dfl_decode_pallas
from experiment_yolo_tpu.ops.pallas.nms_kernel import nms_suppress as j_suppress_kernel
from experiment_yolo_tpu.ops.pallas.nms_kernel import nms_suppress_reference

REG_MAX, NC = 16, 6


def _head_map(seed, b=2, h=6, w=5, spread=True):
    """A raw NCHW Detect map (B, 4*reg_max + nc, H, W); with ``spread`` some
    (anchor, side) groups sit at +-200, a logit spread far past exp's range
    of 88, across groups of one anchor and across neighbouring anchors."""
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((b, 4 * REG_MAX + NC, h, w))).astype(np.float32)
    if spread:
        x[0, 0:REG_MAX, 0, 0] += 200.0  # anchor 0, side l
        x[0, REG_MAX:2 * REG_MAX, 0, 0] -= 200.0  # anchor 0, side t
        x[0, 0:REG_MAX, 0, 1] -= 200.0  # anchor 1, side l
        x[1, 3 * REG_MAX:4 * REG_MAX, 2, 3] += 150.0
    return x


def _nhwc_box(x):
    """NCHW head map -> the JAX DFL input (B, A, 4*reg_max)."""
    b, _, h, w = x.shape
    return np.transpose(x[:, :4 * REG_MAX], (0, 2, 3, 1)).reshape(b, h * w, 4 * REG_MAX)


def test_dfl_decode_matches_jax_and_pallas_interpret():
    """Port plain DFL (read in place from the NCHW map) vs the JAX
    ``dfl_decode`` and the TPU kernel ``dfl_decode_pallas`` in interpret
    mode: 1e-5 abs, exp and the two sums in f32 in another order."""
    x = _head_map(0)
    got = dfl_decode_plain(torch.from_numpy(x), REG_MAX).numpy()
    assert np.isfinite(got).all()
    for want in (janchors.dfl_decode(jnp.asarray(_nhwc_box(x)), REG_MAX),
                 dfl_decode_pallas(jnp.asarray(_nhwc_box(x)), REG_MAX, True)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    before = t_dfl.launches
    np.testing.assert_array_equal(t_dfl(torch.from_numpy(x), REG_MAX).numpy(), got)
    assert t_dfl.launches == before  # a CPU tensor takes the plain version


def test_dfl_decode_plain_is_as_accurate_as_float64(monkeypatch):
    """The plain DFL decode against the same softmax expectation in float64,
    within 1e-5 bins (its f32 sums err about 4e-6), even where the host's f32
    ``exp`` errs: here ``torch.exp`` on f32 is made to err by 1.5e-4 relative
    (with a sign that varies from element to element), which moves a decode
    that takes its exp in f32 by 6.7e-4 bins (2.7e-3 px at stride 4), past
    ``chip_smoke.py``'s 1e-3 px gate against K1."""
    exp = torch.exp

    def inexact(t):
        y = exp(t)
        return y * (1 + 1.5e-4 * torch.sign(torch.sin(1e3 * t))) if y.dtype == torch.float32 else y

    monkeypatch.setattr(torch, "exp", inexact)
    rng = np.random.default_rng(11)
    x = (6 * rng.standard_normal((2, 4 * REG_MAX + NC, 40, 40))).astype(np.float32)
    got = dfl_decode_plain(torch.from_numpy(x), REG_MAX).double().numpy()
    d = x[:, :4 * REG_MAX].reshape(2, 4, REG_MAX, -1).astype(np.float64)
    e = np.exp(d - d.max(2, keepdims=True))
    want = ((e * np.arange(REG_MAX)[:, None]).sum(2) / e.sum(2)).transpose(0, 2, 1)
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("spread", [False, True])
def test_dfl_decode_gradient_matches_pallas_vjp_and_jax_grad(spread):
    """The plain backward (and the autograd path that takes it on the CPU)
    against the VJP of ``dfl_decode_pallas``, whose ``_bwd_kernel`` runs in
    interpret mode here (A = 64 keeps the 128-lane packing), and against
    ``jax.vjp`` of the jnp ``dfl_decode``; with ``spread`` some groups sit at
    +-200. Box channels within 1e-5 abs + 1e-5 rel (p * g * (bin - y) in f32
    in another order); class channels exactly 0."""
    x = _head_map(5, h=8, w=8, spread=spread)
    g = np.random.default_rng(6).standard_normal((2, 64, 4)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = t_dfl(xt, REG_MAX)
    y.backward(torch.from_numpy(g))
    got = dfl_decode_bwd_plain(torch.from_numpy(x), y.detach(), torch.from_numpy(g), REG_MAX).numpy()
    np.testing.assert_array_equal(xt.grad.numpy(), got)
    assert np.isfinite(got).all() and not got[:, 4 * REG_MAX:].any()
    box = np.transpose(got[:, :4 * REG_MAX], (0, 2, 3, 1)).reshape(2, 64, 4 * REG_MAX)  # as the JAX (B, A, 64)
    for fn in (lambda d: dfl_decode_pallas(d, REG_MAX, True), lambda d: janchors.dfl_decode(d, REG_MAX)):
        _, vjp = jax.vjp(fn, jnp.asarray(_nhwc_box(x)))
        np.testing.assert_allclose(box, np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5, rtol=1e-5)
    before = dfl_decode_bwd.launches
    np.testing.assert_array_equal(dfl_decode_bwd(torch.from_numpy(x), y.detach(), torch.from_numpy(g)).numpy(), got)
    assert dfl_decode_bwd.launches == before  # a CPU tensor takes the plain version


def _ciou_boxes(seed, n=300):
    """xyxy pairs that overlap, touch, nest and miss, with tiny and wide boxes."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 60, (n, 2))
    a = np.concatenate([c - rng.uniform(0.5, 20, (n, 2)), c + rng.uniform(0.5, 20, (n, 2))], -1)
    c2 = c + rng.normal(0, 8, (n, 2))
    b = np.concatenate([c2 - rng.uniform(0.5, 20, (n, 2)), c2 + rng.uniform(0.5, 20, (n, 2))], -1)
    b[:20] = a[:20]  # identical pairs
    b[20:40, 0] = a[20:40, 2]  # touching on an edge
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("seed", [1, 4])
def test_ciou_values_and_gradients_match_jax(seed):
    """xyxy CIoU values within 1e-6 abs and gradients (alpha held out of
    them, as the JAX ``stop_gradient``) within 1e-5 abs + 1e-4 rel: the same
    float expressions, but arctan and the divisions round differently."""
    a, b = _ciou_boxes(seed)
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    got = t_bbox_iou(ta, tb, xywh=False, CIoU=True)
    w = np.random.default_rng(seed + 1).standard_normal(got.shape).astype(np.float32)
    got.backward(torch.from_numpy(w))
    want, vjp = jax.vjp(lambda p, q: j_bbox_iou(p, q, xywh=False, CIoU=True), jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    ga, gb = vjp(jnp.asarray(w))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), atol=1e-5, rtol=1e-4)
    with pytest.raises(TypeError, match="FooIoU"):  # the other variants: tests/test_torch_port_iou_zoo.py
        t_bbox_iou(ta, tb, xywh=False, FooIoU=True)


def test_bbox2dist_matches_jax():
    rng = np.random.default_rng(3)
    anchors = rng.uniform(0, 20, (50, 2)).astype(np.float32)
    boxes = np.concatenate([anchors - rng.uniform(-2, 20, (50, 2)), anchors + rng.uniform(-2, 20, (50, 2))],
                           -1).astype(np.float32)
    np.testing.assert_array_equal(tanchors.bbox2dist(torch.from_numpy(anchors), torch.from_numpy(boxes), REG_MAX).numpy(),
                                  np.asarray(janchors.bbox2dist(jnp.asarray(anchors), jnp.asarray(boxes), REG_MAX)))


def test_make_anchors_and_decode_match_jax():
    """Anchors exactly; decoded boxes (xywh px) and sigmoid scores of a
    three-level pyramid within 1e-4 abs (the DFL's 1e-5 times strides up to 8)."""
    feats = [_head_map(s, h=h, w=w, spread=False) for s, (h, w) in enumerate([(8, 6), (4, 3), (2, 2)])]
    strides = (2, 4, 8)
    shapes = [f.shape[2:] for f in feats]
    ta, ts = tanchors.make_anchors(shapes, strides)
    ja, js = janchors.make_anchors(shapes, strides)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    d = np.random.default_rng(1).uniform(0, 10, (2, len(ta), 4)).astype(np.float32)
    for xywh in (True, False):
        np.testing.assert_allclose(tanchors.dist2bbox(torch.from_numpy(d), ta[None], xywh).numpy(),
                                   np.asarray(janchors.dist2bbox(jnp.asarray(d), ja[None], xywh)), atol=1e-6, rtol=0)
    tb, tsc = tanchors.decode_detections([torch.from_numpy(f) for f in feats], strides, NC, REG_MAX)
    jb, jsc = janchors.decode_detections([jnp.asarray(np.transpose(f, (0, 2, 3, 1))) for f in feats], strides, NC,
                                         REG_MAX)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-6, rtol=0)


def test_boxes_match_jax_bitwise():
    """The same float expressions in the same order: identical results, which
    NMS needs so that IoU ties at the threshold break alike."""
    rng = np.random.default_rng(2)
    xywh = np.concatenate([rng.uniform(0, 100, (3, 40, 2)), rng.uniform(1, 30, (3, 40, 2))], -1).astype(np.float32)
    a = t_xywh2xyxy(torch.from_numpy(xywh)).numpy()
    np.testing.assert_array_equal(a, np.asarray(j_xywh2xyxy(jnp.asarray(xywh))))
    for i in range(3):
        np.testing.assert_array_equal(t_box_iou(torch.from_numpy(a[i]), torch.from_numpy(a[i])).numpy(),
                                      np.asarray(j_box_iou(jnp.asarray(a[i]), jnp.asarray(a[i]))))


def _candidates(k, seed, b=2):
    """Score-sorted, clustered xyxy candidates so that suppression happens."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 200, (b, k // 4, 2)).repeat(4, 1) + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(10, 60, (b, k, 2))
    boxes = np.concatenate([centres - wh / 2, centres + wh / 2], -1).astype(np.float32)
    valid = rng.random((b, k)) > 0.2
    return boxes, valid


def _made_up(kind, k, seed):
    """Candidates and valid flags for the cases a bitmask NMS could get
    wrong: ``clustered`` (``_candidates``, also at a K that is no multiple of
    32 or 64), exact ``duplicates``, IoUs exactly at 0.7 (built from small
    integers, so that the float32 IoU is exact: 7/10 ties, 8/10 suppresses,
    6/10 does not), invalid candidates interleaved with valid ones, and a
    batch whose second image has no valid candidate."""
    boxes, valid = _candidates(k, seed)
    if kind == "duplicates":
        boxes[:, 1::2] = boxes[:, 0::2]
    elif kind == "ties":
        rng = np.random.default_rng(seed)
        x0 = 20.0 * np.arange(k // 2, dtype=np.float32)
        inner = np.float32([7, 8, 6])[np.arange(k // 2) % 3]
        zeros, ones = np.zeros_like(x0), np.ones_like(x0)
        pairs = np.stack([np.stack([x0, zeros, x0 + 10, ones], -1), np.stack([x0, zeros, x0 + inner, ones], -1)], 1)
        boxes = np.stack([pairs.reshape(k, 4), pairs[rng.permutation(k // 2)].reshape(k, 4)]).astype(np.float32)
        valid = np.ones((2, k), bool)
    elif kind == "interleaved-invalid":
        valid[:, 1::2] = False
    elif kind == "all-invalid-image":
        valid[1] = False
    return boxes, valid


@pytest.mark.parametrize("k,seed,thr,kind", [
    pytest.param(64, 0, 0.5, "clustered", id="64-0-0.5"), pytest.param(256, 1, 0.7, "clustered", id="256-1-0.7"),
    pytest.param(1024, 2, 0.45, "clustered", id="1024-2-0.45"), pytest.param(100, 3, 0.7, "clustered", id="ragged-100"),
    pytest.param(64, 4, 0.7, "duplicates", id="duplicates"), pytest.param(60, 5, 0.7, "ties", id="iou-at-threshold"),
    pytest.param(64, 6, 0.5, "interleaved-invalid", id="interleaved-invalid"),
    pytest.param(48, 7, 0.5, "all-invalid-image", id="all-invalid-image")])
def test_nms_suppress_matches_jax_reference_and_pallas_interpret(k, seed, thr, kind):
    """Identical keep masks: the IoU is bitwise the JAX package's, so every
    comparison with the threshold decides alike, ties at it included."""
    boxes, valid = _made_up(kind, k, seed)
    got = nms_suppress_plain(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    assert 0 < got.sum() < valid.sum(), "the case should both keep and suppress"
    if kind == "ties":
        iou = t_box_iou(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[0])).numpy()
        assert (iou == np.float32(thr)).sum() >= 2 and (iou > thr).sum() > k, "pairs should sit at and above 0.7"
    if kind == "all-invalid-image":
        assert not got[1].any()
    for i in range(len(boxes)):
        ref = nms_suppress_reference(jnp.asarray(boxes[i]), jnp.asarray(valid[i]), thr)
        np.testing.assert_array_equal(got[i], np.asarray(ref))
        if k <= 256:  # the interpreted kernel steps through K; its reference is checked at K=1024 above
            ker = j_suppress_kernel(jnp.asarray(boxes[i]), jnp.asarray(valid[i]), thr, interpret=True)
            np.testing.assert_array_equal(got[i], np.asarray(ker))
    before = t_suppress.launches
    np.testing.assert_array_equal(t_suppress(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy(), got)
    assert t_suppress.launches == before


def _nms_inputs(seed, b=2, a=2400, nc=NC):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 300, (b, a // 6, 2)).repeat(6, 1) + rng.normal(0, 4, (b, a, 2))
    wh = rng.uniform(8, 50, (b, a, 2))
    boxes = np.concatenate([centres, wh], -1).astype(np.float32)
    scores = rng.beta(0.6, 2.0, (b, a, nc)).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("nms_type,quirk", [("hard", False), ("soft", False), ("soft", True)])
@pytest.mark.parametrize("agnostic", [False, True])
def test_non_max_suppression_matches_jax(nms_type, quirk, agnostic):
    """Full batched NMS, with the top-1024 pre-filter at work (A = 2400):
    identical counts, detections within 1e-5 (soft-NMS decays scores through
    exp)."""
    boxes, scores = _nms_inputs(3)
    assert (scores.max(-1) > 0.25).sum(-1).min() > 1024, "the pre-filter should drop conf-passing anchors"
    kw = dict(conf_thres=0.25, iou_thres=0.5, max_det=100, agnostic=agnostic, nms_type=nms_type,
              soft_first_quirk=quirk)
    td, tn = t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    jd, jn = j_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    assert td.shape == (2, 100, 6) and tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.min() > 0
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


def test_soft_quirk_forces_first_anchor_into_the_pool():
    """With the first conf-passing anchor outside the top-1024 pool, the
    quirk mode puts it in the last slot, as the JAX package does."""
    boxes, scores = _nms_inputs(4)
    scores[:, :40] = np.minimum(scores[:, :40], 0.26)  # the first anchors score low
    best = scores.max(-1)
    first = (best > 0.25).argmax(-1)
    assert ((best > best[np.arange(len(best)), first][:, None]).sum(-1) >= 1024).all(), "first anchor in the pool"
    kw = dict(conf_thres=0.25, iou_thres=0.6, max_det=50, nms_type="soft", soft_first_quirk=True)
    td, tn = t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    jd, jn = j_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


def test_nms_rejects_unknown_type():
    boxes, scores = _nms_inputs(5, b=1, a=12)
    with pytest.raises(ValueError, match="nms_type"):
        t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), nms_type="fast")


@pytest.mark.parametrize("shape", [(96, 128), (128, 128), (128, 64)])
def test_letterbox_pad_only_is_identical(shape):
    """No resize: the port's pad equals OpenCV's copyMakeBorder exactly."""
    img = np.random.default_rng(6).integers(0, 256, (*shape, 3), dtype=np.uint8)
    t_img, t_r, t_pad = t_letterbox(img, (128, 128))
    j_img, j_r, j_pad = j_letterbox(img, (128, 128))
    assert (t_r, t_pad) == (j_r, j_pad)
    np.testing.assert_array_equal(t_img, j_img)


@pytest.mark.parametrize("shape", [(100, 150), (200, 90), (61, 61)])
def test_letterbox_resize_close_to_cv2(shape):
    """With a resize: the same gain, pad and output size; pixels within 2 grey
    levels and under 0.5 on average, since OpenCV's INTER_LINEAR rounds
    through 11-bit fixed-point weights and the port rounds the exact value."""
    img = np.random.default_rng(7).integers(0, 256, (*shape, 3), dtype=np.uint8)
    t_img, t_r, t_pad = t_letterbox(img, (128, 128))
    j_img, j_r, j_pad = j_letterbox(img, (128, 128))
    assert (t_r, t_pad) == (j_r, j_pad) and t_img.shape == j_img.shape
    diff = np.abs(t_img.astype(int) - j_img.astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.5


def test_cfg_defaults_match_jax():
    keys = ("conf", "iou", "max_det", "agnostic_nms", "nms_type", "soft_nms_quirk", "classes", "imgsz", "batch")
    t, j = tcfg.get_cfg(), jcfg.get_cfg()
    assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k) for k in keys}
    assert t.nms_type == "soft"
    o = {"conf": 0.4, "iou": "0.5", "nms_type": "hard", "imgsz": 320}
    t, j = tcfg.get_cfg(o), jcfg.get_cfg(overrides=o)
    assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k) for k in keys}
    for imgsz, stride in [(640, 32), (100, 16), (129, 32)]:
        assert tcfg.check_imgsz(imgsz, stride) == jcfg.check_imgsz(imgsz, stride)
    with pytest.raises(SyntaxError, match="conff"):
        tcfg.get_cfg({"conff": 0.3})
    with pytest.raises(ValueError, match="nms_type"):
        tcfg.get_cfg({"nms_type": "fast"})
