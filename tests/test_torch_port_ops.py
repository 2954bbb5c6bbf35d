"""The port's tensor ops against the JAX package: DFL decode, anchors and
decode, boxes, hard-NMS suppression, full NMS, letterbox and the config.

Inputs come from a numpy seed and go through the JAX function and its port.
Where the JAX function has a Pallas kernel, it also runs in interpret mode,
as the JAX package's own tests run it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch import cfg as tcfg
from experiment_yolo_torch.data.augment import letterbox as t_letterbox
from experiment_yolo_torch.ops import anchors as tanchors
from experiment_yolo_torch.ops.boxes import box_iou as t_box_iou
from experiment_yolo_torch.ops.boxes import xywh2xyxy as t_xywh2xyxy
from experiment_yolo_torch.ops.kernels.dfl_decode import dfl_decode as t_dfl, dfl_decode_plain
from experiment_yolo_torch.ops.kernels.nms_suppress import nms_suppress as t_suppress, nms_suppress_plain
from experiment_yolo_torch.ops.nms import non_max_suppression as t_nms
from experiment_yolo_tpu import cfg as jcfg
from experiment_yolo_tpu.data.augment import letterbox as j_letterbox
from experiment_yolo_tpu.ops import anchors as janchors
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


@pytest.mark.parametrize("k,seed,thr", [(64, 0, 0.5), (256, 1, 0.7), (1024, 2, 0.45)])
def test_nms_suppress_matches_jax_reference_and_pallas_interpret(k, seed, thr):
    """Identical keep masks: the IoU is bitwise the JAX package's, so every
    comparison with the threshold decides alike."""
    boxes, valid = _candidates(k, seed)
    got = nms_suppress_plain(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    assert 0 < got.sum() < valid.sum(), "the case should both keep and suppress"
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
