"""The segmentation family in the PyTorch port against the JAX package:
``Proto`` (a transposed convolution whose kernel is not symmetric) and the
whole ``SegmentationModel`` (``yolov8-seg.yaml`` at n scale, nc 3, 64 px:
parameter count, converter, raw maps and ``predict``); NMS's ``return_idx``
through the plain versions of K2 and K5 (hard, soft, soft-quirk, multi-label);
``segmentation_loss`` in f32 and bf16 with its gradients (more than 64
foreground anchors, ties at the cut, gt masks at another size; 96 px); the polygon
fill and contour area against OpenCV; the float32 linear resize; the segment
dataset's labels and samples; ``SegmentationValidator``'s stats; the
predictor's masks in the original image; a seg checkpoint's round trip and the
server's RLE.

JAX variables are the model's init tree (``jax.eval_shape``) filled from a
seed (``tests/test_torch_port_asf.py:_seeded_like_init``). Each JAX function
is jitted once for the file.
"""

import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch import YOLO
from experiment_yolo_torch.cfg import get_cfg as t_cfg
from experiment_yolo_torch.data import YOLODataset as TDataset
from experiment_yolo_torch.data import augment as TA
from experiment_yolo_torch.data import image_io
from experiment_yolo_torch.data import make_synthetic_task_dataset as t_make
from experiment_yolo_torch.data.polygons import contour_area, fill_polys, polygons2mask_overlap
from experiment_yolo_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.engine.validators_extra import SegmentationValidator, resize_nearest_cv
from experiment_yolo_torch.nn.heads_extra import Proto as TProto
from experiment_yolo_torch.nn.tasks import DetectionModel as TDetModel
from experiment_yolo_torch.nn.tasks import SegmentationModel as TSegModel
from experiment_yolo_torch.nn.tasks import guess_model_task, task_model, yaml_model_load
from experiment_yolo_torch.ops.nms import non_max_suppression as t_nms
from experiment_yolo_torch.serve import _rle as t_rle
from experiment_yolo_torch.utils.convert import _conv_transpose, jax_variables_to_state_dict
from experiment_yolo_torch.utils.loss import LossConfig as TLossConfig
from experiment_yolo_torch.utils.task_losses import segmentation_loss as t_seg_loss
from experiment_yolo_torch.utils.task_losses import top_foreground
from experiment_yolo_tpu.cfg import get_cfg as j_cfg
from experiment_yolo_tpu.data import DataLoader as JLoader
from experiment_yolo_tpu.data import YOLODataset as JDataset
from experiment_yolo_tpu.data.augment import polygons2mask_overlap as j_polygons2mask_overlap
from experiment_yolo_tpu.data.synthetic import make_synthetic_task_dataset as j_make
from experiment_yolo_tpu.engine.predictor import DetectionPredictor as JPredictor
from experiment_yolo_tpu.engine.validators_extra import SegmentationValidator as JValidator
from experiment_yolo_tpu.nn.heads_extra import Proto as JProto
from experiment_yolo_tpu.nn.tasks import SegmentationModel as JSegModel
from experiment_yolo_tpu.ops.nms import non_max_suppression as j_nms
from experiment_yolo_tpu.serve import _rle as j_rle
from experiment_yolo_tpu.utils.loss import LossConfig as JLossConfig
from experiment_yolo_tpu.utils.task_losses import segmentation_loss as j_seg_loss
from test_torch_port_asf import _seeded_like_init

NC, IMGSZ, NM, REG_MAX = 3, 64, 8, 16
STRIDES = (8, 16, 32)
LOSS_IMGSZ = 96  # 189 anchors: room for more than 64 foreground ones
SHAPES = [(LOSS_IMGSZ // s, LOSS_IMGSZ // s) for s in STRIDES]
RATIO = 1.5  # bf16: the port's distance from JAX's f32 over JAX's own bf16 distance, at most (the _amp criterion)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one torch thread, as ``tests/test_torch_port_fit.py``'s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))


# -- the model -------------------------------------------------------------------------------------------------

def test_proto_transposed_kernel_flips_and_matches_jax():
    """``Proto`` on a kernel whose spatial axes are not symmetric: the
    converter's flip gives JAX's output within 3e-6 of its largest value (a
    handful of layers), and the kernel taken without the flip does not."""
    jm = JProto(16, 8)
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 12)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    k = np.asarray(v["params"]["upsample"]["kernel"])
    assert np.abs(k - k[::-1, ::-1]).max() > 0.1
    want = _nchw(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = TProto(12, 16, 8)
    sd = {}
    for name in tm.state_dict():
        parts = name.split(".")
        if parts[-1] == "num_batches_tracked":
            sd[name] = torch.zeros((), dtype=torch.long)
        elif parts[0] == "upsample":
            leaf = v["params"]["upsample"]["kernel" if parts[1] == "weight" else "bias"]
            sd[name] = torch.tensor(_conv_transpose(np.asarray(leaf)) if parts[1] == "weight" else np.asarray(leaf))
        elif parts[1] == "conv":
            sd[name] = torch.tensor(np.transpose(np.asarray(v["params"][parts[0]]["conv"]["kernel"]), (3, 2, 0, 1)))
        else:
            coll = "batch_stats" if parts[2].startswith("running") else "params"
            leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}[parts[2]]
            sd[name] = torch.tensor(np.asarray(v[coll][parts[0]]["bn"][leaf]))
    tm.load_state_dict(sd)
    tm.eval()
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    with torch.no_grad():
        got = tm(xt).numpy()
    assert got.shape == want.shape == (2, 8, 10, 14)
    np.testing.assert_allclose(got, want, atol=3e-6 * np.abs(want).max() * 4, rtol=0)
    sd["upsample.weight"] = torch.tensor(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))))  # no flip
    tm.load_state_dict(sd)
    with torch.no_grad():
        assert np.abs(tm(xt).numpy() - want).max() > 1e-3


@pytest.fixture(scope="module")
def seg_pair():
    """``yolov8-seg.yaml`` at n scale, nc 3: the JAX model and seeded
    variables, and the port model with them converted."""
    cfg = {**yaml_model_load("yolov8n-seg.yaml"), "nc": NC}
    jm = JSegModel(cfg)
    variables = _seeded_like_init(jm, 5)
    tm = TSegModel(cfg, device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    tm.eval()
    return jm, variables, tm


def test_seg_model_build_predict_and_task_match_jax(seg_pair):
    """Parameter count and strides of the JAX model; the eval forward's
    detect maps, coefficient maps and protos, and ``predict``'s boxes,
    scores, flat coefficients and protos, within 1e-5 of each tensor's
    largest value (about 3e-6 a layer over 23 layers); the task routing: a
    ``-seg`` YAML builds a ``SegmentationModel``, a ``DetectionModel``
    refuses a Segment head, and classify raises naming catalogue item 13
    (pose and obb are ported: ``tests/test_torch_port_pose.py``,
    ``tests/test_torch_port_obb.py``)."""
    jm, variables, tm = seg_pair
    assert sum(p.numel() for p in tm.parameters()) == sum(v.size for v in jax.tree.leaves(variables["params"]))
    assert tuple(tm.stride) == tuple(jm.strides) == STRIDES
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    jout = jax.jit(lambda v, xx: (jm.module.apply(v, xx, False), jm.predict(v, xx)))(variables, jnp.asarray(x))
    (jdet, jcoef, jproto), jpred = jout
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    with torch.no_grad():
        tdet, tcoef, tproto = tm(xt)
        tpred = tm.predict(xt)
    for t, j in [*zip(tdet, jdet), *zip(tcoef, jcoef), (tproto, jproto)]:
        j = _nchw(j)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5 * np.abs(j).max(), rtol=0)
    for i, (t, j) in enumerate(zip(tpred, jpred)):
        j = _nchw(j) if i == 3 else np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5 * np.abs(j).max(), rtol=0, err_msg=str(i))
    again = TSegModel(tm.yaml, device="cpu")  # every weight, the transposed convolution's too, from the seeded generator
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                 TSegModel(tm.yaml, device="cpu").state_dict().values()))
    assert guess_model_task("yolov8n-seg.yaml") == "segment" and guess_model_task(tm.yaml) == "segment"
    yolo = YOLO("yolov8n-seg.yaml", nc=NC, device="cpu")
    assert type(yolo.model) is TSegModel and yolo.task == "segment"
    for method in (yolo.double_predict, yolo.sliced_predict):
        with pytest.raises(NotImplementedError, match="detection model"):
            method([np.zeros((64, 64, 3), np.uint8)])
    with pytest.raises(ValueError, match="SegmentationModel"):
        TDetModel({**yaml_model_load("yolov8n-seg.yaml"), "nc": NC}, device="cpu")
    for task in ("classify",):
        with pytest.raises(NotImplementedError, match="catalogue item 13"):
            task_model(task)
        with pytest.raises(NotImplementedError, match="catalogue item 13"):
            YOLO("yolov8n.yaml", task=task, device="cpu")


# -- NMS's return_idx ------------------------------------------------------------------------------------------

def _nms_inputs(seed, a=300, nc=3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (2, a, 2))
    wh = rng.uniform(5, 60, (2, a, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, a, nc)).astype(np.float32) ** 3
    return boxes, scores


NMS_CASES = {
    "hard": dict(nms_type="hard"),
    "soft": dict(nms_type="soft"),
    "soft-quirk": dict(nms_type="soft", soft_first_quirk=True, conf_thres=0.001),
    "multi-label hard": dict(nms_type="hard", multi_label=True, conf_thres=0.001),
    "multi-label soft-quirk": dict(nms_type="soft", soft_first_quirk=True, multi_label=True, conf_thres=0.001,
                                   pre_nms_topk=64),
}


@pytest.mark.parametrize("case", list(NMS_CASES))
def test_return_idx_matches_jax(case):
    """Detections, counts and the anchor of each kept row equal to JAX's
    (0 beyond the counts), through the plain versions of K2 and K5; the
    multi-label soft-quirk case has a pool of 64, so that the quirk's first
    box falls outside it and takes the last slot."""
    kw = {"conf_thres": 0.25, "iou_thres": 0.5, "max_det": 100, **NMS_CASES[case]}
    boxes, scores = _nms_inputs(7)
    if case.startswith("multi-label soft"):
        scores[:, 0] = 0.002  # the lowest conf-passing flat index: low enough to miss the top-64 pool
    jdet, jn, jidx = j_nms(jnp.asarray(boxes), jnp.asarray(scores), return_idx=True, **kw)
    tdet, tn, tidx = t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), return_idx=True, **kw)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tdet.numpy(), np.asarray(jdet), atol=1e-4, rtol=1e-6)
    assert tidx.dtype == torch.int32 and int(tn.min()) > 2
    for b in range(2):
        n = int(tn[b])
        assert (tidx[b, n:] == 0).all()
    det2, n2 = t_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    assert torch.equal(det2, tdet) and torch.equal(n2, tn)


# -- the mask loss ---------------------------------------------------------------------------------------------

def _loss_inputs(seed, mask_hw=(24, 24), zero_maps=False, m=16):
    """Three detect maps, coefficient maps, 24 x 24 protos and labels of
    ``m`` boxes an image with their overlap-index masks (rectangles inside
    the boxes, at ``mask_hw``)."""
    rng = np.random.default_rng(seed)
    b = 2
    maps = [np.zeros((b, 4 * REG_MAX + NC, h, w), np.float32) if zero_maps else
            (2 * rng.standard_normal((b, 4 * REG_MAX + NC, h, w))).astype(np.float32) for h, w in SHAPES]
    coeffs = [rng.standard_normal((b, NM, h, w)).astype(np.float32) for h, w in SHAPES]
    protos = rng.standard_normal((b, NM, 24, 24)).astype(np.float32)
    wh = rng.uniform(14, 48, (b, m, 2))
    xy = rng.uniform(wh / 2, LOSS_IMGSZ - wh / 2)
    if zero_maps:  # box centres and sizes on the stride-8 grid: anchors symmetric about a centre tie
        wh = np.round(wh / 16) * 16
        xy = np.clip(np.round(xy / 8) * 8, wh / 2, LOSS_IMGSZ - wh / 2)
    bboxes = (np.concatenate([xy, wh], -1) / LOSS_IMGSZ).astype(np.float32)
    masks = np.zeros((b, *mask_hw), np.int32)
    for i in range(b):
        for j in range(m):
            x1, y1 = ((xy[i, j] - wh[i, j] / 2) / LOSS_IMGSZ * np.asarray(mask_hw[::-1])).astype(int)
            x2, y2 = ((xy[i, j] + wh[i, j] / 2) / LOSS_IMGSZ * np.asarray(mask_hw[::-1])).astype(int)
            masks[i, y1 + 1:y2, x1 + 1:x2] = j + 1
    lab = {"bboxes": bboxes, "cls": rng.integers(0, NC, (b, m)).astype(np.int32), "mask": np.ones((b, m), bool),
           "masks": masks}
    return maps, coeffs, protos, lab


LOSS_CASES = {"random": {}, "zero maps, ties": {"zero_maps": True}, "gt masks at 48 x 48": {"mask_hw": (48, 48)}}


def _jax_seg_loss(maps, coeffs, protos, lab, dtype):
    """(total, comps, gradients with respect to maps, coefficients and
    protos), jitted; coefficients and protos in ``dtype``, the maps f32, as
    the JAX trainer's segment branch hands them."""
    cfg = JLossConfig(nc=NC, exact_topk=True)

    def fn(f, c, p):
        total, comps, _ = j_seg_loss(f, c, p, {k: jnp.asarray(v) for k, v in lab.items()}, STRIDES, cfg)
        return total, comps

    args = ([jnp.asarray(np.transpose(m, (0, 2, 3, 1))) for m in maps],
            [jnp.asarray(np.transpose(c, (0, 2, 3, 1))).astype(dtype) for c in coeffs],
            jnp.asarray(np.transpose(protos, (0, 2, 3, 1))).astype(dtype))
    (total, comps), grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True))(*args)
    g = [*grads[0], *grads[1], grads[2]]
    return float(total), {k: float(v) for k, v in comps.items()}, [_nchw(x) for x in g]


def _port_seg_loss(maps, coeffs, protos, lab, dtype):
    f = [torch.from_numpy(m).requires_grad_() for m in maps]
    c = [torch.from_numpy(x).to(dtype).requires_grad_() for x in coeffs]
    p = torch.from_numpy(protos).to(dtype).requires_grad_()
    total, comps, res, _, picks = t_seg_loss(f, c, p, {k: torch.from_numpy(v) for k, v in lab.items()}, STRIDES,
                                             TLossConfig(nc=NC))
    total.backward()
    return (total.item(), {k: v.item() for k, v in comps.items()}, [x.grad.float().numpy() for x in (*f, *c, p)],
            res, picks)


@pytest.fixture(scope="module")
def seg_losses():
    out = {}
    for name, kw in LOSS_CASES.items():
        maps, coeffs, protos, lab = _loss_inputs(0, **kw)
        out[name] = {"j32": _jax_seg_loss(maps, coeffs, protos, lab, jnp.float32),
                     "j16": _jax_seg_loss(maps, coeffs, protos, lab, jnp.bfloat16),
                     "t32": _port_seg_loss(maps, coeffs, protos, lab, torch.float32),
                     "t16": _port_seg_loss(maps, coeffs, protos, lab, torch.bfloat16)}
    return out


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_segmentation_loss_matches_jax(seg_losses, case):
    """f32: the total and box, seg, cls, dfl within 1e-5 relative of JAX's,
    each gradient within 1e-4 of its largest value. More than 64 anchors are
    foreground, so the mask term takes a top 64; in the zero-map case the
    64th weight ties with the 65th, and the stable sort keeps JAX's order."""
    total, comps, grads, res, picks = seg_losses[case]["t32"]
    jtotal, jcomps, jgrads = seg_losses[case]["j32"]
    assert int(res.fg_mask.sum(1).min()) > 64 and picks.shape == (2, 64)
    for k in ("box", "seg", "cls", "dfl"):
        np.testing.assert_allclose(comps[k], jcomps[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):  # a level none of whose anchors is picked has no coefficient gradient
        assert np.abs(jg).max() > 0 or 3 <= i < 6, i
        np.testing.assert_allclose(g, jg, atol=1e-4 * np.abs(jg).max(), rtol=0, err_msg=str(i))
    if case.startswith("zero"):
        w = torch.where(res.fg_mask, res.target_scores.sum(-1), -1.0)
        cut = torch.sort(w, dim=1, descending=True, stable=True)[0]
        assert bool(((cut[:, 63] == cut[:, 64]) & (cut[:, 64] > 0)).all()), "no foreground tie at the cut"


def test_top_foreground_breaks_ties_as_lax_top_k():
    """Tied weights (and the -1 of background anchors) come out by lower index, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(3)
    w = rng.integers(0, 4, (3, 200)).astype(np.float32) / 4
    fg = rng.uniform(size=(3, 200)) < 0.5
    got = top_foreground(torch.from_numpy(fg), torch.from_numpy(w), 64).numpy()
    want = np.asarray(jax.lax.top_k(jnp.where(jnp.asarray(fg), jnp.asarray(w), -1.0), 64)[1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("what", ["values", "gradients"])
def test_segmentation_loss_bf16_within_jax_bf16_error(seg_losses, what):
    """Coefficients and protos in bf16 (the maps f32): over the three cases,
    the port's values (total and components) or gradients are no further
    from JAX's f32 results than 1.5 times JAX's own bf16 results are."""
    def vec(r):
        return np.asarray([r[0], *[r[1][k] for k in ("box", "seg", "cls", "dfl")]]) if what == "values" else \
            np.concatenate([g.ravel() for g in r[2]])
    port = jaxd = 0.0
    for case in LOSS_CASES:
        ref = vec(seg_losses[case]["j32"])
        port += np.sum((vec(seg_losses[case]["t16"]) - ref) ** 2)
        jaxd += np.sum((vec(seg_losses[case]["j16"]) - ref) ** 2)
    assert jaxd > 0
    assert np.sqrt(port) <= RATIO * np.sqrt(jaxd), (np.sqrt(port), np.sqrt(jaxd))


# -- polygons, resizes -----------------------------------------------------------------------------------------

def _polygons(rng, kind, h, w):
    n = int(rng.integers(1, 3)) if kind == "fewer than 3 points" else int(rng.integers(3, 14))
    if kind == "convex":
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(2, min(h, w) / 2)
        c = rng.uniform([r, r], [w - r, h - r])
        return (c + r * np.stack([np.cos(ang), np.sin(ang)], -1)).astype(np.int32)
    if kind == "off the image":
        return rng.integers(-25, [w + 25, h + 25], (n, 2)).astype(np.int32)
    if kind == "on the far edges":
        return rng.integers(0, [w + 1, h + 1], (n, 2)).astype(np.int32)
    return rng.integers(0, [w, h], (n, 2)).astype(np.int32)  # concave or self-crossing, and short ones


@pytest.mark.parametrize("kind", ["convex", "concave", "off the image", "on the far edges", "fewer than 3 points"])
def test_polygon_fill_and_area_match_opencv(kind):
    """``fill_polys`` bit-equal to ``cv2.fillPoly`` and to ``cv2.drawContours(...,
    FILLED)`` (CopyPaste's), ``contour_area`` equal to ``cv2.contourArea`` on
    float32 points, on 300 seeded polygons of each kind."""
    rng = np.random.default_rng(hash(kind) % 2 ** 32)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(8, 70, 2))
        pts = _polygons(rng, kind, h, w)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 9)
        contour = np.zeros((h, w, 3), np.uint8)
        cv2.drawContours(contour, [pts], -1, (9, 9, 9), cv2.FILLED)
        got = fill_polys(np.zeros((h, w), np.int32), [pts], [9])
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))
        np.testing.assert_array_equal(got, contour[..., 0])
        f = (pts + rng.uniform(-0.5, 0.5, pts.shape)).astype(np.float32)
        assert contour_area(f) == cv2.contourArea(f)


@pytest.mark.parametrize("n", [7, 300])
def test_overlap_masks_match_jax(n):
    """``polygons2mask_overlap`` equal to the JAX function's (cv2): the
    overlap-index image and the order, with area ties, short polygons and,
    past 255 instances, values beyond a byte."""
    rng = np.random.default_rng(n)
    segs = []
    for i in range(n):
        c = rng.uniform(0, 160, 2)
        k = [2, 3, 5, 8][i % 4]
        segs.append((c + rng.uniform(-20, 20, (k, 2))).astype(np.float32))
    segs[1] = segs[0].copy()  # an area tie
    mask, order = polygons2mask_overlap(segs, (160, 160), 4)
    jmask, jorder = j_polygons2mask_overlap(segs, (160, 160), 4)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.dtype == np.int32 and mask.max() == (n if n > 255 else mask.max()) and mask.max() > 1


@pytest.mark.parametrize("src,dst", [((16, 16), (64, 64)), ((40, 30), (23, 57)), ((64, 48), (32, 24)),
                                     ((7, 9), (7, 20))])
def test_resize_linear_f32_matches_opencv(src, dst):
    """``resize_linear_f32`` within 1e-6 of ``cv2.resize(..., INTER_LINEAR)``
    on float32 maps in [0, 1] (upsampling, mixed, an exact halving)."""
    m = np.random.default_rng(0).uniform(0, 1, (3, *src)).astype(np.float32)
    got = TA.resize_linear_f32(torch.from_numpy(m), dst[::-1]).numpy()
    for g, x in zip(got, m):
        np.testing.assert_allclose(g, cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR), atol=1e-6, rtol=0)


def test_nearest_resize_matches_opencv():
    img = np.random.default_rng(0).integers(0, 9, (40, 30)).astype(np.int32)
    for size in ((16, 16), (50, 61), (30, 40)):
        np.testing.assert_array_equal(resize_nearest_cv(img, size),
                                      cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))


# -- data --------------------------------------------------------------------------------------------------------

SIZES = [(64, 64), (48, 80), (96, 64), (80, 40), (64, 100), (33, 77)]
SAMPLE_HYPS = {
    "mosaic4, warp, flips, CopyPaste": {"degrees": 10.0, "shear": 5.0, "perspective": 1e-4, "flipud": 0.5,
                                        "copy_paste": 0.5},
    "mosaic9, CopyPaste": {"mosaic9": 1.0, "degrees": 10.0, "flipud": 0.5, "copy_paste": 1.0},
    "mixup": {"mixup": 1.0, "degrees": 10.0, "perspective": 1e-4, "copy_paste": 0.5},
    "letterbox, warp, flips": {"mosaic": 0.0, "degrees": 10.0, "shear": 5.0, "flipud": 0.5},
    "letterbox": {"mosaic": 0.0, "degrees": 0.0, "translate": 0.0, "scale": 0.0, "fliplr": 0.0, "hsv_h": 0.0,
                  "hsv_s": 0.0, "hsv_v": 0.0},
}


@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    """The port's synthetic segment dataset (6 train, 4 val at 64 px), and a
    copy at mixed image sizes."""
    root = tmp_path_factory.mktemp("seg")
    yaml = t_make(root / "synthetic", "segment", n_train=6, n_val=4, imgsz=IMGSZ, seed=0)
    shutil.copytree(root / "synthetic", root / "mixed", ignore=shutil.ignore_patterns("*.cache.npy"))
    for split in ("train", "val"):
        for i, f in enumerate(sorted((root / "mixed" / "images" / split).glob("*.bmp"))):
            h, w = SIZES[i % len(SIZES)]
            image_io.imwrite(f, TA.resize_linear(image_io.imread(f, "cpu"), (w, h)))
    return root, yaml


def test_synthetic_segment_labels_match_jax(seg_data, tmp_path):
    """The same draws as the JAX generator: label files and data.yaml equal;
    the polygons drawn as ``cv2.fillPoly`` draws them (the JAX generator's
    pixels before its JPEG)."""
    root, yaml = seg_data
    j_make(tmp_path / "j", "segment", n_train=6, n_val=4, imgsz=IMGSZ, seed=0)
    for split in ("train", "val"):
        for f in sorted((root / "synthetic" / "labels" / split).glob("*.txt")):
            assert f.read_text() == (tmp_path / "j" / "labels" / split / f.name).read_text()
    assert [ln for ln in yaml.read_text().splitlines() if not ln.startswith("path")] == \
        [ln for ln in (tmp_path / "j" / "data.yaml").read_text().splitlines() if not ln.startswith("path")]


@pytest.mark.parametrize("name", list(SAMPLE_HYPS))
def test_segment_samples_match_jax(seg_data, name):
    """``get_sample`` for 6 seeds and every image of the mixed set, task
    segment: boxes, classes, the label mask and the overlap-index ``masks``
    identical to the JAX package's (the polygons through mosaic, warp,
    flips, CopyPaste and MixUp), pixels within 2 grey levels; CopyPaste adds
    instances where it is on."""
    root, _ = seg_data
    ov = {"imgsz": IMGSZ, "task": "segment", **SAMPLE_HYPS[name]}
    path = root / "mixed" / "images" / "train"
    tds = TDataset(path, imgsz=IMGSZ, augment=True, hyp=t_cfg(ov), task="segment", device="cpu")
    jds = JDataset(path, imgsz=IMGSZ, augment=True, hyp=j_cfg(overrides=ov), task="segment")
    n_inst = 0
    for seed in range(6):
        for i in range(len(tds)):
            t, j = tds.get_sample(i, np.random.default_rng(seed)), jds.get_sample(i, np.random.default_rng(seed))
            assert sorted(t) == sorted(j) == ["bboxes", "cls", "img", "mask", "masks"]
            for k in ("bboxes", "cls", "mask", "masks"):
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"seed {seed} image {i} {k}")
            d = np.abs(t["img"].astype(int) - j["img"].astype(int))
            assert d.max() <= 2 and d.mean() < 0.5
            assert t["masks"].shape == (IMGSZ // 4, IMGSZ // 4) and t["masks"].dtype == np.int32
            n_inst += int(t["mask"].sum())
    assert n_inst > 6 * len(tds)


def test_segment_val_samples_and_loader_match_jax(seg_data):
    """Letterboxed val samples (labels, masks, ``ori_shape``, ``ratio_pad``)
    equal; the port's collate stacks ``masks`` (B, H/4, W/4) int32."""
    from experiment_yolo_torch.data import DataLoader as TLoader

    root, _ = seg_data
    path = root / "mixed" / "images" / "val"
    tds = TDataset(path, imgsz=IMGSZ, augment=False, task="segment", device="cpu")
    jds = JDataset(path, imgsz=IMGSZ, augment=False, task="segment")
    for i in range(len(tds)):
        t, j = tds.get_val_sample(i), jds.get_val_sample(i)
        assert sorted(t) == sorted(j)
        for k in t:
            if k != "img":
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"{i} {k}")
    batch = next(iter(TLoader(tds, 2, shuffle=False, workers=1)))
    assert batch["masks"].shape == (2, IMGSZ // 4, IMGSZ // 4) and batch["masks"].dtype == np.int32


# -- validator, predictor, checkpoint, server ------------------------------------------------------------------

class _StubModel:
    """What the JAX validator asks of a model: its strides, and ``predict``
    handing back fixed outputs (the port model's on the same batch)."""

    def __init__(self, outs, strides):
        self.outs, self.strides = outs, strides

    def predict(self, variables, imgs):
        return self.outs


@pytest.fixture(scope="module")
def confident_seg_model():
    """The port's seg model, nc 2, with boxes of about 20 px and class logits
    around 0 (a seeded model's priors keep every score under the val conf)."""
    from experiment_yolo_torch.utils.seeded import sized_boxes_

    tm = TSegModel({**yaml_model_load("yolov8n-seg.yaml"), "nc": 2}, device="cpu")
    with torch.no_grad():
        sized_boxes_(tm, 20.0)
        for cls in tm.detect.cv3:
            cls[-1].bias.zero_()
    tm.eval()
    return tm


def test_segmentation_validator_matches_jax(seg_data, confident_seg_model):
    """``SegmentationValidator`` on the segment dataset's val split: its
    stats (box and mask families, fitness) equal to the JAX validator's run on
    the port model's outputs for the same batch (multi-label hard NMS through
    K2's plain version against JAX's loop, masks at proto resolution cut to
    the boxes, gt masks rebuilt from the overlap image)."""
    root, yaml = seg_data
    tm = confident_seg_model
    ov = {"data": str(yaml), "imgsz": IMGSZ, "batch": 4, "workers": 1, "verbose": False}
    got = SegmentationValidator(ov)(tm)
    jds = JDataset(root / "synthetic" / "images" / "val", imgsz=IMGSZ, augment=False, task="segment")
    batch = next(iter(JLoader(jds, 4, shuffle=False, workers=1, drop_last=False)))
    x = torch.from_numpy(batch["img"]).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        boxes, scores, coeffs, protos = tm.predict(x)
    outs = (jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()), jnp.asarray(coeffs.numpy()),
            jnp.asarray(np.transpose(protos.numpy(), (0, 2, 3, 1))))
    want = JValidator({"data": str(yaml), "imgsz": IMGSZ, "batch": 4, "workers": 1, "verbose": False})(
        _StubModel(outs, tm.stride), None)
    assert sorted(got) == sorted(want)
    assert got["box_mAP50"] > 0 and got["mask_precision"] >= 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)


class _JaxMasksToOrig:
    imgsz = IMGSZ


def test_predictor_masks_match_jax_and_serve_as_rle(confident_seg_model, tmp_path):
    """``DetectionPredictor`` on a segmentation model: one ``Masks`` a
    detection in the original image, equal to JAX ``_masks_to_orig`` on the
    same probabilities (its per-mask OpenCV resizes) except pixels within 1e-5
    of 0.5 (none here), the class filter applied to masks too; the server's
    ``mask_rle`` equal to JAX ``serve.py:_rle``; a seg checkpoint's round
    trip rebuilds a ``SegmentationModel`` with the same masks."""
    tm = confident_seg_model
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (50, 70, 3), np.uint8), rng.integers(0, 255, (90, 40, 3), np.uint8)]
    pred = DetectionPredictor(tm, {"imgsz": IMGSZ, "batch": 2, "conf": 0.3, "max_det": 20})
    res = pred(imgs)
    x = torch.from_numpy(np.stack([TA.letterbox(im, IMGSZ)[0][..., ::-1] for im in imgs]).copy())
    det, counts, probs = pred.infer(x)
    for i, (r, im) in enumerate(zip(res, imgs)):
        n = int(counts[i])
        assert r.masks is not None and r.masks.data.shape == (n, *im.shape[:2]) and n > 0
        _, gain, (padw, padh) = TA.letterbox(im, IMGSZ)
        want = JPredictor._masks_to_orig(_JaxMasksToOrig(), probs[i, :n].numpy(), r.boxes.data, gain, padw, padh,
                                         *im.shape[:2], None)
        np.testing.assert_array_equal(r.masks.data, want)
        assert r.masks.data.any()
        for m in r.masks.data[:3]:
            assert t_rle(m) == j_rle(m)
    assert t_rle(np.ones((3, 2), bool)) == j_rle(np.ones((3, 2), bool)) and t_rle(np.ones((3, 2), bool))["counts"][0] == 0
    cls0 = DetectionPredictor(tm, {"imgsz": IMGSZ, "batch": 2, "conf": 0.3, "max_det": 20, "classes": [0]})(imgs)
    for r, r0 in zip(res, cls0):
        keep = r.boxes.cls == 0
        np.testing.assert_array_equal(r0.masks.data, r.masks.data[keep])
    ckpt = save_checkpoint(tmp_path / "seg.pt", tm)
    back = load_checkpoint(ckpt, "cpu")
    assert type(back) is TSegModel and torch.load(ckpt, weights_only=True)["task"] == "segment"
    res2 = DetectionPredictor(back, {"imgsz": IMGSZ, "batch": 2, "conf": 0.3, "max_det": 20})(imgs)
    for r, r2 in zip(res, res2):
        np.testing.assert_array_equal(r.masks.data, r2.masks.data)
    from experiment_yolo_torch.serve import serialize_results
    answer = serialize_results(res[0])["detections"]
    assert len(answer) == len(res[0].boxes) and answer[1]["mask_rle"] == j_rle(res[0].masks.data[1])
