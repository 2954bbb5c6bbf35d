"""The oriented-box family in the PyTorch port against the JAX package: the
whole ``OBBModel`` (``tests/assets/tiny-obb.yaml``: parameter count,
converter, raw maps and ``predict``; ``yolov8-obb.yaml`` at n scale: its
parameter count and a ``predict`` at 64 px); ``probiou``,
``xywhr2xyxyxyxy``, ``dist2rbox`` and ``decode_rboxes``; ``nms_rotated``
(kernel K7's plain version) and the rotated assigner; ``obb_loss`` in f32
and bf16 with its gradients; ``OBBValidator``'s stats; the synthetic obb
dataset's labels, ``min_area_rect`` bit-equal to ``cv2.minAreaRect`` and the
corners of samples through letterbox, mosaic 4 and 9, the warp, flips and
MixUp; the predictor's ``Results.obb``, the server's JSON, a checkpoint's
round trip and one ``train()`` epoch; the DOTA converter and splitter.

JAX variables are the model's init tree (``jax.eval_shape``) filled from a
seed (``tests/test_torch_port_asf.py:_seeded_like_init``). Each JAX function
is jitted once for the file, except ``probiou``, which is held to JAX run op
by op: on identical boxes its value is ``1 - sqrt(eps + rounding)``, and
XLA's fused form sits 2e-5 from JAX's own op-by-op value there.
"""

import shutil
from functools import partial

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch import YOLO
from experiment_yolo_torch.cfg import get_cfg as t_cfg
from experiment_yolo_torch.cfg.cli import entrypoint
from experiment_yolo_torch.data import YOLODataset as TDataset
from experiment_yolo_torch.data import augment as TA
from experiment_yolo_torch.data import image_io
from experiment_yolo_torch.data import make_synthetic_task_dataset as t_make
from experiment_yolo_torch.data import converter as t_converter
from experiment_yolo_torch.data import split_dota as t_split
from experiment_yolo_torch.data.polygons import min_area_rect
from experiment_yolo_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.engine.validators_extra import OBBValidator
from experiment_yolo_torch.nn.tasks import DetectionModel as TDetModel
from experiment_yolo_torch.nn.tasks import OBBModel as TOBBModel
from experiment_yolo_torch.nn.tasks import guess_model_task, task_model, yaml_model_load
from experiment_yolo_torch.ops import anchors as t_anchors
from experiment_yolo_torch.ops import boxes as t_boxes
from experiment_yolo_torch.ops.kernels.nms_rotated import nms_rotated_suppress_plain
from experiment_yolo_torch.ops.nms import nms_rotated as t_nms_rotated
from experiment_yolo_torch.serve import serialize_results
from experiment_yolo_torch.utils import tal as t_tal
from experiment_yolo_torch.utils.convert import jax_variables_to_state_dict
from experiment_yolo_torch.utils.loss import LossConfig as TLossConfig
from experiment_yolo_torch.utils.seeded import sized_boxes_
from experiment_yolo_torch.utils.task_losses import obb_loss as t_obb_loss
from experiment_yolo_tpu.cfg import get_cfg as j_cfg
from experiment_yolo_tpu.data import DataLoader as JLoader
from experiment_yolo_tpu.data import YOLODataset as JDataset
from experiment_yolo_tpu.data import augment as JA
from experiment_yolo_tpu.data import converter as j_converter
from experiment_yolo_tpu.data import split_dota as j_split
from experiment_yolo_tpu.data.synthetic import make_synthetic_task_dataset as j_make
from experiment_yolo_tpu.engine.results import Results as JResults
from experiment_yolo_tpu.engine.validators_extra import OBBValidator as JValidator
from experiment_yolo_tpu.nn.tasks import OBBModel as JOBBModel
from experiment_yolo_tpu.ops import anchors as j_anchors
from experiment_yolo_tpu.ops import boxes as j_boxes
from experiment_yolo_tpu.ops.nms import nms_rotated as j_nms_rotated
from experiment_yolo_tpu.serve import serialize_results as j_serialize
from experiment_yolo_tpu.utils import tal as j_tal
from experiment_yolo_tpu.utils.loss import LossConfig as JLossConfig
from experiment_yolo_tpu.utils.task_losses import obb_loss as j_obb_loss
from experiment_yolo_tpu.utils.torch_convert import invert_to_torch_state
from test_torch_port_asf import _seeded_like_init

NC, IMGSZ, REG_MAX = 2, 64, 16
TINY = "tests/assets/tiny-obb.yaml"
TINY_STRIDES = (8, 16)
STRIDES = (8, 16, 32)  # the loss's three levels
SHAPES = [(IMGSZ // s, IMGSZ // s) for s in STRIDES]
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tiny_cfg():
    return {**yaml_model_load(TINY), "nc": NC}


# -- the model ---------------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def obb_pair():
    """``tiny-obb.yaml`` at nc 2: the JAX model and seeded variables, and the
    port model with them converted."""
    jm = JOBBModel(_tiny_cfg())
    variables = _seeded_like_init(jm, 7)
    tm = TOBBModel(_tiny_cfg(), device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    tm.eval()
    return jm, variables, tm


def test_obb_model_build_predict_match_jax(obb_pair):
    """Parameter count and strides of the JAX model; the converter: every
    leaf below the head equal to ``invert_to_torch_state``'s (which has no
    OBB rule and drops the head's leaves), the head held by its maps; the
    eval forward's detect and angle maps, and ``predict``'s xywhr boxes
    (pixels, the angle in (-pi/4, 3pi/4)) and scores, within 1e-4 of each
    tensor's largest value."""
    jm, variables, tm = obb_pair
    head = f"model.{len(tm.model) - 1}."
    state = {k: v for k, v in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    inv = invert_to_torch_state(variables, {k: tuple(v.shape) for k, v in state.items()}, jm)
    assert sorted(inv) == sorted(k for k in state if not k.startswith(head))
    assert all(np.array_equal(v, state[k].numpy()) for k, v in inv.items())
    assert sum(p.numel() for p in tm.parameters()) == sum(v.size for v in jax.tree.leaves(variables["params"]))
    assert tuple(tm.stride) == tuple(jm.strides) == TINY_STRIDES and tm.detect.ne == 1
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    (jdet, jang), jpred = jax.jit(lambda v, xx: (jm.module.apply(v, xx, False), jm.predict(v, xx)))(variables,
                                                                                                   jnp.asarray(x))
    xt = _t(np.transpose(x, (0, 3, 1, 2)))
    with torch.no_grad():
        tdet, tang = tm(xt)
        tpred = tm.predict(xt)
    for t, j in [*zip(tdet, jdet), *zip(tang, jang)]:
        j = _nchw(j)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=0)
    for i, (t, j) in enumerate(zip(tpred, jpred)):
        j = np.asarray(j)
        assert t.shape == j.shape, i
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=0, err_msg=str(i))
    ang = tpred[0][..., 4]
    assert tpred[0].shape == (2, 80, 5) and bool(((ang > -np.pi / 4) & (ang < 3 * np.pi / 4)).all())


def test_yolov8n_obb_parameter_count_and_predict():
    """``yolov8-obb.yaml`` at n scale, nc 15 (DOTA v1.0's classes): the
    parameter count of its JAX init tree (``jax.eval_shape``, nothing
    compiled), and one ``predict`` at 64 px: 84 anchors of finite xywhr boxes
    with angles in (-pi/4, 3pi/4) and 15 scores (the modules are held to JAX
    on ``tiny-obb.yaml`` above)."""
    cfg = {**yaml_model_load("yolov8n-obb.yaml"), "nc": 15}
    tree = jax.eval_shape(lambda r: JOBBModel(cfg).module.init(r, jnp.zeros((1, IMGSZ, IMGSZ, 3)), False),
                          jax.random.PRNGKey(0))
    tm = TOBBModel(cfg, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == sum(v.size for v in jax.tree.leaves(tree["params"]))
    with torch.no_grad():
        rboxes, scores = tm.predict(torch.rand(1, 3, IMGSZ, IMGSZ, generator=torch.Generator().manual_seed(1)))
    assert rboxes.shape == (1, 84, 5) and scores.shape == (1, 84, 15) and bool(torch.isfinite(rboxes).all())
    assert bool(((rboxes[..., 4] > -np.pi / 4) & (rboxes[..., 4] < 3 * np.pi / 4)).all())


def test_obb_task_routing():
    """An ``-obb`` YAML builds an ``OBBModel`` through the facade; a
    ``DetectionModel`` refuses an OBB head and an ``OBBModel`` a Detect head;
    the two-stage methods refuse an OBB model; the OBB zoo heads and classify
    still raise naming catalogue item 13."""
    assert guess_model_task("yolov8n-obb.yaml") == "obb" and task_model("obb") is TOBBModel
    yolo = YOLO(TINY, device="cpu")
    assert type(yolo.model) is TOBBModel and yolo.task == "obb"
    for method in (yolo.double_predict, yolo.sliced_predict):
        with pytest.raises(NotImplementedError, match="detection model"):
            method([np.zeros((64, 64, 3), np.uint8)])
    with pytest.raises(ValueError, match="OBBModel"):
        TDetModel(_tiny_cfg(), device="cpu")
    with pytest.raises(ValueError, match="DetectionModel"):
        TOBBModel("yolov8n.yaml", device="cpu")
    for head in ("OBB_LSCD", "OBB_LADH", "OBB_TADDH"):
        cfg = _tiny_cfg()
        cfg["head"] = [*cfg["head"][:-1], [cfg["head"][-1][0], 1, head, ["nc", 1]]]
        with pytest.raises(NotImplementedError, match="catalogue item 13"):
            TOBBModel(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="catalogue item 13"):
        task_model("classify")


# -- geometry ----------------------------------------------------------------------------------------------------

def _rboxes(rng, n, spread=60.0):
    return np.concatenate([rng.uniform(0, spread, (n, 2)), rng.uniform(2, 30, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], -1).astype(np.float32)


def _geometry_cases():
    """(p, q) pairs of one shape, (12, 1, 5) against (1, 12, 5), so that JAX
    run op by op compiles each operation once for the cases."""
    rng = np.random.default_rng(0)
    a, b = _rboxes(rng, 12), _rboxes(rng, 12)
    turned = [a.copy() for _ in range(3)]
    for t, d in zip(turned, (0.0, np.pi / 2, np.pi)):
        t[:, 4] += np.float32(d)
    far = a.copy()
    far[:, :2] += 7680.0  # another class's centres
    return {k: (p[:, None], q[None]) for k, (p, q) in {
        "seeded": (a, b), "identical": (a, a), "disjoint": (a, far), "angle 0": (a, turned[0]),
        "angle pi/2": (a, turned[1]), "angle pi": (a, turned[2])}.items()}


@pytest.mark.parametrize("case", list(_geometry_cases()))
def test_probiou_and_corners_match_jax(case):
    """``probiou`` within 1e-6 of JAX's (op by op) on seeded pairs, identical
    boxes (about 1: eps and rounding), boxes in two classes' offsets (the
    clip at 100: about 0), and boxes turned by 0, pi/2 and pi (pi: the same
    box); ``xywhr2xyxyxyxy`` within 1e-5 px. Near a ProbIoU of 1 the value
    moves by about 1e-6 for one float32 spacing of a cosine, and PyTorch's
    and XLA's float32 cosines part by one spacing on some angles: at most one
    pair of a case may then part from JAX's by more than 1e-6, if both lie
    within 2e-6 of the float64 ProbIoU of the same inputs and the port's is
    no further from it than JAX's."""
    p, q = _geometry_cases()[case]
    got = t_boxes.probiou(_t(p), _t(q)).numpy()
    want = np.asarray(j_boxes.probiou(jnp.asarray(p), jnp.asarray(q)))
    exact = t_boxes.probiou(_t(p).double(), _t(q).double()).numpy()
    off = np.abs(got - want) > 1e-6
    assert off.sum() <= 1, np.abs(got - want).max()
    assert (np.abs(got - exact)[off] <= np.abs(want - exact)[off]).all() and (np.abs(want - exact)[off] <= 2e-6).all()
    if case in ("identical", "angle 0", "angle pi"):  # the same boxes on the diagonal
        assert (np.diagonal(got) > 0.999).all()
    if case == "disjoint":
        assert (got < 1e-6).all()
    np.testing.assert_allclose(t_boxes.xywhr2xyxyxyxy(_t(q)).numpy(),
                               np.asarray(j_boxes.xywhr2xyxyxyxy(jnp.asarray(q))), atol=1e-5, rtol=0)


def test_dist2rbox_and_decode_rboxes_match_jax():
    """``dist2rbox`` and ``decode_rboxes`` (the DFL decode through K1's
    plain version, each level's stride on xywh and not on the angle) within
    1e-5 of each output's largest value."""
    rng = np.random.default_rng(2)
    dist = rng.uniform(0, 8, (2, 30, 4)).astype(np.float32)
    ang = rng.uniform(-0.7, 2.3, (2, 30, 1)).astype(np.float32)
    anc = rng.uniform(0, 8, (30, 2)).astype(np.float32)
    np.testing.assert_allclose(t_anchors.dist2rbox(_t(dist), _t(ang), _t(anc)[None]).numpy(),
                               np.asarray(j_anchors.dist2rbox(dist, ang, anc[None])), atol=1e-5, rtol=0)
    maps = [rng.standard_normal((2, h, w, 4 * REG_MAX + NC)).astype(np.float32) for h, w in SHAPES]
    angle = rng.uniform(-0.7, 2.3, (2, sum(h * w for h, w in SHAPES), 1)).astype(np.float32)
    want = jax.jit(partial(j_anchors.decode_rboxes, strides=STRIDES, nc=NC))(maps, angle)
    got = t_anchors.decode_rboxes([_t(np.transpose(m, (0, 3, 1, 2))) for m in maps], _t(angle), STRIDES, NC)
    for t, j in zip(got, want):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-5 * np.abs(j).max(), rtol=0)


def _nms_inputs(seed, a=300, nc=3):
    rng = np.random.default_rng(seed)
    rb = np.concatenate([rng.uniform(0, 100, (2, a, 2)), rng.uniform(5, 30, (2, a, 2)),
                         rng.uniform(-0.8, 2.3, (2, a, 1))], -1).astype(np.float32)
    return rb, (rng.uniform(0, 1, (2, a, nc)) ** 3).astype(np.float32)


@pytest.mark.parametrize("nc, max_det, topk", [(3, 20, 1024), (3, 300, 1024), (1, 100, 256), (5, 400, 200)],
                         ids=["K above max_det", "K and max_det 300", "one class", "K below max_det"])
def test_nms_rotated_matches_jax(nc, max_det, topk):
    """``nms_rotated`` against JAX's ``fori_loop``: the same counts and the
    same kept rows (xywhr, conf, cls), with the pool above and below
    ``max_det``, over one and several classes; the plain suppression keeps
    every candidate when no two overlap past the threshold."""
    rb, sc = _nms_inputs(nc, nc=nc)
    got, gn = t_nms_rotated(_t(rb), _t(sc), 0.25, 0.45, max_det, topk)
    want, wn = jax.jit(partial(j_nms_rotated, conf_thres=0.25, iou_thres=0.45, max_det=max_det,
                               pre_nms_topk=topk))(rb, sc)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert int(gn.min()) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    far = _t(rb[:, :8].copy())
    far[..., 0] += torch.arange(8, dtype=torch.float32) * 200
    assert nms_rotated_suppress_plain(far, torch.ones(2, 8, dtype=torch.bool), 0.45).all()


def _assign_inputs(seed, m=5):
    rng = np.random.default_rng(seed)
    shapes = [(IMGSZ // s, IMGSZ // s) for s in STRIDES]
    anc, st = t_anchors.make_anchors(shapes, STRIDES, 0.5)
    a = anc.shape[0]
    pd = np.concatenate([rng.uniform(0, IMGSZ, (2, a, 2)), rng.uniform(6, 30, (2, a, 2)),
                         rng.uniform(-0.7, 2.3, (2, a, 1))], -1).astype(np.float32)
    wh = rng.uniform(10, 30, (2, m, 2))
    gt = np.concatenate([rng.uniform(wh / 2, IMGSZ - wh / 2), wh, rng.uniform(-np.pi / 2, 0, (2, m, 1))],
                        -1).astype(np.float32)
    mask = np.ones((2, m), bool)
    mask[1, -2:] = False
    gt[~mask] = 0
    scores = rng.uniform(0, 1, (2, a, NC)).astype(np.float32)
    labels = rng.integers(0, NC, (2, m)).astype(np.int32)
    return scores, pd, (anc * st).numpy(), labels, gt, mask


def test_rotated_assign_matches_jax():
    """``assign(..., rotated=True)`` (anchors inside each rotated box, ProbIoU
    overlaps) against JAX's exact top-k: ``fg_mask``, ``target_gt_idx`` and the
    labels identical, the target boxes and scores within 1e-6."""
    args = _assign_inputs(4)
    res = t_tal.assign(*[_t(x) for x in args], topk=10, num_classes=NC, rotated=True)
    want = jax.jit(partial(j_tal.assign, topk=10, num_classes=NC, rotated=True, exact_topk=True))(*args)
    assert int(res.fg_mask.sum()) > 10
    np.testing.assert_array_equal(res.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(res.target_gt_idx.numpy(), np.asarray(want.target_gt_idx))
    np.testing.assert_array_equal(res.target_labels.numpy(), np.asarray(want.target_labels))
    np.testing.assert_allclose(res.target_bboxes.numpy(), np.asarray(want.target_bboxes), atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.target_scores.numpy(), np.asarray(want.target_scores), atol=1e-6, rtol=0)
    inside = t_tal.select_candidates_in_rotated_gts(_t(args[2]), _t(args[4]))
    np.testing.assert_array_equal(inside.numpy(),
                                  np.asarray(j_tal.select_candidates_in_rotated_gts(args[2], args[4])))


# -- the OBB loss --------------------------------------------------------------------------------------------------

def _loss_inputs(seed, no_fg=False, tiny=False, m=6):
    """Three detect maps, angle maps and labels of ``m`` rotated boxes an
    image (normalised xywh, the angle in [-pi/2, 0)); ``no_fg``: every row is
    padding; ``tiny``: two boxes an image under 2 px on a side."""
    rng = np.random.default_rng(seed)
    b = 2
    maps = [(2 * rng.standard_normal((b, 4 * REG_MAX + NC, h, w))).astype(np.float32) for h, w in SHAPES]
    amaps = [rng.standard_normal((b, 1, h, w)).astype(np.float32) for h, w in SHAPES]
    wh = rng.uniform(8, 32, (b, m, 2))
    if tiny:
        wh[:, :2, 0] = 1.5
    xy = rng.uniform(wh / 2, IMGSZ - wh / 2)
    ang = rng.uniform(-np.pi / 2, 0, (b, m, 1))
    lab = {"bboxes": np.concatenate([xy / IMGSZ, wh / IMGSZ, ang], -1).astype(np.float32),
           "cls": rng.integers(0, NC, (b, m)).astype(np.int32), "mask": np.full((b, m), not no_fg)}
    return maps, amaps, lab


LOSS_CASES = {"seeded": {}, "no foreground": {"no_fg": True}, "a gt under 2 px": {"tiny": True}}


@jax.jit
def _jax_obb_fn(feats, amaps, lab):
    def fn(f, a):
        return j_obb_loss(f, a, lab, STRIDES, JLossConfig(nc=NC, exact_topk=True))

    return jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(feats, amaps)


def _jax_obb_loss(maps, amaps, lab, dtype):
    """(total, comps, gradients), jitted; the angle maps in ``dtype``, the
    maps f32, as the JAX trainer's obb branch hands them."""
    (total, comps), grads = _jax_obb_fn([jnp.asarray(np.transpose(m, (0, 2, 3, 1))) for m in maps],
                                        [jnp.asarray(np.transpose(a, (0, 2, 3, 1))).astype(dtype) for a in amaps],
                                        {k: jnp.asarray(v) for k, v in lab.items()})
    return float(total), {k: float(v) for k, v in comps.items()}, [_nchw(x) for x in (*grads[0], *grads[1])]


def _port_obb_loss(maps, amaps, lab, dtype):
    f = [torch.from_numpy(m).requires_grad_() for m in maps]
    a = [torch.from_numpy(x).to(dtype).requires_grad_() for x in amaps]
    total, comps, res = t_obb_loss(f, a, {n: torch.from_numpy(v) for n, v in lab.items()}, STRIDES, TLossConfig(nc=NC))
    total.backward()
    return total.item(), {n: v.item() for n, v in comps.items()}, [x.grad.float().numpy() for x in (*f, *a)], res


@pytest.fixture(scope="module")
def obb_losses():
    out = {}
    for name, kw in LOSS_CASES.items():
        maps, amaps, lab = _loss_inputs(0, **kw)
        out[name] = {"j32": _jax_obb_loss(maps, amaps, lab, jnp.float32),
                     "j16": _jax_obb_loss(maps, amaps, lab, jnp.bfloat16),
                     "t32": _port_obb_loss(maps, amaps, lab, torch.float32),
                     "t16": _port_obb_loss(maps, amaps, lab, torch.bfloat16)}
    return out


def _rel_l2(a, b):
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb if nb else np.linalg.norm(a)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_obb_loss_matches_jax(obb_losses, case):
    """f32: the total and box, cls, dfl within 1e-5 relative of JAX's (1e-6
    absolute where JAX's is 0: no foreground), each gradient within 1e-4
    relative L2 (1e-6 absolute where JAX's is 0) on the entries where JAX's
    is finite; gts under 2 px take no anchor. Where a background anchor's
    target is a padded zero box (gt row 0 masked: no labels, or under 2 px)
    JAX's gradient is NaN (0 * inf through the ProbIoU's square root); the
    port's is finite everywhere and 0 there."""
    total, comps, grads, res = obb_losses[case]["t32"]
    jtotal, jcomps, jgrads = obb_losses[case]["j32"]
    fg = int(res.fg_mask.sum())
    assert (fg == 0) == (case == "no foreground")
    assert sorted(comps) == sorted(jcomps) == ["box", "cls", "dfl"]
    for k in jcomps:
        np.testing.assert_allclose(comps[k], jcomps[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    nan = [~np.isfinite(jg) for jg in jgrads]
    assert any(m.any() for m in nan) == (case != "seeded")
    for i, (g, jg, m) in enumerate(zip(grads, jgrads, nan)):
        assert np.isfinite(g).all() and (g[m] == 0).all(), i
        assert _rel_l2(g[~m], jg[~m]) <= (1e-4 if np.linalg.norm(jg[~m]) else 1e-6), i
    if case == "a gt under 2 px":
        assert not (res.target_gt_idx[res.fg_mask] < 2).any()
    if fg:
        assert jcomps["box"] > 0 and np.abs(grads[-1]).max() > 0  # the angle maps take a gradient


@pytest.mark.parametrize("what", ["values", "gradients"])
def test_obb_loss_bf16_within_jax_bf16_error(obb_losses, what):
    """Angle maps in bf16 (the maps f32): over the cases, the port's values
    (total and components) or gradients are no further from JAX's f32
    results than 1.5 times JAX's own jitted bf16 results are (gradients on
    the entries where both of JAX's are finite)."""
    def vec(r):
        return np.asarray([r[0], *[r[1][k] for k in ("box", "cls", "dfl")]]) if what == "values" \
            else np.concatenate([g.ravel() for g in r[2]])
    port = jaxd = 0.0
    for case in LOSS_CASES:
        ref, j16 = vec(obb_losses[case]["j32"]), vec(obb_losses[case]["j16"])
        ok = np.isfinite(ref) & np.isfinite(j16)
        port += np.sum((vec(obb_losses[case]["t16"])[ok] - ref[ok]) ** 2)
        jaxd += np.sum((j16[ok] - ref[ok]) ** 2)
    assert jaxd > 0
    assert np.sqrt(port) <= RATIO * np.sqrt(jaxd), (np.sqrt(port), np.sqrt(jaxd))


# -- data ----------------------------------------------------------------------------------------------------------

SIZES = [(64, 64), (48, 80), (96, 64), (80, 40), (64, 100), (33, 77)]
SAMPLE_HYPS = {
    "mosaic4, warp, flips": {"degrees": 10.0, "shear": 5.0, "perspective": 1e-4, "flipud": 0.5},
    "mosaic9, warp": {"mosaic9": 1.0, "degrees": 10.0, "flipud": 0.5, "translate": 0.3},
    "mixup": {"mixup": 1.0, "degrees": 10.0, "perspective": 1e-4},
    "letterbox, warp, flips": {"mosaic": 0.0, "degrees": 10.0, "shear": 5.0, "flipud": 0.5, "scale": 0.9},
    "letterbox": {"mosaic": 0.0, "degrees": 0.0, "translate": 0.0, "scale": 0.0, "fliplr": 0.0, "hsv_h": 0.0,
                  "hsv_s": 0.0, "hsv_v": 0.0},
}


@pytest.fixture(scope="module")
def obb_data(tmp_path_factory):
    """The port's synthetic obb dataset (6 train, 4 val at 64 px), and a copy
    at mixed image sizes."""
    root = tmp_path_factory.mktemp("obb")
    yaml = t_make(root / "synthetic", "obb", n_train=6, n_val=4, imgsz=IMGSZ, seed=0)
    shutil.copytree(root / "synthetic", root / "mixed", ignore=shutil.ignore_patterns("*.cache.npy"))
    for split in ("train", "val"):
        for i, f in enumerate(sorted((root / "mixed" / "images" / split).glob("*.bmp"))):
            h, w = SIZES[i % len(SIZES)]
            image_io.imwrite(f, TA.resize_linear(image_io.imread(f, "cpu"), (w, h)))
    mixed = root / "mixed" / "data.yaml"
    mixed.write_text(yaml.read_text().replace(str(yaml.parent), str(mixed.parent)))
    return root, yaml


def test_synthetic_obb_labels_match_jax(obb_data, tmp_path):
    """The same draws as the JAX generator: label files and data.yaml equal;
    each rectangle is filled as ``cv2.fillPoly`` fills it."""
    root, yaml = obb_data
    j_make(tmp_path / "j", "obb", n_train=6, n_val=4, imgsz=IMGSZ, seed=0)
    for split in ("train", "val"):
        files = sorted((root / "synthetic" / "labels" / split).glob("*.txt"))
        assert len(files) == (6 if split == "train" else 4)
        for f in files:
            assert f.read_text() == (tmp_path / "j" / "labels" / split / f.name).read_text()
    assert [ln for ln in yaml.read_text().splitlines() if not ln.startswith("path")] == \
        [ln for ln in (tmp_path / "j" / "data.yaml").read_text().splitlines() if not ln.startswith("path")]
    img = image_io.imread(root / "synthetic" / "images" / "train" / "00000.bmp", "cpu")
    assert (img.min(-1) >= 120).sum() > 100  # a rectangle's colour, above the background's


def _record(monkeypatch, module):
    """Record every corner set ``module.xyxyxyxy2xywhr`` is handed."""
    seen = []
    orig = module.xyxyxyxy2xywhr

    def rec(corners):
        seen.append(np.array(corners, np.float32))
        return orig(corners)

    monkeypatch.setattr(module, "xyxyxyxy2xywhr", rec)
    return seen


def _datasets(root, name, split="train"):
    ov = {"imgsz": IMGSZ, "task": "obb", "fliplr": 0.5, **SAMPLE_HYPS[name]}
    path = root / "mixed" / "images" / split
    return (TDataset(path, imgsz=IMGSZ, augment=True, hyp=t_cfg(ov), task="obb", device="cpu"),
            JDataset(path, imgsz=IMGSZ, augment=True, hyp=j_cfg(overrides=ov), task="obb"))


@pytest.mark.parametrize("name", list(SAMPLE_HYPS))
def test_obb_samples_match_jax(obb_data, name, monkeypatch):
    """``get_sample`` for 3 seeds and every image of the mixed set, task obb:
    the corners handed to ``xyxyxyxy2xywhr`` within 1e-5 px of the JAX
    package's (through letterbox, mosaic 4 and 9 with their clip, the warp,
    flips, MixUp), and the formatted (max_labels, 5) boxes, classes and label
    mask identical."""
    root, _ = obb_data
    tds, jds = _datasets(root, name)
    t_seen, j_seen = _record(monkeypatch, TA), _record(monkeypatch, JA)
    n = 0
    for seed in range(3):
        for i in range(len(tds)):
            t, j = tds.get_sample(i, np.random.default_rng(seed)), jds.get_sample(i, np.random.default_rng(seed))
            assert sorted(t) == sorted(j) == ["bboxes", "cls", "img", "mask"]
            assert t["bboxes"].shape == (128, 5)
            for k in ("bboxes", "cls", "mask"):
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"seed {seed} image {i} {k}")
            n += int(t["mask"].sum())
    assert n > 0 and len(t_seen) == len(j_seen) > 0
    for a, b in zip(t_seen, j_seen):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def _special_quads():
    rng = np.random.default_rng(9)
    quads = []
    for _ in range(40):  # axis-aligned rectangles, squares at 45 degrees, nearly degenerate quads
        x, y, w, h = rng.integers(0, 60, 4)
        quads.append([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])
        c, r = rng.uniform(10, 600, 2), rng.uniform(1, 50)
        quads.append([[c[0], c[1] - r], [c[0] + r, c[1]], [c[0], c[1] + r], [c[0] - r, c[1]]])
        a, d = rng.uniform(0, 600, 2), rng.uniform(-50, 50, 2)
        quads.append(np.stack([a, a + d, a + 2 * d, a + 0.5 * d]) + rng.normal(0, 1e-3, (4, 2)))
    quads += [[[0, 0], [4, 0], [4, 2], [0, 2]], [[0, 1], [1, 0], [2, 1], [1, 2]], [[3, 3]] * 4,
              [[0, 0], [5, 5], [2, 2], [5, 5]]]
    return np.asarray(quads, np.float32)


def _cv2_rects(quads):
    return np.asarray([[*c, *s, a] for c, s, a in (cv2.minAreaRect(q) for q in quads)], np.float32)


@pytest.mark.parametrize("source", ["synthetic set", "augmented samples", "special quads"])
def test_min_area_rect_bit_equal_to_cv2(obb_data, source, monkeypatch):
    """``min_area_rect`` equal to ``cv2.minAreaRect`` (OpenCV 5.0) bit for
    bit, and ``xyxyxyxy2xywhr`` to the JAX package's: on the synthetic set's
    corners, on the corners that letterbox, mosaic 4 and 9, the warp and the
    flips produce, and on axis-aligned rectangles, squares at 45 degrees,
    nearly degenerate and degenerate quads."""
    root, _ = obb_data
    if source == "synthetic set":
        quads = np.concatenate([np.asarray([ln.split()[1:] for ln in f.read_text().splitlines()], np.float32)
                                for f in sorted((root / "synthetic" / "labels").rglob("*.txt"))]) * IMGSZ
        quads = quads.reshape(-1, 4, 2)
    elif source == "augmented samples":
        seen = _record(monkeypatch, TA)
        for name in ("mosaic4, warp, flips", "mosaic9, warp", "letterbox, warp, flips"):
            tds, _ = _datasets(root, name)
            for i in range(len(tds)):
                tds.get_sample(i, np.random.default_rng(i))
        quads = np.concatenate(seen)
    else:
        quads = _special_quads()
    assert len(quads) >= 20
    np.testing.assert_array_equal(min_area_rect(quads).view(np.int32), _cv2_rects(quads).view(np.int32))
    np.testing.assert_array_equal(TA.xyxyxyxy2xywhr(quads), JA.xyxyxyxy2xywhr(quads))


def test_obb_val_samples_and_loader_match_jax(obb_data):
    """Letterboxed val samples (the (128, 5) boxes, ``ori_shape``,
    ``ratio_pad``) equal; the loader stacks ``bboxes`` (B, 128, 5)."""
    from experiment_yolo_torch.data import DataLoader as TLoader

    root, _ = obb_data
    path = root / "mixed" / "images" / "val"
    tds = TDataset(path, imgsz=IMGSZ, augment=False, task="obb", device="cpu")
    jds = JDataset(path, imgsz=IMGSZ, augment=False, task="obb")
    for i in range(len(tds)):
        t, j = tds.get_val_sample(i), jds.get_val_sample(i)
        assert sorted(t) == sorted(j)
        for k in t:
            if k != "img":
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"{i} {k}")
    batch = next(iter(TLoader(tds, 2, shuffle=False, workers=1)))
    assert batch["bboxes"].shape == (2, 128, 5) and batch["bboxes"].dtype == np.float32


# -- validator, predictor, results, server, checkpoint, train ------------------------------------------------------

class _StubModel:
    """What the JAX validator asks of a model: strides and ``predict`` handing
    back fixed outputs (the port model's on the same batch)."""

    def __init__(self, outs, strides):
        self.outs, self.strides = outs, strides

    def predict(self, variables, imgs):
        return self.outs


@pytest.fixture(scope="module")
def confident_obb_model():
    """The port's tiny OBB model, nc 1, with boxes of about 20 px and class
    logits around 0 (a seeded model's priors keep every score under the val
    conf)."""
    tm = TOBBModel({**yaml_model_load(TINY), "nc": 1}, device="cpu")
    with torch.no_grad():
        sized_boxes_(tm, 20.0)
        for cls in tm.detect.cv3:
            cls[-1].bias.zero_()
    tm.eval()
    return tm


def test_obb_validator_matches_jax(obb_data, confident_obb_model):
    """``OBBValidator`` on the obb dataset's mixed-size val split: its stats
    equal to the JAX validator's run on the port model's outputs for the same
    batch (rotated NMS through K7's plain version against JAX's loop, xywhr
    boxes back through each image's gain and pad, ProbIoU matching)."""
    root, yaml = obb_data
    tm = confident_obb_model
    ov = {"data": str(root / "mixed" / "data.yaml"), "imgsz": IMGSZ, "batch": 4, "workers": 1, "verbose": False}
    got = OBBValidator(ov)(tm)
    jds = JDataset(root / "mixed" / "images" / "val", imgsz=IMGSZ, augment=False, task="obb")
    batch = next(iter(JLoader(jds, 4, shuffle=False, workers=1, drop_last=False)))
    with torch.no_grad():
        outs = tuple(jnp.asarray(t.numpy()) for t in tm.predict(_t(batch["img"]).permute(0, 3, 1, 2).float() / 255))
    want = JValidator(dict(ov))(_StubModel(outs, tm.stride), None)
    assert sorted(got) == sorted(want)
    assert got["mAP50"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_predictor_results_server_and_checkpoint_match_jax(confident_obb_model, tmp_path):
    """``DetectionPredictor`` on an OBB model: hard rotated NMS whatever
    ``nms_type`` says, each detection's centre back through the image's gain
    and pad and clipped to it, its extents over the gain, its angle as it
    is, and ``classes`` not applied, as in JAX; the CLI's ``predict`` on its
    checkpoint; ``Results.obb`` (``xywhr``,
    ``conf``, ``cls``, ``xyxyxyxy``), ``len``, ``verbose`` and the server's
    JSON equal to JAX's ``Results`` and ``serialize_results``, and
    ``to_dict``, ``tojson``, ``save_txt`` and ``save_crop`` raising as
    JAX's; a checkpoint's round trip rebuilds an ``OBBModel`` with the same
    detections."""
    tm = confident_obb_model
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (50, 70, 3), np.uint8), rng.integers(0, 255, (90, 40, 3), np.uint8)]
    ov = {"imgsz": IMGSZ, "batch": 2, "conf": 0.3, "max_det": 20, "nms_type": "soft", "classes": [3]}
    res = DetectionPredictor(tm, ov)(imgs)
    x = _t(np.stack([TA.letterbox(im, IMGSZ)[0][..., ::-1] for im in imgs]))
    det, counts = DetectionPredictor(tm, ov).infer(x)
    for i, (r, im) in enumerate(zip(res, imgs)):
        n = int(counts[i])
        assert n > 0 and r.obb.data.shape == (n, 7) and r.boxes is None and len(r) == n
        _, gain, (padw, padh) = TA.letterbox(im, IMGSZ)
        want = det[i, :n].numpy().copy()
        want[:, 0] = ((want[:, 0] - padw) / gain).clip(0, im.shape[1])
        want[:, 1] = ((want[:, 1] - padh) / gain).clip(0, im.shape[0])
        want[:, 2:4] = want[:, 2:4] / gain
        np.testing.assert_array_equal(r.obb.data, want)
        j = JResults(im, r.path, r.names, None, obb=r.obb.data)
        for attr in ("xywhr", "conf", "cls", "xyxyxyxy"):
            np.testing.assert_array_equal(getattr(r.obb, attr), getattr(j.obb, attr), err_msg=attr)
        assert len(r) == len(j) and r.verbose() == j.verbose() == "(no detections), "
        assert serialize_results(r) == j_serialize(j) and "points" in serialize_results(r)["detections"][0]
        for call, err in ((lambda o: o.to_dict(), AttributeError), (lambda o: o.tojson(), AttributeError),
                          (lambda o: o.save_txt(tmp_path / "a.txt"), TypeError),
                          (lambda o: o.save_crop(tmp_path / "crops"), TypeError)):
            for obj in (r, j):
                with pytest.raises(err):
                    call(obj)
    ckpt = save_checkpoint(tmp_path / "obb.pt", tm)
    back = load_checkpoint(ckpt, "cpu")
    assert type(back) is TOBBModel and torch.load(ckpt, weights_only=True)["task"] == "obb"
    for r, r2 in zip(res, DetectionPredictor(back, ov)(imgs)):
        np.testing.assert_array_equal(r.obb.data, r2.obb.data)
    image_io.imwrite(tmp_path / "a.bmp", imgs[0])
    cli = entrypoint(["predict", f"model={ckpt}", f"source={tmp_path / 'a.bmp'}", "imgsz=64", "conf=0.3", "max_det=20",
                      "device=cpu"])
    np.testing.assert_array_equal(cli[0].obb.data, res[0].obb.data)


def test_obb_train_epoch_and_reload(obb_data):
    """``YOLO(tiny-obb).train()`` for one epoch on the synthetic obb set: the
    loss components are box, cls and dfl, the validator's stats come back,
    and ``last.pt`` reloads as an ``OBBModel`` equal to the EMA."""
    root, yaml = obb_data
    yolo = YOLO(TINY, device="cpu")
    metrics = yolo.train(data=str(yaml), epochs=1, batch=6, imgsz=IMGSZ, workers=1, amp=False,
                         project=str(root / "runs"), optimizer="SGD")
    assert set(yolo.trainer.loss_items) == {"box", "cls", "dfl"} and "mAP50" in metrics
    back = YOLO(str(yolo.trainer.save_dir / "weights" / "last.pt"), device="cpu").model
    assert type(back) is TOBBModel
    ema = yolo.trainer.state.ema.ema.state_dict()
    assert all(torch.equal(v, ema[k]) for k, v in back.state_dict().items())


# -- the DOTA tools ------------------------------------------------------------------------------------------------

DOTA_NAMES = list(t_converter.DOTA_CLASSES)


@pytest.fixture(scope="module")
def dota_tree(tmp_path_factory):
    """A tiny DOTA tree: PNG images in train, val and test, and ``*_original``
    labels (corners in pixels, a category, a difficulty), some objects across
    the crop windows' edges."""
    root = tmp_path_factory.mktemp("dota") / "DOTA"
    rng = np.random.default_rng(3)
    for split, sizes in (("train", [(150, 200), (90, 120)]), ("val", [(130, 170)]), ("test", [(140, 100)])):
        (root / "images" / split).mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            image_io.imwrite(root / "images" / split / f"P{split}{i:03d}.png",
                             rng.integers(0, 255, (h, w, 3), np.uint8))
            if split == "test":
                continue
            lines = []
            for _ in range(8):
                c, r, a = rng.uniform([10, 10], [w - 10, h - 10]), rng.uniform(4, 30, 2), rng.uniform(0, np.pi)
                q = np.asarray([[-r[0], -r[1]], [r[0], -r[1]], [r[0], r[1]], [-r[0], r[1]]]) @ \
                    np.asarray([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]]) + c
                lines.append(" ".join(f"{v:.1f}" for v in q.ravel()) + f" {DOTA_NAMES[rng.integers(0, 15)]} 0")
            (root / "labels" / f"{split}_original").mkdir(parents=True, exist_ok=True)
            (root / "labels" / f"{split}_original" / f"P{split}{i:03d}.txt").write_text("\n".join(lines) + "\n")
    return root


def _crops(monkeypatch, module, attr):
    got = {}

    def rec(path, img, *args, **kwargs):
        got[str(path).split("/images/")[1]] = np.array(img)
        return True

    monkeypatch.setattr(module, attr, rec)
    return got


def test_dota_convert_and_split_match_jax(dota_tree, tmp_path, monkeypatch):
    """``convert_dota_to_yolo_obb`` writes label files byte-equal to JAX's
    (``DOTA_CLASSES`` equal); ``split_trainval`` and ``split_test`` at crop
    64, gap 16 and rates 1 and 0.5: the label files byte-equal, the crops
    equal to JAX's crop arrays before encoding, and ``get_windows``,
    ``get_window_obj`` and ``bbox_iof`` equal."""
    assert t_converter.DOTA_CLASSES == j_converter.DOTA_CLASSES
    jroot = tmp_path / "jax"
    shutil.copytree(dota_tree, jroot)
    t_converter.convert_dota_to_yolo_obb(str(dota_tree))
    j_converter.convert_dota_to_yolo_obb(str(jroot))
    for split in ("train", "val"):
        files = sorted((dota_tree / "labels" / split).glob("*.txt"))
        assert files and all(f.read_bytes() == (jroot / "labels" / split / f.name).read_bytes() for f in files)
    t_crops = _crops(monkeypatch, image_io, "imwrite")
    j_crops = _crops(monkeypatch, cv2, "imwrite")
    kw = {"crop_size": 64, "gap": 16, "rates": (1.0, 0.5)}
    t_split.split_trainval(str(dota_tree), str(tmp_path / "t_split"), device="cpu", **kw)
    t_split.split_test(str(dota_tree), str(tmp_path / "t_split"), device="cpu", **kw)
    j_split.split_trainval(str(jroot), str(tmp_path / "j_split"), **kw)
    j_split.split_test(str(jroot), str(tmp_path / "j_split"), **kw)
    assert sorted(t_crops) == sorted(j_crops) and len(t_crops) > 20
    for k in t_crops:
        np.testing.assert_array_equal(t_crops[k], j_crops[k], err_msg=k)
    t_labels = sorted((tmp_path / "t_split" / "labels").rglob("*.txt"))
    assert len(t_labels) > 5
    assert [f.name for f in t_labels] == [f.name for f in sorted((tmp_path / "j_split" / "labels").rglob("*.txt"))]
    for f in t_labels:
        assert f.read_bytes() == (tmp_path / "j_split" / f.relative_to(tmp_path / "t_split")).read_bytes()
    for t_anno, j_anno in zip(t_split.load_yolo_dota(str(dota_tree)), j_split.load_yolo_dota(str(jroot))):
        assert t_anno["ori_size"] == j_anno["ori_size"]
        np.testing.assert_array_equal(t_anno["label"], j_anno["label"])
        win = t_split.get_windows(t_anno["ori_size"], (64, 128), (16, 32))
        np.testing.assert_array_equal(win, j_split.get_windows(j_anno["ori_size"], (64, 128), (16, 32)))
        for a, b in zip(t_split.get_window_obj(t_anno, win), j_split.get_window_obj(j_anno, win)):
            np.testing.assert_array_equal(a, b)
        quads = t_anno["label"][:, 1:] * np.tile(t_anno["ori_size"][::-1], 4)
        np.testing.assert_array_equal(t_split.bbox_iof(quads, win), j_split.bbox_iof(quads, win))
