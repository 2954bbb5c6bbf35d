"""The paper's two-stage inference in the PyTorch port against the JAX
package: ``engine/double_inference.py`` (crop-and-refine) and
``engine/sliced.py`` (SAHI-style slices), their helpers, NMS's ``max_wh``, and
the facade's ``double_predict`` and ``sliced_predict``.

Both packages run the same weights: the port's seeded LD-P2 (nc=3, He-normal
convs, every box about 24 px a side: ``utils/seeded.py:sized_boxes_``, so that
boxes are confident and crops find them again), moved into JAX with the JAX
package's ``utils/torch_convert.py:convert_state_dict``. Sizes are small:
crops of 64 px, 4 a batch; slices of 64 px, the full image at 64.

The JAX LD-P2 takes its LDConv layers on the gather path (``sampling='gather'``,
what K3 computes), as ``tests/test_torch_port_amp.py``'s: the default ``auto``
compiles a dense hat window as well, a TPU workaround the port does not carry
(ROADMAP catalogue item 5), for a minute of compile a train step.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch import YOLO
from experiment_yolo_torch.data import image_io
from experiment_yolo_torch.engine import double_inference as tdi
from experiment_yolo_torch.engine import sliced as tsl
from experiment_yolo_torch.engine.predictor import DetectionPredictor
from experiment_yolo_torch.engine.results import Results as TResults
from experiment_yolo_torch.nn.tasks import yaml_model_load
from experiment_yolo_torch.ops.nms import non_max_suppression as t_nms
from experiment_yolo_torch.utils.seeded import he_normal_, seeded_images, seeded_model, sized_boxes_
from experiment_yolo_tpu.engine import double_inference as jdi
from experiment_yolo_tpu.engine import sliced as jsl
from experiment_yolo_tpu.engine.results import Results as JResults
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.ops.nms import non_max_suppression as j_nms
from experiment_yolo_tpu.utils.torch_convert import convert_state_dict
from test_torch_port_model import _match
from test_torch_port_amp import _gather_ldconv

CFG, NC, SIDE = "yolov8-LD-P2.yaml", 3, 24.0
TINY = str(Path(__file__).parent / "assets" / "tiny.yaml")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one torch thread, as ``tests/test_torch_port_fit.py``'s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The port's seeded detector on the CPU and the same weights in JAX."""
    cfg = {**yaml_model_load(CFG), "nc": NC}
    tm = seeded_model(cfg, 0, device="cpu")
    sized_boxes_(tm, SIDE)
    with _gather_ldconv():
        jm = JaxModel(CFG, nc=NC)
    jm.names = tm.names
    variables = convert_state_dict({k: v.numpy() for k, v in tm.state_dict().items()
                                    if not k.endswith("num_batches_tracked")}, jm)
    return tm, jm, variables


@pytest.fixture(scope="module")
def image():
    """A 200 x 240 BGR image: blocks of colour plus noise."""
    return np.ascontiguousarray(seeded_images(1, 3)[0][:200, :240])


def test_calculate_optimal_crop_matches_jax():
    """Seeded boxes, some at the image's edges, small (the 32 px floor) and
    large (20% of the side): the same crops."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(40, 900, 2))
        x1, y1 = rng.uniform(-10, w), rng.uniform(-10, h)
        box = np.asarray([x1, y1, x1 + rng.uniform(0, 400), y1 + rng.uniform(0, 400)], np.float32)
        assert tdi.calculate_optimal_crop(box, (h, w)) == jdi.calculate_optimal_crop(box, (h, w))
        assert (tdi.calculate_optimal_crop(box, (h, w), 0.5, 8) == jdi.calculate_optimal_crop(box, (h, w), 0.5, 8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_class_nms_matches_jax(seed):
    """Clustered boxes of three classes, duplicates among them: the same kept indices."""
    rng = np.random.default_rng(seed)
    n = 60
    xy = rng.uniform(0, 100, (n // 4, 2)).repeat(4, 0) + rng.normal(0, 3, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 30, (n, 2))], 1).astype(np.float32)
    boxes[5] = boxes[4]
    scores = rng.uniform(0, 1, n).astype(np.float32)
    classes = rng.integers(0, 3, n // 4).repeat(4).astype(np.float32)  # a cluster's class, a few others
    classes[rng.integers(0, n, 8)] = rng.integers(0, 3, 8)
    for thr in (0.3, 0.45, 0.7):
        got = tdi.per_class_nms(boxes, scores, classes, thr)
        np.testing.assert_array_equal(got, jdi.per_class_nms(boxes, scores, classes, thr))
        assert 0 < len(got) < n


def test_slice_grid_and_nms_max_wh_match_jax():
    for h, w in [(1080, 1920), (720, 1280), (512, 512), (300, 700), (513, 513), (64, 2000), (150, 200)]:
        for s, ov in [(512, 0.2), (64, 0.25), (640, 0.0), (128, 0.5)]:
            assert tsl.slice_grid(h, w, s, ov) == jsl.slice_grid(h, w, s, ov)
    for h, w in [(720, 1280), (7679, 10), (7680, 7680), (7681, 3), (15360, 200), (40000, 9)]:
        assert tsl.nms_max_wh(h, w) == jsl.nms_max_wh(h, w) > max(h, w)


@pytest.mark.parametrize("nms_type", ["hard", "soft"])
def test_nms_max_wh_matches_jax_on_boxes_wider_than_7680(nms_type):
    """Boxes across a 16,000 px square image, two classes: with the default
    ``max_wh`` of 7680 a class-1 box lands on a class-0 box 7,680 px to its
    lower right (the offset shifts x and y) and suppresses it; with
    ``nms_max_wh`` nothing crosses classes. Both packages give the same
    detections at both settings."""
    rng = np.random.default_rng(4)
    n = 64
    boxes = np.concatenate([rng.uniform(7700, 16000, (n, 2)), rng.uniform(20, 60, (n, 2))], 1).astype(np.float32)
    boxes[1::2] = boxes[0::2] - [7675.0, 7680.0, 0.0, 0.0]  # each class-0 box's class-1 partner
    scores = np.zeros((1, n, 2), np.float32)
    scores[0, 0::2, 0] = rng.uniform(0.3, 0.6, n // 2)
    scores[0, 1::2, 1] = rng.uniform(0.7, 0.9, n // 2)
    out = {}
    for max_wh in (7680.0, tsl.nms_max_wh(16000, 16000)):
        kw = dict(conf_thres=0.25, iou_thres=0.5, max_det=100, nms_type=nms_type, max_wh=max_wh)
        td, tn = t_nms(torch.from_numpy(boxes[None]), torch.from_numpy(scores), **kw)
        jd, jn = j_nms(jnp.asarray(boxes[None]), jnp.asarray(scores), **kw)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-3, rtol=0)
        out[max_wh] = td[0, :int(tn[0])].numpy()
    low, high = out.values()
    assert len(high) == n and len(low) < n  # the offset matters here


def _first_pass(tm, img):
    """Hand-made first-pass rows from the port's own detections at 64 px:
    four gated boxes with low confs (a crop may beat them), one with conf
    0.9999 (no crop beats it) and one below the 0.25 gate (left as it is)."""
    res = DetectionPredictor(tm, {"imgsz": 64, "batch": 1, "conf": 0.05})([img])[0]
    rows = res.boxes.data[::3][:6].copy()
    assert len(rows) == 6
    rows[:, 4] = [0.26, 0.3, 0.9999, 0.27, 0.1, 0.28]
    return rows


@pytest.mark.parametrize("final_nms_iou", [1.0, 0.45])
def test_double_inference_refine_matches_jax(pair, image, final_nms_iou):
    """``DoubleInference.refine`` on hand-made first-pass results, crops of
    64 px in batches of 4: the same refined detections as the JAX package's,
    with some refined boxes accepted and some rejected (counted with the
    final NMS off, ``final_nms_iou`` 1.0, so that rows map one to one); empty
    results pass through."""
    tm, jm, variables = pair
    rows = _first_pass(tm, image)
    cfg = dict(crop_size=64, max_crops=4, final_nms_iou=final_nms_iou)
    got = tdi.DoubleInference(tm, tdi.DoubleInferenceConfig(**cfg)).refine(TResults(image, "t", tm.names, rows))
    want = jdi.DoubleInference(jm, variables, jdi.DoubleInferenceConfig(**cfg)).refine(
        JResults(image, "t", jm.names, rows))
    assert len(want.boxes.data) > 0
    _match(got.boxes.data, want.boxes.data)
    if final_nms_iou == 1.0:
        out = got.boxes.data
        assert len(out) == len(rows)
        changed = ~np.all(np.isclose(out, rows), 1)
        assert 1 <= changed[:4].sum(), "no refined box was accepted: the comparison would be empty"
        assert (~changed[[0, 1, 2, 3, 5]]).sum() >= 1, "no refined box was rejected"
        assert not changed[[2, 4]].any()  # conf 0.9999 cannot be beaten; conf 0.1 is below the gate, and 0.28 the 5th
        assert (out[changed, 4] > rows[changed, 4]).all()
    empty = TResults(image, "t", tm.names, np.zeros((0, 6), np.float32))
    assert len(tdi.DoubleInference(tm, tdi.DoubleInferenceConfig(**cfg)).refine(empty)) == 0


@pytest.mark.parametrize("include_full,nms_type", [(True, "soft"), (False, "hard")])
def test_sliced_predictor_matches_jax(pair, image, include_full, nms_type):
    """``SlicedPredictor`` on a 200 x 240 image, slices of 64 px at overlap
    0.25 (20 slices that overlap by at least 16 px), with the letterboxed
    full image and soft NMS, and without it and hard NMS: the same detections
    as the JAX package's."""
    tm, jm, variables = pair
    kw = dict(slice=64, overlap=0.25, include_full=include_full)
    overrides = {"imgsz": 64, "nms_type": nms_type, "verbose": False}
    got = tsl.SlicedPredictor(tm, overrides, **kw)([image])
    want = jsl.SlicedPredictor(jm, variables, overrides=overrides, **kw)([image])
    assert len(got) == len(want) == 1 and len(jsl.slice_grid(200, 240, 64, 0.25)) == 20
    assert len(want[0].boxes.data) > 0, "no detections: the comparison would be empty"
    _match(got[0].boxes.data, want[0].boxes.data)
    d = got[0].boxes.data
    assert (d[:, [0, 2]] <= 240).all() and (d[:, [1, 3]] <= 200).all() and (d[:, :4] >= 0).all()


@pytest.fixture(scope="module")
def tiny_yolo():
    """The facade on ``tests/assets/tiny.yaml`` (a 2-level head, ~50k params),
    with He-normal convs and boxes about 24 px a side."""
    yolo = YOLO(TINY, device="cpu")
    he_normal_(yolo.model, 1)
    sized_boxes_(yolo.model, SIDE)
    return yolo


def test_facade_double_predict(tiny_yolo, image):
    """``YOLO.double_predict`` is ``predict``, then ``DoubleInference`` with
    the defaults (crops letterboxed to 640, 16 a batch): some boxes refined."""
    got = tiny_yolo.double_predict([image], imgsz=64)
    first = tiny_yolo.predict([image], imgsz=64)
    want = tdi.DoubleInference(tiny_yolo.model)(first)
    assert len(got) == 1 and len(got[0]) > 0
    np.testing.assert_array_equal(got[0].boxes.data, want[0].boxes.data)
    assert not np.array_equal(got[0].boxes.data, first[0].boxes.data)


def test_facade_sliced_predict(tiny_yolo, image, tmp_path):
    """``YOLO.sliced_predict`` is ``SlicedPredictor`` with the facade's
    overrides; ``stream=True`` yields the same results; a file reads as its
    pixels (for ``double_predict`` too); videos and streams raise."""
    got = tiny_yolo.sliced_predict(image, slice=64, overlap=0.25, imgsz=64)
    want = tsl.SlicedPredictor(tiny_yolo.model, {"imgsz": 64}, slice=64, overlap=0.25)([image])
    assert len(got) == 1 and len(got[0]) > 0
    np.testing.assert_array_equal(got[0].boxes.data, want[0].boxes.data)
    streamed = list(tiny_yolo.sliced_predict([image], stream=True, slice=64, overlap=0.25, imgsz=64))
    np.testing.assert_array_equal(streamed[0].boxes.data, want[0].boxes.data)
    png = tmp_path / "a.png"
    image_io.imwrite(png, image)
    from_file = tiny_yolo.sliced_predict(str(png), slice=64, overlap=0.25, imgsz=64)
    assert from_file[0].path == str(png)
    np.testing.assert_array_equal(from_file[0].boxes.data, want[0].boxes.data)
    np.testing.assert_array_equal(tiny_yolo.double_predict([png], imgsz=64)[0].boxes.data,
                                  tiny_yolo.double_predict([image], imgsz=64)[0].boxes.data)
    (tmp_path / "clip.mp4").write_bytes(bytes(16))
    with pytest.raises(NotImplementedError, match="queue 1 item 3.5"):
        tiny_yolo.sliced_predict(tmp_path / "clip.mp4")
    with pytest.raises(NotImplementedError, match="queue 1 item 3.5"):
        tiny_yolo.double_predict("rtsp://camera/1")
