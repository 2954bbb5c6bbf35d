"""The whole LD-P2 detect path of the PyTorch port against the JAX package.

One JAX init (PRNGKey(0)) of ``yolov8-LD-P2.yaml`` at its n scale is converted
with the port's converter and loaded with ``strict=True``; both packages then
see the same pixels. The Detect class-bias priors are set to 0 before the
conversion so that scores sit near 0.5 and NMS has real work at conf 0.25.
"""

import jax
import numpy as np
import pytest
import torch

from experiment_yolo_torch.engine.predictor import DetectionPredictor as TorchPredictor
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.utils.convert import jax_variables_to_state_dict
from experiment_yolo_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.ops.anchors import decode_detections
from experiment_yolo_tpu.utils.torch_convert import invert_to_torch_state

CFG = "yolov8-LD-P2.yaml"
IMGSZ = 128


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(CFG)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    head = variables["params"][f"layers_{jm.detect_idx}"]
    for i in range(len(jm.strides)):
        head[f"cv3_{i}_2"]["bias"] = np.zeros_like(head[f"cv3_{i}_2"]["bias"])
    tm = TorchModel(CFG, device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(2)]


def test_structure_matches_jax(pair):
    jm, variables, tm = pair
    assert tm.stride == tuple(jm.strides) == (4, 8, 16)
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax == 918_288


def test_converter_matches_invert_to_torch_state(pair):
    """The port's converter against the JAX package's own inverse mapping,
    fed with the port's state-dict shapes: every leaf identical."""
    jm, variables, tm = pair
    mine = jax_variables_to_state_dict(variables, tm)
    theirs = invert_to_torch_state(variables, {k: tuple(v.shape) for k, v in tm.state_dict().items()}, jm)
    assert set(mine) - set(theirs) == {k for k in mine if k.endswith("num_batches_tracked")}
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)


def test_raw_maps_and_predict_match_jax(pair):
    """Raw head maps within 2e-3 abs, the bar the JAX package holds itself to
    against the fork (tests/test_torch_parity.py): f32 convolutions sum in
    another order in each framework and the 27 layers compound it. Decoded
    boxes within 1e-2 px for the same reason, scaled by the strides."""
    jm, variables, tm = pair
    x = np.random.default_rng(0).random((2, IMGSZ, IMGSZ, 3), dtype=np.float32)
    j_feats = jm.apply(variables, x)
    j_boxes, j_scores = decode_detections(j_feats, jm.strides, jm.nc, jm.reg_max)  # jm.predict's decode
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        t_feats = tm(xt)
        t_boxes, t_scores = tm.predict(xt)
    assert len(t_feats) == len(j_feats) == 3
    for tf, jf in zip(t_feats, j_feats):
        jf = np.transpose(np.asarray(jf), (0, 3, 1, 2))
        assert tf.shape == jf.shape
        np.testing.assert_allclose(tf.numpy(), jf, atol=2e-3, rtol=0)
    np.testing.assert_allclose(t_boxes.numpy(), np.asarray(j_boxes), atol=1e-2, rtol=0)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores), atol=1e-3, rtol=0)


def _match(t_boxes, j_boxes):
    """Same detections in any order: each JAX detection has a port detection of
    its class within 1e-2 px on every coordinate (scores that agree to ~1e-6
    may still swap places in a score sort)."""
    assert len(t_boxes) == len(j_boxes)
    for row in j_boxes:
        same_cls = t_boxes[t_boxes[:, 5] == row[5]]
        assert len(same_cls), f"no port detection of class {row[5]}"
        err = np.abs(same_cls[:, :4] - row[:4]).max(1)
        assert err.min() <= 1e-2, f"closest port box is {err.min()} px off"
        assert abs(same_cls[err.argmin(), 4] - row[4]) <= 1e-3


@pytest.mark.parametrize("nms_type", ["soft", "hard"])
def test_predictor_matches_jax(pair, images, nms_type):
    """DetectionPredictor end to end on two seeded images that are already at
    imgsz, so letterbox only pads and both packages see identical pixels:
    same counts and classes, boxes within 1e-2 px."""
    jm, variables, tm = pair
    overrides = {"imgsz": IMGSZ, "batch": 2, "nms_type": nms_type}
    j_res = JaxPredictor(jm, variables, overrides=overrides)(images)
    t_res = TorchPredictor(tm, overrides=overrides)(images)
    assert len(t_res) == len(j_res) == 2
    assert sum(len(r) for r in j_res) > 0, "no detections: the comparison would be empty"
    for t, j in zip(t_res, j_res):
        assert t.orig_shape == j.orig_shape
        _match(t.boxes.data, j.boxes.data)


def check_config_matches_jax(cfg, strides, n_params, jm, variables):
    """``cfg`` at n scale in both packages: the converted JAX ``variables``
    load into the port with ``strict=True``, strides, class count and
    parameter count agree with JAX and with ``strides`` and ``n_params``, and
    the raw head maps at imgsz 64 agree within 2e-3 abs, the bar LD-P2 is
    held to above. Returns the port model."""
    tm = TorchModel(cfg, device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    assert tm.stride == tuple(jm.strides) == strides and tm.nc == jm.nc
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax == n_params
    x = np.random.default_rng(2).random((2, 64, 64, 3), dtype=np.float32)
    j_feats = jm.apply(variables, x)
    with torch.no_grad():
        t_feats = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(t_feats) == len(j_feats) == len(strides)
    for tf, jf in zip(t_feats, j_feats):
        jf = np.transpose(np.asarray(jf), (0, 3, 1, 2))
        assert tf.shape == jf.shape and np.abs(jf).max() > 0.1
        np.testing.assert_allclose(tf.numpy(), jf, atol=2e-3, rtol=0)
    return tm


@pytest.mark.parametrize("cfg,strides,n_params", [("yolov8.yaml", (8, 16, 32), 3_157_184),
                                                  ("yolov8-ASF-P2P2.yaml", (4, 8, 16), 997_186)])
def test_plain_conv_configs_match_jax(cfg, strides, n_params):
    """The two configs whose downsampling is a plain ``Conv`` layer, at n
    scale, from a JAX init (:func:`check_config_matches_jax`)."""
    jm = JaxModel(cfg)
    check_config_matches_jax(cfg, strides, n_params, jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))))
