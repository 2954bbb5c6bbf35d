"""The whole LD-P2 detect path of the PyTorch port against the JAX package.

One JAX init (PRNGKey(0)) of ``yolov8-LD-P2.yaml`` at its n scale is converted
with the port's converter and loaded with ``strict=True``; both packages then
see the same pixels. The Detect class-bias priors are set to 0 before the
conversion so that scores sit near 0.5 and NMS has real work at conf 0.25.
The predictors also read a folder of JPEG and PNG files, which the port
decodes on the CPU to OpenCV's bytes.

The JAX LD-P2 takes its LDConv layers on the gather path (``sampling='gather'``,
what K3 computes), as ``tests/test_torch_port_amp.py``'s: the default ``auto``
compiles a dense hat window as well, a TPU workaround the port does not carry
(ROADMAP catalogue item 5), for a minute of compile a train step.
"""

import cv2
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
from test_torch_port_amp import _gather_ldconv

CFG = "yolov8-LD-P2.yaml"
IMGSZ = 128


@pytest.fixture(scope="module")
def pair():
    with _gather_ldconv():
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
    j_feats = jax.jit(jm.apply)(variables, x)
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


@pytest.mark.parametrize("nms_type", ["soft", "hard"])
def test_predictor_on_a_folder_matches_jax(pair, images, nms_type, tmp_path):
    """Both predictors on the same folder (two JPEGs, one of them resized by
    the letterbox, and a PNG, in two batches of 2): the same paths and shapes,
    detections within ``_match``; ``stream=True`` yields the list's results."""
    jm, variables, tm = pair
    cv2.imwrite(str(tmp_path / "a.jpg"), images[0])
    cv2.imwrite(str(tmp_path / "b.png"), images[1])
    cv2.imwrite(str(tmp_path / "c.jpg"), cv2.resize(images[0], (160, 96)))
    overrides = {"imgsz": IMGSZ, "batch": 2, "nms_type": nms_type}
    j_res = JaxPredictor(jm, variables, overrides=overrides)(str(tmp_path))
    t_pred = TorchPredictor(tm, overrides=overrides)
    t_res = t_pred(str(tmp_path))
    paths = [str(tmp_path / f) for f in ("a.jpg", "b.png", "c.jpg")]
    assert [r.path for r in t_res] == [r.path for r in j_res] == paths
    assert sum(len(r) for r in j_res) > 0, "no detections: the comparison would be empty"
    for t, j in zip(t_res, j_res):
        assert t.orig_shape == j.orig_shape
        np.testing.assert_array_equal(t.orig_img, j.orig_img)
        _match(t.boxes.data, j.boxes.data)
    streamed = t_pred(str(tmp_path), stream=True)
    assert not isinstance(streamed, list)
    streamed = list(streamed)
    assert [r.path for r in streamed] == [r.path for r in t_res]
    for a, b in zip(streamed, t_res):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)


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
    j_feats = jax.jit(jm.apply)(variables, x)
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


def test_a_value_at_scalseqs_kink_moves_bn_bias_gradient_not_the_output(monkeypatch):
    """Why a card step and a CPU step can both be right and still differ in
    ScalSeq's ``bn.bias`` gradient: its LeakyReLU has a kink at 0, so an
    element within rounding of 0 takes the slope 1 on one device and 0.1 on
    the other. One ScalSeq in training mode: moving ``bn.bias`` by 2e-6 on
    the channel of the picked element nearest 0 carries that element across
    0; the output moves by less than 1e-5 relative L2 and ``bn.bias``'s
    gradient, a plain sum of the slopes' products, by more than 1e-3. Given
    the other side's signs (as ``chip_smoke.py``'s card-versus-CPU step
    gives the CPU the card's), the gradients agree again."""
    from experiment_yolo_torch.nn.modules import ScalSeq

    rng = np.random.default_rng(29)
    with torch.random.fork_rng():  # the weights from a fixed seed, not from wherever the tests before left the generator
        torch.manual_seed(0)
        module = ScalSeq([8, 16, 32], 8).train()
    xs = [torch.from_numpy(rng.standard_normal((2, c, s, s)).astype(np.float32))
          for c, s in ((8, 16), (16, 8), (32, 4))]
    w = torch.from_numpy(rng.standard_normal((2, 8, 16, 16)).astype(np.float32))
    pre = []
    module.bn.register_forward_hook(lambda m, args, y: pre.append(y.detach()))

    def step(bias):
        with torch.no_grad():
            module.bn.bias.copy_(bias)
        module.zero_grad()
        out = module(xs)
        (out * w).sum().backward()
        return out.detach(), module.bn.bias.grad.clone(), pre[-1]

    bias = module.bn.bias.detach().clone()
    _, _, y = step(bias)
    picks = torch.nn.functional.leaky_relu(y, 0.1).argmax(2, keepdim=True)
    near = torch.full_like(y, float("inf")).scatter(2, picks, y.gather(2, picks).abs())
    at = np.unravel_index(int(near.flatten().argmin()), tuple(y.shape))
    delta = 1e-6
    shifted = [bias.clone(), bias.clone()]
    shifted[0][at[1]] += delta - y[at]
    shifted[1][at[1]] -= delta + y[at]
    out_a, grad_a, y_a = step(shifted[0])
    out_b, grad_b, y_b = step(shifted[1])
    assert y_a[at] > 0 > y_b[at]
    assert _rel(out_b, out_a) < 1e-5
    assert _rel(grad_b, grad_a) > 1e-3
    signs = y_a > 0
    monkeypatch.setattr(ScalSeq, "act", staticmethod(lambda z: torch.where(signs, z, 0.1 * z)))
    _, grad_given, _ = step(shifted[1])
    assert _rel(grad_given, grad_a) < 1e-5


def _rel(got, want):
    return float((got - want).norm() / want.norm())
