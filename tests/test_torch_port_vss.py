"""The Mamba/VSS blocks of the PyTorch port (``SS2D``, ``VSSBlock``, ``C2fX``,
``C3X``) and the VSS detector as a whole against the JAX package.

Weights are the JAX modules' own init moved off its constants with a numpy
seed (decays, step sizes and skips that differ by channel and direction),
converted with the port's converter rules and loaded with ``strict=True``;
both packages then see the same numpy inputs. The maps are non-square
(H != W), which is what catches a swapped H and W in the column-major scans.
The JAX side scans with ``associative_scan``, the port step by step, so
modules agree within 1e-4 abs on outputs of order 1.
"""

import math

import jax
import numpy as np
import pytest
import torch

from experiment_yolo_torch.cfg import CFG_DIR, yaml_load
from experiment_yolo_torch.engine.predictor import DetectionPredictor as TorchPredictor
from experiment_yolo_torch.nn import zoo_blocks as tz
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.ops.kernels.selective_scan import selective_scan
from experiment_yolo_torch.utils import convert
from experiment_yolo_torch.utils.convert import jax_variables_to_state_dict
from experiment_yolo_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from experiment_yolo_tpu.nn import zoo_blocks as jz
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.ops.anchors import decode_detections

H, W = 6, 10
ATOL = 1e-4
VSS_YAML = CFG_DIR / "models" / "yolov8-C2f-VSS.yaml"

# two C2f_VSS levels (with and without the shortcut flag, one of them two deep) and a Detect
SMALL_CFG = {
    "nc": 6,
    "scales": {"n": [0.33, 0.25, 1024]},
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],  # 0  /2
        [-1, 1, "Conv", [128, 3, 2]],  # 1  /4
        [-1, 3, "C2f_VSS", [128, True]],  # 2
        [-1, 1, "Conv", [256, 3, 2]],  # 3  /8
        [-1, 6, "C2f_VSS", [256, True]],  # 4  two VSS bottlenecks at n scale
    ],
    "head": [
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 5
        [[-1, 2], 1, "Concat", [1]],  # 6
        [-1, 3, "C2f_VSS", [128]],  # 7  /4, no shortcut
        [[7, 4], 1, "Detect", ["nc"]],  # 8
    ],
}


def _shake(variables, seed):
    """The JAX init as nested numpy dicts, moved off its constants: noise on
    every weight, BatchNorm statistics away from (0, 1), and SS2D's decays,
    step-size biases and skips different for every channel and direction."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if name == "A_logs":
            return np.log(rng.uniform(0.5, 16.0, a.shape)).astype(np.float32)
        if name == "dt_projs_bias":
            return rng.uniform(-5.0, -1.0, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(jax.tree.map(np.asarray, dict(variables)))


def _load(module, variables, rule):
    """Load ``variables`` into a bare port module: ``rule(parts)`` is the
    converter's rule for the state-dict entry split at its dots."""
    state = {}
    for name, ref in module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros_like(ref)
            continue
        kind, path, fn = rule(name.split("."))
        node = variables[kind]
        for k in path:
            node = node[k]
        state[name] = torch.tensor(fn(np.asarray(node, np.float32)))
        assert state[name].shape == ref.shape, name
    module.load_state_dict(state, strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_ss2d_matches_jax_on_a_non_square_map():
    x = np.random.default_rng(0).standard_normal((2, H, W, 16)).astype(np.float32)
    jm = jz.SS2D(d_model=16)
    params = _shake(jax.jit(jm.init)(jax.random.PRNGKey(0), x), seed=1)["params"]
    # the converter's rule starts at the VSSBlock that holds the SS2D
    tm = _load(tz.SS2D(16), {"params": {"self_attention": params}},
               lambda parts: convert._vss((), ["self_attention", *parts]))
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    before = selective_scan.launches
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, H, W, 16)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert selective_scan.launches == before  # CPU tensors take the plain version
    # the transposed map is another function: H and W are not interchangeable
    with torch.no_grad():
        swapped = tm(torch.from_numpy(np.ascontiguousarray(x.reshape(2, W, H, 16)))).numpy().reshape(2, H, W, 16)
    assert np.abs(swapped - want).max() > 100 * ATOL


@pytest.mark.parametrize("d_model,rank", [(16, 1), (32, 2), (64, 4)])
def test_ss2d_hands_k4_unreversed_sequences_and_views_and_matches_jax(monkeypatch, d_model, rank):
    """SS2D makes no reversed copy and no copy of ``B`` and ``C``: K4 gets the
    two sequences, ``B`` and ``C`` as slices of the projection that holds
    ``dt`` beside them (a row of rank + 32 floats), and the flags and sources
    of the four directions. The output still matches the JAX SS2D within
    1e-4 abs at each projection rank."""
    import inspect

    x = np.random.default_rng(8).standard_normal((2, H, W, d_model)).astype(np.float32)
    jm = jz.SS2D(d_model=d_model)
    params = _shake(jax.jit(jm.init)(jax.random.PRNGKey(0), x), seed=9)["params"]
    tm = _load(tz.SS2D(d_model), {"params": {"self_attention": params}},
               lambda parts: convert._vss((), ["self_attention", *parts]))
    assert tm.dt_rank == rank
    calls = []
    monkeypatch.setattr(tz, "selective_scan", lambda *a, **k: calls.append((a, k)) or selective_scan(*a, **k))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)({"params": params}, x)), atol=ATOL, rtol=0)
    ((xs, dt, a, bs, cs, ds), kw), = calls
    length, d = H * W, 2 * d_model
    assert xs.shape == (2, 2, length, d) and dt.shape == (2, 4, length, d) and xs.is_contiguous()
    assert kw == {"reverse": (False, False, True, True), "source": (0, 1, 0, 1)}
    row = rank + 32
    for t, col in ((bs, rank), (cs, rank + 16)):
        assert t.shape == (2, 4, length, 16) and t.stride() == (4 * length * row, length * row, row, 1)
        assert t.storage_offset() == col and t.untyped_storage().data_ptr() == bs.untyped_storage().data_ptr()
    assert a.shape == (4, d, 16) and ds.shape == (4, d)
    source = inspect.getsource(tz.SS2D.forward)
    assert "flip" not in source and "contiguous" not in source


def test_vss_block_matches_jax_and_uses_eps_1e_6():
    x = np.random.default_rng(2).standard_normal((2, H, W, 16)).astype(np.float32)
    x[0, :, :, :] *= 1e-3  # small activations: here a LayerNorm eps of 1e-5 would show
    jm = jz.VSSBlock(c2=16)
    variables = _shake(jax.jit(jm.init)(jax.random.PRNGKey(0), x), seed=3)
    tm = _load(tz.VSSBlock(16), variables, lambda parts: convert._vss((), parts))
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert tm.ln_1.eps == tm.self_attention.out_norm.eps == 1e-6
    tm.ln_1.eps = 1e-5
    with torch.no_grad():
        assert np.abs(_nhwc(tm(_nchw(x))) - want).max() > 10 * ATOL


@pytest.mark.parametrize("kind,inner,n,shortcut", [
    ("C2f", "VSS", 2, True), ("C2f", "VSS", 1, False), ("C2f", "LVMB", 1, False),
    ("C3", "VSS", 1, True), ("C3", "LVMB", 2, False)])
def test_containers_match_jax_and_every_ss2d_parameter_gets_a_gradient(kind, inner, n, shortcut):
    c1, c2 = 24, 32
    x = np.random.default_rng(4).standard_normal((2, H, W, c1)).astype(np.float32)
    jm = (jz.C2fX if kind == "C2f" else jz.C3X)(c2, inner=inner, n=n, shortcut=shortcut)
    variables = _shake(jax.jit(lambda r, xx: jm.init(r, xx, False))(jax.random.PRNGKey(0), x), seed=5)
    tm = (tz.C2fX if kind == "C2f" else tz.C3X)(c1, c2, inner, n, shortcut)
    tm = _load(tm, variables, lambda parts: convert._zoo(inner, parts))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, False))(variables, x))
    out = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), want, atol=ATOL, rtol=0)
    # the shortcut flag is live: the other setting gives another output
    other = _load((tz.C2fX if kind == "C2f" else tz.C3X)(c1, c2, inner, n, not shortcut), variables,
                  lambda parts: convert._zoo(inner, parts))
    with torch.no_grad():
        assert (inner == "LVMB") == bool(np.abs(_nhwc(other(_nchw(x))) - want).max() <= ATOL)
    out.square().sum().backward()
    scans = [m for m in tm.modules() if isinstance(m, tz.SS2D)]
    assert len(scans) == n
    for m in scans:
        for name, p in m.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name


def test_seeded_init_is_the_jax_modules_own():
    """A seeded port model's scan parameters sit where the JAX init puts them:
    decays log(1..N), step-size bias softplus^-1(0.01), skips 1."""
    jm = jz.SS2D(d_model=16)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), np.zeros((1, 4, 4, 16), np.float32)))[
        "params"]
    model = TorchModel(SMALL_CFG, device="cpu", generator=torch.Generator().manual_seed(3))
    scans = [m for m in model.modules() if isinstance(m, tz.SS2D)]
    assert len(scans) == 4
    m = next(s for s in scans if s.d_inner == 32)
    for name in ("A_logs", "dt_projs_bias", "Ds"):
        np.testing.assert_allclose(getattr(m, name).detach().numpy(), params[name], atol=1e-6, rtol=0)
    for name in ("x_proj_weight", "dt_projs_weight"):
        w = getattr(m, name).detach()
        assert w.shape == params[name].shape
        assert 0.5 < float(w.std()) * math.sqrt(w.shape[-1]) < 1.5


@pytest.fixture(scope="module")
def small_pair():
    jm = JaxModel(dict(SMALL_CFG))
    variables = _shake(jm.init(jax.random.PRNGKey(0)), seed=6)
    head = variables["params"][f"layers_{jm.detect_idx}"]
    for i in range(len(jm.strides)):
        head[f"cv3_{i}_2"]["bias"] = np.zeros_like(head[f"cv3_{i}_2"]["bias"])  # scores near 0.5: NMS has work
    tm = TorchModel(dict(SMALL_CFG), device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    return jm, variables, tm


def test_small_vss_detector_raw_maps_and_decode_match_jax(small_pair):
    """Raw head maps within 2e-3 abs and decoded boxes within 1e-2 px, the
    bars ``test_torch_port_model.py`` holds LD-P2 to."""
    jm, variables, tm = small_pair
    assert tm.stride == tuple(jm.strides) == (4, 8)
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    j_feats = jax.jit(jm.apply)(variables, x)
    j_boxes, j_scores = decode_detections(j_feats, jm.strides, jm.nc, jm.reg_max)
    with torch.no_grad():
        t_feats = tm(_nchw(x))
        t_boxes, t_scores = tm.predict(_nchw(x))
    for tf, jf in zip(t_feats, j_feats):
        np.testing.assert_allclose(_nhwc(tf), np.asarray(jf), atol=2e-3, rtol=0)
    np.testing.assert_allclose(t_boxes.numpy(), np.asarray(j_boxes), atol=1e-2, rtol=0)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores), atol=1e-3, rtol=0)


def test_small_vss_detector_hard_nms_detections_match_jax(small_pair):
    jm, variables, tm = small_pair
    image = [np.random.default_rng(7).integers(0, 256, (64, 64, 3), dtype=np.uint8)]
    overrides = {"imgsz": 64, "batch": 1, "nms_type": "hard"}
    (j_res,) = JaxPredictor(jm, variables, overrides=overrides)(image)
    (t_res,) = TorchPredictor(tm, overrides=overrides)(image)
    t, j = t_res.boxes.data, j_res.boxes.data
    assert len(t) == len(j) > 0
    for row in j:  # any order: scores that agree to ~1e-6 may swap places in a sort
        close = (t[:, 5] == row[5]) & (np.abs(t[:, :4] - row[:4]).max(1) <= 1e-2) & (np.abs(t[:, 4] - row[4]) <= 1e-3)
        assert close.any(), f"no port detection within 1e-2 px and 1e-3 of the score of {row}"


def test_vss_yaml_is_yolov8_with_two_substitutions_and_builds_in_both_packages():
    vss = yaml_load(VSS_YAML)
    base = yaml_load(CFG_DIR / "models" / "yolov8.yaml")
    c2f = [i for i, row in enumerate(base["backbone"] + base["head"]) if row[2] == "C2f"]
    assert c2f == [2, 4, 6, 8, 12, 15, 18, 21]
    assert vss.pop("nc") == 6 and base.pop("nc") == 80
    for part in ("backbone", "head"):
        base[part] = [[f, n, "C2f_VSS" if m == "C2f" else m, a] for f, n, m, a in base[part]]
    assert vss == base
    tm = TorchModel(VSS_YAML.name, device="cpu")
    jm = JaxModel(str(VSS_YAML))
    assert tm.stride == tuple(jm.strides) == (8, 16, 32) and tm.nc == jm.nc == 6
    shapes = jax.eval_shape(lambda r: jm.module.init(r, np.zeros((1, 64, 64, 3), np.float32), False),
                            jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    scans = [m for m in tm.modules() if isinstance(m, tz.SS2D)]
    assert [m.d_inner for m in scans] == [32, 64, 64, 128, 128, 256, 128, 64, 128, 256]
    assert [m.dt_rank for m in scans] == [1, 2, 2, 4, 4, 8, 4, 2, 4, 8]
    # every state-dict entry has a place in the JAX variables, of the converted shape
    for name, ref in tm.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        kind, path = convert.jax_path(name, tm)
        node = shapes[kind]
        for k in path:
            node = node[k]
        assert int(np.prod(node.shape)) == ref.numel(), name
