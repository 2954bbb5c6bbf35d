"""The ASF family and the 4-level head of the PyTorch port against the JAX
package: ``ZoomCat`` (the fork's ``Zoom_cat``), ``parse_model``'s middle-source
stride for it, and ``yolov8-ASF-P2.yaml`` (the model of the reference fork's
own ``train.py``: ZoomCat, two ScalSeq + Add branches, a Detect on P2-P5),
``yolov8-ASF.yaml`` and ``yolov8-p2.yaml`` at n scale.

ASF-P2's JAX init (PRNGKey(1)) is built once for the file and converted into
the port; ASF and p2 take variables in the tree of their JAX init, filled
from a seed (their JAX inits would compile for 10-15 s each). One ASF-P2 ``train_step`` (64 px, batch 2, ``amp=False``,
``nbs`` equal to the batch and warmup off, so that the step fires at once
with the full LR of every group) is held against one step of the JAX
``_make_train_step``, compiled once for the file.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.nn.modules import ZoomCat
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.ops.nms import non_max_suppression as t_nms
from experiment_yolo_torch.utils.convert import jax_params_to_named, jax_variables_to_state_dict
from experiment_yolo_torch.utils.loss import detection_loss as t_loss
from experiment_yolo_torch.utils.seeded import seeded_batch
from experiment_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from experiment_yolo_tpu.engine.trainer import TrainState
from experiment_yolo_tpu.nn.modules import ZoomCat as JaxZoomCat
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.ops.anchors import decode_detections as j_decode
from experiment_yolo_tpu.ops.nms import non_max_suppression as j_nms
from experiment_yolo_tpu.optim.builders import YoloSGDState, build_optimizer
from experiment_yolo_tpu.utils.loss import detection_loss as j_loss
from test_torch_port_model import _match, check_config_matches_jax

ASF_P2, IMGSZ, BATCH = "yolov8-ASF-P2.yaml", 64, 2
CONFIGS = [("yolov8-ASF-P2.yaml", (4, 8, 16, 32), 2_495_432), ("yolov8-ASF.yaml", (8, 16, 32), 3_197_312),
           ("yolov8-p2.yaml", (4, 8, 16, 32), 3_354_128)]  # tests/test_model_build.py's golden counts
FIRE_AT_ONCE = {"amp": False, "batch": BATCH, "imgsz": IMGSZ, "nbs": BATCH, "warmup_epochs": 0.0}
RATIO = 1.5  # bf16: the port's distance from JAX f32 over JAX bf16's own, at most (tests/test_torch_port_amp.py)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one torch thread, as ``tests/test_torch_port_fit.py``'s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_like_init(jm, seed):
    """The variables of the JAX model ``jm`` in the tree and shapes of its
    init (``jax.eval_shape``: traced, not compiled), filled from a seeded
    generator (kernels uniform within 1/sqrt(fan_in), BatchNorm scale, bias
    and statistics away from identity, so that a swapped leaf shows), then
    the JAX package's own Detect priors (``_bias_init``)."""
    x = jnp.zeros((1, IMGSZ, IMGSZ, 3), jnp.float32)
    tree = jax.eval_shape(lambda r: jm.module.init(r, x, False), jax.random.PRNGKey(1))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            bound = 1.0 / math.sqrt(math.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        lo, hi = {"scale": (0.8, 1.2), "var": (0.5, 1.5)}.get(name, (-0.1, 0.1))  # bias, mean
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return jax.tree.map(np.asarray, jm._bias_init(jax.tree_util.tree_map_with_path(fill, tree)))


@pytest.fixture(scope="module")
def jax_init():
    """``jax_init(cfg)``: the JAX model and its variables, built once a
    config: ASF-P2's JAX init (PRNGKey(1)); for ASF and p2, whose JAX init
    would take 10-15 s of compiling each, :func:`_seeded_like_init`."""
    cache = {}

    def get(cfg):
        if cfg not in cache:
            jm = JaxModel(cfg)
            cache[cfg] = jm, (jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))) if cfg == ASF_P2
                              else _seeded_like_init(jm, 1))
        return cache[cfg]

    return get


def _levels(seed, c=(5, 3, 7), hw=(8, 6), dtype=np.float32):
    """(large, mid, small) NHWC maps of a pyramid: 2x, 1x and 1/2x the middle size."""
    rng = np.random.default_rng(seed)
    h, w = hw
    return [rng.standard_normal((2, int(h * f), int(w * f), ch)).astype(dtype) for f, ch in zip((2, 1, 0.5), c)]


def _nchw(xs, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype) for x in xs]


@pytest.mark.parametrize("seed,hw", [(0, (8, 6)), (1, (4, 4))])
def test_zoom_cat_matches_jax(seed, hw):
    """ZoomCat against the JAX module on seeded maps, within 1e-6; its
    gradient routes through the 2x2 max and average and the upsample."""
    xs = _levels(seed, hw=hw)
    want = np.asarray(JaxZoomCat().apply({}, [jnp.asarray(x) for x in xs]))
    ts = [t.requires_grad_() for t in _nchw(xs)]
    got = ZoomCat()(ts)
    assert got.shape == (2, 15, *hw)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), want, atol=1e-6, rtol=0)
    g = np.random.default_rng(seed + 5).standard_normal(want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: JaxZoomCat().apply({}, list(a)), *[jnp.asarray(x) for x in xs])
    got.backward(torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 1, 2))))
    for t, jg in zip(ts, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jg), atol=1e-6, rtol=0)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_zoom_cat_bf16_computes_in_the_input_dtype():
    """In bf16 ZoomCat computes in its inputs' dtype, as JAX does: its bf16
    output is no further from JAX's f32 output than 1.5 times JAX's own bf16
    output is, in relative L2 (``tests/test_torch_port_amp.py``'s criterion)."""
    xs = [x.astype(jnp.bfloat16).astype(np.float32) for x in _levels(2)]  # bf16-representable inputs
    j32 = np.asarray(JaxZoomCat().apply({}, [jnp.asarray(x) for x in xs]))
    j16 = np.asarray(JaxZoomCat().apply({}, [jnp.asarray(x, jnp.bfloat16) for x in xs]).astype(jnp.float32))
    got = ZoomCat()(_nchw(xs, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 3, 1)
    own = _rel(j16, j32)
    assert 0 < _rel(got, j32) <= RATIO * own, (_rel(got, j32), own)


def test_zoom_cat_refuses_levels_that_are_not_a_pyramid():
    large, mid, small = _nchw(_levels(3))
    with pytest.raises(ValueError, match="twice the middle"):
        ZoomCat()([large[..., :-2], mid, small])
    with pytest.raises(ValueError, match="does not divide"):
        ZoomCat()([large, mid, small[:, :, :-1]])


def test_parse_model_gives_zoom_cat_the_middle_stride():
    """Zoom_cat's output has its middle source's stride (so the P3 head of
    ASF-P2 reads stride 8, not its first source's 4) and the sum of its
    sources' channels; sources whose strides are not (s/2, s, 2s) raise
    naming the layer."""
    model = TorchModel(ASF_P2, device="cpu")
    seen = {}
    hooks = [model.model[i].register_forward_hook(lambda m, a, out, i=i: seen.__setitem__(i, out.shape))
             for i in (11, 12, 15, 16)]
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 64))
    for h in hooks:
        h.remove()
    assert seen[12][2:] == (4, 4) and seen[16][2:] == (8, 8)  # strides 16 and 8 at 64 px
    assert seen[12][1] == seen[11][1] + 2 * seen[11][1] and seen[16][1] == 3 * seen[15][1]  # n scale: 128 + 64 + 128
    cfg = dict(model.yaml)
    cfg["head"] = [list(r) for r in cfg["head"]]
    cfg["head"][2] = [[-1, 4, -2], 1, "Zoom_cat", []]  # layer 12: strides 8, 8, 32
    with pytest.raises(ValueError, match="layer 12: Zoom_cat takes three sources of strides"):
        TorchModel(cfg, device="cpu")


@pytest.mark.parametrize("cfg,strides,n_params", CONFIGS)
def test_asf_and_p2_configs_match_jax(jax_init, cfg, strides, n_params):
    """Strides, parameter counts (the golden ones), a strict load of the
    converted JAX variables, and raw maps at 64 px within 2e-3 abs
    (``tests/test_torch_port_model.py:check_config_matches_jax``); the
    Detect bias priors of every level equal JAX's."""
    jm, variables = jax_init(cfg)
    check_config_matches_jax(cfg, strides, n_params, jm, variables)
    fresh = TorchModel(cfg, device="cpu").state_dict()
    converted = jax_variables_to_state_dict(variables, TorchModel(cfg, device="cpu"))
    head = max(int(k.split(".")[1]) for k in fresh)
    for i, s in enumerate(strides):  # box 1.0, class log(5 / nc / (640 / stride)^2)
        for branch, want in (("cv2", 1.0), ("cv3", math.log(5 / jm.nc / (640 / s) ** 2))):
            key = f"model.{head}.{branch}.{i}.2.bias"
            np.testing.assert_allclose(fresh[key].numpy(), want, rtol=1e-6, err_msg=key)
            np.testing.assert_allclose(converted[key].numpy(), want, rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("nms_type", ["soft", "hard"])
def test_asf_p2_decode_and_nms_match_jax(jax_init, nms_type):
    """The 4-level decode (34,000 anchors at 640; 340 at 64 px) of the same
    maps in both packages: boxes within 1e-2 px, scores within 1e-6; then NMS
    of the port's decode in both packages: the same detections. The class
    priors are set to 0, so that scores sit near 0.5 and NMS has work."""
    jm, variables = jax_init(ASF_P2)
    tm = TorchModel(ASF_P2, device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    with torch.no_grad():
        for cls in tm.detect.cv3:
            cls[-1].bias.zero_()
    x = np.random.default_rng(4).random((2, IMGSZ, IMGSZ, 3), dtype=np.float32)
    with torch.no_grad():
        feats = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        boxes, scores = tm.predict(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert boxes.shape == (2, 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2, 4)
    jb, js = j_decode([jnp.asarray(f.numpy().transpose(0, 2, 3, 1)) for f in feats], jm.strides, jm.nc, jm.reg_max)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), atol=1e-2, rtol=0)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    kw = dict(conf_thres=0.25, iou_thres=0.7, max_det=300, nms_type=nms_type)
    td, tn = t_nms(boxes, scores, **kw)
    jd, jn = j_nms(jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()), **kw)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn.min()) > 0, "no detections: the comparison would be empty"
    for i in range(2):
        _match(td[i, :int(tn[i])].numpy(), np.asarray(jd)[i, :int(jn[i])])


def _momentum(opt_state):
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if isinstance(node, YoloSGDState):
            return node.momentum
        if isinstance(node, tuple):
            stack.extend(node)
    raise LookupError("no YoloSGDState in the optimizer state")


@pytest.fixture(scope="module")
def step(jax_init):
    """One step of each package from ASF-P2's JAX init on one seeded batch:
    loss components, TAL's foreground mask, momentum buffers (the clipped
    gradient plus weight decay) and parameter updates by port name."""
    jm, variables = jax_init(ASF_P2)
    batch = seeded_batch(BATCH, IMGSZ, 0)
    jt = JaxTrainer(model=jm, variables=variables, overrides=FIRE_AT_ONCE)
    jt.loss_cfg = dataclasses.replace(jt.loss_cfg, exact_topk=True)
    a = jt.args
    jt.tx = build_optimizer(variables["params"], name=a.optimizer, lr0=a.lr0, momentum=a.momentum,
                            weight_decay=a.weight_decay, nb=100, epochs=a.epochs, lrf=a.lrf, cos_lr=a.cos_lr,
                            warmup_epochs=a.warmup_epochs, warmup_bias_lr=a.warmup_bias_lr,
                            warmup_momentum=a.warmup_momentum, nc=jm.nc, accumulate=1)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=jt.tx.init(variables["params"]),
                       ema_params=jax.tree.map(jnp.copy, variables["params"]),
                       ema_batch_stats=jax.tree.map(jnp.copy, variables["batch_stats"]),
                       iou_mean=jnp.asarray(1.0, jnp.float32), step=jnp.zeros([], jnp.int32),
                       ema_updates=jnp.zeros([], jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new, jcomps = jt._make_train_step()(state, jb)
    tm = TorchModel(ASF_P2, device="cpu")
    state_dict = jax_variables_to_state_dict(variables, tm)
    tm.load_state_dict(state_dict, strict=True)
    tr = DetectionTrainer(tm, FIRE_AT_ONCE)
    # TAL's foreground mask over the four levels in each package, from the same train-mode maps of the port
    img = torch.from_numpy(np.ascontiguousarray(batch["img"].transpose(0, 3, 1, 2))).float() / 255.0
    probe = TorchModel(ASF_P2, device="cpu")
    probe.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        feats = probe.train()(img)
    tb = {k: torch.from_numpy(batch[k]) for k in ("bboxes", "cls", "mask")}
    tfg = t_loss(feats, tb, probe.stride, tr.loss_cfg)[2].fg_mask
    jfg = jax.jit(lambda f, t: j_loss(f, t, jm.strides, jt.loss_cfg, return_aux=True)[-1]["fg_mask"])(
        [jnp.asarray(f.numpy().transpose(0, 2, 3, 1)) for f in feats], {k: jb[k] for k in tb})
    comps = tr.train_step(batch)
    opt = tr.state.optimizer
    after = jax_variables_to_state_dict(jax.tree.map(np.asarray, {"params": new.params,
                                                                    "batch_stats": new.batch_stats}), tm)
    names = [n for n, _ in tm.named_parameters()]
    return dict(
        comps={k: float(comps[k]) for k in ("box", "cls", "dfl", "fg")}, jcomps=jax.tree.map(float, jcomps),
        fg=(tfg.numpy(), np.asarray(jfg)), updates_fired=opt.updates,
        momentum={n: opt.state[p]["momentum_buffer"].numpy() for n, p in tm.named_parameters()},
        jmomentum={n: v.numpy() for n, v in jax_params_to_named(_momentum(new.opt_state), tm).items()},
        updates={n: p.detach().numpy() - state_dict[n].numpy() for n, p in tm.named_parameters()},
        jupdates={n: after[n].numpy() - state_dict[n].numpy() for n in names},
        spacing={n: float(np.linalg.norm(np.spacing(after[n].numpy()))) for n in names})


def test_asf_p2_step_losses_and_assignment_match_jax(step):
    """Box, cls and dfl within 1e-4 relative; TAL's foreground mask over the
    four levels, from the same maps, identical anchor by anchor; the step
    fired once."""
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(step["comps"][k], step["jcomps"][k], rtol=1e-4, err_msg=k)
    got, want = step["fg"]
    assert got.shape == want.shape == (BATCH, 340) and want.sum() > 10
    np.testing.assert_array_equal(got, want)
    assert step["updates_fired"] == 1


@pytest.mark.parametrize("what", ["momentum", "updates"])
def test_asf_p2_step_gradients_and_updates_match_jax(step, what):
    """Every parameter's momentum buffer (the step's clipped gradient plus
    weight decay) and update within 1e-3 relative L2 of JAX's, with an
    absolute floor of 1e-6 under a norm of 1e-5; an update also gets one f32
    spacing of each new parameter, since each package rounds p + update once."""
    got, want = step[what], step["j" + what]
    bad = []
    for n, w in want.items():
        diff, norm = float(np.linalg.norm(got[n] - w)), float(np.linalg.norm(w))
        slack = step["spacing"][n] if what == "updates" else 0.0
        if diff > (1e-6 if norm < 1e-5 else 1e-3 * norm) + slack:
            bad.append((n, diff, norm))
    assert not bad, bad[:5]
    assert sum(float(np.abs(w).max()) > 0 for w in want.values()) > 0.9 * len(want)
