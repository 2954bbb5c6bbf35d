"""``DetectAux`` and the loss's auxiliary branch in the PyTorch port against
the JAX package: ``detection_loss`` on six seeded maps (main and aux) for
four recipes in f32 and bf16, the aux branch off for three maps, and
``yolov8-aux.yaml`` at n scale (nc 3): parameter count, strides, the
converter against ``invert_to_torch_state``, the eval and train forwards,
the aux branches idle in eval mode, and one ``train_step`` against one step
of the JAX ``_make_train_step``, compiled once for the file.

The JAX variables are those of the model's init tree (``jax.eval_shape``),
filled from a seed (``tests/test_torch_port_asf.py:_seeded_like_init``). The
JAX TAL takes the exact top-k, as the port's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.nn.tasks import yaml_model_load
from experiment_yolo_torch.utils.convert import jax_params_to_named, jax_variables_to_state_dict
from experiment_yolo_torch.utils.loss import LossConfig as TLossConfig
from experiment_yolo_torch.utils.loss import detection_loss as t_loss
from experiment_yolo_torch.utils.seeded import seeded_batch
from experiment_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from experiment_yolo_tpu.engine.trainer import TrainState
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.optim.builders import build_optimizer
from experiment_yolo_tpu.utils.loss import LossConfig as JLossConfig
from experiment_yolo_tpu.utils.loss import detection_loss as j_loss
from experiment_yolo_tpu.utils.torch_convert import invert_to_torch_state
from test_torch_port_asf import FIRE_AT_ONCE, _momentum, _seeded_like_init

CFG, NC, REG_MAX, IMGSZ, BATCH = "yolov8n-aux.yaml", 3, 16, 64, 2
SHAPES, STRIDES = [(8, 8), (4, 4), (2, 2)], (8, 16, 32)
IOU_MEAN = 0.9  # an incoming Wise-IoU mean away from 1: the aux terms must take it, not the main head's new one
RECIPES = {"defaults": {}, "wiou-nwd-varifocal": dict(use_wiseiou=True, nwd=True, cls_loss="varifocal"),
           "atss": dict(assigner="atss"), "mpdiou": dict(iou_type="MPDIoU")}
RATIO = 1.5  # bf16: the port's distance from JAX's f32 over JAX's own bf16 distance, at most (the _amp criterion)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one torch thread, as ``tests/test_torch_port_fit.py``'s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(seed, b=BATCH, m=6):
    """Padded normalised xywh labels: 2..m boxes of 6..28 px an image at 64 px."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(6, 28, (b, m, 2))
    xy = rng.uniform(wh / 2, IMGSZ - wh / 2)
    bboxes = (np.concatenate([xy, wh], -1) / IMGSZ).astype(np.float32)
    mask = np.arange(m)[None] < rng.integers(2, m + 1, (b, 1))
    return {"bboxes": bboxes * mask[..., None], "cls": rng.integers(0, NC, (b, m)).astype(np.int32), "mask": mask}


def _six_maps(seed, b=BATCH):
    """The main head's three NCHW maps, then the aux head's three."""
    rng = np.random.default_rng(seed)
    return [(2 * rng.standard_normal((b, 4 * REG_MAX + NC, h, w))).astype(np.float32) for h, w in SHAPES * 2]


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_loss(maps, lab, switches, dtype, jit=True):
    """(total, comps, new iou_mean, the gradient with respect to each NCHW
    map), jitted; with ``jit=False`` the forward alone, op by op, and no
    gradient."""
    jcfg = JLossConfig(nc=NC, exact_topk=True, **switches)

    def fn(feats, tb):
        total, comps, iou = j_loss(feats, tb, STRIDES, jcfg, iou_mean=jnp.float32(IOU_MEAN))[:3]
        return total, (comps, iou)

    args = ([jnp.asarray(np.transpose(m, (0, 2, 3, 1))).astype(dtype) for m in maps],
            {k: jnp.asarray(v) for k, v in lab.items()})
    if jit:
        (total, (comps, iou)), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(*args)
    else:
        (total, (comps, iou)), grads = fn(*args), []
    return (float(total), {k: float(v) for k, v in comps.items()}, float(iou),
            [np.transpose(np.asarray(g, np.float32), (0, 3, 1, 2)) for g in grads])


def _port_loss(maps, lab, switches, dtype=torch.float32):
    """(total, comps, new iou_mean, gradients, the main head's assignment)."""
    feats = [torch.from_numpy(m).to(dtype).requires_grad_() for m in maps]
    total, comps, res, iou = t_loss(feats, {k: torch.from_numpy(v) for k, v in lab.items()}, STRIDES,
                                    TLossConfig(nc=NC, **switches), torch.tensor(IOU_MEAN))
    total.backward()
    return total.item(), {k: v.item() for k, v in comps.items()}, iou.item(), [f.grad.float().numpy() for f in feats], res


@pytest.fixture(scope="module")
def losses():
    """Every recipe's loss on the same six maps and labels: JAX in f32 and
    bf16 (one compile a recipe and dtype) and JAX's bf16 forward op by op,
    the port in f32 and bf16."""
    maps, lab = _six_maps(3), _labels(4)
    return {name: {"j32": _jax_loss(maps, lab, sw, jnp.float32), "j16": _jax_loss(maps, lab, sw, jnp.bfloat16),
                   "j16_ops": _jax_loss(maps, lab, sw, jnp.bfloat16, jit=False),
                   "t32": _port_loss(maps, lab, sw), "t16": _port_loss(maps, lab, sw, torch.bfloat16)}
            for name, sw in RECIPES.items()}


@pytest.mark.parametrize("recipe", RECIPES)
def test_aux_loss_matches_jax(losses, recipe):
    """Total and each component within 1e-5 relative of JAX's, the returned
    ``iou_mean`` within 1e-6 (Wise-IoU moves it; the aux head does not), and
    the gradient with respect to each of the six maps within 1e-4 of its
    largest value; the aux maps get a gradient."""
    total, comps, iou, grads, res = losses[recipe]["t32"]
    jtotal, jcomps, jiou, jgrads = losses[recipe]["j32"]
    assert int(res.fg_mask.sum()) > 5
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(comps[k], jcomps[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    np.testing.assert_allclose(iou, jiou, rtol=1e-6)
    assert (iou != np.float32(IOU_MEAN)) == RECIPES[recipe].get("use_wiseiou", False)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert np.abs(jg).max() > 0, f"map {i} got no gradient"
        np.testing.assert_allclose(g, jg, atol=1e-4 * np.abs(jg).max(), rtol=0, err_msg=f"map {i}")


@pytest.mark.parametrize("what", ["values", "gradients"])
def test_aux_loss_bf16_within_jax_bf16_error(losses, what):
    """On bf16 maps, over the four recipes: the port's totals and components
    (``values``) and its gradients with respect to the six maps are no
    further from JAX's f32 results than 1.5 times JAX's own bf16 results
    are, in relative L2 (``tests/test_torch_port_amp.py``'s criterion). The
    values are held to JAX's bf16 forward run op by op, as the port's runs:
    jitted, XLA's CPU fusions keep the bf16 elementwise intermediates in f32,
    and its values then sit about 6 times nearer f32 (1.5e-5 against 9.1e-5
    relative L2 here) while its gradients do not move (1.53e-3 both ways)."""
    def flat(side):
        out = []
        for name in RECIPES:
            total, comps, _, grads = losses[name][side][:4]
            out += [total, *(comps[k] for k in ("box", "cls", "dfl"))] if what == "values" else \
                [g.ravel() for g in grads]
        return np.hstack([np.ravel(v) for v in out])

    want = flat("j32")
    own, got = _rel(flat("j16_ops" if what == "values" else "j16"), want), _rel(flat("t16"), want)
    assert 0 < own and got <= RATIO * own, (got, own)


def test_three_maps_take_no_aux_branch():
    """Three maps give the loss without an aux branch: the components and the
    gradients equal those of the six maps at ``aux_loss_ratio`` 0, whose aux
    maps then get a zero gradient; at the default ratio the six maps' loss is
    larger, and the main head's assignment is the same."""
    maps, lab = _six_maps(5), _labels(6)
    tb = {k: torch.from_numpy(v) for k, v in lab.items()}

    def run(n, **cfg):
        feats = [torch.from_numpy(m).requires_grad_() for m in maps[:n]]
        total, comps, res, _ = t_loss(feats, tb, STRIDES, TLossConfig(nc=NC, **cfg))
        total.backward()
        return total.item(), [v.item() for v in comps.values()], [f.grad for f in feats], res.fg_mask

    three, off, on = run(3), run(6, aux_loss_ratio=0.0), run(6)
    assert three[:2] == off[:2]
    for a, b in zip(three[2], off[2]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert all(not g.any() for g in off[2][3:]) and all(g.abs().max() > 0 for g in on[2][3:])
    assert on[0] > three[0] and torch.equal(on[3], three[3])


@pytest.fixture(scope="module")
def aux_pair():
    """``yolov8n-aux.yaml`` at nc 3 in both packages: the JAX model with
    variables of its init tree filled from a seed, and the port's model with
    them converted."""
    jm = JaxModel(CFG, nc=NC)
    variables = _seeded_like_init(jm, 2)
    tm = TorchModel({**yaml_model_load(CFG), "nc": NC}, device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    return jm, variables, tm


def test_aux_model_structure_and_converter(aux_pair):
    """The parameter count equals JAX's, the strides are (8, 16, 32), the
    aux branches carry the bias priors, and JAX's ``invert_to_torch_state``
    returns every port state-dict key but ``num_batches_tracked`` (it skips
    keys it cannot place), each leaf equal to the port converter's."""
    jm, variables, tm = aux_pair
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert tm.stride == tuple(jm.strides) == STRIDES
    mine = jax_variables_to_state_dict(variables, tm)
    theirs = invert_to_torch_state(variables, {k: tuple(v.shape) for k, v in tm.state_dict().items()}, jm)
    assert set(mine) - set(theirs) == {k for k in mine if k.endswith("num_batches_tracked")}
    assert any(".cv4." in k for k in theirs) and any(".cv5." in k for k in theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    fresh = TorchModel({**yaml_model_load(CFG), "nc": NC}, device="cpu").detect
    for i, s in enumerate(STRIDES):
        for branch in (fresh.cv2, fresh.cv4):
            assert torch.all(branch[i][-1].bias == 1.0)
        for branch in (fresh.cv3, fresh.cv5):
            torch.testing.assert_close(branch[i][-1].bias, torch.full((NC,), np.log(5 / NC / (640 / s) ** 2)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_aux_model_forward_matches_jax(aux_pair, train):
    """The eval forward gives the main head's 3 maps and the train forward
    all 6, main first, each within 2e-3 abs of JAX's
    (``tests/test_torch_port_model.py:check_config_matches_jax``'s bar);
    the train forward's BatchNorm statistics follow JAX's."""
    jm, variables, _ = aux_pair
    tm = TorchModel({**yaml_model_load(CFG), "nc": NC}, device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    x = np.random.default_rng(7).random((BATCH, IMGSZ, IMGSZ, 3), dtype=np.float32)
    if train:
        j_feats, updates = jax.jit(lambda v, xx: jm.apply(v, xx, train=True, mutable=["batch_stats"]))(variables, x)
    else:
        j_feats = jax.jit(jm.apply)(variables, x)
    with torch.no_grad():
        t_feats = tm.train(train)(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(t_feats) == len(j_feats) == (6 if train else 3)
    for tf, jf in zip(t_feats, j_feats):
        jf = np.transpose(np.asarray(jf), (0, 3, 1, 2))
        assert tf.shape == jf.shape and np.abs(jf).max() > 0.1
        np.testing.assert_allclose(tf.numpy(), jf, atol=2e-3, rtol=0)
    if train:
        after = jax_variables_to_state_dict({"params": variables["params"], "batch_stats": updates["batch_stats"]},
                                            tm)
        for k, v in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), after[k].numpy(), atol=2e-3, rtol=1e-3, err_msg=k)


def test_aux_model_eval_forward_runs_no_aux_branch(aux_pair):
    """In eval mode no module of ``cv4``/``cv5`` runs, and ``predict``
    decodes the main head's maps only, in either mode."""
    tm = aux_pair[2]
    head = tm.detect
    ran = []
    hooks = [m.register_forward_hook(lambda *a: ran.append(1)) for m in (*head.cv4.modules(), *head.cv5.modules())]
    x = torch.rand(1, 3, IMGSZ, IMGSZ, generator=torch.Generator().manual_seed(0))
    try:
        with torch.no_grad():
            maps = tm.eval()(x)
            boxes, scores = tm.predict(x)
            assert not ran and len(maps) == 3
            train_boxes, _ = tm.train().predict(x)
            assert ran
    finally:
        tm.eval()
        for h in hooks:
            h.remove()
    anchors = sum(h * w for h, w in SHAPES)
    assert boxes.shape == train_boxes.shape == (1, anchors, 4) and scores.shape == (1, anchors, NC)


@pytest.fixture(scope="module")
def step(aux_pair):
    """One step of each package from the same weights on one seeded batch:
    loss components, momentum buffers and parameter updates by port name."""
    jm, variables, _ = aux_pair
    batch = seeded_batch(BATCH, IMGSZ, 0, nc=NC)
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
    new, jcomps = jt._make_train_step()(state, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = TorchModel({**yaml_model_load(CFG), "nc": NC}, device="cpu")
    state_dict = jax_variables_to_state_dict(variables, tm)
    tm.load_state_dict(state_dict, strict=True)
    tr = DetectionTrainer(tm, FIRE_AT_ONCE)
    comps = tr.train_step(batch)
    opt = tr.state.optimizer
    after = jax_variables_to_state_dict(jax.tree.map(np.asarray, {"params": new.params,
                                                                    "batch_stats": new.batch_stats}), tm)
    names = [n for n, _ in tm.named_parameters()]
    return dict(
        comps={k: float(comps[k]) for k in ("box", "cls", "dfl")}, jcomps=jax.tree.map(float, jcomps),
        updates_fired=opt.updates,
        momentum={n: opt.state[p]["momentum_buffer"].numpy() for n, p in tm.named_parameters()},
        jmomentum={n: v.numpy() for n, v in jax_params_to_named(_momentum(new.opt_state), tm).items()},
        updates={n: p.detach().numpy() - state_dict[n].numpy() for n, p in tm.named_parameters()},
        jupdates={n: after[n].numpy() - state_dict[n].numpy() for n in names},
        spacing={n: float(np.linalg.norm(np.spacing(after[n].numpy()))) for n in names})


def test_aux_step_losses_match_jax(step):
    """Box, cls and dfl (the aux head's terms added at 0.25) within 1e-4
    relative of the JAX step's; the step fired once."""
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(step["comps"][k], step["jcomps"][k], rtol=1e-4, err_msg=k)
    assert step["updates_fired"] == 1


@pytest.mark.parametrize("what", ["momentum", "updates"])
def test_aux_step_gradients_and_updates_match_jax(step, what):
    """Every parameter's momentum buffer (the step's clipped gradient plus
    weight decay) and update within 1e-3 relative L2 of JAX's (the floors of
    ``tests/test_torch_port_asf.py``); every parameter of the aux class
    branches ``cv5`` moves, and the aux box branch of the stride-8 level
    (at 64 px the other levels may hold no aux foreground)."""
    got, want = step[what], step["j" + what]
    bad = []
    for n, w in want.items():
        diff, norm = float(np.linalg.norm(got[n] - w)), float(np.linalg.norm(w))
        slack = step["spacing"][n] if what == "updates" else 0.0
        if diff > (1e-6 if norm < 1e-5 else 1e-3 * norm) + slack:
            bad.append((n, diff, norm))
    assert not bad, bad[:5]
    moved = {n: float(np.abs(w).max()) > 0 for n, w in want.items()}
    assert all(v for n, v in moved.items() if ".cv5." in n) and any(v for n, v in moved.items() if ".cv4.0." in n)
