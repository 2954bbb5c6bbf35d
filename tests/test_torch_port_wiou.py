"""The paper's box loss in the port against the JAX package: the NWD
similarity and Wise-IoU v3 (values and gradients), the loss with the recipe
switched on, and one ``DetectionTrainer.train_step`` of LD-P2 n with the
recipe against one step of the JAX ``_make_train_step``.

The recipe is ``EXPERIMENTS.md``'s: ``use_wiseiou``, ``wiou_ltype='WIoU'``,
``nwd``, ``iou_ratio`` 0.5. The training steps follow
``tests/test_torch_port_train.py`` (64 px, batch 2, ``amp=False``, the
optimizer the JAX ``train()`` builds, the exact top-k in JAX's TAL), except
that the weights are the port's seeded init (He-normal convs, so that scores
spread and TAL has no near-ties) moved into JAX with the JAX package's own
``utils/torch_convert.py:convert_state_dict``. The JAX step is compiled once
for the file.

The JAX LD-P2 takes its LDConv layers on the gather path (``sampling='gather'``,
what K3 computes), as ``tests/test_torch_port_amp.py``'s: the default ``auto``
compiles a dense hat window as well, a TPU workaround the port does not carry
(ROADMAP catalogue item 5), for a minute of compile a train step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.ops.boxes import wasserstein_similarity as t_nwd
from experiment_yolo_torch.ops.boxes import wise_iou_loss as t_wiou
from experiment_yolo_torch.utils.convert import jax_params_to_named
from experiment_yolo_torch.utils.loss import LossConfig as TLossConfig
from experiment_yolo_torch.utils.loss import detection_loss as t_loss
from experiment_yolo_torch.utils.seeded import he_normal_, seeded_batch
from experiment_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from experiment_yolo_tpu.engine.trainer import TrainState
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.ops.boxes import wasserstein_similarity as j_nwd
from experiment_yolo_tpu.ops.boxes import wise_iou_loss as j_wiou
from experiment_yolo_tpu.optim.builders import YoloSGDState, build_optimizer
from experiment_yolo_tpu.utils.loss import LossConfig as JLossConfig
from experiment_yolo_tpu.utils.loss import detection_loss as j_loss
from experiment_yolo_tpu.utils.torch_convert import convert_state_dict
from test_torch_port_amp import _gather_ldconv

CFG, IMGSZ, BATCH, STEPS = "yolov8-LD-P2.yaml", 64, 2, 2
RECIPE = {"use_wiseiou": True, "wiou_ltype": "WIoU", "nwd": True, "iou_ratio": 0.5}
OVERRIDES = {"amp": False, "batch": BATCH, "imgsz": IMGSZ, **RECIPE}
NC, REG_MAX, STRIDES, SHAPES = 6, 16, (8, 16, 32), ((8, 8), (4, 4), (2, 2))


def _box_pairs(seed, n=96):
    """xyxy predictions and targets (n, 4) in grid units: overlapping,
    disjoint, nested and equal boxes, some sharing an edge (ties in min/max)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 20, (n, 2))
    pred = np.concatenate([xy, xy + rng.uniform(0.5, 8, (n, 2))], -1)
    target = pred + rng.normal(0, 1.5, (n, 4))
    target[:, 2:] = np.maximum(target[:, 2:], target[:, :2] + 0.25)
    target[: n // 8] = pred[: n // 8]  # equal boxes
    target[n // 8: n // 4, 0] = pred[n // 8: n // 4, 0]  # a shared left edge
    target[n // 4: n // 4 + 8] = pred[n // 4: n // 4 + 8] + 30.0  # disjoint
    return pred.astype(np.float32), target.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_wasserstein_similarity_matches_jax(seed):
    """NWD similarity within 1e-6 relative, its gradient with respect to both
    boxes within 1e-6 abs + 1e-5 rel."""
    pred, target = _box_pairs(seed)
    g = np.random.default_rng(seed + 9).standard_normal((len(pred), 1)).astype(np.float32)
    jv, jvjp = jax.vjp(j_nwd, jnp.asarray(pred), jnp.asarray(target))
    jgp, jgt = jvjp(jnp.asarray(g))
    p, t = torch.from_numpy(pred).requires_grad_(), torch.from_numpy(target).requires_grad_()
    v = t_nwd(p, t)
    v.backward(torch.from_numpy(g))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgt), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("iou_mean", [1.0, 0.6])
@pytest.mark.parametrize("seed", [0, 1])
def test_wise_iou_loss_matches_jax(seed, iou_mean):
    """Wise-IoU v3 loss within 1e-5 relative, the new running mean within
    1e-6, the gradient with respect to both boxes within 1e-5 abs + 1e-4
    rel (``l2_box`` and the focusing ``beta`` out of it, as in JAX)."""
    pred, target = _box_pairs(seed)
    g = np.random.default_rng(seed + 7).standard_normal(len(pred)).astype(np.float32)

    def jfn(p, t):
        return j_wiou(p, t, jnp.float32(iou_mean))

    (jloss, jmean), jvjp = jax.vjp(jfn, jnp.asarray(pred), jnp.asarray(target))
    jgp, jgt = jvjp((jnp.asarray(g), jnp.zeros((), jnp.float32)))
    p, t = torch.from_numpy(pred).requires_grad_(), torch.from_numpy(target).requires_grad_()
    loss, mean = t_wiou(p, t, torch.tensor(iou_mean))
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mean.item(), float(jmean), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgt), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kw", [{"ltype": "SIoU"}, {"monotonous": True}, {"monotonous": None}, {"inner": True},
                                {"focaler": True}])
def test_wise_iou_refuses_unported_forms(kw):
    """Each of these forms is taken now (held to JAX in
    ``tests/test_torch_port_iou_zoo.py``): finite values for a pair of boxes
    that overlap; an ltype neither package knows raises ``ValueError``."""
    pred, target = _box_pairs(0, 8)
    loss, mean = t_wiou(torch.from_numpy(pred[-2:]), torch.from_numpy(pred[-2:] + 0.5), torch.tensor(1.0), **kw)
    assert torch.isfinite(loss).all() and torch.isfinite(mean)
    with pytest.raises(ValueError, match="unsupported Wise-IoU ltype 'FooIoU'"):
        t_wiou(torch.from_numpy(pred), torch.from_numpy(target), torch.tensor(1.0), **{**kw, "ltype": "FooIoU"})


def _head_maps(seed, b=2):
    rng = np.random.default_rng(seed)
    return [(2 * rng.standard_normal((b, 4 * REG_MAX + NC, h, w))).astype(np.float32) for h, w in SHAPES]


def _labels(seed, b=2, m=5, imgsz=64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.2, 0.8, (b, m, 2))
    wh = rng.uniform(0.1, 0.4, (b, m, 2))
    mask = np.ones((b, m), bool)
    mask[1, 3:] = False
    return {"bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "cls": rng.integers(0, NC, (b, m)).astype(np.int32), "mask": mask}


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_with_the_recipe_matches_jax(seed):
    """The loss with Wise-IoU and the NWD blend: components within 1e-5
    relative, the new running mean (over foreground anchors only, from 0.8)
    within 1e-6 relative, the gradient with respect to each head map within
    1e-5 abs + 1e-4 rel; JAX's loss and gradient jitted."""
    maps, lab = _head_maps(seed), _labels(seed + 5)
    jcfg = JLossConfig(nc=NC, exact_topk=True, **RECIPE)

    def jfn(feats, labels):
        total, comps, new_mean = j_loss(feats, labels, STRIDES, jcfg, jnp.float32(0.8))
        return total, (comps, new_mean)

    (jtotal, (jcomps, jmean)), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(np.transpose(m, (0, 2, 3, 1))) for m in maps], {k: jnp.asarray(v) for k, v in lab.items()})
    feats = [torch.from_numpy(m).requires_grad_() for m in maps]
    total, comps, res, mean = t_loss(feats, {k: torch.from_numpy(v) for k, v in lab.items()}, STRIDES,
                                     TLossConfig(nc=NC, **RECIPE), torch.tensor(0.8))
    total.backward()
    assert int(res.fg_mask.sum()) > 10 and mean.item() != pytest.approx(0.8, abs=1e-5)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(comps[k].item(), float(jcomps[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(mean.item(), float(jmean), rtol=1e-6)
    for f, jg in zip(feats, jgrads):
        np.testing.assert_allclose(f.grad.numpy(), np.transpose(np.asarray(jg), (0, 3, 1, 2)), atol=1e-5, rtol=1e-4)


def _momentum(opt_state):
    """The ``YoloSGDState`` inside the JAX optimizer's nested state."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if isinstance(node, YoloSGDState):
            return node.momentum
        if isinstance(node, tuple):
            stack.extend(node)
    raise LookupError("no YoloSGDState in the optimizer state")


@pytest.fixture(scope="module")
def run():
    tm = TorchModel(CFG, device="cpu")
    he_normal_(tm, 3)
    with _gather_ldconv():
        jm = JaxModel(CFG)
    variables = convert_state_dict({k: v.numpy() for k, v in tm.state_dict().items()
                                    if not k.endswith("num_batches_tracked")}, jm)
    tr = DetectionTrainer(tm, OVERRIDES)
    jt = JaxTrainer(model=jm, variables=variables, overrides=OVERRIDES)
    jt.loss_cfg = dataclasses.replace(jt.loss_cfg, exact_topk=True)
    a = jt.args
    acc = max(round(a.nbs / a.batch), 1)
    jt.tx = build_optimizer(variables["params"], name=a.optimizer, lr0=a.lr0, momentum=a.momentum,
                            weight_decay=a.weight_decay * a.batch * acc / a.nbs, nb=100, epochs=a.epochs, lrf=a.lrf,
                            cos_lr=a.cos_lr, warmup_epochs=a.warmup_epochs, warmup_bias_lr=a.warmup_bias_lr,
                            warmup_momentum=a.warmup_momentum, nc=jm.nc, accumulate=acc)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=jt.tx.init(variables["params"]),
                       ema_params=jax.tree.map(jnp.copy, variables["params"]),
                       ema_batch_stats=jax.tree.map(jnp.copy, variables["batch_stats"]),
                       iou_mean=jnp.asarray(1.0, jnp.float32), step=jnp.zeros([], jnp.int32),
                       ema_updates=jnp.zeros([], jnp.int32))
    jstep = jt._make_train_step()
    out = []
    for seed in range(STEPS):
        batch = seeded_batch(BATCH, IMGSZ, seed)
        state, jcomps = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        comps = tr.train_step(batch)
        out.append(dict(jcomps=jax.tree.map(float, jcomps), comps={k: float(v) for k, v in comps.items()},
                        iou_mean=tr.state.iou_mean.item(), jiou_mean=float(state.iou_mean),
                        momentum={n: tr.state.optimizer.state[p]["momentum_buffer"].clone()
                                  for n, p in tm.named_parameters()},
                        jmomentum=jax_params_to_named(_momentum(state.opt_state), tm)))
    return dict(tr=tr, steps=out)


def _rel_ok(got, want, rtol=1e-3, floor=1e-6):
    """Relative L2 within ``rtol``, or an absolute L2 within ``floor`` for a
    tensor whose norm is below 1e-5 (a BatchNorm-cancelled bias)."""
    diff, norm = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
    return diff <= floor if norm < 1e-5 else diff <= rtol * norm


def test_recipe_step_losses_match_jax(run):
    """Each step's box (Wise-IoU blended with NWD), cls and dfl within 1e-4
    relative, as the CIoU step's are."""
    for step in run["steps"]:
        for k in ("box", "cls", "dfl"):
            np.testing.assert_allclose(step["comps"][k], step["jcomps"][k], rtol=1e-4, err_msg=k)
        assert step["comps"]["fg"] > 20


def test_recipe_step_iou_mean_matches_jax(run):
    """The running mean after each micro-batch within 1e-6 relative; it moved
    from 1.0 on each."""
    means = [step["iou_mean"] for step in run["steps"]]
    for step in run["steps"]:
        np.testing.assert_allclose(step["iou_mean"], step["jiou_mean"], rtol=1e-6)
    assert 1.0 > means[0] > means[1] > 0.9
    assert run["tr"].state.iou_mean.dtype == torch.float32 and run["tr"].state.iou_mean.dim() == 0


def test_recipe_step_gradients_match_jax(run):
    """Every momentum buffer after each update (after the first, the clipped
    gradient plus weight decay), leaf by leaf: 1e-3 relative L2, with an
    absolute floor of 1e-6 where the norm is below 1e-5, as the CIoU step's."""
    model = run["tr"].state.model
    for i, step in enumerate(run["steps"]):
        bad = [n for n, _ in model.named_parameters()
               if not _rel_ok(step["momentum"][n].numpy(), step["jmomentum"][n].numpy())]
        assert not bad, f"step {i}: {bad[:5]}"
    assert run["tr"].state.optimizer.updates == STEPS
