"""The whole training slice: one port ``DetectionTrainer.train_step`` of
LD-P2 n against one step of the JAX package's ``_make_train_step``.

One JAX init (PRNGKey(0)) of ``yolov8-LD-P2.yaml`` is converted into the port.
Both trainers take the same two seeded labelled batches at 64 px, batch 2,
with ``amp=False``, the default loss (the JAX one with the exact top-k) and
the optimizer that the JAX ``train()`` builds: SGD, accumulate
``round(nbs / batch)`` = 32 on the ramped firing plan (both steps fire, the
first with a weight LR of 0), weight decay scaled by ``batch * accumulate /
nbs``, and the EMA. The JAX step is compiled once for the file.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiment_yolo_torch.nn.modules as tmodules
from experiment_yolo_torch.engine.trainer import DetectionTrainer
from experiment_yolo_torch.nn.modules import LDConv
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.utils.convert import jax_params_to_named, jax_variables_to_state_dict
from experiment_yolo_torch.utils.loss import detection_loss as t_loss
from experiment_yolo_torch.utils.seeded import seeded_batch
from experiment_yolo_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from experiment_yolo_tpu.engine.trainer import TrainState
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.optim.builders import YoloSGDState, build_optimizer
from experiment_yolo_tpu.utils.loss import detection_loss as j_loss

CFG, IMGSZ, BATCH, STEPS = "yolov8-LD-P2.yaml", 64, 2, 2
OVERRIDES = {"amp": False, "batch": BATCH, "imgsz": IMGSZ}


def _jax_trainer(jm, variables):
    """The JAX trainer with the optimizer, state and step its ``train()`` builds."""
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
    return jt, jt._make_train_step(), state


def _fg_masks(jm, jt, variables, tr, batch):
    """The TAL foreground mask of each package's loss on the first batch,
    from the initial weights in train mode (on a copy of the port model, so
    that its BatchNorm statistics stay as they were)."""
    img = batch["img"].astype(np.float32) / 255.0
    feats, _ = jax.jit(lambda v, x: jm.module.apply(v, x, True, mutable=["batch_stats"]))(variables, img)
    tb = {k: jnp.asarray(batch[k]) for k in ("bboxes", "cls", "mask")}
    jmask = j_loss(list(feats), tb, jm.strides, jt.loss_cfg, return_aux=True)[-1]["fg_mask"]
    model = copy.deepcopy(tr.state.model)
    with torch.no_grad():
        tfeats = model(torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))))
        res = t_loss(tfeats, {k: torch.from_numpy(batch[k]) for k in tb}, model.stride, tr.loss_cfg)[2]
    return res.fg_mask.numpy(), np.asarray(jmask)


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


def _spy_gather(record):
    """A stand-in for the LDConv gather that records, per call, the norms of
    the gradients reaching its source and its offsets through the gather
    alone (each input goes in through a view that only the gather reads)."""
    gather = tmodules.ldconv_gather

    def spy(x, off, stride):
        xv, ov = x.view_as(x), off.view_as(off)
        entry = {}
        for name, t in (("x", xv), ("off", ov)):
            if t.requires_grad:  # the first layer's source is the image
                t.register_hook(lambda g, name=name: entry.__setitem__(name, float(g.norm())))
        record.append(entry)
        return gather(xv, ov, stride)

    return spy


@pytest.fixture(scope="module")
def run():
    jm = JaxModel(CFG)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = TorchModel(CFG, device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    tr = DetectionTrainer(tm, OVERRIDES)
    jt, jstep, state = _jax_trainer(jm, variables)
    batches = [seeded_batch(BATCH, IMGSZ, seed) for seed in range(STEPS)]
    fg_masks = _fg_masks(jm, jt, variables, tr, batches[0])
    out, gather_grads = [], []
    gather = tmodules.ldconv_gather
    tmodules.ldconv_gather = _spy_gather(gather_grads)
    try:
        for batch in batches:
            state, jcomps = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
            comps = tr.train_step(batch)
            momentum = {n: tr.state.optimizer.state[p]["momentum_buffer"].clone() for n, p in tm.named_parameters()}
            out.append(dict(jcomps=jax.tree.map(float, jcomps), comps={k: float(v) for k, v in comps.items()},
                            momentum=momentum, jmomentum=jax_params_to_named(_momentum(state.opt_state), tm),
                            grads=[g for g in gather_grads]))
            gather_grads.clear()
    finally:
        tmodules.ldconv_gather = gather
    jvars = {"params": state.params, "batch_stats": state.batch_stats}
    jema = {"params": state.ema_params, "batch_stats": state.ema_batch_stats}
    return dict(tr=tr, steps=out, jstate=jax_variables_to_state_dict(jax.tree.map(np.asarray, jvars), tm),
                jema=jax_variables_to_state_dict(jax.tree.map(np.asarray, jema), tm), init=variables, fg_masks=fg_masks)


def _rel_ok(got, want, rtol=1e-3, floor=1e-6):
    """Relative L2 within ``rtol``, or an absolute L2 within ``floor`` for a
    tensor whose norm is below 1e-5 (a BatchNorm-cancelled bias)."""
    diff, norm = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
    return diff <= floor if norm < 1e-5 else diff <= rtol * norm


def test_loss_components_match_jax(run):
    """Each step's box, cls and dfl within 1e-4 relative."""
    for step in run["steps"]:
        for k in ("box", "cls", "dfl"):
            np.testing.assert_allclose(step["comps"][k], step["jcomps"][k], rtol=1e-4, err_msg=k)
        assert step["comps"]["fg"] > 20


def test_tal_foreground_mask_is_identical(run):
    """The foreground mask TAL assigns on the first batch, anchor by anchor."""
    got, want = run["fg_masks"]
    assert got.shape == want.shape and want.sum() > 20
    np.testing.assert_array_equal(got, want)


def test_every_momentum_buffer_matches_jax(run):
    """The momentum buffers after each update (after the first, the clipped
    gradient plus weight decay), leaf by leaf: 1e-3 relative L2, with an
    absolute floor of 1e-6 where the norm is below 1e-5."""
    model = run["tr"].state.model
    for i, step in enumerate(run["steps"]):
        bad = [n for n, _ in model.named_parameters()
               if not _rel_ok(step["momentum"][n].numpy(), step["jmomentum"][n].numpy())]
        assert not bad, f"step {i}: {bad[:5]}"
    assert run["tr"].state.optimizer.updates == STEPS  # both micro-batches fired (the plan starts at k = 1)


def test_parameters_and_bn_statistics_match_jax(run):
    """Parameters after two steps within 1e-5 abs + 1e-4 rel; the BatchNorm
    running mean and the running variance, which JAX updates with the
    biased batch variance, within 1e-5 abs + 1e-4 rel; the batch count moved.
    Most tensors moved from their initial values."""
    tr = run["tr"]
    init = jax_variables_to_state_dict(run["init"], tr.state.model)
    moved = total = 0
    for name, v in tr.state.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == STEPS, name
            continue
        np.testing.assert_allclose(v.numpy(), run["jstate"][name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
        moved, total = moved + (not torch.equal(v, init[name])), total + 1
    # the second step's weight LR is 1e-4: some norm weights at 1.0 move by
    # less than f32 resolves there, in JAX as here
    assert moved >= 0.9 * total, f"only {moved} of {total} tensors moved"


def test_running_var_is_the_biased_update():
    """One train-mode BatchNorm step moves ``running_var`` towards the biased
    batch variance, as the JAX package's BatchNorm does (not PyTorch's
    unbiased one)."""
    bn = tmodules.BatchNorm2d(3, eps=1e-3, momentum=0.03).train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 2, 2)).astype(np.float32) * 3 + 1)
    bn(x)
    var = x.transpose(0, 1).reshape(3, -1).var(1, unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.97 + 0.03 * var).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), (0.03 * x.mean((0, 2, 3))).numpy(), rtol=1e-6, atol=1e-7)


def test_ema_matches_jax(run):
    """The EMA of the parameters and the BatchNorm statistics after two
    micro-batches within 1e-5 abs + 1e-4 rel, and in eval mode."""
    ema = run["tr"].state.ema
    assert ema.updates == STEPS and not ema.ema.training and run["tr"].state.model.training
    for name, v in ema.ema.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), run["jema"][name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_gather_passes_gradients_to_offsets_and_sources(run):
    """Every LDConv's offsets and source receive a non-zero gradient through
    the gather, and every ``p_conv`` a non-zero update: the gather is not
    cut out of the graph."""
    model = run["tr"].state.model
    for step in run["steps"]:
        assert len(step["grads"]) == 10 and sum("x" in g for g in step["grads"]) == 9  # all but the image
        assert all(g["off"] > 0 and g.get("x", 1.0) > 0 for g in step["grads"]), step["grads"]
        for m in model.modules():
            if isinstance(m, LDConv):
                assert step["momentum"][f"model.{m.i}.p_conv.weight"].abs().sum() > 0


def test_trainer_refuses_amp_and_unported_switches():
    """``amp`` is ported: with the defaults (amp=True) the trainer computes in
    bf16 and with amp=False in f32, the parameters staying f32; the switches
    that are not ported still raise."""
    model = TorchModel(CFG, device="cpu")
    trainer = DetectionTrainer(model, {"batch": 2})  # amp defaults to True
    assert trainer.args.amp and trainer.dtype == model.dtype == trainer.state.ema.ema.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert DetectionTrainer(model, OVERRIDES).dtype == model.dtype == torch.float32
    # the IoU zoo is taken now; a name neither package knows raises
    assert DetectionTrainer(model, {**OVERRIDES, "iou_type": "GIoU"}).loss_cfg.iou_type == "GIoU"
    wiou = DetectionTrainer(model, {**OVERRIDES, "use_wiseiou": True, "wiou_ltype": "SIoU"})
    assert wiou.loss_cfg.wiou_ltype == "SIoU"
    with pytest.raises(ValueError, match="unknown iou_type 'FooIoU'"):
        DetectionTrainer(model, {**OVERRIDES, "iou_type": "FooIoU"})
    with pytest.raises(ValueError, match="uint8"):
        DetectionTrainer(model, OVERRIDES).train_step({**seeded_batch(2, IMGSZ, 0),
                                                       "img": np.zeros((2, 3, IMGSZ, IMGSZ), np.float32)})
