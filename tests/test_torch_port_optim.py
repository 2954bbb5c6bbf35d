"""The port's optimizer, firing plan, parameter groups and EMA against the JAX
package's ``optim/builders.py`` and ``utils/ema.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.optim import builders as tb
from experiment_yolo_torch.utils.convert import jax_path
from experiment_yolo_torch.utils.ema import ModelEMA, ema_update
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.optim import builders as jb
from experiment_yolo_tpu.utils.ema import ema_update as j_ema_update


@pytest.mark.parametrize("nb,epochs,warmup,k", [(10, 30, 3.0, 8), (50, 4, 3.0, 32), (7, 20, 0.0, 4),
                                                (200, 2, 1.0, 2), (1, 1, 3.0, 64), (3, 5, 3.0, 1)])
def test_step_plan_matches_jax(nb, epochs, warmup, k):
    got, want = tb._torch_step_plan(nb, epochs, warmup, k), jb._torch_step_plan(nb, epochs, warmup, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("warmup,cos_lr", [(3.0, False), (0.0, False), (3.0, True)])
def test_schedules_match_jax(warmup, cos_lr):
    """LR, bias LR and momentum at every batch of a run, within 1e-6
    relative (the JAX package computes them in f32, the port in f64)."""
    args = dict(lr0=0.01, nb=40, warmup_epochs=warmup, warmup_bias_lr=0.1, warmup_momentum=0.8, momentum=0.937)
    t = tb.warmup_schedules(lf=tb.lr_lambda(10, 0.01, cos_lr), **args)
    j = jb.warmup_schedules(lf=jb.lr_lambda(10, 0.01, cos_lr), **args)
    steps = np.arange(0, 400, 7, dtype=np.float32)
    for tf, jf in zip(t, j):
        np.testing.assert_allclose([tf(float(s)) for s in steps], np.asarray(jax.vmap(jf)(jnp.asarray(steps))),
                                   rtol=1e-6, atol=1e-9)


def test_group_labels_match_jax_through_the_converter():
    """Every LD-P2 parameter lands in the group that ``param_group_label``
    gives its JAX counterpart, found through the converter's own mapping:
    BatchNorm biases in the bias group, BatchNorm weights in the norm group,
    every other weight (``conv.0``, ``p_conv``, ``conv3d`` included) in the
    weight group."""
    model = TorchModel("yolov8-LD-P2.yaml", device="cpu")
    shapes = jax.eval_shape(JaxModel("yolov8-LD-P2.yaml").init, jax.random.PRNGKey(0))["params"]
    jlabels = {tuple(getattr(p, "key", p) for p in path): jb.param_group_label(path, leaf)
               for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    groups = tb.param_groups(model)
    assert sum(len(v) for v in groups.values()) == len(list(model.parameters()))
    for label, named in groups.items():
        for name, _ in named:
            kind, path = jax_path(name, model)
            assert kind == "params" and jlabels[path] == label, name
    assert {n for n, _ in groups["norm"]} >= {"model.0.conv.1.weight", "model.24.bn.weight"}
    assert {"model.0.conv.0.weight", "model.0.p_conv.weight", "model.24.conv3d.weight"} <= \
        {n for n, _ in groups["weight"]}


class _Tiny(nn.Module):
    """One parameter of each group, with the shapes of the JAX tree below."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Linear(3, 4, bias=False)  # weight (4, 3): the weight group
        self.bn = nn.BatchNorm1d(3)  # norm weight and bias-group bias
        self.head = nn.Linear(3, 2)  # weight and bias


def _tiny_params(rng):
    return {"conv": {"kernel": rng.standard_normal((4, 3))}, "bn": {"scale": 1 + 0.1 * rng.standard_normal(3),
                                                                    "bias": rng.standard_normal(3)},
            "head": {"kernel": rng.standard_normal((2, 3)), "bias": rng.standard_normal(2)}}


_NAMES = {"conv.weight": ("conv", "kernel"), "bn.weight": ("bn", "scale"), "bn.bias": ("bn", "bias"),
          "head.weight": ("head", "kernel"), "head.bias": ("head", "bias")}


@pytest.mark.parametrize("accumulate,warmup", [(1, 3.0), (4, 0.0), (4, 3.0)])
def test_sgd_lockstep_with_jax_build_optimizer(accumulate, warmup):
    """12 micro-steps on one fixed gradient sequence: the port's SGD (sums
    accumulated in ``.grad``, fired by the plan) against the JAX
    ``build_optimizer`` chain (``MultiSteps`` means scaled back to sums).
    Some steps' summed gradients exceed the clip norm of 10. Parameters after
    every micro-step within 1e-6 abs + 1e-5 rel (f32, mean-times-k against a
    sum, f32 against f64 schedules)."""
    rng = np.random.default_rng(accumulate + int(warmup))
    params = jax.tree.map(lambda a: a.astype(np.float32), _tiny_params(rng))
    kw = dict(name="SGD", lr0=0.1, momentum=0.9, weight_decay=0.05, nb=5, epochs=3, lrf=0.1, cos_lr=False,
              warmup_epochs=warmup, warmup_bias_lr=0.2, warmup_momentum=0.6, accumulate=accumulate)
    model = _Tiny()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(params[_NAMES[name][0]][_NAMES[name][1]]))
    opt = tb.build_optimizer(model, **kw)
    tx = jb.build_optimizer(params, **kw)
    state, jp = tx.init(params), params
    fired = 0
    for step in range(12):
        scale = 8.0 if step % 3 == 0 else 0.5
        g = jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        if opt.mini_step == 0:
            opt.zero_grad()
        for name, p in model.named_parameters():
            new = torch.from_numpy(np.asarray(g[_NAMES[name][0]][_NAMES[name][1]]))
            p.grad = new.clone() if p.grad is None else p.grad + new
        fired += opt.step()
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[_NAMES[name][0]][_NAMES[name][1]]),
                                       atol=1e-6, rtol=1e-5, err_msg=f"{name} after micro-step {step}")
    assert fired == opt.updates == (12 if accumulate == 1 or warmup else 3)


def test_unported_optimizers_raise():
    kw = dict(lr0=0.01, momentum=0.9, weight_decay=0.0, nb=10, lrf=0.01, cos_lr=False, warmup_epochs=0.0,
              warmup_bias_lr=0.1, warmup_momentum=0.8)
    with pytest.raises(NotImplementedError, match="AdamW"):
        tb.build_optimizer(_Tiny(), "auto", epochs=10, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tb.build_optimizer(_Tiny(), "SOAP", epochs=100, **kw)
    assert isinstance(tb.build_optimizer(_Tiny(), "auto", epochs=100, **kw), tb.YoloSGD)


@pytest.mark.parametrize("updates", [1, 7, 2000, 50000])
def test_ema_update_matches_jax(updates):
    """``ema_update`` within 1e-6 relative of the JAX one: an f32 ulp or two,
    since JAX rounds the decay to f32 and the port keeps it in f64."""
    rng = np.random.default_rng(updates)
    ema = [rng.standard_normal((5, 3)).astype(np.float32), rng.standard_normal(4).astype(np.float32)]
    new = [rng.standard_normal((5, 3)).astype(np.float32), rng.standard_normal(4).astype(np.float32)]
    want = j_ema_update([jnp.asarray(e) for e in ema], [jnp.asarray(n) for n in new], jnp.asarray(updates))
    got = [torch.from_numpy(e.copy()) for e in ema]
    ema_update(got, [torch.from_numpy(n) for n in new], updates)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7, rtol=1e-6)


def test_model_ema_covers_parameters_and_bn_statistics():
    model = _Tiny()
    ema = ModelEMA(model)
    assert not ema.ema.training and not any(p.requires_grad for p in ema.ema.parameters())
    assert len(ModelEMA.tracked(model)) == 5 + 2  # parameters, running mean and var (not the batch count)
    with torch.no_grad():
        for t in ModelEMA.tracked(model):
            t.add_(1.0)
    ema.update(model)
    d = 0.9999 * (1 - np.exp(-1 / 2000))
    for e, t in zip(ModelEMA.tracked(ema.ema), ModelEMA.tracked(model)):
        t = t.detach().numpy()
        np.testing.assert_allclose(e.numpy(), (t - 1.0) * d + t * (1 - d), atol=1e-6)
