"""The optimizer zoo in the port against the JAX package's ``build_optimizer``
(``optim/builders.py``) and ``soap`` (``optim/soap.py``): Adam, AdamW,
NAdam, RAdam, RMSProp, SOAP and ``auto`` (AdamW for runs shorter than 50
epochs), each on its optax chain, and each family's state through a
``state_dict`` round trip.

The parameters are one of each group (a conv weight, a BatchNorm scale, a
BatchNorm bias, a linear layer's weight and bias) with the shapes of their
flax counterparts; the gradients come from a numpy seed, some steps' sums
above the clip norm of 10. SOAP's factors are sums of outer products of
random gradients, whose eigenvalues are distinct: a degenerate eigenvalue
would give ``jnp.linalg.eigh`` and ``torch.linalg.eigh`` different bases of
its eigenspace, and SOAP's step would differ while both are right.
"""

import io

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from experiment_yolo_torch.optim import builders as tb
from experiment_yolo_torch.optim.soap import SOAP
from experiment_yolo_tpu.optim import builders as jb
from experiment_yolo_tpu.optim.soap import soap as j_soap

UPDATES = 8


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, bias=False)  # the weight group, (O, I, kh, kw)
        self.bn = nn.BatchNorm2d(4)  # the norm group's weight, the bias group's bias
        self.head = nn.Linear(4, 4)  # weight and bias (square: SOAP's two factors of full rank)


# port name -> (flax path, the flax leaf from the torch tensor)
_LEAVES = {"conv.weight": (("conv", "kernel"), lambda t: t.transpose(2, 3, 1, 0)),
           "bn.weight": (("bn", "scale"), lambda t: t), "bn.bias": (("bn", "bias"), lambda t: t),
           "head.weight": (("head", "kernel"), lambda t: t.T), "head.bias": (("head", "bias"), lambda t: t)}


def _setup(seed):
    """The port model and the JAX parameter tree holding the same values."""
    torch.manual_seed(seed)
    model = _Tiny()
    with torch.no_grad():
        model.bn.weight.uniform_(0.5, 1.5)
        model.bn.bias.normal_()
    params = {}
    for name, p in model.named_parameters():
        (mod, leaf), to_jax = _LEAVES[name]
        params.setdefault(mod, {})[leaf] = to_jax(p.detach().numpy().copy())
    return model, params


def _grads(rng, step, params):
    scale = 8.0 if step % 3 == 0 else 0.5
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)


def _torch_leaf(tree, name):
    (mod, leaf), to_jax = _LEAVES[name]
    a = np.asarray(tree[mod][leaf])
    return a.transpose(3, 2, 0, 1) if name == "conv.weight" else (a.T if name == "head.weight" else a)


def _run(model, opt, params, tx, state, rng, micro_steps, check):
    """``micro_steps`` micro-batches through both; ``check(name, port, jax)``
    after each. Returns the JAX parameters and state."""
    fired, update = 0, jax.jit(tx.update)
    for step in range(micro_steps):
        g = _grads(rng, step, params)
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
        if opt.mini_step == 0:
            opt.zero_grad()
        for name, p in model.named_parameters():
            new = torch.from_numpy(np.ascontiguousarray(_torch_leaf(g, name)))
            p.grad = new.clone() if p.grad is None else p.grad + new
        fired += opt.step()
        for name, p in model.named_parameters():
            check(f"{name} after micro-step {step}", p.detach().numpy(), _torch_leaf(params, name))
    return params, state, fired


def _rel_check(rtol):
    def check(what, got, want, slack=0.0):
        diff, norm = float(np.linalg.norm(got - want)), float(np.linalg.norm(want))
        assert diff <= rtol * norm + slack, f"{what}: relative L2 {diff / norm:.3g} > {rtol}"
    return check


KW = dict(lr0=0.01, momentum=0.9, weight_decay=0.05, nb=5, lrf=0.1, cos_lr=False, warmup_bias_lr=0.2,
          warmup_momentum=0.6)


@pytest.mark.parametrize("accumulate,warmup", [(1, 3.0), (4, 0.0)], ids=["accumulate1", "accumulate4"])
@pytest.mark.parametrize("name", ["Adam", "AdamW", "NAdam", "RAdam", "RMSProp", "SOAP", "auto"])
def test_optimizer_lockstep_with_jax_build_optimizer(name, accumulate, warmup):
    """8 updates on one fixed gradient sequence (32 micro-batches at
    accumulate 4): the port's optimizer (sums accumulated in ``.grad``, fired
    by the plan) against the JAX ``build_optimizer`` chain (``MultiSteps``
    means scaled back to sums). Every parameter after every micro-step within
    1e-6 relative L2 of JAX's (SOAP: 1e-5, its ``eigh`` in another library),
    and so is its displacement from the start after the last, give or take
    one f32 spacing of the parameter per update (each side rounds p + u).
    RAdam crosses its rectification threshold (rho_t >= 5 from the sixth
    update on)."""
    model, params = _setup(1)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    kw = dict(KW, name=name, epochs=10, warmup_epochs=warmup, accumulate=accumulate)
    opt = tb.build_optimizer(model, **kw)
    tx = jb.build_optimizer(params, **kw)
    rtol = 1e-5 if name == "SOAP" else 1e-6
    micro = UPDATES * (accumulate if not warmup else 1)
    jparams, _, fired = _run(model, opt, params, tx, tx.init(params), np.random.default_rng(2), micro,
                             _rel_check(rtol))
    assert fired == opt.updates == UPDATES
    assert isinstance(opt, {"SGD": tb.YoloSGD, "RMSProp": tb.YoloRMSProp, "SOAP": SOAP}.get(name, tb.YoloAdam))
    if name == "auto":
        assert opt.family == "AdamW" and opt.b1 == 0.9 and opt.schedules()[0] <= 0.002
    for n, p in model.named_parameters():
        want = _torch_leaf(jparams, n)
        _rel_check(rtol)(f"{n}'s displacement", (p.detach() - start[n]).numpy(), want - start[n].numpy(),
                         UPDATES * float(np.linalg.norm(np.spacing(want))))


def test_soap_refreshes_its_basis_like_jax():
    """``soap(precondition_frequency=3)`` with decoupled decay on the weight
    group for 8 updates, so that the first applies no step and the basis is
    refreshed at updates 3 and 6 (a power iteration, a QR and the eigenvalue
    sort): every parameter within 1e-5 relative L2 of the JAX
    transformation's after every update."""
    model, params = _setup(3)
    labels = jax.tree_util.tree_map_with_path(jb.param_group_label, params)
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     j_soap(lambda _: 0.01, weight_decay=0.05, precondition_frequency=3,
                            decay_mask=jax.tree.map(lambda label: label == "weight", labels)))
    opt = SOAP(tb.param_groups(model), lambda _: 0.01, lambda _: 0.01, lambda _: 0.9, 0.05, [1], range(UPDATES),
               precondition_frequency=3)
    _, _, fired = _run(model, opt, params, tx, tx.init(params), np.random.default_rng(4), UPDATES, _rel_check(1e-5))
    assert fired == UPDATES
    st = opt.state[model.conv.weight]
    assert [tuple(q.shape) for q in st["q"]] == [(4, 4), (3, 3), (3, 3), (3, 3)]
    assert all(torch.allclose(q.T @ q, torch.eye(q.shape[0]), atol=1e-5) for q in st["q"])


@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW", "NAdam", "RAdam", "RMSProp", "SOAP"])
def test_state_dict_round_trip_resumes_bit_equal(name):
    """Three updates, the optimizer's ``state_dict`` through ``torch.save``
    into a fresh model and optimizer, three more updates (across a SOAP
    refresh at frequency 2): parameters and every state tensor bit-equal to
    six updates straight."""
    kw = dict(KW, name=name, epochs=10, warmup_epochs=0.0, accumulate=1)

    def build(model):
        opt = tb.build_optimizer(model, **kw)
        if name == "SOAP":
            opt.precondition_frequency = 2
        return opt

    def steps(model, opt, rng, n):
        for _ in range(n):
            opt.zero_grad()
            for p in model.parameters():
                p.grad = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            opt.step()

    straight, _ = _setup(5)
    opt = build(straight)
    steps(straight, opt, np.random.default_rng(6), 6)

    first, _ = _setup(5)
    opt1 = build(first)
    rng = np.random.default_rng(6)
    steps(first, opt1, rng, 3)
    buf = io.BytesIO()
    torch.save({"model": first.state_dict(), "optimizer": opt1.state_dict()}, buf)
    buf.seek(0)
    ckpt = torch.load(buf, weights_only=False)
    resumed, _ = _setup(7)
    resumed.load_state_dict(ckpt["model"])
    opt2 = build(resumed)
    opt2.load_state_dict(ckpt["optimizer"])
    assert (opt2.updates, opt2.mini_step) == (3, 0)
    steps(resumed, opt2, rng, 3)
    for (n, a), b in zip(straight.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), n
    want, got = opt.state_dict()["state"], opt2.state_dict()["state"]
    flat = lambda v: [t for x in v for t in (x if isinstance(x, list) else [x]) if t is not None]
    for i in want:
        for key in want[i]:
            assert all(torch.equal(a, b) for a, b in zip(flat([want[i][key]]), flat([got[i][key]]))), (i, key)
