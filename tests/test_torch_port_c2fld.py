"""``C2f_LDConv`` (``BottleneckLD``, ``C2fLD``) in the PyTorch port against
the JAX package: each module's forward and VJP in train mode, and
``yolov8-LD-P2.yaml`` with its ``C2f`` rows renamed ``C2f_LDConv`` (the model
no YAML of the repo names, which the chip check drives): parameter count,
strides, the converter against ``invert_to_torch_state`` and the eval
forward. The JAX variables are their init tree (``jax.eval_shape``) filled
from a seed. The JAX LDConv layers take the exact gather path
(``sampling='gather'``, what K3 computes; the default ``auto`` compiles a
dense hat window for seconds a layer). Tolerance: ROADMAP's LDConv float
order, 4e-4."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.nn.modules import BottleneckLD as TBottleneckLD
from experiment_yolo_torch.nn.modules import C2fLD as TC2fLD
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.nn.tasks import yaml_model_load
from experiment_yolo_torch.utils.convert import _ldconv, _rule, jax_variables_to_state_dict
from experiment_yolo_tpu.nn import modules as M
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from experiment_yolo_tpu.utils.torch_convert import invert_to_torch_state
from test_torch_port_asf import _seeded_like_init

TOL = 4e-4
IMGSZ = 64


class _GatherLDConv(M.LDConv):
    sampling: str = "gather"


_GatherLDConv.__name__ = _GatherLDConv.__qualname__ = "LDConv"


@pytest.fixture(scope="module", autouse=True)
def gather_ldconv():
    """JAX LDConv layers, built at construction or inside a block's call, on the gather path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "LDConv", _GatherLDConv)
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _filled(tree, seed):
    """Every leaf of a flax init tree drawn from a seed: kernels within
    1/sqrt(fan_in), BatchNorm away from identity."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            bound = 1.0 / math.sqrt(math.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        lo, hi = {"scale": (0.8, 1.2), "var": (0.5, 1.5)}.get(name, (-0.1, 0.1))
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(fill, tree))


def _state_dict(tm, variables, rule):
    """The port module's state dict from JAX variables, leaf by leaf through ``rule(parts)``."""
    out = {}
    for name, ref in tm.state_dict().items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros_like(ref)
            continue
        kind, path, fn = rule(name.split("."))
        node = variables[kind]
        for k in path:
            node = node[k]
        out[name] = torch.tensor(fn(np.asarray(node, np.float32)))
    return out


def _bottleneck_rule(tm):
    return lambda parts: _ldconv((parts[0],), parts[1:], tm.cv1.num_param)


def _c2fld_rule(tm):
    return lambda parts: _rule("C2f_LDConv", parts, tm)


MODULES = {
    "BottleneckLD": (lambda c: M.BottleneckLD(c, True, 4, e=1.0), lambda c: TBottleneckLD(c, c, True, 4, e=1.0),
                     _bottleneck_rule),
    "C2fLD": (lambda c: M.C2fLD(c, n=2, shortcut=True), lambda c: TC2fLD(c, c, 2, True), _c2fld_rule),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_forward_and_vjp_match_jax(name):
    """Train-mode forward (BatchNorm on batch statistics), the gradient with
    respect to the input and every parameter, and the running statistics,
    each within 4e-4 relative L2 of ``jax.vjp`` of the JAX module; the eval
    forward too. The input is 13 x 11, so no level's h*w is a multiple of 32
    (K3's backward warps straddle channel slices there on the card)."""
    c = 16
    jmaker, tmaker, rule = MODULES[name]
    jm, tm = jmaker(c), tmaker(c)
    x = np.random.default_rng(1).standard_normal((2, c, 13, 11)).astype(np.float32)
    x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    variables = _filled(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x_nhwc, False)), seed=2)
    tm.load_state_dict(_state_dict(tm, variables, rule(tm)), strict=True)

    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.transpose(np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, False))(variables, x_nhwc)), (0, 3, 1, 2))
    assert _rel(got, want) < TOL

    def fn(params, xx):
        return jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx, True,
                        mutable=["batch_stats"])

    w = np.random.default_rng(3).standard_normal((2, 13, 11, c)).astype(np.float32)

    @jax.jit
    def vjp_fn(params, xx, ww):
        y, vjp, stats = jax.vjp(fn, params, xx, has_aux=True)
        return y, vjp(ww), stats

    jy, (jg_params, jg_x), jstats = vjp_fn(variables["params"], x_nhwc, jnp.asarray(w))
    tm.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt)
    y.backward(torch.from_numpy(np.ascontiguousarray(np.transpose(w, (0, 3, 1, 2)))))
    assert _rel(y.detach().numpy(), np.transpose(np.asarray(jy), (0, 3, 1, 2))) < TOL
    assert _rel(xt.grad.numpy(), np.transpose(np.asarray(jg_x), (0, 3, 1, 2))) < TOL
    for pname, p in tm.named_parameters():
        kind, path, fn_ = rule(tm)(pname.split("."))
        node = jg_params
        for k in path:
            node = node[k]
        jg = fn_(np.asarray(node, np.float32))
        assert np.linalg.norm(jg) > 0, pname
        assert _rel(p.grad.numpy(), jg) < TOL, pname
    for bname, buf in tm.named_buffers():
        if "running" in bname:
            kind, path, fn_ = rule(tm)(bname.split("."))
            node = jstats[kind]
            for k in path:
                node = node[k]
            np.testing.assert_allclose(buf.numpy(), np.asarray(node), atol=1e-6, rtol=1e-5, err_msg=bname)


def _ld_c2f_cfg(nc=3):
    d = yaml_model_load("yolov8-LD-P2.yaml")
    return {**d, "nc": nc, **{sec: [[f, n, "C2f_LDConv" if m == "C2f" else m, a] for f, n, m, a in d[sec]]
                              for sec in ("backbone", "head")}}


def test_c2f_ldconv_model_matches_jax():
    """LD-P2 with ``C2f_LDConv`` at n scale: the parameter count and strides
    of the JAX model, the converter equal to ``invert_to_torch_state``
    (whose ``m.{k}.cv1|cv2`` LDConv leaves JAX maps at
    ``utils/torch_convert.py:154-162``), and the raw maps of the eval forward
    within 4e-4 of each map's largest value."""
    cfg = _ld_c2f_cfg()
    jm = JaxModel(cfg)
    variables = _seeded_like_init(jm, 6)
    tm = TorchModel(cfg, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == sum(v.size for v in jax.tree.leaves(variables["params"]))
    assert tuple(tm.stride) == tuple(jm.strides)
    assert sum(isinstance(m, TBottleneckLD) for m in tm.modules()) == 9
    sd = jax_variables_to_state_dict(variables, tm)
    ref = invert_to_torch_state(variables, {k: tuple(v.shape) for k, v in tm.state_dict().items()}, jm)
    assert set(ref) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    tm.load_state_dict(sd, strict=True)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = jax.jit(lambda v, xx: jm.module.apply(v, xx, False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))))
    for g, w in zip(got, want):
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        np.testing.assert_allclose(g.numpy(), w, atol=TOL * np.abs(w).max(), rtol=0)
