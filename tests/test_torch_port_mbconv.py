"""``MBConv`` (EfficientNet's mobile inverted bottleneck with its repeats
inside) in the PyTorch port against the JAX package's, and the two configs
it opens, ``yolov8-lafiyolo.yaml`` and ``yolov8-efficientnet.yaml``.

The module alone, on seeded inputs and variables (BatchNorm away from
identity), in train mode (output and running statistics), in eval mode and
through the VJP with respect to the input and every parameter, for the
cases that reach each branch: no expansion with a residual, a stride on the
first of two repeats (the intermediate keeps the input's width), three
repeats with ReLU, no activation, and ``drop_path``, which the JAX module
stores and never applies. The configs: strides, parameter counts equal to
JAX's at scales n and l (repeats 1-4), and lafiyolo's forward and one
gradient against JAX at 64 px.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.nn.modules import MBConv
from experiment_yolo_torch.nn.tasks import DetectionModel as TorchModel
from experiment_yolo_torch.utils.convert import _rule, jax_params_to_named, jax_variables_to_state_dict
from experiment_yolo_tpu.nn.modules import MBConv as JaxMBConv
from experiment_yolo_tpu.nn.tasks import DetectionModel as JaxModel
from test_torch_port_asf import _seeded_like_init

# (c1, c2, n, e, act, drop_path, stride)
CASES = {"no-expansion-residual": (8, 8, 1, 1, "SiLU", 0.0, 1), "stride2-two-repeats": (8, 16, 2, 6, "silu", 0.0, 2),
         "three-repeats-relu": (8, 16, 3, 6, "relu", 0.0, 1), "identity": (8, 8, 1, 6, "identity", 0.0, 1),
         "drop-path": (8, 16, 1, 6, "silu", 0.2, 1)}
MODEL_CFGS = {"yolov8-lafiyolo.yaml": None, "yolov8-efficientnet.yaml": 1_986_034}  # JAX README.md:89 at n scale


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one torch thread, as ``tests/test_torch_port_fit.py``'s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(tree, seed):
    """Seeded variables in ``tree``'s shapes: kernels uniform within
    1/sqrt(fan_in), BatchNorm scale, bias and statistics away from identity."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.uniform(-1, 1, shape).astype(np.float32) / math.sqrt(math.prod(shape[:-1]))
        lo, hi = {"scale": (0.8, 1.2), "var": (0.5, 1.5)}.get(name, (-0.1, 0.1))
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _to_port(variables, mod, names):
    """The JAX variables at the port's state-dict ``names``, by the port's converter rule."""
    out = {}
    for name in names:
        kind, path, fn = _rule("MBConv", name.split("."), mod)
        node = variables[kind]
        for k in path:
            node = node[k]
        out[name] = torch.tensor(fn(np.asarray(node, np.float32)))
    return out


def _nhwc(t):
    return np.ascontiguousarray(t.detach().numpy().transpose(0, 2, 3, 1))


@pytest.mark.parametrize("case", CASES)
def test_mbconv_matches_jax(case):
    """Train-mode output within 1e-5 abs and the new running statistics
    within 1e-6, eval-mode output within 1e-5, and the VJP of a seeded
    cotangent with respect to the input within 1e-5 of its largest value and
    with respect to every parameter within 1e-5 of the largest parameter
    gradient (a block before the last feeds a 1x1 conv and a train-mode
    BatchNorm, which remove a per-channel constant: its ``conv3.bn.bias``
    takes a zero gradient, rounding noise on both sides, and so does
    ``conv2.bn.bias`` with no activation);
    ``drop_path`` changes nothing."""
    c1, c2, n, e, act, drop_path, stride = CASES[case]
    x = np.random.default_rng(1).standard_normal((2, 12, 12, c1)).astype(np.float32)
    jmod = JaxMBConv(c2, n=n, e=e, act=act.lower(), drop_path=drop_path, stride=stride)
    variables = _fill(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False)), 2)
    tmod = MBConv(c1, c2, n, e, act, drop_path, stride)
    state = tmod.state_dict()
    state.update(_to_port(variables, tmod, [k for k in state if not k.endswith("num_batches_tracked")]))
    tmod.load_state_dict(state, strict=True)
    assert len(tmod.blocks) == n and hasattr(tmod.blocks[0], "conv1") == (e != 1)
    assert [b.add for b in tmod.blocks] == [c1 == (c2 if i == n - 1 else c1) and (stride if i == 0 else 1) == 1
                                            for i in range(n)]

    def train_apply(params, xx):  # (output, new batch_stats)
        return jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx, True,
                          mutable=["batch_stats"])

    want, vjp, updates = jax.vjp(train_apply, variables["params"], jnp.asarray(x), has_aux=True)
    ct = np.random.default_rng(3).standard_normal(np.shape(want)).astype(np.float32)
    jgrad_params, jgrad_x = vjp(jnp.asarray(ct))

    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_()
    got = tmod.train()(xt)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    stats = _to_port({"batch_stats": updates["batch_stats"]}, tmod,
                     [k for k in state if k.endswith(("running_mean", "running_var"))])
    for k, v in stats.items():
        np.testing.assert_allclose(tmod.state_dict()[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-6, err_msg=k)
    got.backward(torch.from_numpy(np.ascontiguousarray(ct.transpose(0, 3, 1, 2))))
    jx = np.asarray(jgrad_x)
    np.testing.assert_allclose(_nhwc(xt.grad), jx, atol=1e-5 * np.abs(jx).max(), rtol=0)
    jp = {k: v.numpy() for k, v in _to_port({"params": jgrad_params}, tmod,
                                            [k for k, _ in tmod.named_parameters()]).items()}
    atol = 1e-5 * max(np.abs(w).max() for w in jp.values())
    for k, p in tmod.named_parameters():
        zero = (k.endswith("conv3.bn.bias") and not k.startswith(f"blocks.{n - 1}.")) or \
            (act == "identity" and k.endswith("conv2.bn.bias"))
        assert (np.abs(jp[k]).max() <= atol) == zero, k
        np.testing.assert_allclose(p.grad.numpy(), jp[k], atol=atol, rtol=0, err_msg=k)

    tmod.load_state_dict(state, strict=True)
    want_eval = jmod.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got_eval = tmod.eval()(xt)
    np.testing.assert_allclose(_nhwc(got_eval), np.asarray(want_eval), atol=1e-5, rtol=0)
    if drop_path:
        plain = MBConv(c1, c2, n, e, act, 0.0, stride).eval()
        plain.load_state_dict(state, strict=True)
        with torch.no_grad():
            torch.testing.assert_close(plain(xt), got_eval, atol=0, rtol=0)


def test_mbconv_refuses_an_unknown_activation_as_jax_does():
    with pytest.raises(ValueError, match="unknown activation 'gelu'"):
        MBConv(8, 8, act="GELU")
    x = jnp.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError, match="unknown activation 'gelu'"):
        JaxMBConv(8, act="gelu").init(jax.random.PRNGKey(0), x, False)


@pytest.mark.parametrize("scale", ["n", "l"])
@pytest.mark.parametrize("cfg", MODEL_CFGS)
def test_mbconv_configs_build_like_jax(cfg, scale):
    """Each config at scale n (nc 6) and l: strides (8, 16, 32), the MBConv
    repeats the depth gives (1 each at n; 1, 2, 2, 3, 3, 4, 1 at l) and a
    parameter count equal to JAX's (efficientnet at n: JAX README.md's)."""
    name = cfg.replace("yolov8", f"yolov8{scale}")
    tm = TorchModel(name, device="cpu")
    assert tm.stride == (8, 16, 32) and tm.nc == 6
    want_n = [1] * 7 if scale == "n" else [1, 2, 2, 3, 3, 4, 1]
    assert [len(m.blocks) for m in tm.model if isinstance(m, MBConv)] == want_n
    n_params = sum(p.numel() for p in tm.parameters())
    assert n_params == JaxModel(name).num_params_static()
    if scale == "n" and MODEL_CFGS[cfg]:
        assert n_params == MODEL_CFGS[cfg]


@pytest.fixture(scope="module")
def lafiyolo():
    """``yolov8-lafiyolo.yaml`` at n scale in both packages, the JAX variables
    in its init tree filled from a seed and converted into the port."""
    jm = JaxModel("yolov8-lafiyolo.yaml")
    variables = _seeded_like_init(jm, 4)
    tm = TorchModel("yolov8-lafiyolo.yaml", device="cpu")
    tm.load_state_dict(jax_variables_to_state_dict(variables, tm), strict=True)
    return jm, variables, tm


def test_lafiyolo_forward_matches_jax(lafiyolo):
    """The eval-mode raw maps at 64 px within 2e-3 abs of JAX's
    (``tests/test_torch_port_model.py:check_config_matches_jax``'s bar)."""
    jm, variables, tm = lafiyolo
    x = np.random.default_rng(5).random((2, 64, 64, 3), dtype=np.float32)
    j_feats = jax.jit(jm.apply)(variables, x)
    with torch.no_grad():
        t_feats = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(t_feats) == len(j_feats) == 3
    for tf, jf in zip(t_feats, j_feats):
        jf = np.transpose(np.asarray(jf), (0, 3, 1, 2))
        assert tf.shape == jf.shape and np.abs(jf).max() > 0.1
        np.testing.assert_allclose(tf.numpy(), jf, atol=2e-3, rtol=0)


def test_lafiyolo_gradient_matches_jax(lafiyolo):
    """The gradient of a seeded weighting of the train-mode maps at 64 px
    with respect to every parameter within 1e-3 relative L2 of JAX's (the
    floors of ``tests/test_torch_port_asf.py``'s step), the MBConv
    backbone's included. Each MBConv block's ``conv3.bn.bias`` takes a zero
    gradient in train mode: the block's output reaches only 1x1 convolutions
    followed by train-mode BatchNorm, which carry the bias's per-channel
    constant to constants and subtract them with the batch mean. There both
    packages give rounding noise, held within 1e-7 of the gradient's global
    norm on each side (about 4e-9 of it here, beside 1e-4 for the others)."""
    jm, variables, tm = lafiyolo
    x = np.random.default_rng(6).random((2, 64, 64, 3), dtype=np.float32)
    rng = np.random.default_rng(7)
    weights = [rng.standard_normal((2, 64 // s, 64 // s, jm.no)).astype(np.float32) for s in (8, 16, 32)]

    def loss(params):
        feats, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                            mutable=["batch_stats"])
        return sum((f * w).sum() for f, w in zip(feats, weights))

    jgrads = jax_params_to_named(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(variables["params"])), tm)
    feats = tm.train()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    sum((f * torch.from_numpy(w).permute(0, 3, 1, 2)).sum() for f, w in zip(feats, weights)).backward()
    global_norm = math.sqrt(sum(float(np.linalg.norm(v.numpy())) ** 2 for v in jgrads.values()))
    bad = []
    for n, p in tm.named_parameters():
        w, g = jgrads[n].numpy(), p.grad.numpy()
        diff, norm = float(np.linalg.norm(g - w)), float(np.linalg.norm(w))
        if n.endswith("conv3.bn.bias") and ".blocks." in n:
            ok = max(norm, float(np.linalg.norm(g))) <= 1e-7 * global_norm
        else:
            ok = diff <= (1e-6 if norm < 1e-5 else 1e-3 * norm)
        if not ok:
            bad.append((n, diff, norm))
    assert not bad, bad[:5]
    assert any(".blocks." in n and float(jgrads[n].abs().max()) > 0 for n, _ in tm.named_parameters())
