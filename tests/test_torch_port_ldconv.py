"""The port's LDConv gather and module against the JAX package's LDConv.

Inputs come from a numpy seed and go to both packages. Offsets are drawn
large on purpose, so that many sampling positions leave the image and the
border double count (``border='torch'``) and the corner clamps are exercised,
as in ``tests/test_ldconv_torch_border.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.nn.modules import LDConv as TorchLDConv
from experiment_yolo_torch.ops.kernels.ldconv_gather import WINDOW_R, grid_points, ldconv_gather, ldconv_gather_plain
from experiment_yolo_tpu.nn.modules import LDConv as JaxLDConv
from experiment_yolo_tpu.nn.modules import _ldconv_grid_pts, ldconv_bilinear_gather
from experiment_yolo_tpu.ops.pallas.ldconv_kernel import bilinear_gather_single

CASES = [(1, 1), (1, 2), (3, 1), (3, 2), (5, 1), (4, 2)]  # (num_param, stride)


def _jax_positions(off, stride, hx, wx):
    """The JAX LDConv's positions in edge-padded coordinates and its padded
    source sizes, in its own float order (nn/modules.py:795-818).
    off: (B, 2N, h, w) numpy."""
    b, n2, h, w = off.shape
    n = n2 // 2
    o = jnp.asarray(np.transpose(off, (0, 2, 3, 1))).reshape(b, h, w, 2, n)
    pts = _ldconv_grid_pts(n)
    pad_r = max(0, (h - 1) * stride + max(p[0] for p in pts) + WINDOW_R + 2 - hx)
    pad_c = max(0, (w - 1) * stride + max(p[1] for p in pts) + WINDOW_R + 2 - wx)
    p_n = jnp.asarray(pts, jnp.float32)
    gr = jnp.arange(h, dtype=jnp.float32)[:, None] * stride + WINDOW_R
    gc = jnp.arange(w, dtype=jnp.float32)[None, :] * stride + WINDOW_R
    pr = gr[None, :, :, None] + p_n[None, None, None, :, 0] + o[..., 0, :]
    pc = gc[None, :, :, None] + p_n[None, None, None, :, 1] + o[..., 1, :]
    return jnp.stack([pr, pc], -1), pad_r, pad_c


def _border_mul(p, hx, wx):
    """``LDConv._border_mul`` of the JAX package on padded positions."""
    return JaxLDConv(c2=1)._border_mul(p[..., 0] - WINDOW_R, p[..., 1] - WINDOW_R, hx, wx)


def _inputs(seed, n, stride, c=5, hx=13, wx=11, scale=4.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, c, hx, wx)).astype(np.float32)
    h, w = -(-hx // stride), -(-wx // stride)
    off = (scale * rng.standard_normal((2, 2 * n, h, w))).astype(np.float32)
    return x, off


def test_grid_points_match_jax():
    for n in range(1, 13):
        assert grid_points(n) == _ldconv_grid_pts(n)


@pytest.mark.parametrize("n,stride", CASES)
def test_gather_matches_jax_gather_times_border_mul(n, stride):
    """Port plain gather vs ``ldconv_bilinear_gather`` on the edge-padded
    source times ``_border_mul``: the same float operations in the same
    order, so 1e-6 abs covers only XLA's freedom to fuse on the CPU."""
    x, off = _inputs(n * 10 + stride, n, stride)
    b, c, hx, wx = x.shape
    p, pad_r, pad_c = _jax_positions(off, stride, hx, wx)
    xp = np.pad(np.transpose(x, (0, 2, 3, 1)), ((0, 0), (WINDOW_R, pad_r), (WINDOW_R, pad_c), (0, 0)), mode="edge")
    want = ldconv_bilinear_gather(jnp.asarray(xp), p) * _border_mul(p, hx, wx)[..., None]
    want = np.asarray(want).reshape(b, -1, n * c)  # (B, h*w, N*C), n-major
    got = ldconv_gather_plain(torch.from_numpy(x), torch.from_numpy(off), stride)
    assert got.shape == want.shape
    oob = np.asarray(_border_mul(p, hx, wx)) > 1
    assert oob.any() and not oob.all(), "offsets should put some samples outside the image and some inside"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the wrapper takes the plain version for CPU tensors and launches nothing
    before = ldconv_gather.launches
    np.testing.assert_array_equal(ldconv_gather(torch.from_numpy(x), torch.from_numpy(off), stride).numpy(),
                                  got.numpy())
    assert ldconv_gather.launches == before


@pytest.mark.parametrize("n,stride", [(3, 1), (3, 2)])
def test_gather_matches_pallas_kernel_interpret(n, stride):
    """Port plain gather vs the TPU kernel ``bilinear_gather_single`` run in
    interpret mode on the same edge-padded source and positions, times the
    border multiplier. The kernel sums its four corners in another order,
    so 1e-5 abs (a few ulps of values of order 10)."""
    x, off = _inputs(3 + stride, n, stride)
    b, c, hx, wx = x.shape
    p, pad_r, pad_c = _jax_positions(off, stride, hx, wx)
    xp = np.pad(np.transpose(x, (0, 2, 3, 1)), ((0, 0), (WINDOW_R, pad_r), (WINDOW_R, pad_c), (0, 0)), mode="edge")
    mul = np.asarray(_border_mul(p, hx, wx))
    got = ldconv_gather_plain(torch.from_numpy(x), torch.from_numpy(off), stride).numpy()
    for i in range(b):
        q = np.asarray(p[i]).reshape(-1, 2)
        want = np.asarray(bilinear_gather_single(jnp.asarray(xp[i]), jnp.asarray(q), interpret=True))
        want = (want * mul[i].reshape(-1, 1)).reshape(-1, n * c)
        np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=0)


def _module_pair(n, stride, c1, c2, seed, weight_scale):
    """A JAX LDConv's variables from numpy and the port's LDConv holding the
    same weights; ``weight_scale`` sets how far the offsets reach."""
    rng = np.random.default_rng(seed)
    p_w = (weight_scale * rng.standard_normal((3, 3, c1, 2 * n))).astype(np.float32)
    p_b = (weight_scale * 2 * rng.standard_normal(2 * n)).astype(np.float32)
    proj = (rng.standard_normal((n * c1, c2)) / np.sqrt(n * c1)).astype(np.float32)
    bn = {k: rng.uniform(0.5, 1.5, c2).astype(np.float32) for k in ("scale", "var")}
    bn.update({k: (0.1 * rng.standard_normal(c2)).astype(np.float32) for k in ("bias", "mean")})
    variables = {
        "params": {"p_conv": {"kernel": p_w, "bias": p_b}, "proj": {"kernel": proj},
                   "bn": {"scale": bn["scale"], "bias": bn["bias"]}},
        "batch_stats": {"bn": {"mean": bn["mean"], "var": bn["var"]}},
    }
    tm = TorchLDConv(c1, c2, n, stride).eval()
    sd = {
        "p_conv.weight": np.transpose(p_w, (3, 2, 0, 1)),
        "p_conv.bias": p_b,
        "conv.0.weight": proj.reshape(n, c1, c2).transpose(2, 1, 0)[..., None],  # W[o,i,n,0] = dense[n*C+i, o]
        "conv.1.weight": bn["scale"], "conv.1.bias": bn["bias"],
        "conv.1.running_mean": bn["mean"], "conv.1.running_var": bn["var"],
    }
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    sd["conv.1.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    tm.load_state_dict(sd, strict=True)
    return tm, variables


@pytest.mark.parametrize("sampling", ["gather", "auto"])
@pytest.mark.parametrize("n,stride,weight_scale", [(1, 1, 1.0), (1, 2, 1.0), (3, 1, 1.0), (3, 2, 1.0), (3, 1, 0.02)])
def test_module_matches_jax(sampling, n, stride, weight_scale):
    """The port's LDConv (offset conv -> gather -> matmul projection -> BN ->
    SiLU) vs the JAX LDConv on the same weights. With weight scale 1 the
    offsets leave the hat window and ``auto`` takes its gather branch; at
    0.02 they stay inside it and ``auto`` takes the dense hat-window path,
    which sums in another order. 1e-4 abs: the 3x3 offset conv and the
    projection sum in another order in each framework."""
    c1, c2 = 4, 6
    tm, variables = _module_pair(n, stride, c1, c2, seed=n + 7 * stride, weight_scale=weight_scale)
    x = np.random.default_rng(11).standard_normal((2, c1, 15, 12)).astype(np.float32)
    jm = JaxLDConv(c2=c2, num_param=n, stride=stride, sampling=sampling)
    want = np.asarray(jm.apply(variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == np.transpose(want, (0, 3, 1, 2)).shape
    np.testing.assert_allclose(got, np.transpose(want, (0, 3, 1, 2)), atol=1e-4, rtol=0)
