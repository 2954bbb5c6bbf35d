"""The port's LDConv gather, its backward, and the module against the JAX
package's LDConv.

Inputs come from a numpy seed and go to both packages. Offsets are drawn
large on purpose, so that many sampling positions leave the image and the
border double count (``border='torch'``) and the corner clamps are exercised,
as in ``tests/test_ldconv_torch_border.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.nn.modules import LDConv as TorchLDConv
from experiment_yolo_torch.ops.kernels.ldconv_gather import (WINDOW_R, _samples, grid_points, ldconv_gather,
                                                             ldconv_gather_bwd, ldconv_gather_bwd_plain,
                                                             ldconv_gather_plain)
from experiment_yolo_torch.utils.seeded import contention_offsets, seam_offsets
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
    want = jax.jit(lambda xx, pp: ldconv_bilinear_gather(xx, pp) * _border_mul(pp, hx, wx)[..., None])(
        jnp.asarray(xp), p)
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
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == np.transpose(want, (0, 3, 1, 2)).shape
    np.testing.assert_allclose(got, np.transpose(want, (0, 3, 1, 2)), atol=1e-4, rtol=0)


def _pin_positions(off, stride, hx, wx):
    """Put some samples exactly on the padded rails 0 and size_padded - 1, some
    on integer positions, and some 40 px out, by editing ``off`` in place."""
    b, n2, h, w = off.shape
    n = n2 // 2
    pts = grid_points(n)
    _, pad_r, pad_c = _jax_positions(off, stride, hx, wx)
    hp, wp = hx + WINDOW_R + pad_r, wx + WINDOW_R + pad_c
    rng = np.random.default_rng(99)
    for k, flat in enumerate(rng.permutation(b * n * h * w)[:24]):  # 24 distinct samples
        bi, ni, i, j = np.unravel_index(flat, (b, n, h, w))
        base_r, base_c = i * stride + WINDOW_R + pts[ni][0], j * stride + WINDOW_R + pts[ni][1]
        target = [(0.0, 0.0), (hp - 1.0, wp - 1.0), (0.0, wp - 1.0), (float(rng.integers(hp)), float(rng.integers(wp))),
                  (hp + 40.0, -40.0), (-40.0, wp + 40.0)][k % 6]
        off[bi, ni, i, j], off[bi, n + ni, i, j] = target[0] - base_r, target[1] - base_c
    return off


@pytest.mark.parametrize("n,stride,offsets", [pytest.param(n, s, "random", id=f"{n}-{s}") for n, s in CASES]
                         + [pytest.param(n, s, kind, id=f"{n}-{s}-{kind}") for kind in ("contention", "seam")
                            for n, s in ((3, 2), (1, 1))])
def test_gather_backward_matches_jax_vjp(n, stride, offsets):
    """Plain backward vs ``jax.vjp`` of the JAX gather times ``_border_mul``
    on the edge-padded source (the custom VJP ``_ldconv_gather_bwd``, then
    the pad's transpose), with samples on both rails, on integer positions and
    40 px out; also on the offsets that hold the kernel to the plain version
    on the card (``utils/seeded.py``): contention, 90% of the samples on
    sixteen source positions, and seam, every sample on one source row at the
    column after its pixel's own. dx and doff within 1e-5 abs + 1e-5 rel (the
    same products, summed in another order). The autograd path equals the
    plain backward."""
    x, off = _inputs(n * 10 + stride + 100, n, stride)
    b, c, hx, wx = x.shape
    if offsets == "contention":
        off = contention_offsets(torch.from_numpy(x), torch.from_numpy(off), stride,
                                 torch.Generator().manual_seed(7)).numpy()
    elif offsets == "seam":
        off = seam_offsets(torch.from_numpy(x), torch.from_numpy(off), stride).numpy()
        pos = np.asarray(_jax_positions(off, stride, hx, wx)[0]) - WINDOW_R  # (B, h, w, N, [row, col]), source px
        cols = (np.arange(off.shape[3]) + 1) % off.shape[3] + 0.25
        np.testing.assert_allclose(pos[..., 0], hx // 2 + 0.25, atol=1e-5)
        np.testing.assert_allclose(pos[..., 1], np.broadcast_to(cols[None, None, :, None], pos.shape[:-1]), atol=1e-5)
    off = _pin_positions(off, stride, hx, wx)
    p, pad_r, pad_c = _jax_positions(off, stride, hx, wx)
    dy = np.random.default_rng(5).standard_normal((b, p.shape[1] * p.shape[2], n * c)).astype(np.float32)

    def fn(x_nhwc, pos):
        xp = jnp.pad(x_nhwc, ((0, 0), (WINDOW_R, pad_r), (WINDOW_R, pad_c), (0, 0)), mode="edge")
        return ldconv_bilinear_gather(xp, pos) * _border_mul(pos, hx, wx)[..., None]

    jdx, jdp = jax.jit(lambda xx, pp, g: jax.vjp(fn, xx, pp)[1](g))(
        jnp.asarray(np.transpose(x, (0, 2, 3, 1))), p, jnp.asarray(dy.reshape(b, p.shape[1], p.shape[2], n, c)))
    jdx = np.transpose(np.asarray(jdx), (0, 3, 1, 2))
    jdoff = np.transpose(np.asarray(jdp), (0, 4, 3, 1, 2)).reshape(off.shape)  # (B, [row N, col N], h, w)
    pos = np.asarray(p)
    hp, wp = hx + WINDOW_R + pad_r, wx + WINDOW_R + pad_c
    assert (pos[..., 0] == 0).any() and (pos[..., 0] == hp - 1).any() and (pos[..., 1] == wp - 1).any()
    assert (pos[..., 0] > hp + 30).any() and (pos[..., 1] < -30).any()
    if offsets == "contention":  # most samples read one of sixteen source pixels' neighbourhoods
        src = np.floor(pos - WINDOW_R).reshape(-1, 2)
        _, counts = np.unique(src, axis=0, return_counts=True)
        assert np.sort(counts)[-16:].sum() >= 0.8 * len(src)

    dx, doff = ldconv_gather_bwd_plain(torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(dy), stride)
    np.testing.assert_allclose(dx.numpy(), jdx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(doff.numpy(), jdoff, atol=1e-5, rtol=1e-5)
    far = (pos[..., 0] > hp + 30) | (pos[..., 0] < -30)  # (B, h, w, N): rows far out give no row gradient
    assert (doff.numpy()[:, :n].transpose(0, 2, 3, 1)[far] == 0).all()

    xt, ot = torch.from_numpy(x).requires_grad_(), torch.from_numpy(off).requires_grad_()
    ldconv_gather(xt, ot, stride).backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(xt.grad.numpy(), dx.numpy())
    np.testing.assert_array_equal(ot.grad.numpy(), doff.numpy())
    before = ldconv_gather_bwd.launches
    ldconv_gather_bwd(torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(dy), stride)
    assert ldconv_gather_bwd.launches == before  # CPU tensors take the plain version


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def test_backward_plain_in_float64_sums_the_same_products():
    """``dtype=torch.float64`` keeps the float32 positions and weights and
    sums in float64, on contention offsets: a float64 result within 1e-5 of
    the float32 one (the order of float32 sums), and the default unchanged."""
    x, off = _inputs(41, 3, 2)
    xt = torch.from_numpy(x)
    off = contention_offsets(xt, torch.from_numpy(off), 2, torch.Generator().manual_seed(3))
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal((2, off.shape[2] * off.shape[3], 15))
                          .astype(np.float32))
    got32, got64 = (ldconv_gather_bwd_plain(xt, off, dy, 2, dtype) for dtype in (torch.float32, torch.float64))
    for a, b, d in zip(got32, got64, ldconv_gather_bwd_plain(xt, off, dy, 2)):
        assert b.dtype == torch.float64 and torch.equal(a, d)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
        assert not np.array_equal(a.numpy(), b.numpy().astype(np.float32))

@pytest.mark.parametrize("sampling", ["gather", "auto"])
@pytest.mark.parametrize("n,stride,weight_scale", [(1, 2, 1.0), (3, 1, 1.0), (3, 2, 1.0), (3, 1, 0.02)])
def test_module_gradients_match_jax(sampling, n, stride, weight_scale):
    """Gradients of the port's LDConv in train mode (K3's plain backward,
    BatchNorm on batch statistics) against ``jax.vjp`` of the JAX LDConv, for
    the input and every parameter, and the running statistics the step
    leaves (the JAX biased variance): 1e-4 relative L2, the forward's 1e-4
    carried through the same sums. With ``auto`` at weight scale 0.02 the JAX
    LDConv differentiates its dense hat-window path, which gives the same
    gradient away from integer positions."""
    c1, c2 = 4, 6
    tm, variables = _module_pair(n, stride, c1, c2, seed=n + 7 * stride, weight_scale=weight_scale)
    x = np.random.default_rng(12).standard_normal((2, c1, 15, 12)).astype(np.float32)
    jm = JaxLDConv(c2=c2, num_param=n, stride=stride, sampling=sampling)

    def fn(params, x_nhwc):
        return jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x_nhwc, train=True,
                        mutable=["batch_stats"])

    x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    w = np.random.default_rng(13).standard_normal(jax.eval_shape(fn, variables["params"], x_nhwc)[0].shape).astype(
        np.float32)

    @jax.jit
    def forward_and_vjp(params, xx, ww):
        jy, vjp, jstats = jax.vjp(fn, params, xx, has_aux=True)
        return jy, jstats, vjp(ww)

    jy, jstats, (jg_params, jg_x) = forward_and_vjp(variables["params"], x_nhwc, jnp.asarray(w))

    tm.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt)
    y.backward(torch.from_numpy(np.ascontiguousarray(np.transpose(w, (0, 3, 1, 2)))))
    assert _rel(y.detach().numpy(), np.transpose(np.asarray(jy), (0, 3, 1, 2))) < 1e-4
    assert _rel(xt.grad.numpy(), np.transpose(np.asarray(jg_x), (0, 3, 1, 2))) < 1e-4
    want = {
        "p_conv.weight": np.transpose(np.asarray(jg_params["p_conv"]["kernel"]), (3, 2, 0, 1)),
        "p_conv.bias": np.asarray(jg_params["p_conv"]["bias"]),
        "conv.0.weight": np.asarray(jg_params["proj"]["kernel"]).reshape(n, c1, c2).transpose(2, 1, 0)[..., None],
        "conv.1.weight": np.asarray(jg_params["bn"]["scale"]), "conv.1.bias": np.asarray(jg_params["bn"]["bias"]),
    }
    for name, p in tm.named_parameters():
        assert np.linalg.norm(want[name]) > 0, name
        assert _rel(p.grad.numpy(), want[name]) < 1e-4, name
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(getattr(tm.conv[1], f"running_{leaf}").numpy(),
                                   np.asarray(jstats["batch_stats"]["bn"][leaf]), atol=1e-6, rtol=1e-5)


def test_positions_near_a_whole_number_move_p_conv_gradient_not_the_output():
    """Why a card step and a CPU step can both be right and still differ in
    ``p_conv``'s gradient: the bilinear corner pair, the border multiplier
    and the rail gate are step functions of a sample's position. One LDConv
    on an 8 x 8 source (every position below 16) with ``p_conv``'s weight at
    0, so that its bias is each sample's offset: at bias 0 every position is
    a whole number, and two float32 spacings of 8 lower the floor of each to
    the corner pair below. Away from the rails the samples move by less than
    1e-5 relative L2 (the position moved by 2e-6), while ``p_conv``'s weight
    gradient, a difference of the pair's two source values, moves by more
    than 1e-3 relative L2; on the rails the multiplier jumps by 2x."""
    c1, c2, n, hx = 4, 6, 3, 8
    rng = np.random.default_rng(23)
    module = TorchLDConv(c1, c2, n, 1)
    with torch.no_grad():
        module.conv[0].weight.copy_(torch.from_numpy(rng.standard_normal((c2, c1, n, 1)).astype(np.float32)))
        module.p_conv.weight.zero_()
    x = torch.from_numpy(rng.standard_normal((2, c1, hx, hx)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, c2, hx, hx)).astype(np.float32))
    below = 2 * float(np.spacing(np.float32(8.0)))

    def step(offset):
        with torch.no_grad():
            module.p_conv.bias.fill_(-offset)
        module.zero_grad()
        (module(x) * w).sum().backward()
        off = module.p_conv(x).detach()
        assert torch.all(off == -offset)
        return ldconv_gather_plain(x, off, 1).reshape(2, hx * hx, n, c1), off, module.p_conv.weight.grad.clone()

    samples, off, grad = step(0.0)
    samples_below, off_below, grad_below = step(below)
    pr, pc, _, _, _, _ = _samples(x, off, 1)
    assert torch.equal(pr, pr.round()) and torch.equal(pc, pc.round()) and pr.max() < 16 and pc.max() < 16
    pr_below, pc_below, _, _, _, _ = _samples(x, off_below, 1)
    assert bool(((pr - pr_below > 0) & (pr - pr_below <= below)).all())  # a few spacings below every whole number
    rails = torch.tensor([WINDOW_R, WINDOW_R + hx - 1.0])  # where the border multiplier steps
    row_rail, col_rail = ((pos[..., None] == rails).any(-1)[..., None].expand_as(samples) for pos in (pr, pc))
    away, one_rail = ~(row_rail | col_rail), row_rail ^ col_rail
    assert away.any() and one_rail.any()
    assert _rel(samples_below[away].numpy(), samples[away].numpy()) < 1e-5
    assert _rel(grad_below.numpy(), grad.numpy()) > 1e-3
    # on one rail the sample is doubled or halved (its value moves by the same 2e-6 of a pixel)
    doubled, halved = ((samples_below - k * samples).abs() for k in (2.0, 0.5))
    assert torch.minimum(doubled, halved)[one_rail].max() < 1e-4
    assert (samples_below - samples)[one_rail].abs().max() > 0.1


def test_bf16_backward_wrapper_hands_the_kernel_bf16_dx_and_scratch(monkeypatch):
    """The bf16 backward's wrapper on the card's path, with tensors on
    ``meta`` and the launch stubbed: it makes a bf16 ``dx``, an f32 ``doff``
    and an f32 scratch for the sums, one float per element of ``x``, and
    nothing else (no fill, no cast: the launch zeroes the sums and rounds
    them into ``dx``), hands them to the bf16 entry point with the scratch's
    length, and counts one launch a call; the f32 form still zero-fills its
    f32 ``dx``; another dtype raises before any launch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from experiment_yolo_torch.ops.kernels import _build
    from experiment_yolo_torch.ops.kernels import ldconv_gather as k3

    def validate(t, what, dtype, ndim, dense_last_only=False):  # _build.validate without its device check
        if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
            raise TypeError(f"{what}: {t.dtype}")
        assert t.dim() == ndim and t.is_contiguous()

    calls = []
    monkeypatch.setattr(_build, "validate", validate)
    monkeypatch.setattr(_build, "launch", lambda name, argtypes, *args, device, lib=None: calls.append(
        (name, tuple(argtypes), args, lib)))

    class Made(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops.append((func.__name__, out.dtype, tuple(out.shape)))
            return out

    x = torch.empty(2, 16, 16, 20, dtype=torch.bfloat16, device="meta")
    off = torch.empty(2, 6, 8, 10, device="meta")
    dy = torch.empty(2, 80, 48, dtype=torch.bfloat16, device="meta")
    before, before_f32 = k3.ldconv_gather_bwd_bf16.launches, k3.ldconv_gather_bwd.launches
    for n in (1, 2):
        with Made() as made:
            dx, doff = k3.ldconv_gather_bwd(x, off, dy, 2)
        assert sorted(made.ops, key=str) == sorted([("empty_like.default", torch.float32, tuple(off.shape)),
                                                    ("empty_like.default", torch.bfloat16, tuple(x.shape)),
                                                    ("empty.memory_format", torch.float32, (x.numel(),))], key=str)
        assert dx.dtype == torch.bfloat16 and doff.dtype == torch.float32
        assert k3.ldconv_gather_bwd_bf16.launches == before + n
    name, argtypes, args, lib = calls[-1]
    assert (name, argtypes, lib) == ("ldconv_gather_bwd_bf16", k3._BWD_BF16_ARGS, "ldconv_gather")
    assert len(args) == len(argtypes) and args[6] == x.numel()
    assert args[7:] == (2, 16, 16, 20, 8, 10, 3, 2, 2, 2, *k3._geometry(x, off, 2)[2:])
    assert k3.ldconv_gather_bwd.launches == before_f32
    with Made() as made:
        k3.ldconv_gather_bwd(x.float(), off, dy.float(), 2)
    assert ("zeros.default", torch.float32, tuple(x.shape)) in made.ops and calls[-1][0] == "ldconv_gather_bwd"
    assert k3.ldconv_gather_bwd.launches == before_f32 + 1
    with pytest.raises(TypeError):
        k3.ldconv_gather_bwd(x.half(), off, dy.half(), 2)
    assert len(calls) == 3 and k3.ldconv_gather_bwd_bf16.launches == before + 2
