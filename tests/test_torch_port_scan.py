"""The port's selective scan (kernel K4's plain version and its wrapper)
against the JAX package's ``selective_scan_reference`` and its Pallas kernel
in interpret mode.

Inputs come from a numpy seed and go to both packages: ``dt`` is a softplus of
a normal and ``A`` minus the exp of a normal, as in
``tests/test_selective_scan.py``. The JAX reference multiplies decays in a tree
(``associative_scan``); the Pallas kernel and the port's plain version walk the
recurrence step by step. The tolerance is 1e-4 of the reference's largest
value, the bar the JAX package's own test sets at L = 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.ops.kernels import _build
from experiment_yolo_torch.ops.kernels import selective_scan as scan_module
from experiment_yolo_torch.ops.kernels.selective_scan import selective_scan, selective_scan_plain
from experiment_yolo_tpu.ops.pallas.selective_scan import selective_scan_pallas, selective_scan_reference

RTOL = 1e-4  # of the reference's largest value


def _inputs(b, l, d, n, seed, directions=None):
    rng = np.random.default_rng(seed)
    lead, g = ((b,), ()) if directions is None else ((b, directions), (directions,))
    x = rng.standard_normal((*lead, l, d)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((*lead, l, d)), 0).astype(np.float32)
    a = -np.exp(rng.standard_normal((*g, d, n))).astype(np.float32)
    bs = rng.standard_normal((*lead, l, n)).astype(np.float32)
    cs = rng.standard_normal((*lead, l, n)).astype(np.float32)
    dv = rng.standard_normal((*g, d)).astype(np.float32)
    return x, dt, a, bs, cs, dv


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_d", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 8, 4), (2, 256, 8, 16)])
def test_plain_matches_jax_reference_and_pallas_interpret(shape, with_d):
    args = list(_inputs(*shape, seed=shape[1] + with_d))
    if not with_d:
        args[5] = None
    got = selective_scan_plain(*_torch(args)).numpy()
    ref = np.asarray(selective_scan_reference(*args))
    pallas = np.asarray(selective_scan_pallas(*args, interpret=True))
    assert got.shape == ref.shape == shape[:3]
    tol = RTOL * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)


def test_direction_axis_equals_one_scan_per_direction():
    """(B, G, L, D) inputs with per-direction A and D: the same values as G
    separate calls in the JAX function's own shapes, bit for bit."""
    x, dt, a, bs, cs, dv = _torch(_inputs(2, 40, 8, 16, seed=3, directions=4))
    got = selective_scan_plain(x, dt, a, bs, cs, dv)
    assert got.shape == (2, 4, 40, 8)
    for k in range(4):
        one = selective_scan_plain(x[:, k], dt[:, k], a[k], bs[:, k], cs[:, k], dv[k])
        np.testing.assert_array_equal(got[:, k].numpy(), one.numpy())
        ref = np.asarray(selective_scan_reference(*(t.numpy() for t in (x[:, k], dt[:, k], a[k], bs[:, k], cs[:, k],
                                                                        dv[k]))))
        np.testing.assert_allclose(one.numpy(), ref, atol=RTOL * np.abs(ref).max(), rtol=0)


def test_chunks_change_no_value(monkeypatch):
    """The plain version computes decays and outputs CHUNK steps at a time;
    a sequence that spans several ragged chunks equals one chunk, bit for bit."""
    args = _torch(_inputs(1, 50, 4, 16, seed=5))
    whole = selective_scan_plain(*args)
    monkeypatch.setattr(scan_module, "CHUNK", 7)
    np.testing.assert_array_equal(selective_scan_plain(*args).numpy(), whole.numpy())


def test_wrapper_takes_the_plain_version_on_the_cpu_and_launches_nothing():
    args = _torch(_inputs(2, 16, 8, 16, seed=1))
    before = selective_scan.launches
    np.testing.assert_array_equal(selective_scan(*args).numpy(), selective_scan_plain(*args).numpy())
    assert selective_scan.launches == before


def test_cpu_gradients_match_jax():
    """The CPU path is differentiable as it stands: every input's gradient of
    sum(y * w) against ``jax.grad`` of the reference, 1e-4 of its largest value."""
    arrays = _inputs(2, 24, 4, 16, seed=7)
    w = np.random.default_rng(8).standard_normal(arrays[0].shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(selective_scan_reference(*a) * w), argnums=tuple(range(6)))(*arrays)
    leaves = [t.requires_grad_() for t in _torch(arrays)]
    (selective_scan(*leaves) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(leaves, want):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), g, atol=RTOL * np.abs(g).max(), rtol=0)


def test_wrapper_raises_where_the_card_would_need_a_gradient(monkeypatch):
    """K4 has no backward kernel: with the device check stubbed, tensors that
    are not on the CPU and ask for a gradient raise before any launch; under
    ``no_grad`` the same call goes on to the launch."""
    launched = []
    monkeypatch.setattr(_build, "validate", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a, **k: launched.append(a[0]))
    x, dt, a, bs, cs, dv = (torch.zeros(s, device="meta") for s in
                            ((1, 8, 4), (1, 8, 4), (4, 16), (1, 8, 16), (1, 8, 16), (4,)))
    a.requires_grad_()
    before = selective_scan.launches
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        selective_scan(x, dt, a, bs, cs, dv)
    assert not launched and selective_scan.launches == before
    with torch.no_grad():
        assert selective_scan(x, dt, a, bs, cs, dv).shape == (1, 8, 4)
    assert launched == ["selective_scan"] and selective_scan.launches == before + 1
    selective_scan.launches = before


@pytest.mark.parametrize("bad,match", [
    (dict(dt=(2, 16, 7)), "dt"), (dict(a=(8, 4, 1)), r"\(B, L, D\)"), (dict(bs=(2, 15, 16)), "B "),
    (dict(cs=(2, 16, 8)), "C "), (dict(dv=(7,)), "D ")])
def test_plain_rejects_shapes_that_disagree(bad, match):
    shapes = dict(x=(2, 16, 8), dt=(2, 16, 8), a=(8, 16), bs=(2, 16, 16), cs=(2, 16, 16), dv=(8,))
    shapes.update(bad)
    with pytest.raises(ValueError, match=match):
        selective_scan_plain(*(torch.zeros(s) for s in shapes.values()))
