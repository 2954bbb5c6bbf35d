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

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.ops.kernels import _build
from experiment_yolo_torch.ops.kernels import selective_scan as scan_module
from experiment_yolo_torch.ops.kernels.selective_scan import chunk_length, selective_scan, selective_scan_plain
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


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_d", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 8, 4), (2, 256, 8, 16)])
def test_plain_matches_jax_reference_and_pallas_interpret(shape, with_d, reverse):
    """``reverse``: the port scans from the last step and returns ``y`` in the
    order of its inputs; the JAX functions get the sequences flipped and their
    ``y`` is flipped back."""
    args = list(_inputs(*shape, seed=shape[1] + with_d))
    if not with_d:
        args[5] = None
    got = selective_scan_plain(*_torch(args), reverse=(reverse,)).numpy()
    if reverse:
        args = [a[:, ::-1] if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    ref = np.asarray(selective_scan_reference(*args))
    pallas = np.asarray(selective_scan_pallas(*args, interpret=True))
    if reverse:
        ref, pallas = ref[:, ::-1], pallas[:, ::-1]
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


@pytest.mark.parametrize("reverse,source", [((False, False, True, True), (0, 1, 0, 1)), ((True, False, True, False), None),
                                            (None, (1, 1, 0, 0)), ((False,) * 4, (0, 1, 2, 3))])
def test_reverse_and_source_equal_the_old_form_on_flipped_copies(reverse, source):
    """A reversed direction equals the scan of its flipped ``x``, ``dt``,
    ``B``, ``C``, flipped back; ``source`` equals an indexed copy of ``x``:
    bit for bit, with per-direction A and D, and within 1e-4 of the JAX
    reference's largest value per direction."""
    x, dt, a, bs, cs, dv = _torch(_inputs(2, 40, 8, 16, seed=11, directions=4))
    xsrc = x[:, :len(set(source))].contiguous() if source is not None else x
    got = selective_scan_plain(xsrc, dt, a, bs, cs, dv, reverse=reverse, source=source)
    assert got.shape == (2, 4, 40, 8)
    for k in range(4):
        rev = bool(reverse[k]) if reverse is not None else False
        one = [xsrc[:, source[k] if source is not None else k], dt[:, k], bs[:, k], cs[:, k]]
        if rev:
            one = [t.flip(1) for t in one]
        old = selective_scan_plain(one[0], one[1], a[k], one[2], one[3], dv[k])
        ref = np.asarray(selective_scan_reference(one[0].numpy(), one[1].numpy(), a[k].numpy(), one[2].numpy(),
                                                  one[3].numpy(), dv[k].numpy()))
        if rev:
            old, ref = old.flip(1), ref[:, ::-1]
        np.testing.assert_array_equal(got[:, k].numpy(), old.numpy())
        np.testing.assert_allclose(got[:, k].numpy(), ref, atol=RTOL * np.abs(ref).max(), rtol=0)
    if reverse is not None and any(reverse):  # the flag is live
        assert not torch.equal(got, selective_scan_plain(xsrc, dt, a, bs, cs, dv, source=source))


@pytest.mark.parametrize("rank", [1, 2, 4, 8])
def test_strided_b_and_c_views_equal_contiguous_copies(rank):
    """``B`` and ``C`` as slices of one (B, G, L, rank + 2N) projection, as SS2D
    hands them over (a row of 33, 34, 36 or 40 floats), give the values of
    their contiguous copies, bit for bit, in the single-scan form too."""
    x, dt, a, _, _, dv = _torch(_inputs(2, 24, 8, 16, seed=13, directions=4))
    dbl = torch.from_numpy(np.random.default_rng(14).standard_normal((2, 4, 24, rank + 32)).astype(np.float32))
    _, bs, cs = dbl.split([rank, 16, 16], -1)
    assert not bs.is_contiguous() and bs.stride() == (4 * 24 * (rank + 32), 24 * (rank + 32), rank + 32, 1)
    kw = dict(reverse=(False, True, False, True))
    want = selective_scan_plain(x, dt, a, bs.contiguous(), cs.contiguous(), dv, **kw)
    np.testing.assert_array_equal(selective_scan(x, dt, a, bs, cs, dv, **kw).numpy(), want.numpy())
    one = selective_scan_plain(x[:, 1], dt[:, 1], a[1], bs[:, 1], cs[:, 1], dv[1], reverse=(True,))
    np.testing.assert_array_equal(one.numpy(), want[:, 1].numpy())


@pytest.mark.parametrize("sequences,length,dim,want", [
    (32, 25_600, 32, 264), (32, 6_400, 64, 136), (32, 1_600, 128, 72), (32, 400, 256, 40),  # the VSS model's levels
    (32, 1_003, 128, 48), (4096, 400, 256, 400), (1, 20, 8, 24), (1, 64, 8, 32), (2, 1, 4, 8)])
def test_chunk_length_fills_the_card_once_with_whole_tiles(sequences, length, dim, want):
    """On 132 SMs of 24 resident warps: as many chunks as warps fit, never
    shorter than 32 steps, a whole number of 8-step tiles that cover L."""
    got = chunk_length(sequences, length, dim, sms=132)
    assert got == want and got % scan_module.TILE == 0
    chunks = -(-length // got)
    assert chunks * got >= length > (chunks - 1) * got
    assert chunks == 1 or (got >= scan_module.MIN_CHUNK
                           and chunks * sequences * -(-dim // 32) <= 132 * scan_module.WARPS_PER_SM)


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
    sum(y * w) against ``jax.grad`` of the reference (jitted), 1e-4 of its
    largest value."""
    arrays = _inputs(2, 24, 4, 16, seed=7)
    w = np.random.default_rng(8).standard_normal(arrays[0].shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(selective_scan_reference(*a) * w), argnums=tuple(range(6))))(*arrays)
    leaves = [t.requires_grad_() for t in _torch(arrays)]
    (selective_scan(*leaves) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(leaves, want):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), g, atol=RTOL * np.abs(g).max(), rtol=0)


def test_wrapper_raises_where_the_card_would_need_a_gradient(monkeypatch):
    """K4 has a backward kernel now, so nothing raises: with the device check
    stubbed, tensors that are not on the CPU and ask for a gradient go
    through the autograd Function ``SelectiveScan``, one forward launch, and
    ``backward()`` makes one launch of K4's backward kernel; under
    ``no_grad`` the same call is the forward launch alone."""
    launched = []
    monkeypatch.setattr(_build, "validate", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda *a, **k: launched.append(a[0]))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: types.SimpleNamespace(multi_processor_count=132))
    x, dt, a, bs, cs, dv = (torch.zeros(s, device="meta") for s in
                            ((1, 8, 4), (1, 8, 4), (4, 16), (1, 8, 16), (1, 8, 16), (4,)))
    a.requires_grad_()
    before = selective_scan.launches, scan_module.selective_scan_bwd.launches
    y = selective_scan(x, dt, a, bs, cs, dv)
    assert y.shape == (1, 8, 4)  # the single-direction form: the Function's output, its direction axis taken off
    assert "SelectiveScan" in type(y.grad_fn.next_functions[0][0]).__name__
    assert launched == ["selective_scan"] and selective_scan.launches == before[0] + 1
    y.sum().backward()
    assert launched == ["selective_scan", "selective_scan_bwd"] and a.grad is not None and a.grad.shape == (4, 16)
    assert scan_module.selective_scan_bwd.launches == before[1] + 1
    with torch.no_grad():
        assert selective_scan(x, dt, a, bs, cs, dv).shape == (1, 8, 4)
    assert launched == ["selective_scan", "selective_scan_bwd", "selective_scan"]
    selective_scan.launches, scan_module.selective_scan_bwd.launches = before


def test_wrapper_hands_the_kernel_flags_sources_strides_and_one_count_per_call(monkeypatch):
    """With the device check and the launch stubbed: one call of four
    directions over L = 1,003 is one count, and the kernel gets the reverse
    flags as a bit mask, the sources four bits each, the strides of the ``B``
    and ``C`` views in floats, the chunk length, and scratch for the carry."""
    calls = []
    monkeypatch.setattr(_build, "validate", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda name, argtypes, *args, **k: calls.append((name, argtypes, args)))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: types.SimpleNamespace(multi_processor_count=132))
    meta = dict(device="meta")
    x, dt, a, dv = (torch.zeros(s, **meta) for s in ((2, 2, 1003, 64), (2, 4, 1003, 64), (4, 64, 16), (4, 64)))
    _, bs, cs = torch.zeros((2, 4, 1003, 33), **meta).split([1, 16, 16], -1)
    before = selective_scan.launches
    with torch.no_grad():
        y = selective_scan(x, dt, a, bs, cs, dv, reverse=(False, False, True, True), source=(0, 1, 0, 1))
    assert y.shape == (2, 4, 1003, 64) and selective_scan.launches == before + 1
    (name, argtypes, args), = calls
    assert name == "selective_scan" and len(argtypes) == len(args) == 23
    row = 33
    assert args[8:] == (2, 4, 2, 1003, 64, 16, 4 * 1003 * row, 1003 * row, row, 4 * 1003 * row, 1003 * row, row,
                        0b1100, 0x1010, chunk_length(8, 1003, 64, 132))
    selective_scan.launches = before


@pytest.mark.parametrize("kw,match", [
    (dict(reverse=(True, False)), "reverse has 2 flags for 4"), (dict(source=(0, 1, 2)), "source"),
    (dict(source=(0, 1, 0, 4)), "source"), (dict(source=(0, 1, 0, 1), x_dirs=3), None)])
def test_plain_rejects_flags_and_sources_that_disagree(kw, match):
    x, dt, a, bs, cs, dv = _torch(_inputs(1, 8, 4, 16, seed=2, directions=4))
    x = x[:, :kw.pop("x_dirs", 4)]
    if match is None:  # fewer x directions than scan directions is what source is for
        assert selective_scan_plain(x, dt, a, bs, cs, dv, **kw).shape == (1, 4, 8, 4)
        with pytest.raises(ValueError, match="x .* must be"):
            selective_scan_plain(x, dt, a, bs, cs, dv)
        with pytest.raises(ValueError, match="direction axis"):
            selective_scan_plain(x[:, 0], dt[:, 0], a[0], bs[:, 0], cs[:, 0], dv[0], source=(0,))
        return
    with pytest.raises(ValueError, match=match):
        selective_scan_plain(x, dt, a, bs, cs, dv, **kw)


@pytest.mark.parametrize("bad,match", [
    (dict(dt=(2, 16, 7)), "dt"), (dict(a=(8, 4, 1)), r"\(B, L, D\)"), (dict(bs=(2, 15, 16)), "B "),
    (dict(cs=(2, 16, 8)), "C "), (dict(dv=(7,)), "D ")])
def test_plain_rejects_shapes_that_disagree(bad, match):
    shapes = dict(x=(2, 16, 8), dt=(2, 16, 8), a=(8, 16), bs=(2, 16, 16), cs=(2, 16, 16), dv=(8,))
    shapes.update(bad)
    with pytest.raises(ValueError, match=match):
        selective_scan_plain(*(torch.zeros(s) for s in shapes.values()))
