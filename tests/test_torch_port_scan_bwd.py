"""The backward of the port's selective scan (kernel K4's backward, its plain
version and the autograd Function that binds it) against the JAX package.

The JAX package trains through autodiff of ``selective_scan_reference`` (an
``associative_scan``); ``selective_scan_bwd_plain`` walks the reverse
recurrence step by step. Inputs come from a numpy seed and go to both: ``dt``
a softplus of a normal, ``A`` minus the exp of a normal, ``B`` and ``C`` as
views of one projection with rows of rank + 32 floats, as SS2D hands them
over. Directions with the ``reverse`` flag and ``source`` indices go to the JAX
function one at a time, flipped where reversed, and the ``dx`` of directions
that share an ``x`` are added. The tolerance is the scan's own: 1e-4 of each
gradient's largest value. Lengths of 37 and 300 steps are no multiple of the
plain version's 256-step chunk.
"""

import types

import jax
import numpy as np
import pytest
import torch

from experiment_yolo_torch.ops.kernels import _build
from experiment_yolo_torch.ops.kernels import selective_scan as scan_module
from experiment_yolo_torch.ops.kernels.selective_scan import (SelectiveScan, chunk_length, selective_scan,
                                                              selective_scan_bwd, selective_scan_bwd_plain,
                                                              selective_scan_plain)
from experiment_yolo_tpu.ops.pallas.selective_scan import selective_scan_reference

RTOL = 1e-4  # of each gradient's largest value
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
FLAGS = [(None, None), ((False, False, True, True), (0, 1, 0, 1)), ((True, False, False, True), (1, 1, 0, 2))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, gx, g, length, d, seed, rank=2, dtype=np.float32):
    """x (B, Gx, L, D), dt, A, B and C (views of one (B, G, L, rank + 32) projection), D, dy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, gx, length, d))
    dt = np.logaddexp(rng.standard_normal((b, g, length, d)), 0)
    a = -np.exp(rng.standard_normal((g, d, 16)))
    wide = torch.from_numpy(rng.standard_normal((b, g, length, rank + 32)).astype(dtype))
    dv, dy = rng.standard_normal((g, d)), rng.standard_normal((b, g, length, d))
    t = [torch.from_numpy(v.astype(dtype)) for v in (x, dt, a)]
    return (*t, wide[..., rank:rank + 16], wide[..., rank + 16:], torch.from_numpy(dv.astype(dtype)),
            torch.from_numpy(dy.astype(dtype)))


_vjp = jax.jit(lambda x, dt, a, b, c, d, ct: jax.vjp(selective_scan_reference, x, dt, a, b, c, d)[1](ct))


def _jax_grads(x, dt, a, b, c, d, dy, reverse, source):
    """The six gradients through ``jax.vjp`` of the reference, one direction at a time."""
    g = dt.shape[1]
    src = source if source is not None else range(g)
    out = [np.zeros(x.shape, np.float32), np.zeros(dt.shape, np.float32), np.zeros(a.shape, np.float32),
           np.zeros(b.shape, np.float32), np.zeros(c.shape, np.float32), np.zeros(d.shape, np.float32)]
    for k in range(g):
        rev = bool(reverse[k]) if reverse is not None else False
        seq = [np.ascontiguousarray(t[:, i].numpy()) for t, i in ((x, src[k]), (dt, k), (b, k), (c, k), (dy, k))]
        if rev:
            seq = [s[:, ::-1] for s in seq]
        gx, gdt, ga, gb, gc, gd = (np.asarray(v) for v in _vjp(seq[0], seq[1], a[k].numpy(), seq[2], seq[3],
                                                                 d[k].numpy(), seq[4]))
        if rev:
            gx, gdt, gb, gc = (v[:, ::-1] for v in (gx, gdt, gb, gc))
        out[0][:, src[k]] += gx
        out[1][:, k], out[2][k], out[3][:, k], out[4][:, k], out[5][k] = gdt, ga, gb, gc, gd
    return out


def _close(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        top = np.abs(w).max()
        assert top > 0, (what, name)
        np.testing.assert_allclose(g, w, atol=RTOL * top, rtol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("length", [37, 300])
@pytest.mark.parametrize("flags", FLAGS, ids=["plain", "ss2d", "shared"])
def test_plain_backward_matches_jax_vjp(flags, length):
    """Every gradient, with reverse flags and shared sources (whose ``dx``
    add), ``B`` and ``C`` strided, within 1e-4 of its largest value."""
    reverse, source = flags
    gx = 4 if source is None else max(source) + 1
    x, dt, a, b, c, d, dy = _inputs(2, gx, 4, length, 8, seed=length + len(str(flags)))
    assert not b.is_contiguous() and b.stride(2) == 34
    got = selective_scan_bwd_plain(x, dt, a, b, c, d, dy, reverse, source)
    _close(got, _jax_grads(x, dt, a, b, c, d, dy, reverse, source), f"{flags} L={length}")
    assert got[3].is_contiguous() and got[4].is_contiguous()  # dB and dC come back dense


def test_plain_backward_single_direction_form_matches_jax_vjp():
    """(B, L, D) inputs without the direction axis, reversed, against the
    reference on the flipped sequence."""
    x, dt, a, b, c, d, dy = (t[:, 0] if t.dim() == 4 else t[0] for t in _inputs(2, 1, 1, 45, 6, seed=3))
    got = selective_scan_bwd_plain(x, dt, a, b, c, d, dy, (True,))
    flip = [np.ascontiguousarray(t.numpy()[:, ::-1]) for t in (x, dt, b, c, dy)]
    want = [np.asarray(v) for v in _vjp(flip[0], flip[1], a.numpy(), flip[2], flip[3], d.numpy(), flip[4])]
    want = [v[:, ::-1] if i in (0, 1, 3, 4) else v for i, v in enumerate(want)]
    _close(got, want, "single direction")


@pytest.mark.parametrize("with_d", [True, False])
@pytest.mark.parametrize("flags", FLAGS, ids=["plain", "ss2d", "shared"])
def test_plain_backward_matches_autograd_of_the_plain_forward(flags, with_d):
    """The same gradients as autograd through ``selective_scan_plain``, the
    CPU path's own backward, at a length that spans two ragged chunks."""
    reverse, source = flags
    gx = 4 if source is None else max(source) + 1
    *args, dy = _inputs(2, gx, 4, 300, 8, seed=11)
    if not with_d:
        args[5] = None
    leaves = [t.detach().clone().requires_grad_() if t is not None else None for t in args]
    y = selective_scan_plain(*leaves, reverse=reverse, source=source)
    want = torch.autograd.grad(y, [t for t in leaves if t is not None], dy)
    got = selective_scan_bwd_plain(*args, dy, reverse, source)
    assert (got[5] is None) == (not with_d)
    _close([g for g in got if g is not None], want, f"{flags} D={with_d}")


def test_function_cpu_form_passes_gradcheck_in_float64():
    """``SelectiveScan``'s CPU form (the plain forward and backward) against
    finite differences, in float64, with SS2D's flags and sources."""
    x, dt, a, b, c, d, _ = _inputs(1, 2, 4, 6, 3, seed=5, dtype=np.float64)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, a, b, c, d)]
    assert selective_scan_plain(*leaves[:5], reverse=(True,) * 4, source=(0, 1, 0, 1)).dtype == torch.float64
    assert torch.autograd.gradcheck(lambda *t: SelectiveScan.apply(*t, (False, False, True, True), (0, 1, 0, 1)),
                                    leaves, eps=1e-6, atol=1e-7)


def test_plain_backward_in_float64_tracks_float32():
    """The float64 form the card's checks use: its gradients are float64 and
    within 1e-5 of the f32 ones' largest values."""
    args = _inputs(1, 2, 4, 50, 5, seed=8)
    f32 = selective_scan_bwd_plain(*args[:6], args[6], (False, False, True, True), (0, 1, 0, 1))
    f64 = selective_scan_bwd_plain(*(t.double() for t in args[:6]), args[6].double(), (False, False, True, True),
                                   (0, 1, 0, 1))
    for name, lo, hi in zip(NAMES, f32, f64):
        assert lo.dtype == torch.float32 and hi.dtype == torch.float64, name
        assert float((lo.double() - hi).abs().max()) <= 1e-5 * float(hi.abs().max()), name


@pytest.fixture
def stubbed_card(monkeypatch):
    """The device check and the launches stubbed: meta tensors stand for the
    card's, and each launch is recorded with its arguments."""
    calls = []
    monkeypatch.setattr(_build, "validate", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda name, argtypes, *args, **k: calls.append((name, argtypes, args)))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: types.SimpleNamespace(multi_processor_count=132))
    before = selective_scan.launches, selective_scan_bwd.launches
    yield calls
    selective_scan.launches, selective_scan_bwd.launches = before


def _meta(b, gx, g, length, d, rank=1):
    meta = dict(device="meta")
    x, dt, a, dv = (torch.zeros(s, **meta) for s in ((b, gx, length, d), (b, g, length, d), (g, d, 16), (g, d)))
    _, bs, cs = torch.zeros((b, g, length, rank + 32), **meta).split([rank, 16, 16], -1)
    return x, dt, a, bs, cs, dv


@pytest.mark.parametrize("dim,with_d", [(64, True), (32, False)])
def test_backward_wrapper_hands_the_kernel_its_shapes_strides_flags_and_chunk(stubbed_card, dim, with_d):
    """Through the Function on the card: one forward launch, then on
    ``backward`` one launch of K4's backward, counted once, with the
    pointers of the six inputs, ``dy``, the forward's carry, seven scratch
    buffers (the g carry, the tile start states, ...) and six outputs (``dD``
    None without ``D``), and the forward's chunk length, which the backward
    takes from the forward."""
    x, dt, a, bs, cs, dv = _meta(2, 2, 4, 1003, dim)
    leaves = [t.requires_grad_() for t in (x, dt, a, dv)]
    before = selective_scan_bwd.launches
    y = selective_scan(x, dt, a, bs, cs, dv if with_d else None, reverse=(False, False, True, True),
                       source=(0, 1, 0, 1))
    assert [c[0] for c in stubbed_card] == ["selective_scan"]
    y.sum().backward()
    (name, argtypes, args), = stubbed_card[1:]
    assert name == "selective_scan_bwd" and len(argtypes) == len(args) == 36
    assert selective_scan_bwd.launches == before + 1 and all(t.grad is not None for t in leaves[:3])
    row = 33
    chunk = chunk_length(8, 1003, dim, 132)
    assert args[21:] == (2, 4, 2, 1003, dim, 16, 4 * 1003 * row, 1003 * row, row, 4 * 1003 * row, 1003 * row, row,
                         0b1100, 0x1010, chunk)
    assert args[21:][-1] == stubbed_card[0][2][-1]  # the forward's chunk length
    assert (args[20] is None) == (not with_d) and (args[5] is None) == (not with_d)  # dD with D only
    assert dv.grad is None or with_d


def test_backward_wrapper_counts_each_call_and_refuses_a_missing_carry(stubbed_card):
    x, dt, a, bs, cs, dv = _meta(1, 2, 4, 1003, 64)
    dy = torch.zeros(dt.shape, device="meta")
    before = selective_scan_bwd.launches
    with pytest.raises(ValueError, match="needs the forward's carry"):
        selective_scan_bwd(x, dt, a, bs, cs, dv, dy, source=(0, 1, 0, 1), chunk=136)
    with pytest.raises(ValueError, match="chunk length"):
        selective_scan_bwd(x, dt, a, bs, cs, dv, dy, source=(0, 1, 0, 1), chunk=100)
    with pytest.raises(ValueError, match="chunk length"):
        selective_scan_bwd(x, dt, a, bs, cs, dv, dy, source=(0, 1, 0, 1), chunk=0)
    assert selective_scan_bwd.launches == before
    selective_scan_bwd(x, dt, a, bs, cs, dv, dy, source=(0, 1, 0, 1), chunk=1008)  # past the forward's cap: one chunk
    assert selective_scan_bwd.launches == before + 1
    carry = torch.zeros((4, 7, 17, 64), device="meta")  # 1,003 steps in chunks of 136: 8 chunks, 7 carried
    grads = selective_scan_bwd(x, dt, a, bs, cs, dv, dy, source=(0, 1, 0, 1), carry=carry, chunk=136)
    assert selective_scan_bwd.launches == before + 2
    assert [tuple(g.shape) for g in grads] == [tuple(x.shape), tuple(dt.shape), tuple(a.shape), (1, 4, 1003, 16),
                                               (1, 4, 1003, 16), tuple(dv.shape)]


def test_backward_wrapper_on_the_cpu_is_the_plain_version_and_launches_nothing():
    *args, dy = _inputs(1, 2, 4, 20, 4, seed=9)
    before = selective_scan_bwd.launches
    got = selective_scan_bwd(*args, dy, (False, False, True, True), (0, 1, 0, 1))
    want = selective_scan_bwd_plain(*args, dy, (False, False, True, True), (0, 1, 0, 1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert selective_scan_bwd.launches == before


@pytest.mark.parametrize("sequences,length,dim", [(32, 204_800, 32), (4, 25_600, 32), (512, 25_600, 32)])
def test_chunk_length_is_at_most_what_the_backward_holds(sequences, length, dim):
    """No chunk is longer than 512 steps, however few chunks would fill the
    card (the cap the forward keeps; the backward takes any length), and it
    stays a whole number of the forward's tiles and of the backward's."""
    got = chunk_length(sequences, length, dim, sms=132)
    assert got <= scan_module.MAX_CHUNK == 512 and got % scan_module.TILE == 0 and got % scan_module.BWD_TILE == 0
    assert got == 512 or -(-length // got) * sequences * -(-dim // 32) <= 132 * scan_module.WARPS_PER_SM


@pytest.mark.parametrize("kernel,phase,group", [
    ("void selective_scan_kernel_outputs<4>(ScanArgs)", "forward", "K4 selective_scan"),
    ("selective_scan_kernel_carry(ScanArgs, long long)", "forward", "K4 selective_scan"),
    ("void selective_scan_bwd_kernel_main<4>(BwdArgs)", "backward", "K4 selective_scan_bwd"),
    ("void selective_scan_bwd_kernel_starts<2>(BwdArgs)", "backward", "K4 selective_scan_bwd"),
    ("selective_scan_bwd_kernel_gcarry(BwdArgs, long long)", "backward", "K4 selective_scan_bwd"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, false>(int, float, "
     "float const*, float const*, float const*, float*, float*, float*)", "forward", "LayerNorm forward"),
    ("void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel<float, float>(long, long, float const*, "
     "float const*, float const*, float const*, float*, float*)", "backward", "LayerNorm backward")])
def test_profile_train_groups_k4_and_layer_norm_kernels(kernel, phase, group):
    """``profile_train``'s breakdown of a VSS step names K4's forward and
    backward passes and PyTorch's LayerNorm kernels in groups of their own."""
    from experiment_yolo_torch.profile_train import group_of

    assert group_of(kernel, phase) == group

