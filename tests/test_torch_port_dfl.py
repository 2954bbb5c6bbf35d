"""K1's forward over every level of a head at once (``dfl_decode_levels``)
against the per-level path, the JAX ``dfl_decode`` and the TPU kernel
``dfl_decode_pallas`` in interpret mode; its level table as plain Python; and
its wrapper's card path with tensors on ``meta`` and the launch stubbed.

Maps are (B, 70, H, W) Detect heads (reg_max 16, nc 6) at batch 2: three
levels at LD-P2's strides (4, 8, 16 at imgsz 64) and four P2-P5 levels with
ragged sizes (38 x 38, 19 x 19, 10 x 10, 5 x 5).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiment_yolo_torch.ops.kernels import _build
from experiment_yolo_torch.ops.kernels import dfl_decode as k1
from experiment_yolo_tpu.ops import anchors as janchors
from experiment_yolo_tpu.ops.pallas.dfl_decode import dfl_decode_pallas

REG_MAX = 16
LEVELS = {"LD-P2 strides": [(16, 16), (8, 8), (4, 4)], "P2-P5 ragged": [(38, 38), (19, 19), (10, 10), (5, 5)]}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _maps(shapes, dtype, seed=0):
    """Seeded maps of each level's shape; the first level has a +-200 logit
    spread across the groups of one anchor."""
    rng = np.random.default_rng(seed)
    maps = [(3 * rng.standard_normal((2, 4 * REG_MAX + 6, h, w))).astype(np.float32) for h, w in shapes]
    maps[0][0, :REG_MAX, 0, 0] += 200.0
    maps[0][0, REG_MAX:2 * REG_MAX, 0, 0] -= 200.0
    return [torch.from_numpy(m).to(dtype) for m in maps]


def _jax_box(f: torch.Tensor, dtype=None):
    """A map's box channels as the JAX decode's (B, A, 4*reg_max) input, in the
    map's dtype or in ``dtype`` (a bf16 map widens exactly to f32)."""
    b, _, h, w = f.shape
    x = np.transpose(f[:, :4 * REG_MAX].float().numpy(), (0, 2, 3, 1)).reshape(b, h * w, 4 * REG_MAX)
    return jnp.asarray(x).astype(dtype or (jnp.bfloat16 if f.dtype == torch.bfloat16 else jnp.float32))


def _spacing(x) -> np.ndarray:
    """The bf16 spacing at each element's magnitude."""
    _, e = np.frexp(np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("levels", list(LEVELS))
def test_levels_decode_matches_per_level_plain_jax_and_pallas(levels, dtype):
    """The one-call decode of every level on the CPU: bit-equal to the levels'
    plain decodes concatenated, and within 1e-5 of the JAX ``dfl_decode`` and
    of ``dfl_decode_pallas`` in interpret mode (a level whose size breaks its
    128-lane packing takes its jnp reference), level by level, concatenated;
    no launch is counted. A bf16 map reaches JAX widened to f32, exactly, as
    K1 and the Pallas kernel widen it (the jnp decode would take its softmax
    in bf16)."""
    maps = _maps(LEVELS[levels], DTYPES[dtype])
    before = k1.dfl_decode.launches + k1.dfl_decode_bf16.launches
    got = k1.dfl_decode_levels(maps, REG_MAX)
    assert got.dtype == torch.float32 and got.shape == (2, sum(h * w for h, w in LEVELS[levels]), 4)
    assert torch.equal(got, torch.cat([k1.dfl_decode_plain(f, REG_MAX) for f in maps], 1))
    assert torch.equal(k1.dfl_decode_levels_fwd(maps, REG_MAX), got)
    for fn in (lambda d: janchors.dfl_decode(d, REG_MAX), lambda d: dfl_decode_pallas(d, REG_MAX, True)):
        want = np.concatenate([np.asarray(fn(_jax_box(f, jnp.float32))) for f in maps], 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert k1.dfl_decode.launches + k1.dfl_decode_bf16.launches == before


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_levels_gradient_matches_per_level_path_and_pallas_vjp(dtype):
    """The gradient of every level through the one-call ``autograd.Function``
    on the CPU: bit-equal to the per-level path's (one decode a map, then the
    concatenation) and, level by level, within 1e-5 (f32) or one bf16 spacing
    plus 1e-5 of the largest value (bf16, ``chip_smoke.py``'s gate of a bf16
    ``dx``) of ``jax.vjp`` of ``dfl_decode_pallas`` in interpret mode on the
    same maps (LD-P2's levels, whose sizes keep its 128-lane packing, so its
    ``_bwd_kernel`` runs, in the map's dtype); class channels exactly 0. Each
    side takes its own forward's ``y``, which differ by f32 rounding (4e-6):
    where ``bin - y`` nearly cancels, that moves a small ``dx`` by more than
    its bf16 spacing."""
    shapes = LEVELS["LD-P2 strides"]
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((2, sum(h * w for h, w in shapes), 4))
                         .astype(np.float32))
    xs = [f.requires_grad_() for f in _maps(shapes, DTYPES[dtype], seed=2)]
    k1.dfl_decode_levels(xs, REG_MAX).backward(g)
    ref = [f.detach().clone().requires_grad_() for f in xs]
    torch.cat([k1.dfl_decode(f, REG_MAX) for f in ref], 1).backward(g)
    first = 0
    for x, r in zip(xs, ref):
        assert x.grad.dtype == x.dtype and torch.equal(x.grad, r.grad)
        assert not x.grad[:, 4 * REG_MAX:].float().any()
        b, _, h, w = x.shape
        _, vjp = jax.vjp(lambda d: dfl_decode_pallas(d, REG_MAX, True), _jax_box(x.detach()))
        want = np.asarray(vjp(jnp.asarray(g[:, first:first + h * w].numpy()))[0].astype(jnp.float32))
        box = np.transpose(x.grad[:, :4 * REG_MAX].float().numpy(), (0, 2, 3, 1)).reshape(b, h * w, 4 * REG_MAX)
        if x.dtype == torch.bfloat16:
            assert (np.abs(box - want) <= _spacing(want) + 1e-5 * np.abs(want).max()).all()
        else:
            np.testing.assert_allclose(box, want, atol=1e-5, rtol=0)
        first += h * w


LD_P2_640 = [(25600, 70 * 25600, 0), (6400, 70 * 6400, 1 << 20), (1600, 70 * 1600, 2 << 20)]
LD_P2_608 = [(152 * 152, 70 * 152 * 152, 0), (76 * 76, 70 * 76 * 76, 0), (38 * 38, 70 * 38 * 38, 0)]


def test_level_table_widths_first_anchors_and_blocks():
    """The forward's level table as the kernel is built (4-byte loads: two
    bf16 anchors or one f32 anchor a thread): LD-P2's levels at 640 (25,600,
    6,400, 1,600 anchors) and at 608 take the widest width, 19 x 38 anchors
    too, an odd count one anchor; first anchors follow the levels, and the
    block sums count ceil(A / (width * THREADS)) a level."""
    for itemsize, widest in ((2, 2), (4, 1)):
        table = k1.level_table(LD_P2_640, itemsize)
        assert [t.width for t in table] == [widest] * 3 and [t.first for t in table] == [0, 25600, 32000]
        assert [t.block_end for t in table] == list(np.cumsum([-(-a // (widest * k1.THREADS))
                                                               for a, _, _ in LD_P2_640]))
        assert [t.width for t in k1.level_table(LD_P2_608, itemsize)] == [widest] * 3
    narrow = k1.level_table([(19 * 38, 70 * 19 * 38, 0), (19 * 19, 70 * 19 * 19, 0)], 2)
    assert [t.width for t in narrow] == [2, 1]
    assert narrow[1].block_end == narrow[0].block_end + 3  # 361 anchors, one a thread: 3 blocks of 128
    assert k1.level_table([(5, 70 * 5, 0)], 4)[0] == k1.Level(5, 350, 0, 1, 0, 1)


def test_level_table_up_to_16_byte_loads(monkeypatch):
    """With loads of up to 16 bytes (the variants' widest), a level takes the
    widest load its shape allows: LD-P2's levels at 640 8 bf16 or 4 f32
    anchors, P4 at 608 (38 x 38 = 1,444 anchors) 4 in bf16, 19 x 38 anchors 2,
    an odd count 1."""
    monkeypatch.setattr(k1, "MAX_LOAD_BYTES", 16)
    assert [t.width for t in k1.level_table(LD_P2_640, 2)] == [8, 8, 8]
    assert [t.width for t in k1.level_table(LD_P2_640, 4)] == [4, 4, 4]
    assert [t.width for t in k1.level_table(LD_P2_608, 2)] == [8, 8, 4]
    assert [t.width for t in k1.level_table(LD_P2_608, 4)] == [4, 4, 4]
    table = k1.level_table([(19 * 38, 70 * 19 * 38, 0), (19 * 19, 70 * 19 * 19, 0)], 2)
    assert [t.width for t in table] == [2, 1]
    assert [t.block_end for t in k1.level_table(LD_P2_640, 2)] == [25, 32, 34]


@pytest.mark.parametrize("ptr,stride,itemsize,width", [
    (2, 70 * 1600, 2, 1), (4, 70 * 1600, 2, 2), (8, 70 * 1600, 2, 4), (16, 70 * 1600, 2, 8),
    (4, 70 * 1600, 4, 1), (8, 70 * 1600, 4, 2), (0, 70 * 1600 + 2, 2, 2), (0, 70 * 1600 + 1, 4, 1)])
def test_level_width_follows_address_and_batch_stride(monkeypatch, ptr, stride, itemsize, width):
    """A level's width also divides its batch stride, and its map's address
    is aligned to the load: else a narrower width, down to one anchor (with
    loads of up to 16 bytes here, and as the kernel is built)."""
    monkeypatch.setattr(k1, "MAX_LOAD_BYTES", 16)
    assert k1.level_width(1600, stride, ptr, itemsize) == width
    monkeypatch.undo()
    assert k1.level_width(1600, stride, ptr, itemsize) == min(width, max(1, k1.MAX_LOAD_BYTES // itemsize))


def test_level_table_takes_one_to_four_levels():
    with pytest.raises(ValueError, match="1 to 4"):
        k1.level_table([(16, 1120, 0)] * 5, 2)
    with pytest.raises(ValueError, match="1 to 4"):
        k1.level_table([], 2)
    with pytest.raises(ValueError, match="1 to 4"):
        k1.dfl_decode_levels_fwd(_maps([(2, 2)] * 5, torch.float32))


def test_kernel_constants_match_the_source():
    """The wrapper's level count, block size and widest load are the CUDA
    source's."""
    src = (_build.CSRC / "dfl_decode.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["MAX_LEVELS"], const["DECODE_THREADS"], const["MAX_LOAD_BYTES"]) == (
        k1.MAX_LEVELS, k1.THREADS, k1.MAX_LOAD_BYTES)


@pytest.fixture
def stubbed(monkeypatch):
    """The card path on ``meta`` tensors: ``_build.validate`` without its
    device check, and every launch recorded instead of made."""
    def validate(t, what, dtype, ndim, dense_last_only=False):
        if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
            raise TypeError(f"{what}: {t.dtype}")
        assert t.dim() == ndim and t.is_contiguous()

    calls = []
    monkeypatch.setattr(_build, "validate", validate)
    monkeypatch.setattr(_build, "launch", lambda name, argtypes, *args, device, lib=None: calls.append(
        (name, tuple(argtypes), args, lib)))
    return calls


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_levels_wrapper_makes_one_launch_a_call(stubbed, n, dtype):
    """On the card's path the forward makes its (B, sum A_i, 4) f32 output with
    ``empty`` and nothing else, and launches its dtype's entry point once a
    call for 1 to 4 levels, with the level table padded to four levels and
    one count a call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Made(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops.append((func.__name__, out.dtype, tuple(out.shape)))
            return out

    dt = DTYPES[dtype]
    sizes = [(40, 40), (20, 20), (10, 10), (5, 5)][:n]
    maps = [torch.empty(2, 70, h, w, dtype=dt, device="meta") for h, w in sizes]
    entry = k1.dfl_decode_bf16 if dt == torch.bfloat16 else k1.dfl_decode
    before = entry.launches
    with Made() as made:
        out = k1.dfl_decode_levels_fwd(maps)
    total = sum(h * w for h, w in sizes)
    assert made.ops == [("empty.memory_format", torch.float32, (2, total, 4))] and out.shape == (2, total, 4)
    assert entry.launches == before + 1 and len(stubbed) == 1
    name, argtypes, args, lib = stubbed[0]
    assert (name, argtypes, lib) == (entry.__name__, k1._ARGS, "dfl_decode") and len(args) == len(argtypes)
    table = k1.level_table([(h * w, 70 * h * w, 0) for h, w in sizes], maps[0].element_size())
    pad = 4 - n
    assert args[5:9] == (2, total, n, 16)
    assert args[9:13] == (*(t.anchors for t in table), *[0] * pad)
    assert args[13:17] == (*(t.batch_stride for t in table), *[0] * pad)
    assert args[17:21] == (*(t.width for t in table), *[1] * pad)
    assert args[21:25] == (*(t.first for t in table), *[0] * pad)
    assert args[25:29] == (*(t.block_end for t in table), *[0] * pad)


def test_levels_wrapper_raises_on_mixed_levels(stubbed):
    """Levels of one call share a dtype, a device and a batch, and number at
    most four; each mix raises before any launch, on the card's path and on
    the CPU's."""
    meta = [torch.empty(2, 70, 8, 8, device="meta"), torch.empty(2, 70, 4, 4, device="meta")]
    with pytest.raises(TypeError, match="levels of"):
        k1.dfl_decode_levels_fwd([meta[0], meta[1].bfloat16()])
    with pytest.raises(ValueError, match="levels of shapes"):
        k1.dfl_decode_levels_fwd([meta[0], torch.empty(1, 70, 4, 4, device="meta")])
    with pytest.raises(ValueError, match="levels on"):
        k1.dfl_decode_levels_fwd([meta[0], torch.zeros(2, 70, 4, 4)])
    with pytest.raises(ValueError, match="levels on"):
        k1.dfl_decode_levels_fwd([torch.zeros(2, 70, 4, 4), meta[0]])
    with pytest.raises(ValueError, match="1 to 4"):
        k1.dfl_decode_levels_fwd(meta * 3)
    with pytest.raises(TypeError, match="levels of"):
        k1.dfl_decode_levels_fwd([torch.zeros(2, 70, 4, 4), torch.zeros(2, 70, 4, 4, dtype=torch.bfloat16)])
    assert stubbed == []


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_wrapper_reads_y_and_g_in_place(stubbed, dtype):
    """The backward's card path launches one kernel for a level, handing it
    the concatenated ``y`` and ``g`` as they are with their anchor count and
    the level's first anchor; a level that does not fit in them raises."""
    dt = DTYPES[dtype]
    feat = torch.empty(2, 70, 10, 10, dtype=dt, device="meta")
    y, g = torch.empty(2, 400 + 100 + 25, 4, device="meta"), torch.empty(2, 525, 4, device="meta")
    dx = k1.dfl_decode_bwd(feat, y, g, 16, 400)
    assert dx.shape == feat.shape and dx.dtype == dt
    name, argtypes, args, lib = stubbed[-1]
    assert (name, argtypes, lib) == ("dfl_decode_bwd_bf16" if dt == torch.bfloat16 else "dfl_decode_bwd",
                                     k1._BWD_ARGS, "dfl_decode")
    assert args[4:] == (2, 100, 7000, 16, 525, 400)
    with pytest.raises(ValueError, match="anchors 426 to 526"):
        k1.dfl_decode_bwd(feat, y, g, 16, 426)


def test_kernel_variants_substitutions_are_in_the_sources():
    """Every text piece a throwaway variant of ``kernel_variants`` replaces is
    in its CUDA source, so that no variant fails on the card for a stale
    piece."""
    from experiment_yolo_torch import kernel_variants as kv

    sources = {"K1_VARIANTS": "dfl_decode", "K2_VARIANTS": "nms_suppress", "K3_VARIANTS": "ldconv_gather",
               "K3BWD_VARIANTS": "ldconv_gather", "K3BF16_VARIANTS": "ldconv_gather",
               "K3BWDBF16_VARIANTS": "ldconv_gather", "K4_VARIANTS": "selective_scan",
               "K4BWD_VARIANTS": "selective_scan", "K5_VARIANTS": "soft_nms"}
    for table, lib in sources.items():
        text = (_build.CSRC / f"{lib}.cu").read_text()
        for tag, variant in getattr(kv, table).items():
            pieces = variant[0] if table in ("K1_VARIANTS", "K4BWD_VARIANTS") else variant
            for old, new in pieces:
                assert old in text, f"{table}[{tag!r}]: {old!r}"
                text = text.replace(old, new)
            text = (_build.CSRC / f"{lib}.cu").read_text()
