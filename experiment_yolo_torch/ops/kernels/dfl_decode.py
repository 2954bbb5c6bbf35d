"""Kernel K1: DFL decode of a Detect head map and its backward, with their
plain PyTorch versions.

Replaces ``experiment_yolo_tpu/ops/pallas/dfl_decode.py:_fwd_kernel`` and
``_bwd_kernel`` (reached through ``dfl_decode_pallas``). The kernels,
``csrc/dfl_decode.cu``, read the first ``4*reg_max`` channels of the NCHW map
in place and are bound by memory; the source says how their layout keeps every
load coalesced.

:func:`dfl_decode_levels` decodes every level of a Detect head, up to
:data:`MAX_LEVELS`, into one concatenated (B, sum H_i*W_i, 4) tensor with one
launch of the forward kernel; :func:`dfl_decode` is the same for one map. Both
are differentiable: a ``torch.autograd.Function`` whose forward and backward
launch the kernels for CUDA tensors and take :func:`dfl_decode_plain` and
:func:`dfl_decode_bwd_plain` only for tensors on the CPU. The backward is the
JAX package's analytic VJP, ``dx = p * g * (bin - y)`` with ``p`` recomputed
from the input, one launch a level, reading ``y`` and ``g`` in place in the
concatenated tensors.

The forward takes a level table (:func:`level_table`): each level's first
anchor in the output, the anchors a thread decodes (:func:`level_width`: the
widest load, up to :data:`MAX_LOAD_BYTES`, that the level's anchor count,
batch stride and address allow) and the running sum of its blocks.

Each kernel has an f32 and a bf16 form (the maps of a bf16 model). The bf16
forms widen the map exactly and compute in f32, as the Pallas kernels do on a
bf16 input (``_fwd_kernel``'s ``astype(float32)``): the forward writes f32
distances, the backward reads f32 ``y`` and ``g`` and writes ``dx`` rounded
once to bf16. Each form counts its own launches (``dfl_decode.launches``,
``dfl_decode_bf16.launches``, ``dfl_decode_bwd.launches``,
``dfl_decode_bwd_bf16.launches``); any other dtype raises on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from experiment_yolo_torch.ops.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)  # the maps the kernels take


def _softmax_bins(feat: torch.Tensor, reg_max: int):
    """(B, 4, reg_max, H*W) group softmax of the box channels, each group
    shifted by its own max, and the bin values (reg_max, 1). The exp is
    taken in float64 and rounded once to f32, so that the plain version is
    as accurate as the kernels' ``expf`` whatever the host's f32 ``exp``
    does. One run on the card's host once put the plain decode 1.4e-3 px
    from K1's; one probe then saw PyTorch's f32 ``exp`` on a CPU err by
    1.5e-4 relative, enough for that, but later probes never did: the cause
    is unconfirmed."""
    b, _, h, w = feat.shape
    x = feat[:, : 4 * reg_max].reshape(b, 4, reg_max, h * w).float()
    e = torch.exp((x - x.amax(2, keepdim=True)).double()).float()
    bins = torch.arange(reg_max, dtype=torch.float32, device=feat.device)[:, None]
    return e, bins


def dfl_decode_plain(feat: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Softmax expectation over ``reg_max`` bins: (B, no, H, W) -> (B, H*W, 4) f32.

    Channels ``[side*reg_max + bin]`` for side in (l, t, r, b), as the JAX
    package's ``dfl_decode`` reads its (..., A, 4*reg_max) input. Each group
    subtracts its own max, so a cross-group logit spread of any size stays finite.
    """
    e, bins = _softmax_bins(feat, reg_max)
    return ((e * bins).sum(2) / e.sum(2)).transpose(1, 2)


def dfl_decode_bwd_plain(feat: torch.Tensor, y: torch.Tensor, g: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Gradient of :func:`dfl_decode_plain` at ``feat`` for the incoming
    gradient ``g`` (B, H*W, 4), given its output ``y``: (B, no, H, W) in
    ``feat``'s dtype, ``p * g * (bin - y)`` in the box channels (computed in
    f32, rounded once) and 0 in the class channels."""
    e, bins = _softmax_bins(feat, reg_max)
    p = e * (1.0 / e.sum(2, keepdim=True))
    gt, yt = g.float().transpose(1, 2)[:, :, None], y.float().transpose(1, 2)[:, :, None]  # (B, 4, 1, A)
    dx = torch.zeros(feat.shape, dtype=torch.float32, device=feat.device)
    dx[:, : 4 * reg_max] = (p * gt * (bins - yt)).reshape(dx[:, : 4 * reg_max].shape)
    return dx.to(feat.dtype)


MAX_LEVELS = 4  # levels one launch of the forward decodes (csrc/dfl_decode.cu MAX_LEVELS)
MAX_LOAD_BYTES = 4  # a forward thread's load a bin at most: 2 bf16 or 1 f32 anchor (csrc/dfl_decode.cu)
THREADS = 128  # threads a block of the forward (csrc/dfl_decode.cu DECODE_THREADS)
_LEVEL_ARGS = (ctypes.c_int,) * 4 + (ctypes.c_longlong,) * 4 + (ctypes.c_int,) * 12  # A, stride, width, first, end
_ARGS = (ctypes.c_void_p,) * (MAX_LEVELS + 1) + (ctypes.c_int,) * 4 + _LEVEL_ARGS
_BWD_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int, ctypes.c_longlong) + (ctypes.c_int,) * 3


class Level(NamedTuple):
    """One row of the forward's level table."""
    anchors: int  # H*W
    batch_stride: int  # elements
    ptr: int  # the map's address
    width: int  # anchors a thread
    first: int  # the level's first anchor in the output
    block_end: int  # blocks of this level and of those before it, per image


def level_width(anchors: int, batch_stride: int, ptr: int, itemsize: int) -> int:
    """Anchors a thread of the forward decodes on one level: the widest power
    of two whose load (``width * itemsize`` bytes, at most MAX_LOAD_BYTES)
    divides the level's anchor count and batch stride, and to whose size the
    map's address is aligned; 1 if none."""
    width = max(1, MAX_LOAD_BYTES // itemsize)
    while width > 1 and (anchors % width or batch_stride % width or ptr % (width * itemsize)):
        width //= 2
    return width


def level_table(levels: Sequence[Tuple[int, int, int]], itemsize: int) -> List[Level]:
    """The forward's table for levels given as (anchors, batch stride, address)."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"dfl_decode: {len(levels)} levels; one launch decodes 1 to {MAX_LEVELS}")
    table, first, end = [], 0, 0
    for anchors, stride, ptr in levels:
        width = level_width(anchors, stride, ptr, itemsize)
        end += -(-anchors // (width * THREADS))
        table.append(Level(anchors, stride, ptr, width, first, end))
        first += anchors
    return table


def _check_levels(feats: Sequence[torch.Tensor]) -> None:
    """One launch takes 1 to MAX_LEVELS maps of one device, dtype and batch."""
    if not 1 <= len(feats) <= MAX_LEVELS:
        raise ValueError(f"dfl_decode: {len(feats)} levels; one launch decodes 1 to {MAX_LEVELS}")
    f0 = feats[0]
    for f in feats[1:]:
        if f.device != f0.device:
            raise ValueError(f"dfl_decode: levels on {f0.device} and {f.device}")
        if f.dtype != f0.dtype:
            raise TypeError(f"dfl_decode: levels of {f0.dtype} and {f.dtype}")
        if f.dim() != 4 or f0.dim() != 4 or f.shape[0] != f0.shape[0]:
            raise ValueError(f"dfl_decode: levels of shapes {tuple(f0.shape)} and {tuple(f.shape)}: expected "
                             "(B, no, H, W) maps of one batch")


def _check_feat(feat: torch.Tensor, reg_max: int) -> None:
    _build.validate(feat, "dfl_decode feat", DTYPES, 4)
    if feat.shape[1] < 4 * reg_max:
        raise ValueError(f"dfl_decode: {feat.shape[1]} channels < 4*reg_max = {4 * reg_max}")


def _launch_args(feats: Sequence[torch.Tensor], out: torch.Tensor, reg_max: int) -> tuple:
    """The forward's C arguments for ``feats`` and the output ``out`` (the
    stream apart): the maps' and the output's addresses, the batch, the total
    anchor count, the level count and ``reg_max``, then the table's columns,
    each padded to MAX_LEVELS."""
    table = level_table([(f.shape[2] * f.shape[3], f.stride(0), f.data_ptr()) for f in feats],
                        feats[0].element_size())
    pad = [Level(0, 0, 0, 1, 0, 0)] * (MAX_LEVELS - len(table))
    cols = list(zip(*(table + pad)))
    return (*cols[2], out.data_ptr(), out.shape[0], out.shape[1], len(table), reg_max,
            *cols[0], *cols[1], *cols[3], *cols[4], *cols[5])


def dfl_decode_levels_fwd(feats: Sequence[torch.Tensor], reg_max: int = 16) -> torch.Tensor:
    """The levels' :func:`dfl_decode_plain` outputs, concatenated along the
    anchors: (B, sum H_i*W_i, 4) f32, through one launch of kernel K1 (its f32
    or bf16 form) for CUDA tensors (no autograd)."""
    feats = list(feats)
    _check_levels(feats)
    if feats[0].device.type == "cpu":
        return torch.cat([dfl_decode_plain(f, reg_max) for f in feats], 1)
    for f in feats:
        _check_feat(f, reg_max)
    total = sum(f.shape[2] * f.shape[3] for f in feats)
    out = torch.empty((feats[0].shape[0], total, 4), dtype=torch.float32, device=feats[0].device)
    entry = dfl_decode_bf16 if feats[0].dtype == torch.bfloat16 else dfl_decode
    _build.launch(entry.__name__, _ARGS, *_launch_args(feats, out, reg_max), device=feats[0].device, lib="dfl_decode")
    entry.launches += 1
    return out


def dfl_decode_bwd(feat: torch.Tensor, y: torch.Tensor, g: torch.Tensor, reg_max: int = 16,
                   first: int = 0) -> torch.Tensor:
    """:func:`dfl_decode_bwd_plain` through the K1 backward kernel (its f32 or
    bf16 form, by ``feat``'s dtype) for CUDA tensors. ``y`` and ``g`` are
    (B, T, 4), the level's H*W anchors from ``first`` on (the concatenated
    output of :func:`dfl_decode_levels` and its gradient), read in place."""
    b, no, h, w = feat.shape
    if feat.device.type == "cpu":
        return dfl_decode_bwd_plain(feat, y[:, first:first + h * w], g[:, first:first + h * w], reg_max)
    _check_feat(feat, reg_max)
    for t, what in ((y, "y"), (g, "g")):
        _build.validate(t, f"dfl_decode_bwd {what}", torch.float32, 3)
        if t.shape[0] != b or t.shape[2] != 4 or not 0 <= first <= t.shape[1] - h * w or t.device != feat.device:
            raise ValueError(f"dfl_decode_bwd: {what} {tuple(t.shape)} must be (B, T, 4) with B = {b} and anchors "
                             f"{first} to {first + h * w} in T, on the device of feat")
    dx = torch.empty_like(feat)
    dx[:, 4 * reg_max:].zero_()
    entry = dfl_decode_bwd_bf16 if feat.dtype == torch.bfloat16 else dfl_decode_bwd
    _build.launch(entry.__name__, _BWD_ARGS, feat.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(),
                  b, h * w, no * h * w, reg_max, y.shape[1], first, device=feat.device, lib="dfl_decode")
    entry.launches += 1
    return dx


dfl_decode_bf16 = _build.Form("dfl_decode_bf16")  # launched by dfl_decode_levels_fwd for bf16 maps
dfl_decode_bwd_bf16 = _build.Form("dfl_decode_bwd_bf16")  # launched by dfl_decode_bwd for a bf16 map


class _DFLDecodeLevels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, reg_max: int, *feats: torch.Tensor) -> torch.Tensor:
        y = dfl_decode_levels_fwd(feats, reg_max)
        ctx.save_for_backward(y, *feats)
        ctx.reg_max = reg_max
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        y, *feats = ctx.saved_tensors
        g = g.contiguous()
        grads, first = [], 0
        for f, needed in zip(feats, ctx.needs_input_grad[1:]):
            grads.append(dfl_decode_bwd(f, y, g, ctx.reg_max, first) if needed else None)
            first += f.shape[2] * f.shape[3]
        return (None, *grads)


def dfl_decode_levels(feats: Sequence[torch.Tensor], reg_max: int = 16) -> torch.Tensor:
    """Differentiable DFL decode of a head's levels [(B, no, H_i, W_i)] ->
    (B, sum H_i*W_i, 4), in level order: one launch of kernel K1 and one of
    its backward a level for CUDA tensors, the plain versions for CPU ones."""
    return _DFLDecodeLevels.apply(reg_max, *feats)


def dfl_decode(feat: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Differentiable DFL decode (B, no, H, W) -> (B, H*W, 4): kernel K1 and
    its backward for a CUDA tensor, the plain versions for a CPU one."""
    return dfl_decode_levels([feat], reg_max)


dfl_decode.launches = 0
dfl_decode_bwd.launches = 0
