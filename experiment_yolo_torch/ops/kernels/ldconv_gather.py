"""Kernel K3: the LDConv bilinear gather and its backward, with their plain
PyTorch versions.

Replaces ``experiment_yolo_tpu/ops/pallas/ldconv_kernel.py:_gather_kernel``
(reached through ``bilinear_gather_single``), with the semantics of the JAX
LDConv's production gather: ``ldconv_gather_packed`` times ``_border_mul``
(``nn/modules.py:422,665``), and of its hand-written custom VJP
``_ldconv_gather_bwd`` (``nn/modules.py:469``). The kernels,
``csrc/ldconv_gather.cu``, turn the raw offset-conv output into positions,
corners, weights and the border multiplier in one pass and are bound by
memory. The forward computes each sample once per (pixel, n), reads the
corners with a warp along neighbouring pixels of one channel plane, and turns
the values into the (pixel, n, channel) layout through a tile in shared
memory. The backward, bound by its atomic adds into ``dx``, merges the adds
of neighbouring lanes that fall on one cell, pairs neighbouring cells into
8-byte adds, and splits the channels of wide layers over threads; the source
says how, and what bounds each.

:func:`ldconv_gather` is differentiable: a ``torch.autograd.Function`` whose
forward and backward launch the kernels for CUDA tensors and take
:func:`ldconv_gather_plain` and :func:`ldconv_gather_bwd_plain` only for
tensors on the CPU.

Both kernels have an f32 and a bf16 form (the sources of a bf16 model,
``nn/modules.py:780-805`` of the JAX package). The bf16 forward widens the
source exactly, computes as the f32 form does (f32 offsets, positions,
weights, multiplier and sums) and rounds its output once to bf16, through a
bf16 tile left with 16-byte stores; the bf16 backward reads the bf16 source
and incoming gradient, sums ``dx`` in f32 in a scratch that its launch
zeroes, rounds it once into a bf16 ``dx`` in the same launch
(``_ldconv_gather_bwd``'s ``astype``), and writes ``doff`` in f32. Each
form counts its own launches (``ldconv_gather.launches``,
``ldconv_gather_bf16.launches``, ``ldconv_gather_bwd.launches``,
``ldconv_gather_bwd_bf16.launches``); any other source dtype raises on the
card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Tuple

import torch

from experiment_yolo_torch.ops.kernels import _build

WINDOW_R = 2  # the JAX LDConv's window_r: the edge pad R before the base grid
_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 12
_BWD_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 12
_BWD_BF16_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong,) + (ctypes.c_int,) * 12
DTYPES = (torch.float32, torch.bfloat16)  # the sources the kernels take


def grid_points(num_param: int) -> List[Tuple[int, int]]:
    """The N sampling-grid points (row, col): row-major over round(sqrt(N))
    columns plus a remainder row (the JAX package's ``_ldconv_grid_pts``)."""
    base = round(math.sqrt(num_param))
    rows, rem = divmod(num_param, base)
    return [(r, c) for r in range(rows) for c in range(base)] + [(rows, c) for c in range(rem)]


@functools.lru_cache(maxsize=None)
def _padded(hx: int, wx: int, h: int, w: int, n: int, stride: int):
    pts = grid_points(n)
    max_pr = max(p[0] for p in pts)
    max_pc = max(p[1] for p in pts)
    hp = hx + WINDOW_R + max(0, (h - 1) * stride + max_pr + WINDOW_R + 2 - hx)
    wp = wx + WINDOW_R + max(0, (w - 1) * stride + max_pc + WINDOW_R + 2 - wx)
    return n, round(math.sqrt(n)), hp, wp


def _geometry(x: torch.Tensor, off: torch.Tensor, stride: int):
    """(N, base, padded H, padded W) for a source and its offsets; the padded
    sizes are those of the JAX LDConv's edge-padded source. Kept per shape:
    a forward asks ten times."""
    _, _, hx, wx = x.shape
    _, n2, h, w = off.shape
    return _padded(hx, wx, h, w, n2 // 2, stride)


def _samples(x: torch.Tensor, off: torch.Tensor, stride: int):
    """Where each LDConv sample reads, in the JAX package's float order: the
    unclamped padded positions ``pr``, ``pc`` (B, h*w, N), the bilinear
    weights, the four source corners as flat indices into one (H*W) channel
    plane, and the border multiplier.

    Positions are ``i*stride + R + grid + offset`` in the source edge-padded by
    R = 2, clamped to the padded size; corners are clamped; the padded row or
    column r reads source row or column clamp(r - R); each sample is doubled
    per axis whose unpadded position lies outside [0, size-1) (the reference
    fork's border double count).
    """
    b, c, hx, wx = x.shape
    _, _, h, w = off.shape
    n, _, hp, wp = _geometry(x, off, stride)
    pts = torch.tensor(grid_points(n), dtype=torch.float32, device=x.device)  # (N, 2)
    off = off.float().reshape(b, 2, n, h * w).permute(0, 3, 2, 1)  # (B, hw, N, [row, col])
    gr = (torch.arange(h, dtype=torch.float32, device=x.device) * stride + WINDOW_R)[:, None].expand(h, w)
    gc = (torch.arange(w, dtype=torch.float32, device=x.device) * stride + WINDOW_R)[None, :].expand(h, w)
    pr = gr.reshape(1, h * w, 1) + pts[:, 0] + off[..., 0]  # (B, hw, N)
    pc = gc.reshape(1, h * w, 1) + pts[:, 1] + off[..., 1]

    prc, pcc = pr.clamp(0.0, hp - 1), pc.clamp(0.0, wp - 1)
    r0, c0 = prc.floor(), pcc.floor()
    wr1, wc1 = prc - r0, pcc - c0
    wr0, wc0 = 1.0 - wr1, 1.0 - wc1
    r0, c0 = r0.long(), c0.long()
    r1, c1 = (r0 + 1).clamp(max=hp - 1), (c0 + 1).clamp(max=wp - 1)
    # padded row/col -> source row/col: edge padding is a clamp
    sr0, sr1 = (r0 - WINDOW_R).clamp(0, hx - 1), (r1 - WINDOW_R).clamp(0, hx - 1)
    sc0, sc1 = (c0 - WINDOW_R).clamp(0, wx - 1), (c1 - WINDOW_R).clamp(0, wx - 1)
    corners = (sr0 * wx + sc0, sr0 * wx + sc1, sr1 * wx + sc0, sr1 * wx + sc1)
    ar, ac = pr - WINDOW_R, pc - WINDOW_R
    mul = (1.0 + ((ar < 0) | (ar >= hx - 1)).float()) * (1.0 + ((ac < 0) | (ac >= wx - 1)).float())
    return pr, pc, (wr0, wr1, wc0, wc1), corners, mul, (hp, wp)


def _corner_values(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, C, H*W) source at (B, hw, N) flat indices -> (B, hw, N, C)."""
    b, c, _ = src.shape
    _, hw, n = idx.shape
    full = idx.reshape(b, 1, hw * n).expand(b, c, hw * n)
    return src.gather(2, full).reshape(b, c, hw, n).permute(0, 2, 3, 1)


def ldconv_gather_plain(x: torch.Tensor, off: torch.Tensor, stride: int) -> torch.Tensor:
    """Bilinear samples of ``x`` (B, C, H, W) at the LDConv positions given by
    the offset-conv output ``off`` (B, 2N, h, w) -> (B, h*w, N*C), n-major
    (see :func:`_samples` for the positions). The float order is the JAX
    package's, so equal inputs give equal results. A bf16 ``x`` is widened
    first; the f32 result is rounded once to ``x``'s dtype.
    """
    b, c, hx, wx = x.shape
    _, _, h, w = off.shape
    n = off.shape[1] // 2
    _, _, (wr0, wr1, wc0, wc1), (i00, i01, i10, i11), mul, _ = _samples(x, off, stride)
    src = x.float().reshape(b, c, hx * wx)
    out = ((wr0 * wc0)[..., None] * _corner_values(src, i00)
           + (wr0 * wc1)[..., None] * _corner_values(src, i01)
           + (wr1 * wc0)[..., None] * _corner_values(src, i10)
           + (wr1 * wc1)[..., None] * _corner_values(src, i11))
    return (out * mul[..., None]).reshape(b, h * w, n * c).to(x.dtype)


def ldconv_gather_bwd_plain(x: torch.Tensor, off: torch.Tensor, dy: torch.Tensor, stride: int,
                            dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dx (B, C, H, W), doff (B, 2N, h, w)) of
    :func:`ldconv_gather_plain` for the incoming gradient ``dy`` (B, h*w, N*C).

    The JAX package's VJP (``_ldconv_gather_bwd``) after the border
    multiplier, which has no gradient of its own: ``dx`` is a scatter-add of
    the four weighted corners into the unpadded source (duplicate and clamped
    corners accumulate, the transpose of the edge padding); the offset
    gradient is ``sum_c d * ((x10 - x00) * wc0 + (x11 - x01) * wc1)`` for rows,
    alike for columns, kept where the unclamped padded position lies in
    ``[0, size_padded - 1]`` and 0 outside.

    ``dtype=torch.float64`` takes the same float32 positions and weights but
    multiplies and sums in float64: a reference for the float32 sums, whose
    order the kernel's atomics and ``scatter_add_`` each choose. A bf16 ``x``
    and ``dy`` are widened first; with ``dtype=torch.float32`` its ``dx`` is
    the f32 sum rounded once to bf16, and ``doff`` stays f32.
    """
    b, c, hx, wx = x.shape
    _, n2, h, w = off.shape
    n = n2 // 2
    pr, pc, weights, corners, mul, (hp, wp) = _samples(x, off, stride)
    wr0, wr1, wc0, wc1 = (t.to(dtype) for t in weights)
    src = x.to(dtype).reshape(b, c, hx * wx)
    d = dy.to(dtype).reshape(b, h * w, n, c) * mul.to(dtype)[..., None]  # (B, hw, N, C)
    v00, v01, v10, v11 = (_corner_values(src, i) for i in corners)
    dpr = (d * ((v10 - v00) * wc0[..., None] + (v11 - v01) * wc1[..., None])).sum(-1)
    dpc = (d * ((v01 - v00) * wr0[..., None] + (v11 - v10) * wr1[..., None])).sum(-1)
    dpr = dpr * ((pr >= 0) & (pr <= hp - 1)).to(dtype)
    dpc = dpc * ((pc >= 0) & (pc <= wp - 1)).to(dtype)
    doff = torch.stack([dpr, dpc], 1).permute(0, 1, 3, 2).reshape(b, n2, h, w)  # (B, [row N, col N], h, w)

    dx = torch.zeros((b, c, hx * wx), dtype=dtype, device=x.device)
    for wgt, idx in zip((wr0 * wc0, wr0 * wc1, wr1 * wc0, wr1 * wc1), corners):
        upd = (wgt[..., None] * d).permute(0, 3, 1, 2).reshape(b, c, h * w * n)
        dx.scatter_add_(2, idx.reshape(b, 1, h * w * n).expand(b, c, h * w * n), upd)
    dx = dx.reshape(b, c, hx, wx)
    return (dx.to(x.dtype) if dtype == torch.float32 else dx), doff


def _check(x: torch.Tensor, off: torch.Tensor, what: str) -> None:
    _build.validate(x, f"{what} x", DTYPES, 4)
    _build.validate(off, f"{what} off", torch.float32, 4)
    n2 = off.shape[1]
    if off.shape[0] != x.shape[0] or n2 % 2 or n2 == 0 or off.device != x.device:
        raise ValueError(f"{what}: x {tuple(x.shape)} and off {tuple(off.shape)} must be "
                         "(B, C, H, W) and (B, 2N, h, w) on one device")


def _geom_args(x: torch.Tensor, off: torch.Tensor, stride: int):
    b, c, hx, wx = x.shape
    _, _, h, w = off.shape
    n, base, hp, wp = _geometry(x, off, stride)
    return b, c, hx, wx, h, w, n, base, stride, WINDOW_R, hp, wp


def ldconv_gather_fwd(x: torch.Tensor, off: torch.Tensor, stride: int) -> torch.Tensor:
    """:func:`ldconv_gather_plain` through kernel K3 (its f32 or bf16 form, by
    ``x``'s dtype) for CUDA tensors (no autograd)."""
    if x.device.type == "cpu":
        return ldconv_gather_plain(x, off, stride)
    _check(x, off, "ldconv_gather")
    b, c, _, _ = x.shape
    _, n2, h, w = off.shape
    out = torch.empty((b, h * w, n2 // 2 * c), dtype=x.dtype, device=x.device)
    entry = ldconv_gather_bf16 if x.dtype == torch.bfloat16 else ldconv_gather
    _build.launch(entry.__name__, _ARGS, x.data_ptr(), off.data_ptr(), out.data_ptr(), *_geom_args(x, off, stride),
                  device=x.device, lib="ldconv_gather")
    entry.launches += 1
    return out


def ldconv_gather_bwd(x: torch.Tensor, off: torch.Tensor, dy: torch.Tensor,
                      stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ldconv_gather_bwd_plain` through the K3 backward kernel (its f32
    or bf16 form, by ``x``'s dtype, which ``dy`` shares) for CUDA tensors."""
    if x.device.type == "cpu":
        return ldconv_gather_bwd_plain(x, off, dy, stride)
    _check(x, off, "ldconv_gather_bwd")
    _build.validate(dy, "ldconv_gather_bwd dy", x.dtype, 3)
    b, c, _, _ = x.shape
    _, n2, h, w = off.shape
    if tuple(dy.shape) != (b, h * w, n2 // 2 * c) or dy.device != x.device:
        raise ValueError(f"ldconv_gather_bwd: dy {tuple(dy.shape)} must be (B, h*w, N*C) = "
                         f"{(b, h * w, n2 // 2 * c)} on the device of x")
    doff = torch.empty_like(off)
    if x.dtype == torch.bfloat16:  # the launch zeroes the f32 sums, adds, and rounds them once into dx
        dx = torch.empty_like(x)
        sums = torch.empty(x.numel(), dtype=torch.float32, device=x.device)
        _build.launch(ldconv_gather_bwd_bf16.__name__, _BWD_BF16_ARGS, x.data_ptr(), off.data_ptr(), dy.data_ptr(),
                      dx.data_ptr(), doff.data_ptr(), sums.data_ptr(), sums.numel(), *_geom_args(x, off, stride),
                      device=x.device, lib="ldconv_gather")
        ldconv_gather_bwd_bf16.launches += 1
        return dx, doff
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)  # the kernel adds into it
    _build.launch("ldconv_gather_bwd", _BWD_ARGS, x.data_ptr(), off.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  doff.data_ptr(), *_geom_args(x, off, stride), device=x.device, lib="ldconv_gather")
    ldconv_gather_bwd.launches += 1
    return dx, doff


ldconv_gather_bf16 = _build.Form("ldconv_gather_bf16")  # launched by ldconv_gather_fwd for a bf16 source
ldconv_gather_bwd_bf16 = _build.Form("ldconv_gather_bwd_bf16")  # launched by ldconv_gather_bwd for a bf16 source


class _LDConvGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, off: torch.Tensor, stride: int) -> torch.Tensor:
        ctx.save_for_backward(x, off)
        ctx.stride = stride
        return ldconv_gather_fwd(x, off, stride)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, off = ctx.saved_tensors
        dx, doff = ldconv_gather_bwd(x, off, dy.contiguous(), ctx.stride)
        return dx, doff, None


def ldconv_gather(x: torch.Tensor, off: torch.Tensor, stride: int) -> torch.Tensor:
    """Differentiable LDConv gather (B, C, H, W), (B, 2N, h, w) -> (B, h*w, N*C):
    kernel K3 and its backward for CUDA tensors, the plain versions for CPU ones."""
    return _LDConvGather.apply(x, off, stride)


ldconv_gather.launches = 0
ldconv_gather_bwd.launches = 0
