"""Kernel K4: the selective scan (Mamba state-space recurrence), and its plain
PyTorch version.

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t (+ D * x_t)

Replaces ``experiment_yolo_tpu/ops/pallas/selective_scan.py:_scan_kernel``
(reached through ``selective_scan_pallas``), the ``D * x`` term included. The
kernel, ``csrc/selective_scan.cu``, runs one thread per (sequence, channel,
chunk of L) with the channel's 16 states in registers, in three passes (each
chunk's end state from zero, a carry over the chunks, each chunk again from
its true start), and streams its inputs through a ring of tiles in shared
memory. No single unit bounds it: a pass is as fast as its exps, its reads of
``B`` and ``C`` from shared memory and its copies from device memory overlap;
the source says how, with the measurements.

Shapes follow the JAX function: ``x``, ``dt`` (B, L, D), ``A`` (D, N), ``B``,
``C`` (B, L, N), ``D`` (D,). Every tensor may carry one more axis G of scan
directions that share the call, ``x``, ``dt`` (B, G, L, D), ``A`` (G, D, N),
``B``, ``C`` (B, G, L, N), ``D`` (G, D): SS2D's four directions are then one
call, not four. Two more arguments say what SS2D used to do with copies:
``reverse`` (a sequence of one flag per direction; of one flag without the
axis) scans a direction from its last step to its first and returns ``y`` in
the order of its inputs, which is the scan of the flipped sequence, flipped
back; ``source`` (one index per
direction) names the direction of ``x`` (B, Gx, L, D) that a direction reads,
so a reversed direction shares its forward partner's ``x``. ``B`` and ``C``
may be views with any strides over batch, direction and step (slices of the
projection that holds them side by side); only their last axis must be dense.

:func:`selective_scan` launches the kernel for CUDA tensors and takes
:func:`selective_scan_plain` only for tensors on the CPU, which is
differentiable as it stands. On the card a call that needs a gradient goes
through :class:`SelectiveScan`, an autograd Function whose forward launches K4
and keeps its carry buffer (each chunk's start state) and whose backward
launches K4's backward kernel (:func:`selective_scan_bwd`, in the same
source), which recomputes the states from those starts. The Pallas kernel has
no backward: the JAX package trains through ``selective_scan_reference``'s
autodiff, which :func:`selective_scan_bwd_plain` writes out step by step.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from experiment_yolo_torch.ops.kernels import _build

_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 15
_BWD_ARGS = (ctypes.c_void_p,) * 21 + (ctypes.c_int,) * 15
N_STATE = 16  # the kernel keeps a channel's states in 16 registers
CHUNK = 256  # steps whose decays and inputs the plain version computes at once
MAX_DIRECTIONS = 8  # the kernel takes the direction flags and sources packed into two ints
# How the kernel cuts L (mirrors csrc/selective_scan.cu): a warp scans 32 channels of one chunk, an SM
# holds 24 such warps (12 blocks of 2, by registers and shared memory), and a chunk is a whole number
# of 8-step tiles, no shorter than 32 steps, below which the carry between chunks costs more than it
# wins, and no longer than 512 steps: the chunking with which K4's times were measured (the backward
# takes any length).
LANES, WARPS_PER_SM, TILE, MIN_CHUNK, MAX_CHUNK = 32, 24, 8, 32, 512
# Steps of the backward's tiles (mirrors BWD_TILE in csrc/selective_scan.cu): its first pass keeps the
# state before each of a chunk's tiles, 16 x 32 floats a channel group, in scratch that the wrapper sizes.
BWD_TILE = 4

Flags = Optional[Sequence[bool]]
Sources = Optional[Sequence[int]]


def _with_directions(x, dt, a, b, c, d, source):
    """Every tensor with the direction axis G, and whether it was added."""
    single = x.dim() == 3
    if single:
        if source is not None:
            raise ValueError("selective_scan: source needs the direction axis (x of shape (B, Gx, L, D))")
        x, dt, a, b, c = x[:, None], dt[:, None], a[None], b[:, None], c[:, None]
        d = None if d is None else d[None]
    return (x, dt, a, b, c, d), single


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in float64 for float64 ``x`` (the card's
    checks of the kernels), in float32 otherwise."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _check_shapes(x, dt, a, b, c, d, reverse, source) -> None:
    if x.dim() != 4 or a.dim() != 3 or dt.dim() != 4:
        raise ValueError(f"selective_scan: x {tuple(x.shape)} must be (B, L, D) or (B, G, L, D)")
    bsz, gx, l, dim = x.shape
    g, n = dt.shape[1], a.shape[-1]
    if source is None and gx != g:
        raise ValueError(f"selective_scan: x {tuple(x.shape)} must be {(bsz, g, l, dim)} for dt {tuple(dt.shape)}")
    want = {"dt": (dt, (bsz, g, l, dim)), "A": (a, (g, dim, n)), "B": (b, (bsz, g, l, n)), "C": (c, (bsz, g, l, n))}
    if d is not None:
        want["D"] = (d, (g, dim))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)} must be {shape} for x {tuple(x.shape)}")
    if reverse is not None and len(reverse) != g:
        raise ValueError(f"selective_scan: reverse has {len(reverse)} flags for {g} directions")
    if source is not None and (len(source) != g or not all(0 <= int(i) < gx for i in source)):
        raise ValueError(f"selective_scan: source {tuple(source)} must name one of x's {gx} directions for each "
                         f"of the {g} directions")


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         d: Optional[torch.Tensor] = None, reverse: Flags = None,
                         source: Sources = None) -> torch.Tensor:
    """The recurrence step by step in float32 (float64 for float64 ``x``), as the Pallas kernel runs it:
    ``h = h * exp(dt_t * A) + (dt_t * B_t) * x_t``, then ``y_t = sum_n(h * C_t)``
    and ``+ x_t * D``. Decays, inputs and outputs are computed ``CHUNK`` steps
    at a time, which changes no value. ``source`` is an index into ``x``'s
    directions; a reversed direction is flipped on the way in and its ``y`` on
    the way out. Differentiable as it stands."""
    (x, dt, a, b, c, d), single = _with_directions(x, dt, a, b, c, d, source)
    _check_shapes(x, dt, a, b, c, d, reverse, source)
    work = _work_dtype(x)
    x, dt, a, b, c = (t.to(work) for t in (x, dt, a, b, c))
    if source is not None:
        x = x[:, [int(i) for i in source]]
    backwards = None
    if reverse is not None and any(reverse):
        backwards = torch.tensor([bool(r) for r in reverse], device=x.device)[None, :, None, None]
        x, dt, b, c = (torch.where(backwards, t.flip(2), t) for t in (x, dt, b, c))
    bsz, g, l, dim = x.shape
    h = torch.zeros((bsz, g, dim, a.shape[-1]), dtype=work, device=x.device)
    ys = []
    for t0 in range(0, l, CHUNK):
        sl = slice(t0, min(t0 + CHUNK, l))
        da = torch.exp(dt[:, :, sl, :, None] * a[None, :, None])  # (B, G, T, D, N)
        dbx = dt[:, :, sl, :, None] * b[:, :, sl, None, :] * x[:, :, sl, :, None]
        hs = []
        for t in range(da.shape[2]):
            h = h * da[:, :, t] + dbx[:, :, t]
            hs.append(h)
        ys.append((torch.stack(hs, 2) * c[:, :, sl, None, :]).sum(-1))
    y = torch.cat(ys, 2) if ys else torch.zeros_like(x)
    if d is not None:
        y = y + x * d.to(work)[None, :, None]
    if backwards is not None:
        y = torch.where(backwards, y.flip(2), y)
    return y[:, 0] if single else y


def selective_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                             d: Optional[torch.Tensor], dy: torch.Tensor, reverse: Flags = None,
                             source: Sources = None) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``sum(selective_scan_plain(x, dt, a, b, c, d, reverse,
    source) * dy)``: ``(dx, ddt, dA, dB, dC, dD)`` in the shapes of the
    inputs (``dB`` and ``dC`` dense, ``dD`` None without ``d``), in float32
    (float64 for float64 ``x``). With ``a_t = exp(dt_t A)`` and, per state,
    the gradient reaching ``h_t``, ``g_t = C_t dy_t + a_{t+1} g_{t+1}``, the
    reverse recurrence is walked step by step; ``h`` is recomputed forwards
    CHUNK steps at a time from the states kept at each chunk's start, and the
    sums over channels, states, images and steps are taken a chunk at a time.
    Directions that share an ``x`` (``source``) add their ``dx``; a reversed
    direction is flipped on the way in and its gradients on the way out."""
    (x, dt, a, b, c, d), single = _with_directions(x, dt, a, b, c, d, source)
    _check_shapes(x, dt, a, b, c, d, reverse, source)
    dy = dy[:, None] if single else dy
    if tuple(dy.shape) != tuple(dt.shape):
        raise ValueError(f"selective_scan: dy {tuple(dy.shape)} must be {tuple(dt.shape)}")
    work = _work_dtype(x)
    gx = x.shape[1]
    src = [int(i) for i in source] if source is not None else list(range(dt.shape[1]))
    xs, dt, a, b, c, dy = (t.to(work) for t in (x[:, src], dt, a, b, c, dy))
    backwards = None
    if reverse is not None and any(reverse):
        backwards = torch.tensor([bool(r) for r in reverse], device=x.device)[None, :, None, None]
        xs, dt, b, c, dy = (torch.where(backwards, t.flip(2), t) for t in (xs, dt, b, c, dy))
    bsz, g, l, dim = dt.shape
    n = a.shape[-1]
    aa = a[None, :, None]  # (1, G, 1, D, N)
    spans = [slice(t0, min(t0 + CHUNK, l)) for t0 in range(0, l, CHUNK)]

    def decays_and_inputs(sl):
        dtsl = dt[:, :, sl, :, None]
        return torch.exp(dtsl * aa), dtsl * b[:, :, sl, None, :] * xs[:, :, sl, :, None]

    h = torch.zeros((bsz, g, dim, n), dtype=work, device=x.device)
    starts = []
    for sl in spans:  # each chunk's start state
        starts.append(h)
        da, dbx = decays_and_inputs(sl)
        for t in range(da.shape[2]):
            h = torch.addcmul(dbx[:, :, t], h, da[:, :, t])
    dxs, ddt, db, dc = (torch.zeros_like(t) for t in (dt, dt, b, c))
    da_sum = torch.zeros((g, dim, n), dtype=work, device=x.device)
    ga = torch.zeros((bsz, g, dim, n), dtype=work, device=x.device)  # a_{t+1} g_{t+1}
    for sl, h in zip(reversed(spans), reversed(starts)):
        da, dbx = decays_and_inputs(sl)
        prev = []
        for t in range(da.shape[2]):  # h_{t-1}, recomputed
            prev.append(h)
            h = torch.addcmul(dbx[:, :, t], h, da[:, :, t])
        cdy = c[:, :, sl, None, :] * dy[:, :, sl, :, None]  # C_t dy_t, (B, G, T, D, N)
        gs = [None] * da.shape[2]
        for t in reversed(range(da.shape[2])):
            gs[t] = cdy[:, :, t] + ga
            ga = da[:, :, t] * gs[t]
        gs, ah = torch.stack(gs, 2), da * torch.stack(prev, 2)  # (B, G, T, D, N): g_t and a_t h_{t-1}
        bsl, xsl, dtsl, dysl = b[:, :, sl, None, :], xs[:, :, sl], dt[:, :, sl], dy[:, :, sl]
        dc[:, :, sl] = ((ah + dbx) * dysl[..., None]).sum(3)
        db[:, :, sl] = (gs * (dtsl * xsl)[..., None]).sum(3)
        dxs[:, :, sl] = dtsl * (gs * bsl).sum(-1)
        ddt[:, :, sl] = (gs * (aa * ah + bsl * xsl[..., None])).sum(-1)
        da_sum += (gs * dtsl[..., None] * ah).sum((0, 2))
    dd = None
    if d is not None:
        dxs = dxs + d.to(work)[None, :, None] * dy
        dd = (xs * dy).sum((0, 2))
    if backwards is not None:
        dxs, ddt, db, dc = (torch.where(backwards, t.flip(2), t) for t in (dxs, ddt, db, dc))
    dx = torch.zeros((bsz, gx, l, dim), dtype=work, device=x.device).index_add_(
        1, torch.tensor(src, device=x.device), dxs)
    if single:
        return dx[:, 0], ddt[:, 0], da_sum[0], db[:, 0], dc[:, 0], None if dd is None else dd[0]
    return dx, ddt, da_sum, db, dc, dd


def chunk_length(sequences: int, length: int, dim: int, sms: int) -> int:
    """The steps per chunk for ``sequences`` (images x directions) scans of
    ``length`` steps over ``dim`` channels on a card of ``sms`` SMs: as many
    chunks as fill the card's resident warps once, each a whole number of
    tiles and at most MAX_CHUNK steps. A card that the sequences fill by
    themselves gets one chunk, unless it is longer than that."""
    warps = max(1, sequences * math.ceil(dim / LANES))
    chunks = max(1, min(sms * WARPS_PER_SM // warps, length // MIN_CHUNK))
    return min(MAX_CHUNK, max(1, math.ceil(length / chunks / TILE)) * TILE)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kernel_inputs(x, dt, a, b, c, d, reverse, source):
    """The inputs with the direction axis, checked as the kernels take them."""
    (x4, dt4, a3, b4, c4, d2), single = _with_directions(x, dt, a, b, c, d, source)
    tensors = {"x": (x4, 4), "dt": (dt4, 4), "A": (a3, 3), "B": (b4, 4), "C": (c4, 4)}
    if d2 is not None:
        tensors["D"] = (d2, 2)
    for name, (t, ndim) in tensors.items():
        _build.validate(t, f"selective_scan {name}", torch.float32, ndim, dense_last_only=name in ("B", "C"))
        if t.device != x.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, x on {x.device}")
    _check_shapes(x4, dt4, a3, b4, c4, d2, reverse, source)
    bsz, g = dt4.shape[:2]
    if a3.shape[-1] != N_STATE:
        raise ValueError(f"selective_scan: the kernel takes N = {N_STATE} states, got {a3.shape[-1]}")
    if g > MAX_DIRECTIONS or bsz * g > 65535:
        raise ValueError(f"selective_scan: the kernel takes at most {MAX_DIRECTIONS} directions and 65,535 "
                         f"sequences a call, got {g} and {bsz * g}")
    if any(s >= 2 ** 31 for t in (b4, c4) for s in t.stride()):
        raise ValueError("selective_scan: the strides of B and C must be below 2^31 floats")
    return (x4, dt4, a3, b4, c4, d2), single


def _packed(reverse: Flags, source: Sources, g: int) -> Tuple[int, int]:
    """The reverse flags as a bit mask, the sources four bits each."""
    return (sum(1 << i for i, r in enumerate(reverse or ()) if r),
            sum(int(s) << (4 * i) for i, s in enumerate(source if source is not None else range(g))))


def _launch(x4, dt4, a3, b4, c4, d2, reverse, source):
    """K4 on checked inputs with the direction axis: ``(y, carry, chunk)``,
    where ``carry`` holds each chunk's start state (after the first) and each
    chunk's sum of dt (None for a single chunk), as the backward takes it."""
    bsz, g, l, dim = dt4.shape
    y = torch.empty_like(dt4)
    chunk = chunk_length(bsz * g, l, dim, _sm_count(x4.device)) if y.numel() else TILE
    chunks = math.ceil(l / chunk)
    carry = torch.empty((bsz * g, chunks - 1, N_STATE + 1, dim), dtype=torch.float32, device=x4.device)
    if y.numel():
        _build.launch("selective_scan", _ARGS, x4.data_ptr(), dt4.data_ptr(), a3.data_ptr(), b4.data_ptr(),
                      c4.data_ptr(), d2.data_ptr() if d2 is not None else None, y.data_ptr(),
                      carry.data_ptr() if chunks > 1 else None, bsz, g, x4.shape[1], l, dim, N_STATE,
                      *b4.stride()[:3], *c4.stride()[:3], *_packed(reverse, source, g), chunk, device=x4.device)
        selective_scan.launches += 1
    return y, (carry if chunks > 1 else None), chunk


class SelectiveScan(torch.autograd.Function):
    """K4 with its backward kernel, on inputs with the direction axis. The
    forward keeps K4's carry buffer, so the backward starts each chunk's
    recomputed states from the forward's own. For CPU tensors (its CPU form,
    for the tests) the plain versions take both places."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, reverse, source):
        if x.device.type == "cpu":
            y, carry, chunk = selective_scan_plain(x, dt, a, b, c, d, reverse, source), None, None
        else:
            y, carry, chunk = _launch(x, dt, a, b, c, d, reverse, source)
        ctx.save_for_backward(x, dt, a, b, c, d, carry)
        ctx.flags = reverse, source, chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a, b, c, d, carry = ctx.saved_tensors
        reverse, source, chunk = ctx.flags
        grads = selective_scan_bwd(x, dt, a, b, c, d, dy.contiguous(), reverse, source, carry=carry, chunk=chunk)
        return (*grads, None, None)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   d: Optional[torch.Tensor] = None, reverse: Flags = None, source: Sources = None) -> torch.Tensor:
    """:func:`selective_scan_plain` through kernel K4 for CUDA tensors: one
    call, counted once, for all its directions (three kernel passes when L is
    cut into chunks, one when it is not). Where a gradient is needed the call
    goes through :class:`SelectiveScan`, whose backward is K4's backward
    kernel."""
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, a, b, c, d, reverse, source)
    inputs, single = _kernel_inputs(x, dt, a, b, c, d, reverse, source)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        y = SelectiveScan.apply(*inputs, reverse, source)
    else:
        y = _launch(*inputs, reverse, source)[0]
    return y[:, 0] if single else y


selective_scan.launches = 0


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       d: Optional[torch.Tensor], dy: torch.Tensor, reverse: Flags = None, source: Sources = None, *,
                       carry: Optional[torch.Tensor] = None, chunk: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """:func:`selective_scan_bwd_plain` through K4's backward kernel for CUDA
    tensors, counted once a call: ``(dx, ddt, dA, dB, dC, dD)``, ``dB`` and
    ``dC`` dense. ``carry`` and ``chunk``: what the forward left (see
    :func:`_launch`); the kernel recomputes each chunk's states from its start
    state there."""
    if x.device.type == "cpu":
        return selective_scan_bwd_plain(x, dt, a, b, c, d, dy, reverse, source)
    inputs, single = _kernel_inputs(x, dt, a, b, c, d, reverse, source)
    dy4 = dy[:, None] if single else dy
    _build.validate(dy4, "selective_scan dy", torch.float32, 4)
    dx, ddt, da, db, dc, dd = _launch_bwd(*inputs, dy4, reverse, source, carry, chunk)
    if single:
        return dx[:, 0], ddt[:, 0], da[0], db[:, 0], dc[:, 0], None if dd is None else dd[0]
    return dx, ddt, da, db, dc, dd


def _launch_bwd(x4, dt4, a3, b4, c4, d2, dy4, reverse, source, carry, chunk):
    """K4's backward on checked inputs with the direction axis."""
    if dy4.shape != dt4.shape:
        raise ValueError(f"selective_scan: dy {tuple(dy4.shape)} must be {tuple(dt4.shape)}")
    bsz, g, l, dim = dt4.shape
    gx = x4.shape[1]
    if chunk is None or chunk % TILE or chunk <= 0:
        raise ValueError(f"selective_scan_bwd: the forward's chunk length, a positive multiple of {TILE}, is needed; "
                         f"got {chunk}")
    chunks, groups = math.ceil(l / chunk), math.ceil(dim / LANES)
    if chunks > 1 and (carry is None or tuple(carry.shape) != (bsz * g, chunks - 1, N_STATE + 1, dim)):
        got = None if carry is None else tuple(carry.shape)
        raise ValueError(f"selective_scan_bwd: L = {l} in chunks of {chunk} needs the forward's carry of "
                         f"{(bsz * g, chunks - 1, N_STATE + 1, dim)}, got {got}")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x4.device)

    dx, ddt, da, db, dc = empty(bsz, gx, l, dim), empty(bsz, g, l, dim), empty(g, dim, N_STATE), \
        empty(bsz, g, l, N_STATE), empty(bsz, g, l, N_STATE)
    dd = empty(g, dim) if d2 is not None else None
    if not dt4.numel():
        return tuple(None if t is None else t.zero_() for t in (dx, ddt, da, db, dc, dd))
    gcarry = empty(bsz * g, chunks - 1, N_STATE, dim) if chunks > 1 else None
    starts = empty(bsz * g, chunks, groups, math.ceil(chunk / BWD_TILE), N_STATE, LANES)  # each tile's start state
    dbp, dcp = (empty(groups, bsz, g, l, N_STATE), empty(groups, bsz, g, l, N_STATE)) if groups > 1 else (db, dc)
    scratch = (gcarry, starts, empty(bsz, g, l, dim), dbp, dcp, empty(bsz * g, chunks, N_STATE, dim),
               empty(bsz * g, chunks, dim))
    ptrs = [None if t is None else t.data_ptr() for t in (x4, dt4, a3, b4, c4, d2, dy4, carry, *scratch,
                                                            dx, ddt, da, db, dc, dd)]
    _build.launch("selective_scan_bwd", _BWD_ARGS, *ptrs, bsz, g, gx, l, dim, N_STATE, *b4.stride()[:3],
                  *c4.stride()[:3], *_packed(reverse, source, g), chunk, device=x4.device, lib="selective_scan")
    selective_scan_bwd.launches += 1
    return dx, ddt, da, db, dc, dd


selective_scan_bwd.launches = 0
