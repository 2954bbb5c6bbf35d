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
:func:`selective_scan_plain` only for tensors on the CPU. K4 is forward-only,
as the Pallas kernel is: on the card a call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from experiment_yolo_torch.ops.kernels import _build

_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 15
N_STATE = 16  # the kernel keeps a channel's states in 16 registers
CHUNK = 256  # steps whose decays and inputs the plain version computes at once
MAX_DIRECTIONS = 8  # the kernel takes the direction flags and sources packed into two ints
# How the kernel cuts L (mirrors csrc/selective_scan.cu): a warp scans 32 channels of one chunk, an SM
# holds 24 such warps (12 blocks of 2, by registers and shared memory), and a chunk is a whole number
# of 8-step tiles and no shorter than 32 steps, below which the carry between chunks costs more than
# it wins.
LANES, WARPS_PER_SM, TILE, MIN_CHUNK = 32, 24, 8, 32

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
    """The recurrence step by step in float32, as the Pallas kernel runs it:
    ``h = h * exp(dt_t * A) + (dt_t * B_t) * x_t``, then ``y_t = sum_n(h * C_t)``
    and ``+ x_t * D``. Decays, inputs and outputs are computed ``CHUNK`` steps
    at a time, which changes no value. ``source`` is an index into ``x``'s
    directions; a reversed direction is flipped on the way in and its ``y`` on
    the way out. Differentiable as it stands."""
    (x, dt, a, b, c, d), single = _with_directions(x, dt, a, b, c, d, source)
    _check_shapes(x, dt, a, b, c, d, reverse, source)
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    if source is not None:
        x = x[:, [int(i) for i in source]]
    backwards = None
    if reverse is not None and any(reverse):
        backwards = torch.tensor([bool(r) for r in reverse], device=x.device)[None, :, None, None]
        x, dt, b, c = (torch.where(backwards, t.flip(2), t) for t in (x, dt, b, c))
    bsz, g, l, dim = x.shape
    h = torch.zeros((bsz, g, dim, a.shape[-1]), dtype=torch.float32, device=x.device)
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
        y = y + x * d.float()[None, :, None]
    if backwards is not None:
        y = torch.where(backwards, y.flip(2), y)
    return y[:, 0] if single else y


def chunk_length(sequences: int, length: int, dim: int, sms: int) -> int:
    """The steps per chunk for ``sequences`` (images x directions) scans of
    ``length`` steps over ``dim`` channels on a card of ``sms`` SMs: as many
    chunks as fill the card's resident warps once, each a whole number of
    tiles. A card that the sequences fill by themselves gets one chunk."""
    warps = max(1, sequences * math.ceil(dim / LANES))
    chunks = max(1, min(sms * WARPS_PER_SM // warps, length // MIN_CHUNK))
    return max(1, math.ceil(length / chunks / TILE)) * TILE


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   d: Optional[torch.Tensor] = None, reverse: Flags = None, source: Sources = None) -> torch.Tensor:
    """:func:`selective_scan_plain` through kernel K4 for CUDA tensors: one
    call, counted once, for all its directions (three kernel passes when L is
    cut into chunks, one when it is not)."""
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, a, b, c, d, reverse, source)
    (x4, dt4, a3, b4, c4, d2), single = _with_directions(x, dt, a, b, c, d, source)
    tensors = {"x": (x4, 4), "dt": (dt4, 4), "A": (a3, 3), "B": (b4, 4), "C": (c4, 4)}
    if d2 is not None:
        tensors["D"] = (d2, 2)
    for name, (t, ndim) in tensors.items():
        _build.validate(t, f"selective_scan {name}", torch.float32, ndim, dense_last_only=name in ("B", "C"))
        if t.device != x.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, x on {x.device}")
    _check_shapes(x4, dt4, a3, b4, c4, d2, reverse, source)
    bsz, g, l, dim = dt4.shape
    if a3.shape[-1] != N_STATE:
        raise ValueError(f"selective_scan: the kernel takes N = {N_STATE} states, got {a3.shape[-1]}")
    if g > MAX_DIRECTIONS or bsz * g > 65535:
        raise ValueError(f"selective_scan: the kernel takes at most {MAX_DIRECTIONS} directions and 65,535 "
                         f"sequences a call, got {g} and {bsz * g}")
    if any(s >= 2 ** 31 for t in (b4, c4) for s in t.stride()):
        raise ValueError("selective_scan: the strides of B and C must be below 2^31 floats")
    if torch.is_grad_enabled() and any(t.requires_grad for t, _ in tensors.values()):
        raise NotImplementedError("selective_scan: K4 has no backward kernel yet; on the card call it under "
                                  "torch.no_grad() (the CPU path is differentiable)")
    y = torch.empty_like(dt4)
    if y.numel():
        chunk = chunk_length(bsz * g, l, dim, _sm_count(x.device))
        chunks = math.ceil(l / chunk)
        carry = torch.empty((bsz * g, chunks - 1, N_STATE + 1, dim), dtype=torch.float32, device=x.device)
        reverse_mask = sum(1 << i for i, r in enumerate(reverse or ()) if r)
        source_pack = sum(int(s) << (4 * i) for i, s in enumerate(source if source is not None else range(g)))
        _build.launch("selective_scan", _ARGS, x4.data_ptr(), dt4.data_ptr(), a3.data_ptr(), b4.data_ptr(),
                      c4.data_ptr(), d2.data_ptr() if d2 is not None else None, y.data_ptr(),
                      carry.data_ptr() if chunks > 1 else None, bsz, g, x4.shape[1], l, dim, N_STATE,
                      *b4.stride()[:3], *c4.stride()[:3], reverse_mask, source_pack, chunk, device=x.device)
        selective_scan.launches += 1
    return y[:, 0] if single else y


selective_scan.launches = 0
