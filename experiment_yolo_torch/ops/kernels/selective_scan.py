"""Kernel K4: the selective scan (Mamba state-space recurrence), and its plain
PyTorch version.

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t (+ D * x_t)

Replaces ``experiment_yolo_tpu/ops/pallas/selective_scan.py:_scan_kernel``
(reached through ``selective_scan_pallas``), the ``D * x`` term included. The
kernel, ``csrc/selective_scan.cu``, runs one thread per (sequence, channel,
state) with the loop over L inside, streams its inputs through a ring of tiles
in shared memory, and is bound by the chain of L dependent steps, not by
bytes; the source says how.

Shapes follow the JAX function: ``x``, ``dt`` (B, L, D), ``A`` (D, N), ``B``,
``C`` (B, L, N), ``D`` (D,). Every tensor may carry one more axis G of scan
directions that share the call, ``x``, ``dt`` (B, G, L, D), ``A`` (G, D, N),
``B``, ``C`` (B, G, L, N), ``D`` (G, D): SS2D's four directions are then one
launch, not four.

:func:`selective_scan` launches the kernel for CUDA tensors and takes
:func:`selective_scan_plain` only for tensors on the CPU. K4 is forward-only,
as the Pallas kernel is: on the card a call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from experiment_yolo_torch.ops.kernels import _build

_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
N_STATE = 16  # the kernel keeps a channel's states in 16 neighbouring lanes
CHUNK = 256  # steps whose decays and inputs the plain version computes at once


def _with_directions(x, dt, a, b, c, d):
    """Every argument with the direction axis G, and whether it was added."""
    single = x.dim() == 3
    if single:
        x, dt, a, b, c = x[:, None], dt[:, None], a[None], b[:, None], c[:, None]
        d = None if d is None else d[None]
    return (x, dt, a, b, c, d), single


def _check_shapes(x, dt, a, b, c, d) -> None:
    if x.dim() != 4 or a.dim() != 3:
        raise ValueError(f"selective_scan: x {tuple(x.shape)} must be (B, L, D) or (B, G, L, D)")
    bsz, g, l, dim = x.shape
    n = a.shape[-1]
    want = {"dt": (dt, (bsz, g, l, dim)), "A": (a, (g, dim, n)), "B": (b, (bsz, g, l, n)), "C": (c, (bsz, g, l, n))}
    if d is not None:
        want["D"] = (d, (g, dim))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)} must be {shape} for x {tuple(x.shape)}")


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The recurrence step by step in float32, as the Pallas kernel and the
    CUDA kernel run it: ``h = h * exp(dt_t * A) + (dt_t * B_t) * x_t``, then
    ``y_t = sum_n(h * C_t)`` and ``+ x_t * D``. Decays, inputs and outputs are
    computed ``CHUNK`` steps at a time, which changes no value. Differentiable
    as it stands."""
    (x, dt, a, b, c, d), single = _with_directions(x, dt, a, b, c, d)
    _check_shapes(x, dt, a, b, c, d)
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
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
    return y[:, 0] if single else y


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`selective_scan_plain` through kernel K4 for CUDA tensors: one
    launch for all the directions of the call."""
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, a, b, c, d)
    (x4, dt4, a3, b4, c4, d2), single = _with_directions(x, dt, a, b, c, d)
    tensors = {"x": (x4, 4), "dt": (dt4, 4), "A": (a3, 3), "B": (b4, 4), "C": (c4, 4)}
    if d2 is not None:
        tensors["D"] = (d2, 2)
    for name, (t, ndim) in tensors.items():
        _build.validate(t, f"selective_scan {name}", torch.float32, ndim)
        if t.device != x.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, x on {x.device}")
    _check_shapes(x4, dt4, a3, b4, c4, d2)
    if a3.shape[-1] != N_STATE:
        raise ValueError(f"selective_scan: the kernel takes N = {N_STATE} states, got {a3.shape[-1]}")
    if b4.data_ptr() % 16 or c4.data_ptr() % 16:
        raise ValueError("selective_scan: B and C must be 16-byte aligned (the kernel copies them four floats at a time)")
    if torch.is_grad_enabled() and any(t.requires_grad for t, _ in tensors.values()):
        raise NotImplementedError("selective_scan: K4 has no backward kernel yet; on the card call it under "
                                  "torch.no_grad() (the CPU path is differentiable)")
    bsz, g, l, dim = x4.shape
    y = torch.empty_like(x4)
    if y.numel():
        _build.launch("selective_scan", _ARGS, x4.data_ptr(), dt4.data_ptr(), a3.data_ptr(), b4.data_ptr(),
                      c4.data_ptr(), d2.data_ptr() if d2 is not None else None, y.data_ptr(), bsz, g, l, dim,
                      N_STATE, device=x.device)
        selective_scan.launches += 1
    return y[:, 0] if single else y


selective_scan.launches = 0
