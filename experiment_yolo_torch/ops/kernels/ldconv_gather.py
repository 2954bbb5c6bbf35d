"""Kernel K3: the LDConv bilinear gather, and its plain PyTorch version.

Replaces ``experiment_yolo_tpu/ops/pallas/ldconv_kernel.py:_gather_kernel``
(reached through ``bilinear_gather_single``), with the semantics of the JAX
LDConv's production gather: ``ldconv_gather_packed`` times ``_border_mul``
(``nn/modules.py:422,665``). The kernel, ``csrc/ldconv_gather.cu``, turns the
raw offset-conv output into positions, corners, weights and the border
multiplier in one pass and is bound by memory; the source says how.

:func:`ldconv_gather` launches the kernel for CUDA tensors and takes
:func:`ldconv_gather_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch

from experiment_yolo_torch.ops.kernels import _build

WINDOW_R = 2  # the JAX LDConv's window_r: the edge pad R before the base grid
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 12


def grid_points(num_param: int) -> List[Tuple[int, int]]:
    """The N sampling-grid points (row, col): row-major over round(sqrt(N))
    columns plus a remainder row (the JAX package's ``_ldconv_grid_pts``)."""
    base = round(math.sqrt(num_param))
    rows, rem = divmod(num_param, base)
    return [(r, c) for r in range(rows) for c in range(base)] + [(rows, c) for c in range(rem)]


def _geometry(x: torch.Tensor, off: torch.Tensor, stride: int):
    """(N, base, padded H, padded W) for a source and its offsets; the padded
    sizes are those of the JAX LDConv's edge-padded source."""
    _, _, hx, wx = x.shape
    _, n2, h, w = off.shape
    n = n2 // 2
    pts = grid_points(n)
    max_pr = max(p[0] for p in pts)
    max_pc = max(p[1] for p in pts)
    hp = hx + WINDOW_R + max(0, (h - 1) * stride + max_pr + WINDOW_R + 2 - hx)
    wp = wx + WINDOW_R + max(0, (w - 1) * stride + max_pc + WINDOW_R + 2 - wx)
    return n, round(math.sqrt(n)), hp, wp


def ldconv_gather_plain(x: torch.Tensor, off: torch.Tensor, stride: int) -> torch.Tensor:
    """Bilinear samples of ``x`` (B, C, H, W) at the LDConv positions given by
    the offset-conv output ``off`` (B, 2N, h, w) -> (B, h*w, N*C) f32, n-major.

    Positions are ``i*stride + R + grid + offset`` in the source edge-padded by
    R = 2, clamped to the padded size; corners are clamped; each sample is
    doubled per axis whose unpadded position lies outside [0, size-1) (the
    reference fork's border double count). The float order is the JAX
    package's, so equal inputs give equal results.
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

    src = x.float().reshape(b, c, hx * wx)

    def corner(r, col):  # (B, hw, N) source indices -> (B, hw, N, C)
        idx = (r * wx + col).reshape(b, 1, h * w * n).expand(b, c, h * w * n)
        return src.gather(2, idx).reshape(b, c, h * w, n).permute(0, 2, 3, 1)

    out = ((wr0 * wc0)[..., None] * corner(sr0, sc0)
           + (wr0 * wc1)[..., None] * corner(sr0, sc1)
           + (wr1 * wc0)[..., None] * corner(sr1, sc0)
           + (wr1 * wc1)[..., None] * corner(sr1, sc1))
    ar, ac = pr - WINDOW_R, pc - WINDOW_R
    mul = (1.0 + ((ar < 0) | (ar >= hx - 1)).float()) * (1.0 + ((ac < 0) | (ac >= wx - 1)).float())
    return (out * mul[..., None]).reshape(b, h * w, n * c)


def ldconv_gather(x: torch.Tensor, off: torch.Tensor, stride: int) -> torch.Tensor:
    """:func:`ldconv_gather_plain` through kernel K3 for CUDA tensors."""
    if x.device.type == "cpu":
        return ldconv_gather_plain(x, off, stride)
    _build.validate(x, "ldconv_gather x", torch.float32, 4)
    _build.validate(off, "ldconv_gather off", torch.float32, 4)
    b, c, hx, wx = x.shape
    _, n2, h, w = off.shape
    if off.shape[0] != b or n2 % 2 or n2 == 0 or off.device != x.device:
        raise ValueError(f"ldconv_gather: x {tuple(x.shape)} and off {tuple(off.shape)} must be "
                         "(B, C, H, W) and (B, 2N, h, w) on one device")
    n, base, hp, wp = _geometry(x, off, stride)
    out = torch.empty((b, h * w, n * c), dtype=torch.float32, device=x.device)
    _build.launch("ldconv_gather", _ARGS, x.data_ptr(), off.data_ptr(), out.data_ptr(),
                  b, c, hx, wx, h, w, n, base, stride, WINDOW_R, hp, wp, device=x.device)
    ldconv_gather.launches += 1
    return out


ldconv_gather.launches = 0
