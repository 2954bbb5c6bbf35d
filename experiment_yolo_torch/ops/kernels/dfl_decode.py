"""Kernel K1: DFL decode of a Detect head map and its backward, with their
plain PyTorch versions.

Replaces ``experiment_yolo_tpu/ops/pallas/dfl_decode.py:_fwd_kernel`` and
``_bwd_kernel`` (reached through ``dfl_decode_pallas``). The kernels,
``csrc/dfl_decode.cu``, read the first ``4*reg_max`` channels of the NCHW map
in place and are bound by memory; the source says how their layout keeps every
load coalesced.

:func:`dfl_decode` is differentiable: a ``torch.autograd.Function`` whose
forward and backward launch the kernels for a CUDA tensor and take
:func:`dfl_decode_plain` and :func:`dfl_decode_bwd_plain` only for a tensor on
the CPU. The backward is the JAX package's analytic VJP,
``dx = p * g * (bin - y)`` with ``p`` recomputed from the input.
"""

from __future__ import annotations

import ctypes

import torch

from experiment_yolo_torch.ops.kernels import _build

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int)
_BWD_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int)


def _softmax_bins(feat: torch.Tensor, reg_max: int):
    """(B, 4, reg_max, H*W) group softmax of the box channels, each group
    shifted by its own max, and the bin values (reg_max, 1)."""
    b, _, h, w = feat.shape
    x = feat[:, : 4 * reg_max].reshape(b, 4, reg_max, h * w).float()
    e = torch.exp(x - x.amax(2, keepdim=True))
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
    gradient ``g`` (B, H*W, 4), given its output ``y``: (B, no, H, W) f32,
    ``p * g * (bin - y)`` in the box channels and 0 in the class channels."""
    e, bins = _softmax_bins(feat, reg_max)
    p = e * (1.0 / e.sum(2, keepdim=True))
    gt, yt = g.float().transpose(1, 2)[:, :, None], y.float().transpose(1, 2)[:, :, None]  # (B, 4, 1, A)
    dx = torch.zeros(feat.shape, dtype=torch.float32, device=feat.device)
    dx[:, : 4 * reg_max] = (p * gt * (bins - yt)).reshape(dx[:, : 4 * reg_max].shape)
    return dx


def _check_feat(feat: torch.Tensor, reg_max: int) -> None:
    _build.validate(feat, "dfl_decode feat", torch.float32, 4)
    if feat.shape[1] < 4 * reg_max:
        raise ValueError(f"dfl_decode: {feat.shape[1]} channels < 4*reg_max = {4 * reg_max}")


def dfl_decode_fwd(feat: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """:func:`dfl_decode_plain` through kernel K1 for a CUDA tensor (no autograd)."""
    if feat.device.type == "cpu":
        return dfl_decode_plain(feat, reg_max)
    _check_feat(feat, reg_max)
    b, no, h, w = feat.shape
    out = torch.empty((b, h * w, 4), dtype=torch.float32, device=feat.device)
    _build.launch("dfl_decode", _ARGS, feat.data_ptr(), out.data_ptr(), b, h * w, no * h * w, reg_max,
                  device=feat.device)
    dfl_decode.launches += 1
    return out


def dfl_decode_bwd(feat: torch.Tensor, y: torch.Tensor, g: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """:func:`dfl_decode_bwd_plain` through the K1 backward kernel for CUDA tensors."""
    if feat.device.type == "cpu":
        return dfl_decode_bwd_plain(feat, y, g, reg_max)
    _check_feat(feat, reg_max)
    b, no, h, w = feat.shape
    for t, what in ((y, "y"), (g, "g")):
        _build.validate(t, f"dfl_decode_bwd {what}", torch.float32, 3)
        if tuple(t.shape) != (b, h * w, 4) or t.device != feat.device:
            raise ValueError(f"dfl_decode_bwd: {what} {tuple(t.shape)} must be (B, H*W, 4) = {(b, h * w, 4)} "
                             "on the device of feat")
    dx = torch.empty_like(feat)
    dx[:, 4 * reg_max:].zero_()
    _build.launch("dfl_decode_bwd", _BWD_ARGS, feat.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(),
                  b, h * w, no * h * w, reg_max, device=feat.device, lib="dfl_decode")
    dfl_decode_bwd.launches += 1
    return dx


class _DFLDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat: torch.Tensor, reg_max: int) -> torch.Tensor:
        y = dfl_decode_fwd(feat, reg_max)
        ctx.save_for_backward(feat, y)
        ctx.reg_max = reg_max
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        feat, y = ctx.saved_tensors
        return dfl_decode_bwd(feat, y, g.contiguous(), ctx.reg_max), None


def dfl_decode(feat: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Differentiable DFL decode (B, no, H, W) -> (B, H*W, 4): kernel K1 and
    its backward for a CUDA tensor, the plain versions for a CPU one."""
    return _DFLDecode.apply(feat, reg_max)


dfl_decode.launches = 0
dfl_decode_bwd.launches = 0
