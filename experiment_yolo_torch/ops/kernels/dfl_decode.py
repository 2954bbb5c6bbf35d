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

import torch

from experiment_yolo_torch.ops.kernels import _build

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int)
_BWD_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int)
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


def _check_feat(feat: torch.Tensor, reg_max: int) -> None:
    _build.validate(feat, "dfl_decode feat", DTYPES, 4)
    if feat.shape[1] < 4 * reg_max:
        raise ValueError(f"dfl_decode: {feat.shape[1]} channels < 4*reg_max = {4 * reg_max}")


def dfl_decode_fwd(feat: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """:func:`dfl_decode_plain` through kernel K1 (its f32 or bf16 form) for a
    CUDA tensor (no autograd)."""
    if feat.device.type == "cpu":
        return dfl_decode_plain(feat, reg_max)
    _check_feat(feat, reg_max)
    b, no, h, w = feat.shape
    out = torch.empty((b, h * w, 4), dtype=torch.float32, device=feat.device)
    entry = dfl_decode_bf16 if feat.dtype == torch.bfloat16 else dfl_decode
    _build.launch(entry.__name__, _ARGS, feat.data_ptr(), out.data_ptr(), b, h * w, no * h * w, reg_max,
                  device=feat.device, lib="dfl_decode")
    entry.launches += 1
    return out


def dfl_decode_bwd(feat: torch.Tensor, y: torch.Tensor, g: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """:func:`dfl_decode_bwd_plain` through the K1 backward kernel (its f32 or
    bf16 form, by ``feat``'s dtype) for CUDA tensors."""
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
    entry = dfl_decode_bwd_bf16 if feat.dtype == torch.bfloat16 else dfl_decode_bwd
    _build.launch(entry.__name__, _BWD_ARGS, feat.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(),
                  b, h * w, no * h * w, reg_max, device=feat.device, lib="dfl_decode")
    entry.launches += 1
    return dx


dfl_decode_bf16 = _build.Form("dfl_decode_bf16")  # launched by dfl_decode_fwd for a bf16 map
dfl_decode_bwd_bf16 = _build.Form("dfl_decode_bwd_bf16")  # launched by dfl_decode_bwd for a bf16 map


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
