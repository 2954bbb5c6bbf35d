"""Kernel K1: DFL decode of a Detect head map, and its plain PyTorch version.

Replaces ``experiment_yolo_tpu/ops/pallas/dfl_decode.py:_fwd_kernel`` (reached
through ``dfl_decode_pallas``). The kernel, ``csrc/dfl_decode.cu``, reads the
first ``4*reg_max`` channels of the NCHW map in place and is bound by memory;
the source says how its layout keeps every load coalesced.

:func:`dfl_decode` launches the kernel for a CUDA tensor and takes
:func:`dfl_decode_plain` only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from experiment_yolo_torch.ops.kernels import _build

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int)


def dfl_decode_plain(feat: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Softmax expectation over ``reg_max`` bins: (B, no, H, W) -> (B, H*W, 4) f32.

    Channels ``[side*reg_max + bin]`` for side in (l, t, r, b), as the JAX
    package's ``dfl_decode`` reads its (..., A, 4*reg_max) input. Each group
    subtracts its own max, so a cross-group logit spread of any size stays finite.
    """
    b, _, h, w = feat.shape
    x = feat[:, : 4 * reg_max].reshape(b, 4, reg_max, h * w).float()
    e = torch.exp(x - x.amax(2, keepdim=True))
    bins = torch.arange(reg_max, dtype=torch.float32, device=feat.device)
    num = (e * bins[:, None]).sum(2)
    den = e.sum(2)
    return (num / den).transpose(1, 2)


def dfl_decode(feat: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """:func:`dfl_decode_plain` through kernel K1 for a CUDA tensor."""
    if feat.device.type == "cpu":
        return dfl_decode_plain(feat, reg_max)
    _build.validate(feat, "dfl_decode feat", torch.float32, 4)
    b, no, h, w = feat.shape
    if no < 4 * reg_max:
        raise ValueError(f"dfl_decode: {no} channels < 4*reg_max = {4 * reg_max}")
    out = torch.empty((b, h * w, 4), dtype=torch.float32, device=feat.device)
    _build.launch("dfl_decode", _ARGS, feat.data_ptr(), out.data_ptr(), b, h * w, no * h * w, reg_max,
                  device=feat.device)
    dfl_decode.launches += 1
    return out


dfl_decode.launches = 0
