"""Kernel K7: greedy rotated-box NMS suppression, and its plain PyTorch version.

Replaces the greedy loop of ``experiment_yolo_tpu/ops/nms.py:_nms_rotated_single``
(a ``fori_loop`` over the ProbIoU matrix, ``:274-283``; not Pallas, but one
compiled loop on the device, where its plain PyTorch form is K dependent
steps launched from the host). The kernel, ``nms_rotated_suppress_launch`` in
``csrc/nms_suppress.cu``, is K2's bitmask design: a pair pass over the whole
card writes, for every pair (i, j > i), the bit ``probiou(i, j) > thr``; K2's
chain kernel, one warp per image, then walks the words unchanged. The pair
pass computes the plain version's float32 ProbIoU operation by operation, so
the keep masks are equal bit for bit on the card.

:func:`nms_rotated_suppress` launches the kernel for CUDA tensors (two
launches, one count) and takes :func:`nms_rotated_suppress_plain` only for
tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from experiment_yolo_torch.ops.boxes import probiou
from experiment_yolo_torch.ops.kernels import _build

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int, ctypes.c_float)
MAX_K = 8192  # K2's chain: 128 64-bit words of one row, at most four per lane of its warp


def nms_rotated_suppress_plain(rboxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Keep mask (B, K) bool for score-sorted xywhr boxes (B, K, 5), the
    class offset on their centres, and candidate mask ``valid`` (B, K): box i
    suppresses every later j with ``probiou(i, j) > iou_thres`` while i is
    itself kept (the JAX package's ``fori_loop``, batched)."""
    k = rboxes.shape[1]
    iou = probiou(rboxes[:, :, None], rboxes[:, None])  # (B, K, K)
    later = torch.arange(k, device=rboxes.device)
    keep = valid.clone()
    for i in range(k):
        keep &= ~((iou[:, i] > iou_thres) & keep[:, i:i + 1] & (later > i))
    return keep


def nms_rotated_suppress(rboxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """:func:`nms_rotated_suppress_plain` through kernel K7 for CUDA tensors."""
    if rboxes.device.type == "cpu":
        return nms_rotated_suppress_plain(rboxes, valid, iou_thres)
    _build.validate(rboxes, "nms_rotated_suppress rboxes", torch.float32, 3)
    _build.validate(valid, "nms_rotated_suppress valid", torch.bool, 2)
    b, k, five = rboxes.shape
    if five != 5 or tuple(valid.shape) != (b, k) or valid.device != rboxes.device:
        raise ValueError(f"nms_rotated_suppress: rboxes {tuple(rboxes.shape)} and valid {tuple(valid.shape)} must "
                         "be (B, K, 5) and (B, K) on one device")
    if rboxes.data_ptr() % 4:
        raise ValueError("nms_rotated_suppress: rboxes must be 4-byte aligned (the kernel loads floats)")
    if k > MAX_K:
        raise ValueError(f"nms_rotated_suppress: K={k} candidates exceed the kernel's {MAX_K}")
    keep = torch.empty((b, k), dtype=torch.bool, device=rboxes.device)
    if b and k:
        # the pair pass's bit per (i, j > i): row i's 64-bit words from its own word on (the rest is never read)
        mask = torch.empty((b, k, (k + 63) // 64), dtype=torch.int64, device=rboxes.device)
        _build.launch("nms_rotated_suppress", _ARGS, rboxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                      mask.data_ptr(), b, k, float(iou_thres), device=rboxes.device, lib="nms_suppress")
        nms_rotated_suppress.launches += 1
    return keep


nms_rotated_suppress.launches = 0
